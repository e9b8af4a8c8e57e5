"""Operand-Decomposition Mitchell multiplier (ODMA), paper baseline [19].

Counterpart of `repro.core.odma`:
  a * b = (a AND b) * (a OR b) + (a AND NOT b) * (NOT a AND b),
with each sub-product evaluated by Mitchell's algorithm.
"""
from __future__ import annotations

import torch

from repro_torch.core.mitchell import _check_width, mitchell, wrap_int32


def decompose(a: torch.Tensor, b: torch.Tensor, nbits: int):
    mask = (1 << nbits) - 1
    a = a.to(torch.int64) & mask
    b = b.to(torch.int64) & mask
    return a & b, a | b, a & (~b & mask), (~a & mask) & b


def odma(a: torch.Tensor, b: torch.Tensor, nbits: int = 16) -> torch.Tensor:
    """ODMA approximate product: two Mitchell multiplies + one add (int32,
    wrapped like the reference's)."""
    _check_width(nbits)
    p1a, p1b, p2a, p2b = decompose(a, b, nbits)
    return wrap_int32(mitchell(p1a, p1b, nbits).to(torch.int64)
                      + mitchell(p2a, p2b, nbits))


def odma_exact_identity(a: torch.Tensor, b: torch.Tensor, nbits: int = 16) -> torch.Tensor:
    """The decomposition identity with exact products (an oracle), in the
    reference's lane: int32 while 2 * nbits <= 31, wrapped; uint32 at 16
    bits, modulo 2**32."""
    _check_width(nbits)
    p1a, p1b, p2a, p2b = decompose(a, b, nbits)
    total = p1a * p1b + p2a * p2b
    if 2 * nbits <= 31:
        return wrap_int32(total)
    return (total & ((1 << 32) - 1)).to(torch.uint32)


__all__ = ["decompose", "odma", "odma_exact_identity"]
