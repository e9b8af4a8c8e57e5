"""Mitchell logarithmic multipliers (paper §2.1/§2.2) and the Babic
basic-block family BB + k ECC (paper baseline [18]) on integer tensors.

Counterpart of `repro.core.mitchell`, same integer formulation:
  a = 2^k1 + x1,  b = 2^k2 + x2,  m = (x1 << k2) + (x2 << k1)
  Mitchell: P = 2^(k1+k2) + m  if m < 2^(k1+k2)  else  2m
  BB:       P = 2^(k1+k2) + m  (no case split), ECC stages re-apply BB to
            the mantissa residues.

Products are computed in int64 and returned as int32, wrapped. The
reference declares a uint32 lane for 16-bit products (`_prod_dtype`), but
JAX promotes uint32 shifted by the int32 characteristic to int32, so its
Mitchell-family products are int32 at every width and wrap at 2**31 (e.g.
mitchell(65535, 65535, 16) == -131072). The port returns the same values.
"""
from __future__ import annotations

import torch

from repro_torch.core.bitops import leading_one_position

MAX_NBITS = 16
_U32 = (1 << 32) - 1


def _check_width(nbits: int) -> None:
    if not (2 <= nbits <= MAX_NBITS):
        raise ValueError(f"nbits must be in [2, {MAX_NBITS}], got {nbits}")


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> int32 with two's-complement wrap (the reference's
    `.astype(jnp.int32)` of a uint32 product, or an int32 sum that
    overflowed)."""
    x = x.to(torch.int64) & _U32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _pow2(k: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(k) << k


def characteristic_and_mantissa(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(k, mantissa) with x = 2^k + mantissa; (0, 0) for x == 0."""
    x = x.to(torch.int64)
    k = leading_one_position(x)
    return k, x - torch.where(x > 0, _pow2(k), 0)


def mitchell(a: torch.Tensor, b: torch.Tensor, nbits: int = 16) -> torch.Tensor:
    """Mitchell's algorithm (MA) product approximation, eq. 8."""
    _check_width(nbits)
    a, b = a.to(torch.int64), b.to(torch.int64)
    k1, x1 = characteristic_and_mantissa(a)
    k2, x2 = characteristic_and_mantissa(b)
    m = (x1 << k2) + (x2 << k1)
    lead = _pow2(k1 + k2)
    p = torch.where(m < lead, lead + m, 2 * m)
    return wrap_int32(torch.where((a == 0) | (b == 0), 0, p))


def babic_bb(a: torch.Tensor, b: torch.Tensor, nbits: int = 16) -> torch.Tensor:
    """Babic/Bulic basic block (no case split): 2^(k1+k2) + m."""
    _check_width(nbits)
    a, b = a.to(torch.int64), b.to(torch.int64)
    k1, x1 = characteristic_and_mantissa(a)
    k2, x2 = characteristic_and_mantissa(b)
    p = _pow2(k1 + k2) + (x1 << k2) + (x2 << k1)
    return wrap_int32(torch.where((a == 0) | (b == 0), 0, p))


def babic_ecc(a: torch.Tensor, b: torch.Tensor, nbits: int = 16,
              num_ecc: int = 1) -> torch.Tensor:
    """Iterative logarithmic multiplier: BB + `num_ecc` correction stages,
    each applying BB to the previous stage's mantissa residues."""
    _check_width(nbits)
    ra, rb = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
    total = torch.zeros_like(ra)
    for _ in range(num_ecc + 1):
        total = total + babic_bb(ra, rb, nbits).to(torch.int64)
        ra = characteristic_and_mantissa(ra)[1]
        rb = characteristic_and_mantissa(rb)[1]
    return wrap_int32(total)


__all__ = ["MAX_NBITS", "babic_bb", "babic_ecc", "characteristic_and_mantissa",
           "mitchell", "wrap_int32"]
