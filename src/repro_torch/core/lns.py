"""Log-number-system (LNS) tensor codecs.

Counterpart of `repro.core.lns`. An integer magnitude v > 0 is represented
as the fixed-point log L(v) = (k << F) | frac, with k the characteristic
(leading-one position) and F fraction bits; Mitchell's approximation is the
truncated fraction, exact when F >= nbits - 1. Multiplying is adding codes.

Codes are int32 values carried in int64, with the reference's int32 shift
semantics (`bitops.shift_left_int32` / `shift_right_int32`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.bitops import (
    leading_one_position,
    shift_left_int32,
    shift_right_int32,
    wrap32,
)


class LNSCode(NamedTuple):
    code: torch.Tensor         # int32 fixed-point log2, (k << frac_bits) | frac
    is_zero: torch.Tensor      # bool
    frac_bits: int


def encode(v: torch.Tensor, nbits: int, frac_bits: int | None = None) -> LNSCode:
    """Exact Mitchell log encode of unsigned integers (frac_bits >= nbits-1)."""
    if frac_bits is None:
        frac_bits = nbits - 1
    v = wrap32(v.to(torch.int64))
    k = leading_one_position(v)
    mant = v - torch.where(v > 0, shift_left_int32(torch.ones_like(k), k), 0)
    frac = torch.where(frac_bits >= k, shift_left_int32(mant, frac_bits - k),
                       shift_right_int32(mant, k - frac_bits))
    code = shift_left_int32(k, torch.full_like(k, frac_bits)) | frac
    return LNSCode(code.to(torch.int32), v == 0, frac_bits)


def decode(c: LNSCode) -> torch.Tensor:
    """Mitchell antilog: 2^k (1 + f), with the >= 1 carry case of eq. 8."""
    fb = c.frac_bits
    code = c.code.to(torch.int64)
    k = code >> fb
    frac = code & ((1 << fb) - 1)
    scaled = torch.where(fb >= k, shift_right_int32(frac, fb - k),
                         shift_left_int32(frac, k - fb))
    v = wrap32(shift_left_int32(torch.ones_like(k), k) + scaled)
    return torch.where(c.is_zero, 0, v).to(torch.int32)


def lns_multiply(a: LNSCode, b: LNSCode) -> LNSCode:
    """Multiplication = addition of log codes (the sum's carry into the
    characteristic field implements eq. 8's f1 + f2 >= 1 case)."""
    if a.frac_bits != b.frac_bits:
        raise ValueError(f"frac_bits differ: {a.frac_bits} vs {b.frac_bits}")
    code = wrap32(a.code.to(torch.int64) + b.code.to(torch.int64))
    return LNSCode(code.to(torch.int32), a.is_zero | b.is_zero, a.frac_bits)


__all__ = ["LNSCode", "decode", "encode", "lns_multiply"]
