"""Element-wise integer bit operations used by the logarithmic multipliers.

Counterpart of `repro.core.bitops`. The port carries every multiplier
operand and product in int64: the reference's 16-bit widths use uint32
lanes, and torch has no uint32 add, shift or compare on the CPU. Operands
are non-negative values below 2**nbits, nbits <= 16.
"""
from __future__ import annotations

import torch


def leading_one_position(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) per element by a branch-free binary search (the
    paper's leading-one detector); 0 for x == 0, as in the reference."""
    x = x.to(torch.int64)
    k = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        gt = x >= (1 << shift)
        k = k + gt * shift
        x = torch.where(gt, x >> shift, x)
    return k


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> int64 tensor holding the int32 two's-complement wrap
    of each value (an int32 lane's result carried in int64)."""
    return ((x + (1 << 31)) & ((1 << 32) - 1)) - (1 << 31)


def shift_left_int32(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """XLA's int32 `x << s` on int32 values carried in int64: the low 32
    bits of x * 2**s, and 0 when s lies outside [0, 31]."""
    ok = (s >= 0) & (s < 32)
    return torch.where(ok, wrap32(x << s.clamp(0, 31)), 0)


def shift_right_int32(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """XLA's arithmetic int32 `x >> s` on int32 values carried in int64:
    the sign fill (0 or -1) when s lies outside [0, 31]."""
    ok = (s >= 0) & (s < 32)
    return torch.where(ok, x >> s.clamp(0, 31), torch.where(x < 0, -1, 0))


def mantissa(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The integer mantissa x - 2^k (the bits below the leading one), int32
    as the reference's."""
    x = wrap32(x.to(torch.int64))
    return wrap32(x - torch.where(x > 0, shift_left_int32(torch.ones_like(x),
                                                          k.to(torch.int64)), 0)
                  ).to(torch.int32)


def decode_power(k: torch.Tensor) -> torch.Tensor:
    """The decoder: characteristic k -> 2^k, int32 (the paper's d)."""
    k = k.to(torch.int64)
    return shift_left_int32(torch.ones_like(k), k).to(torch.int32)


def popcount(x: torch.Tensor, nbits: int = 32) -> torch.Tensor:
    """Set bits among the low `nbits` of each element's uint32 value
    (the ODMA error analysis); int32."""
    x = x.to(torch.int64) & ((1 << 32) - 1)
    c = torch.zeros_like(x)
    for i in range(nbits):
        c = c + ((x >> i) & 1)
    return c.to(torch.int32)


def bit_width_mask(nbits: int) -> int:
    return (1 << nbits) - 1


def split_halves(x: torch.Tensor, nbits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) nbits/2-bit halves of an nbits operand (paper Table 2)."""
    if nbits % 2:
        raise ValueError(f"radix-2 decomposition needs even width, got {nbits}")
    half = nbits // 2
    return (x >> half) & bit_width_mask(half), x & bit_width_mask(half)


__all__ = ["bit_width_mask", "decode_power", "leading_one_position", "mantissa", "popcount",
           "shift_left_int32", "shift_right_int32", "split_halves", "wrap32"]
