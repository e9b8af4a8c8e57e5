"""Generic-width Karatsuba-Ofman recursion (paper §2.3) over pluggable base
multipliers.

Counterpart of `repro.core.karatsuba`:

  * `kom(a, b, nbits, base_nbits, base_fn, variant)` recurses radix-2 from
    `nbits` down to `base_nbits`, then applies `base_fn`, any element-wise
    exact-or-approximate multiplier on `base_nbits`-wide operands;
  * `variant='kom4'` is the paper's 4-product split (Table 2 steps 5-8),
    `variant='kom3'` eq. 19's 3-product Karatsuba with a sign-tracked cross
    term;
  * `exact_base(w)` is the hardware-exact base (a narrow exact unit composed
    into a wide exact multiply -- the REFMLM program);
  * `op_counts` gives Table 9's economics as operation counts.

The reference combines each level in int32 lanes, and in uint32 lanes where
2 * width > 31. The port carries every level in int64 and reduces it the
same way: modulo 2**32 for the uint32 lane, to the int32 wrap otherwise.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.bitops import split_halves, wrap32
from repro_torch.core.mitchell import _check_width

BaseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def exact_base(base_nbits: int) -> BaseFn:
    """Hardware-exact base multiplier (an int32 lane product)."""
    del base_nbits
    return lambda a, b: wrap32(a.to(torch.int64) * b.to(torch.int64))


def _lane(x: torch.Tensor, width: int) -> torch.Tensor:
    """x reduced to the reference's product lane of a `width`-bit level."""
    return x & ((1 << 32) - 1) if 2 * width > 31 else wrap32(x)


def kom(a: torch.Tensor, b: torch.Tensor, nbits: int, *, base_nbits: int = 2,
        base_fn: BaseFn | None = None, variant: str = "kom4") -> torch.Tensor:
    """KOM product of non-negative `nbits`-wide operands, as int64.

    Exact iff `base_fn` is exact on `base_nbits`-wide operands (the paper's
    theorem: KOM introduces no error of its own)."""
    _check_width(nbits)
    if nbits % base_nbits != 0 or (nbits // base_nbits) & (nbits // base_nbits - 1):
        raise ValueError(f"nbits={nbits} must be base_nbits*2^L (base={base_nbits})")
    if base_fn is None:
        base_fn = exact_base(base_nbits)

    def sub(x, y, w):                 # a sub-product as the reference's int32
        return wrap32(recurse(x, y, w).to(torch.int64))

    def recurse(x: torch.Tensor, y: torch.Tensor, w: int) -> torch.Tensor:
        if w == base_nbits:
            return base_fn(x, y)
        half = w // 2
        xh, xl = split_halves(wrap32(x.to(torch.int64)), w)
        yh, yl = split_halves(wrap32(y.to(torch.int64)), w)
        low = sub(xl, yl, half)
        high = sub(xh, yh, half)
        if variant == "kom4":
            mid = wrap32(sub(xh, yl, half) + sub(xl, yh, half))
        elif variant == "kom3":
            dl, dr = xl - xh, yh - yl
            sign = torch.sign(dl) * torch.sign(dr)
            mid = wrap32(low + high + sign * sub(dl.abs(), dr.abs(), half))
        else:
            raise ValueError(f"unknown variant {variant!r}")
        return _lane(_lane(low, w) + (_lane(mid, w) << half)
                     + (_lane(high, w) << w), w)

    return recurse(a, b, nbits)


def op_counts(nbits: int, base_nbits: int = 2, variant: str = "kom4") -> dict[str, int]:
    """Base-multiplies and word-adds per product (Table 9 economics, op form)."""
    if nbits == base_nbits:
        return {"base_mults": 1, "adds": 0}
    sub = op_counts(nbits // 2, base_nbits, variant)
    if variant == "kom4":
        return {"base_mults": 4 * sub["base_mults"], "adds": 4 * sub["adds"] + 3}
    return {"base_mults": 3 * sub["base_mults"], "adds": 3 * sub["adds"] + 6}


__all__ = ["BaseFn", "exact_base", "kom", "op_counts"]
