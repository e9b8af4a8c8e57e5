"""The filter bank: named integer-coefficient 2-D image filters.

A copy of `repro.filters.bank` (the port imports nothing of `repro`). Each
`FilterSpec` is a KxK integer tap table plus the fixed-point bookkeeping
(`shift`, `post`) of the paper's convolution engine and, where the kernel
is rank-1, its separable row/column decomposition. Smoothing filters sum to
~2**shift and the engine computes `(acc + 2**(shift-1)) >> shift`;
derivative filters use shift=0 and `post='abs'`. For a separable spec the
2-D table IS the outer product of the row and column vectors, so with an
exact multiplier the two-pass and direct paths agree bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class FilterSpec(NamedTuple):
    """One filter of the bank, in the integer datapath's terms."""

    name: str
    taps: np.ndarray            # (kh, kw) int32 coefficient table
    shift: int                  # output normalization: acc >> shift
    post: str                   # 'clip' (smoothing) | 'abs' (derivative)
    sep_row: np.ndarray | None  # (kw,) int32 horizontal pass, or None
    sep_col: np.ndarray | None  # (kh,) int32 vertical pass, or None

    @property
    def separable(self) -> bool:
        return self.sep_row is not None

    @property
    def ksize(self) -> tuple[int, int]:
        return self.taps.shape  # type: ignore[return-value]


def gaussian_kernel_1d(ktaps: int, sigma: float, scale: int) -> np.ndarray:
    """Sampled, truncated 1-D Gaussian rounded to integers summing to `scale`
    (the center tap absorbs the rounding residue)."""
    if ktaps % 2 != 1:
        raise ValueError(f"ktaps must be odd, got {ktaps}")
    r = ktaps // 2
    xs = np.arange(-r, r + 1, dtype=np.float64)
    g = np.exp(-(xs**2) / (2.0 * sigma**2))
    k = np.round(g / g.sum() * scale).astype(np.int64)
    k[r] += scale - k.sum()
    if k.sum() != scale or not (k > 0).all():
        raise ValueError(f"sigma={sigma} leaves a zero tap at scale {scale}")
    return k.astype(np.int32)


def _separable(name: str, row: np.ndarray, col: np.ndarray, shift: int,
               post: str = "clip") -> FilterSpec:
    taps = np.outer(col.astype(np.int64), row.astype(np.int64)).astype(np.int32)
    return FilterSpec(name, taps, shift, post,
                      row.astype(np.int32), col.astype(np.int32))


def _direct(name: str, taps: list[list[int]], shift: int,
            post: str = "clip") -> FilterSpec:
    return FilterSpec(name, np.asarray(taps, np.int32), shift, post, None, None)


def _build_bank(sigma: float = 1.0) -> dict[str, FilterSpec]:
    g3 = gaussian_kernel_1d(3, sigma, scale=16)          # [4, 8, 4]
    g5 = gaussian_kernel_1d(5, sigma, scale=16)          # [1, 4, 6, 4, 1]
    return {
        "gaussian3": _separable("gaussian3", g3, g3, shift=8),
        "gaussian5": _separable("gaussian5", g5, g5, shift=8),
        # 4 * 7 = 28 ~ 256/9: the closest unit-gain rank-1 box at shift 8.
        "box3": _separable("box3", np.full(3, 4, np.int64),
                           np.full(3, 7, np.int64), shift=8),
        # Sharpen: 32 * (identity + laplacian), shift 5.
        "sharpen3": _direct("sharpen3", [[0, -32, 0],
                                         [-32, 160, -32],
                                         [0, -32, 0]], shift=5),
        "sobel_x": _separable("sobel_x", np.array([-1, 0, 1], np.int64),
                              np.array([1, 2, 1], np.int64), shift=0, post="abs"),
        "sobel_y": _separable("sobel_y", np.array([1, 2, 1], np.int64),
                              np.array([-1, 0, 1], np.int64), shift=0, post="abs"),
        "laplacian": _direct("laplacian", [[0, 1, 0],
                                           [1, -4, 1],
                                           [0, 1, 0]], shift=0, post="abs"),
    }


FILTER_BANK: dict[str, FilterSpec] = _build_bank()
FILTER_NAMES: tuple[str, ...] = tuple(FILTER_BANK)


def get_filter(name: str, *, sigma: float | None = None) -> FilterSpec:
    """Look up a bank filter; `sigma` re-samples the Gaussian members."""
    if sigma is not None and name in ("gaussian3", "gaussian5"):
        return _build_bank(sigma)[name]
    try:
        return FILTER_BANK[name]
    except KeyError:
        raise ValueError(
            f"unknown filter {name!r}; bank: {FILTER_NAMES}") from None


def max_intermediate(spec: FilterSpec, pixel_max: int = 255) -> int:
    """Worst-case |row-pass accumulator| -- sizes the second-pass multiplier."""
    if not spec.separable:
        return 0
    return int(pixel_max * np.abs(spec.sep_row.astype(np.int64)).sum())


__all__ = ["FILTER_BANK", "FILTER_NAMES", "FilterSpec", "gaussian_kernel_1d",
           "get_filter", "max_intermediate"]
