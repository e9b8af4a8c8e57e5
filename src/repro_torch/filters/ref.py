"""Plain PyTorch oracles for the filter subsystem.

Counterpart of `repro.filters.ref`: an independently written
shift-and-accumulate loop over the taps (not the conv passes' code), so the
tests compare two implementations of the same dataflow. Integer in, integer
out, the same wrapping int32 sum and fixed-point epilogue as the passes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.kcm import tap_multiplier
from repro_torch.filters.bank import FilterSpec, get_filter, max_intermediate
from repro_torch.filters.conv import second_pass_nbits


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement wrap of int64 values into int32."""
    return ((x + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def conv2d_ref(imgs: torch.Tensor, taps, *, method: str = "refmlm",
               nbits: int = 8, shift: int = 8, post: str = "clip") -> torch.Tensor:
    """(N, H, W) int32 batched convolution oracle, signed-magnitude taps."""
    taps = np.asarray(taps, np.int64)
    kh, kw = taps.shape
    n, h, w = imgs.shape
    padded = torch.zeros((n, h + kh - 1, w + kw - 1), dtype=torch.int64,
                         device=imgs.device)
    padded[:, kh // 2:kh // 2 + h, kw // 2:kw // 2 + w] = imgs
    mult = tap_multiplier(method)
    acc = torch.zeros((n, h, w), dtype=torch.int64, device=imgs.device)
    for di in range(kh):
        for dj in range(kw):
            tap = padded[:, di:di + h, dj:dj + w]
            c = torch.full_like(tap, int(taps[di, dj]))
            prod = mult(tap.abs(), c.abs(), nbits).to(torch.int64)
            acc = acc + torch.sign(c) * torch.sign(tap) * prod
    acc = _to_int32(acc)
    if post == "none":
        return acc
    if post == "abs":
        acc = _to_int32(acc.to(torch.int64).abs())
    if shift > 0:
        acc = _to_int32(acc.to(torch.int64) + (1 << (shift - 1))) >> shift
    return acc.clamp(0, 255)


def apply_filter_ref(imgs: torch.Tensor, filt: FilterSpec | str, *,
                     method: str = "refmlm", nbits: int = 8,
                     separable: bool | None = None) -> torch.Tensor:
    """Oracle for pipeline.apply_filter on an (N, H, W) batch -> uint8."""
    spec = get_filter(filt) if isinstance(filt, str) else filt
    if separable is None:
        separable = spec.separable
    if separable:
        row = np.asarray(spec.sep_row, np.int64)[None, :]
        col = np.asarray(spec.sep_col, np.int64)[:, None]
        nb2 = second_pass_nbits(max_intermediate(spec),
                                int(np.abs(spec.sep_col).max()))
        tmp = conv2d_ref(imgs, row, method=method, nbits=nbits, shift=0,
                         post="none")
        out = conv2d_ref(tmp, col, method=method, nbits=nb2, shift=spec.shift,
                         post=spec.post)
    else:
        out = conv2d_ref(imgs, spec.taps, method=method, nbits=nbits,
                         shift=spec.shift, post=spec.post)
    return out.to(torch.uint8)


__all__ = ["apply_filter_ref", "conv2d_ref"]
