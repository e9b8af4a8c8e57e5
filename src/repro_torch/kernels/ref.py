"""Plain oracles of the kernels under the reference's names.

Counterpart of `repro.kernels.ref`. The two matmul oracles are the plain
PyTorch versions defined beside their kernels and re-exported here;
`gaussian_conv3x3_ref` is the shift-and-accumulate 3x3 convolution of the
paper's Fig. 9 experiment. All are bit-exact against their kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.bitops import wrap32
from repro_torch.core.kcm import tap_multiplier
from repro_torch.kernels.karatsuba_matmul import (
    karatsuba_matmul_plain as karatsuba_matmul_ref,
)
from repro_torch.kernels.mitchell_matmul import (
    mitchell_matmul_plain as mitchell_matmul_ref,
)


def gaussian_conv3x3_ref(img: torch.Tensor, kernel, *, method: str = "refmlm",
                         nbits: int = 8) -> torch.Tensor:
    """(H, W) pixels, (3, 3) coefficient table -> (H, W) int32:
    clip((sum of tap products + 128) >> 8, 0, 255), zero padding."""
    h, w = img.shape
    padded = F.pad(img.to(torch.int64), (1, 1, 1, 1))
    kernel = torch.as_tensor(kernel).to(torch.int64)
    mult = tap_multiplier(method)
    acc = torch.zeros((h, w), dtype=torch.int64, device=img.device)
    for di in range(3):
        for dj in range(3):
            tap = padded[di:di + h, dj:dj + w]
            coeff = torch.full_like(tap, int(kernel[di, dj]))
            acc = acc + mult(tap, coeff, nbits).to(torch.int64)
    return (wrap32(wrap32(acc) + 128) >> 8).clamp(0, 255).to(torch.int32)


__all__ = ["gaussian_conv3x3_ref", "karatsuba_matmul_ref", "mitchell_matmul_ref"]
