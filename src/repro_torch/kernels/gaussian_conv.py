"""3x3 Gaussian convolution with a selectable multiplier (paper §3.3).

Counterpart of `repro.kernels.gaussian_conv`: the paper's Fig. 9 scale-256
tap table and the single-image wrapper over the direct conv pass.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.filters.conv import conv2d_pass


def gaussian_kernel_3x3(sigma: float = 1.0, scale: int = 256) -> np.ndarray:
    """Sampled, truncated, integer-scaled 2-D Gaussian (paper eq. 25/Fig. 9)."""
    xs = np.arange(-1, 2, dtype=np.float64)
    g = np.exp(-(xs[:, None] ** 2 + xs[None, :] ** 2) / (2.0 * sigma**2))
    g /= 2.0 * np.pi * sigma**2
    return np.round(g / g.sum() * scale).astype(np.int32)


def gaussian_conv3x3_kernel(img: torch.Tensor, kernel, *, method: str = "refmlm",
                            nbits: int = 8, mult_impl: str = "auto") -> torch.Tensor:
    """img (H, W) int32 pixels in [0, 255]; kernel (3, 3) scale-256 table;
    -> (H, W) int32 on the image's device."""
    return conv2d_pass(img[None], kernel, method=method, nbits=nbits, shift=8,
                       post="clip", mult_impl=mult_impl)[0]


__all__ = ["gaussian_conv3x3_kernel", "gaussian_kernel_3x3"]
