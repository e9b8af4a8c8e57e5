"""Public entry points of the kernels package.

Counterpart of `repro.kernels.ops` for the filter datapath: the legacy
`gaussian_filter` (paper Fig. 9 table), with the bank's `apply_filter` and
`filter_bank_apply` re-exported. The reference's `lns_matmul` and
`limb_matmul` are not ported yet (ROADMAP Queue 2, items 2c and 2d).
"""
from __future__ import annotations

import torch

from repro_torch.core.platform import resolve_device
from repro_torch.filters.pipeline import apply_filter, filter_bank_apply
from repro_torch.kernels.gaussian_conv import (
    gaussian_conv3x3_kernel,
    gaussian_kernel_3x3,
)


def gaussian_filter(img, kernel, *, method: str = "refmlm", nbits: int = 8,
                    mult_impl: str = "auto",
                    device: str | torch.device | None = None) -> torch.Tensor:
    """3x3 Gaussian smoothing of an (H, W) image with the selected
    multiplier; -> uint8 tensor on `device` (the CUDA card by default)."""
    x = torch.as_tensor(img).to(device=resolve_device(device), dtype=torch.int32)
    out = gaussian_conv3x3_kernel(x, kernel, method=method, nbits=nbits,
                                  mult_impl=mult_impl)
    return out.to(torch.uint8)


__all__ = ["apply_filter", "filter_bank_apply", "gaussian_filter",
           "gaussian_kernel_3x3"]
