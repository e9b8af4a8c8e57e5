"""Public entry points of the kernels package.

Counterpart of `repro.kernels.ops`: the float-in / float-out matmuls over
the two matmul kernels (`lns_matmul`, `limb_matmul`), which quantize, call
the kernel on integers and rescale, and the legacy `gaussian_filter` (paper
Fig. 9 table), with the bank's `apply_filter` and `filter_bank_apply`
re-exported. The reference's TPU block and `accum` arguments have no
counterpart: the kernels take ragged shapes as they are.

The port computes what the reference's source says. The reference wraps
both matmuls in `jax.jit`, where XLA may rewrite the float32 scale
arithmetic (a division by the constant qmax becomes a multiply by its
reciprocal, and the two scales' constants are folded together), so the
jitted reference can differ from these in the last bit of the rescale;
run op by op (`jax.disable_jit()`), it gives the same bytes.
"""
from __future__ import annotations

import torch

from repro_torch.core import approx_matmul
from repro_torch.core.platform import resolve_device
from repro_torch.filters.pipeline import apply_filter, filter_bank_apply
from repro_torch.kernels.gaussian_conv import (
    gaussian_conv3x3_kernel,
    gaussian_kernel_3x3,
)


def _float_operands(a, b, device) -> tuple[torch.Tensor, torch.Tensor]:
    dev = resolve_device(device)
    a, b = torch.as_tensor(a).to(dev), torch.as_tensor(b).to(dev)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected (M, K) x (K, N), got {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    return a, b


def lns_matmul(a, b, *, nbits: int = 8, num_ecc: int = 0, case_split: bool = True,
               device: str | torch.device | None = None) -> torch.Tensor:
    """Approximate float matmul on the Mitchell-family kernel: a (M, K) x
    b (K, N) -> float32 (M, N) on `device` (the CUDA card by default).
    num_ecc=0 / case_split=True is Mitchell's algorithm; case_split=False
    with k ECCs is the Babic iterative multiplier."""
    a, b = _float_operands(a, b, device)
    return approx_matmul.kernel_lns_matmul(a, b, nbits=nbits, num_ecc=num_ecc,
                                           case_split=case_split)


def limb_matmul(a, b, *, karatsuba: bool = True,
                device: str | torch.device | None = None) -> torch.Tensor:
    """Exact wide-int matmul from 3 (karatsuba) or 4 (schoolbook) limb
    products: a (M, K) x b (K, N) -> float32 (M, N) on `device`. The int32
    partial sums are rescaled in float32, as the reference does."""
    a, b = _float_operands(a, b, device)
    return approx_matmul.limb_matmul(a, b, karatsuba=karatsuba, kernel=True)


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
           "gaussian_kernel_3x3", "limb_matmul", "lns_matmul"]
