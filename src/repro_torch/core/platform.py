"""Device resolution for the port's entry points.

Counterpart of `repro.core.platform`, whose `resolve_interpret` and
`grid_compiler_params` choose between the Pallas interpreter and the TPU
compiler. Here an entry point runs on the CUDA card unless the caller names
another device. With no card and no explicit device it raises: nothing
quietly falls back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` -> the CUDA card (raises when there is none); else `device`."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


__all__ = ["resolve_device"]
