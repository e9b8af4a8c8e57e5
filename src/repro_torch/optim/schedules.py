"""LR schedules: pure functions of the step, on the step's device.

Counterpart of `repro.optim.schedules`. The step and the learning rate are
0-d float32 tensors on the step's device, never Python floats: reading a
float back would cost a host sync a step, and on CUDA PyTorch turns a
division by a host scalar into a multiply by its reciprocal, which can
differ from the quotient in the last bit. So every divisor is a float32
tensor on the step's device (`repro_torch.core.quant.f32`), as in the
reference's float32 arithmetic.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.core.quant import f32


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warm-up (step 0 trains too), then a cosine decay to
    `final_frac` of the peak. lr(step) takes a 0-d tensor (any dtype) and
    returns a 0-d float32 tensor on its device."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * (step + 1.0) / f32(max(warmup_steps, 1), step)
        prog = torch.clamp((step - warmup_steps) / f32(max(total_steps - warmup_steps, 1), step),
                           0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5
                         * (1 + torch.cos(f32(math.pi, step) * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


__all__ = ["cosine_schedule"]
