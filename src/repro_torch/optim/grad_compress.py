"""int8 gradient compression with error feedback.

Counterpart of `repro.optim.grad_compress`'s codec (`compress_grads`,
`init_error_feedback`): each gradient, plus the residual the last step's
quantization left, is quantized to int8 with one abs-max scale and
dequantized; what the int8 grid lost is fed into the next step instead of
discarded. Rounding is half to even (`torch.round`) and every division is
by a float32 tensor on the gradient's device. As in the reference, the
scale of a segment leaf is taken over the whole stack of its layers
(`repro_torch.optim.optimizers.Group`), and the residual keeps the stacked
shape.

The reference's `shard_map_allreduce_i8` (the int8 wire format of the
data-parallel all-reduce) needs more than one shard and has no counterpart
in one process on one card.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import f32
from repro_torch.optim.optimizers import Group


def _quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.maximum(g.abs().max(), f32(1e-30, g)) / f32(127.0, g)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_grads(grads: list[list[torch.Tensor]], ef: dict,
                   groups: list[Group]) -> tuple[list[list[torch.Tensor]], dict]:
    """grads + error-feedback residual -> (dequantized grads, new residual);
    `grads` and the result list, per group, the per-layer grads."""
    out, new_ef = [], {}
    for group, gs in zip(groups, grads):
        g = torch.stack(gs) if group.stacked else gs[0]
        gf = g.to(torch.float32) + ef[group.key]
        q, scale = _quantize(gf)
        deq = q.to(torch.float32) * scale
        new_ef[group.key] = gf - deq
        out.append(list(deq.unbind(0)) if group.stacked else [deq])
    return out, new_ef


def init_error_feedback(groups: list[Group]) -> dict:
    return {g.key: torch.zeros(g.shape, dtype=torch.float32, device=g.params[0].device)
            for g in groups}


__all__ = ["compress_grads", "init_error_feedback"]
