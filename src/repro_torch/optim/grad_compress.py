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

On a mesh (`runtime.train_lib`) the grads and the residual are this rank's
blocks of the stacked leaf: the abs-max is the block's, all-reduced (max)
over the mesh axes that split the leaf, and each block is quantized,
dequantized and kept where it is. A max is exact, so the dequantized
blocks and the residual are those of the whole-leaf codec, to the byte.

`shard_map_allreduce_i8(x, mesh, axis)` is the reference's int8
all-reduce, on the ranks of a `DeviceMesh` axis: the ranks agree on one
scale first (an all-reduce of the abs-max, one float), then sum their int8
payloads exactly in int32, so the mean is the reference's to the byte.
"""
from __future__ import annotations

import torch

from repro_torch.core.collectives import all_reduce
from repro_torch.core.quant import f32
from repro_torch.optim.optimizers import Group


def _quantize(g: torch.Tensor, axes: tuple = ()) -> tuple[torch.Tensor, torch.Tensor]:
    gmax = g.abs().max()
    for a in axes:
        all_reduce(gmax, "max", a)
    scale = torch.maximum(gmax, f32(1e-30, g)) / f32(127.0, g)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_grads(grads: list[list[torch.Tensor]], ef: dict, groups: list[Group],
                   axes: list[tuple] | None = None) -> tuple[list[list[torch.Tensor]], dict]:
    """grads + error-feedback residual -> (dequantized grads, new residual);
    `grads` and the result list, per group, the per-layer grads (on a mesh
    their blocks, and `axes`, per group, the mesh axes that split its leaf:
    module docstring)."""
    out, new_ef = [], {}
    for i, (group, gs) in enumerate(zip(groups, grads)):
        g = torch.stack(gs) if group.stacked else gs[0]
        gf = g.to(torch.float32) + ef[group.key]
        q, scale = _quantize(gf, axes[i] if axes else ())
        deq = q.to(torch.float32) * scale
        new_ef[group.key] = gf - deq
        out.append(list(deq.unbind(0)) if group.stacked else [deq])
    return out, new_ef


def shard_map_allreduce_i8(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The mean over the ranks of `mesh`'s `axis` of their `x` (this
    rank's rows), with an int8 wire format: max |x| over the ranks, the
    scale max(smax, 1e-30) / 127, q = clamp(round(x / scale), -127, 127)
    in int8, the int32 sum of q over the ranks, rescaled and divided by the
    ranks' number. Every rank gets the same rows back."""
    group = mesh.get_group(axis)
    smax = all_reduce(x.abs().max().to(torch.float32), "max", group)
    scale = torch.maximum(smax, f32(1e-30, x)) / f32(127.0, x)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    qsum = all_reduce(q.to(torch.int32), "sum", group)
    n = f32(mesh.size(mesh.mesh_dim_names.index(axis)), x)
    return qsum.to(torch.float32) * scale / n


def init_error_feedback(groups: list[Group]) -> dict:
    return {g.key: torch.zeros(g.shape, dtype=torch.float32, device=g.params[0].device)
            for g in groups}


__all__ = ["compress_grads", "init_error_feedback", "shard_map_allreduce_i8"]
