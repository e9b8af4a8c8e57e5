"""Train-step factory: loss and grads with microbatch accumulation, the
optional int8 error-feedback gradient compression, the optimizer update.

Counterpart of `repro.runtime.train_lib`. `TrainState` holds the step (a
0-d int32 tensor), the params (float32 leaves that require grad, one dict
per layer), the optimizer state and the error-feedback residual (None
without `cfg.grad_compress`), the last two in the reference's stacked
shapes keyed by its tree paths (`repro_torch.optim.optimizers`).

`train_step(state, batch)` updates the params and the optimizer state in
place and returns (the next `TrainState`, the metrics as 0-d tensors on the
device): it reads nothing back to the host. The grads come from
`torch.autograd.grad` over the leaves; a leaf the loss does not reach
(zamba2's unapplied `shared_block`, R7) gets None there and counts as
zeros, as `jax.grad` gives, so weight decay still moves it. With
`cfg.microbatches` = k > 1 the batch's rows split into k consecutive
microbatches, and the reference's order is kept: zeros, then + each
microbatch's grads, then / k; the losses summed, then / k; the last
microbatch's metrics.

With a `mesh` (a named `DeviceMesh` over the process group's ranks,
`repro_torch.launch.mesh.make_host_mesh`) the state at rest is sharded by
the reference's rules (`runtime.elastic.state_shardings`: params,
optimizer state and residual are DTensors holding this rank's block; the
step and the optimizer's count stay whole), and the step computes on the
reference's shards (`runtime.sharding.activation_sharding_ctx`):
  * the rows split over the rules' batch axes ("data", or ("pod",
    "data"), and "model" too where not every layer splits its heads over
    it: qwen2-0.5b's 14 heads on 16; an axis a microbatch's rows do not
    divide drops out), and the ranks along the other axes share their rows
    (`sharding.batch_axes`, `rank_rows`). Every reduction that spans rows
    stays global over them, as in the reference's GSPMD step: the
    quantizer's abs-max of each activation (`core.quant`), the loss's
    counts (`Model.loss_fn`), the MoE chunks (a rank's tokens must be
    whole chunks of the global stream, or ValueError);
  * the params stay sharded: each layer gathers its FSDP blocks just
    before its forward (`models.transformer`) and computes on its "model"
    shard where the rules split it in whole heads, experts or vocab
    columns (`models.layers`, `models.moe`, `models.model`);
  * each param's grad comes out of its gather's backward as this rank's
    block of the global grad: reduce-scattered over the FSDP axes and
    all-reduced over the row axes the param rests whole on. No grad is
    all-reduced whole.
The update runs on each rank's blocks, and no grad, param or optimizer
statistic is gathered whole for it: AdamW is element-wise; grad_compress
takes each leaf's abs-max over the axes that split it and keeps its
residual as a block (`optim.grad_compress`); Adafactor reduces its factored
statistics and its clip over the axes that split each leaf (`optim.
optimizers.Split`, built here from the blocks' layouts). The grad norm sums
each block's squares over the axes that shard it. The metrics are global.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import collectives as coll
from repro_torch.core.collectives import all_reduce_rows
from repro_torch.core.quant import f32
from repro_torch.core.tree import tree_map_with_path
from repro_torch.optim import cosine_schedule, get_optimizer, param_groups
from repro_torch.optim.grad_compress import compress_grads, init_error_feedback
from repro_torch.optim.optimizers import Group, Split
from repro_torch.runtime import sharding as shd


class TrainState(NamedTuple):
    step: torch.Tensor
    params: Any
    opt: Any
    ef: Any | None            # error-feedback residual (grad_compress only)


def make_train_state(model, gen: torch.Generator, mesh=None) -> TrainState:
    """Fresh params from `gen` (on the model's device), a zero optimizer
    state and, under `cfg.grad_compress`, a zero residual. With a `mesh`
    every rank draws the same state from the same seed and keeps its
    blocks (`shard_state`)."""
    if mesh is not None:
        return shard_state(make_train_state(model, gen), model.cfg, mesh)
    params = model.init(gen)
    groups = param_groups(params, model.cfg)
    for group in groups:
        for t in group.params:
            t.requires_grad_(True)
    opt = get_optimizer(model.cfg.optimizer).init(groups)
    ef = init_error_feedback(groups) if model.cfg.grad_compress else None
    return TrainState(torch.zeros((), dtype=torch.int32, device=model.device), params, opt, ef)


def multi_pod(mesh) -> bool:
    return "pod" in mesh.mesh_dim_names


def shard_state(state: TrainState, cfg, mesh) -> TrainState:
    """A whole `TrainState` (the same on every rank) as this rank's blocks
    on `mesh`, by `state_shardings`."""
    from repro_torch.runtime.elastic import state_shardings
    return shd.distribute_tree(state, state_shardings(state, cfg, mesh,
                                                      multi_pod=multi_pod(mesh)))


def grads_of(model, params, batch: dict, leaves: list[torch.Tensor]):
    """(loss, metrics, grads) of `model.loss_fn(params, batch)`, the loss
    and metrics detached: the grads of `leaves` by `torch.autograd.grad`,
    zeros for a leaf the loss does not reach (as `jax.grad` gives)."""
    loss, metrics = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, mesh=None) -> Callable:
    """The step of the module docstring; one body for both: with a `mesh`
    it gathers the params, takes this rank's rows, sums the losses, the
    metrics and the grads over the ranks, and writes its blocks back."""
    cfg = model.cfg
    optimizer = get_optimizer(cfg.optimizer)
    lr_fn = cosine_schedule(peak_lr, warmup, total_steps)
    if mesh is not None:
        import torch.distributed as dist
        if mesh.size() != dist.get_world_size():
            raise ValueError(f"the mesh holds {mesh.size()} of the world's "
                             f"{dist.get_world_size()} ranks")

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        k = cfg.microbatches
        rows = len(next(iter(batch.values())))
        if mesh is None:
            n = rows // k
            per, first, params, ctx = n, 0, state.params, contextlib.nullcontext()
        else:
            axes = shd.batch_axes(cfg, mesh, rows // k, multi_pod=multi_pod(mesh))
            groups_n, index = rank_rows(mesh, axes)
            n, per = row_split(cfg, batch, groups_n)
            first = index * per
            params, layouts = shd.local_blocks(state.params, mesh, grad=True)
            ctx = shd.activation_sharding_ctx(mesh, cfg, multi_pod=multi_pod(mesh), rows=axes,
                                              layouts=layouts)
        groups = param_groups(params, cfg)
        leaves = [t for group in groups for t in group.params]
        acc = loss_sum = None
        if k > 1:                       # the reference's order: zeros, + each microbatch
            acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in leaves]
            loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        with ctx:
            for j in range(k):
                lo = j * n + first
                loss, metrics, grads = grads_of(
                    model, params, {key: x[lo:lo + per] for key, x in batch.items()}, leaves)
                acc = grads if acc is None else [a + g for a, g in zip(acc, grads)]
                loss_sum = loss if loss_sum is None else loss_sum + loss
            if mesh is not None:        # each row block's shares -> the global sums
                names = sorted(metrics)
                sums = all_reduce_rows(torch.stack([loss_sum, *(metrics[m] for m in names)])
                                       .to(torch.float32))
                loss_sum, metrics = sums[0], {m: sums[1 + i] for i, m in enumerate(names)}
        loss = loss_sum
        if k > 1:
            kf = f32(k, loss_sum)
            acc = [a / kf for a in acc]
            loss = loss_sum / kf
        grads, i = [], 0
        for group in groups:
            grads.append(acc[i:i + len(group.params)])
            i += len(group.params)
        at_rest = groups if mesh is None else param_groups(state.params, cfg)
        splits = None if mesh is None else _splits(at_rest, state.opt["state"], mesh)

        new_ef = state.ef
        if cfg.grad_compress:
            ef = _local(state.ef)
            grads, new = compress_grads(grads, ef, groups,
                                        None if splits is None else [s.axes for s in splits])
            if mesh is None:
                new_ef = new
            else:                       # this rank's blocks, kept where they rest
                with torch.no_grad():
                    for key, t in ef.items():
                        t.copy_(new[key])

        lr = lr_fn(state.step)
        optimizer.update(grads, {"count": state.opt["count"], "state": _local(state.opt["state"])},
                         [Group(g.key, _local(g.params), g.stacked) for g in at_rest], lr, splits)
        if mesh is None:
            gnorm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                                   for gs in grads for g in gs))
        else:
            gnorm = _block_norm(grads, at_rest, mesh)
        out_metrics = {"loss": loss, "lr": lr, "grad_norm": gnorm, **metrics}
        return TrainState(state.step + 1, state.params, state.opt, new_ef), out_metrics

    return train_step


def row_split(cfg, batch: dict, world: int) -> tuple[int, int]:
    """(rows of a global microbatch, rows of it a rank) for `batch` over
    `world` ranks; ValueError where the rows, or the MoE layers' chunks,
    do not split evenly (module docstring)."""
    x = next(iter(batch.values()))
    rows, k = len(x), cfg.microbatches
    if rows % k or (rows // k) % world:
        raise ValueError(f"a batch of {rows} rows in {k} microbatches does not split "
                         f"over {world} ranks")
    n = rows // k
    per = n // world
    if "moe" in cfg.block_kinds():
        seq = x.shape[1]
        chunk = min(cfg.moe_seq_chunk, n * seq)
        if min(cfg.moe_seq_chunk, per * seq) != chunk or (per * seq) % chunk:
            raise ValueError(
                f"MoE chunks: a rank's {per} rows x {seq} tokens are not whole "
                f"chunks of the global microbatch's {chunk}-token chunks "
                f"(moe_seq_chunk {cfg.moe_seq_chunk}, {n} rows over {world} ranks)")
    return n, per


def rank_rows(mesh, axes) -> tuple[int, int]:
    """(row groups, this rank's group) when a batch's rows split over the
    mesh axes `axes`, the first major: `row_split`'s `world` and the index
    of this rank's block. The ranks along the other axes share a group and
    compute the same rows; over every axis of the mesh the groups are the
    ranks."""
    names, coord = list(mesh.mesh_dim_names), mesh.get_coordinate()
    groups, index = 1, 0
    for ax in axes:
        size = mesh.size(names.index(ax))
        groups, index = groups * size, index * size + coord[names.index(ax)]
    return groups, index


def _splits(at_rest, opt_state: dict, mesh) -> list[Split]:
    """Each group's `Split`: the axes that split each dim of its stacked
    grad block (the at-rest param's, behind the unsplit layers dim) and of
    each of its state leaves at rest."""
    axes = coll.mesh_axes(mesh)

    def dims(t) -> tuple[tuple, ...]:
        per: list[tuple] = [() for _ in range(t.ndim)]
        for a, d in shd.layout_of(t, axes):
            if a.size > 1:
                per[d] += (a,)
        return tuple(per)

    out = []
    for g in at_rest:
        grad = dims(g.params[0])
        out.append(Split(((),) + grad if g.stacked else grad,
                         {k: dims(t) for k, t in opt_state[g.key].items()}))
    return out


def _block_norm(grads, at_rest, mesh) -> torch.Tensor:
    """The global norm of the grads from each rank's blocks: the sum of
    squares of the blocks of the leaves sharded over the same axes, summed
    over those axes (a leaf whole on an axis counted once)."""
    axes = coll.mesh_axes(mesh)
    sums: dict = {}
    for gs, group in zip(grads, at_rest):
        for g, t in zip(gs, group.params):
            names = tuple(a.name for a, _ in shd.layout_of(t, axes) if a.size > 1)
            sq = torch.sum(g.to(torch.float32) ** 2)
            sums[names] = sq if names not in sums else sums[names] + sq
    total = None
    for names, sq in sums.items():
        for name in dict.fromkeys(names):
            coll.all_reduce(sq, "sum", axes[name])
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _local(tree):
    """This rank's blocks of a tree of state leaves: a DTensor's local
    tensor, a plain leaf whole."""
    return tree_map_with_path(lambda _, t: t.to_local() if shd.is_sharded(t) else t, tree)


__all__ = ["TrainState", "grads_of", "make_train_state", "make_train_step", "rank_rows",
           "row_split", "shard_state"]
