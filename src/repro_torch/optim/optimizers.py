"""AdamW (full first and second moments) and Adafactor (factored second
moment, no first moment, for the 340B+ configs), over the reference's
stacked parameter groups.

Counterpart of `repro.optim.optimizers`, with its float32 order of
operations: the bias corrections `c1` / `c2` and Adafactor's `beta` are
0-d tensors on the device computed from `count`, the learning rate is a
0-d tensor (`repro_torch.optim.schedules`), and `jax.lax.rsqrt` is
`torch.rsqrt`.

The grouping. The reference stacks each `segment_kinds` segment's layers
on axis 0 (a leaf per pattern position, `reps` layers deep) and updates
the stacked leaves; the port keeps one params dict per layer.
`param_groups` lists the port's tensors by the reference's leaf: a
`Group` holds the tensors the reference stacks, its tree path as the key
("backbone/segments/0/0/attn/wq/w", as the reference's checkpoint names
it) and whether it is stacked. The optimizer state has the reference's
stacked shapes, keyed by that path. What that changes:
  * AdamW is element-wise, so each layer's tensors update against their
    rows of the stacked state, in place, with no copy;
  * Adafactor couples the stack: a stacked 1-D leaf (a norm vector,
    (reps, d)) is factored across the layers (`vr` (reps,), `vc` (d,)),
    and the update-clipping RMS is taken over the whole stack. So each
    stacked group is updated on `torch.stack` of its grads and params,
    then written back: a copy of the group's grads and params at a time,
    beside the update's temporaries of the same size.

`update(grads, state, groups, lr, splits=None)` changes the params (float32
leaves that require grad, written under `torch.no_grad`) and the state in
place and returns the state; `grads` is a list, per group, of the
per-layer grads.

On a mesh each rank updates its blocks (`runtime.train_lib`): the params,
grads and state leaves are this rank's blocks, and `splits` gives, a group
at a time, the mesh axes that split each dim of the stacked grad block and
of each state leaf at rest (`Split`). AdamW is element-wise and reads none
of it. Adafactor's reductions over the stack become global: the row and
column means are local sums all-reduced over the axes that split the
reduced dim, then divided by its whole size; the sum of `vr` is
all-reduced over the axes that split its last dim; the clip's mean of
step**2 is all-reduced over every axis that splits the leaf. Where a
statistic rests split over other axes than the grad block's dim (`vc`'s
specs follow the param's leading logical names), it moves between the
two layouts as a zero-padded whole vector all-reduced over the axes it
leaves (m + n floats a leaf, never the grad). Inside each element the
float32 order of operations is the unsplit one; only the cross-rank sums
are added in another order.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.collectives import all_reduce
from repro_torch.core.quant import f32
from repro_torch.core.tree import tree_paths
from repro_torch.models.transformer import segment_kinds


class Group(NamedTuple):
    key: str                       # the reference's tree path of the leaf
    params: list[torch.Tensor]     # the port's tensors, in stacking order
    stacked: bool                  # a segment leaf: stacked on axis 0

    @property
    def shape(self) -> tuple[int, ...]:
        """The reference's shape of the leaf."""
        one = tuple(self.params[0].shape)
        return (len(self.params), *one) if self.stacked else one


class Optimizer(NamedTuple):
    init: Callable[[list[Group]], dict]
    update: Callable[..., dict]     # (grads, state, groups, lr, splits) -> state, in place


#: per dim of a block, the mesh axes (`core.collectives.Axis`, mesh order,
#: the first major) that split it; () where the dim is whole
Dims = tuple[tuple, ...]


class Split(NamedTuple):
    """How a group's blocks lie on the mesh (module docstring): the dims
    of its stacked grad block (the params' blocks are the same), and of
    each of its state leaves at rest, by name."""
    grad: Dims
    state: dict[str, Dims]

    @property
    def axes(self) -> tuple:
        """Every axis that splits the grad block, in dim order."""
        return tuple(a for d in self.grad for a in d)


def _whole(ndim: int) -> Dims:
    return ((),) * ndim


def _index(axes) -> tuple[int, int]:
    """(this rank's block index, the blocks' number) over `axes`."""
    idx, n = 0, 1
    for a in axes:
        idx, n = idx * a.size + a.index, n * a.size
    return idx, n


def _relayout(x: torch.Tensor, src: Dims, dst: Dims, summed: tuple = ()) -> torch.Tensor:
    """`x`, a block split as `src`, as the block split as `dst`, summed
    over the axes `summed` (each rank's share of the sum): on each dim
    whose axes differ, zero-padded to the whole dim and all-reduced over
    the axes it leaves, then cut to `dst`'s block. `x` itself where
    nothing moves and nothing is summed."""
    moved = [d for d in range(x.ndim) if src[d] != dst[d]]
    if not moved and not summed:
        return x
    x = x.clone()
    for d in moved:
        idx, n = _index(src[d])
        whole = x.new_zeros((*x.shape[:d], x.shape[d] * n, *x.shape[d + 1:]))
        whole.narrow(d, idx * x.shape[d], x.shape[d]).copy_(x)
        x = whole
    for a in (*summed, *(a for d in moved for a in src[d])):
        all_reduce(x, "sum", a)
    for d in moved:
        idx, n = _index(dst[d])
        x = x.narrow(d, idx * (x.shape[d] // n), x.shape[d] // n)
    return x


def _mean_to(x: torch.Tensor, dim: int, dims: Dims, dst: Dims) -> torch.Tensor:
    """The mean of the whole leaf over `dim`, of which `x` is the block
    split as `dims`, as the block split as `dst`; `x.mean(dim)` where
    nothing is split."""
    red = dims[dim]
    kept = dims[:dim % x.ndim] + dims[dim % x.ndim + 1:]
    if not red:
        return _relayout(x.mean(dim), kept, dst)
    n = x.shape[dim] * _index(red)[1]
    return _relayout(x.sum(dim), kept, dst, red) / f32(n, x)


def _sum_last(x: torch.Tensor, dims: Dims) -> torch.Tensor:
    """The sum over the last dim of the whole leaf of which `x` is the
    block split as `dims`, keepdim."""
    s = x.sum(-1, keepdim=True)
    for a in dims[-1]:
        all_reduce(s, "sum", a)
    return s


def _mean_all(x: torch.Tensor, dims: Dims) -> torch.Tensor:
    """The mean of every element of the whole leaf of which `x` is the
    block split as `dims`."""
    axes = [a for d in dims for a in d]
    if not axes:
        return torch.mean(x)
    s = torch.sum(x)
    for a in axes:
        all_reduce(s, "sum", a)
    return s / f32(x.numel() * _index(axes)[1], x)


def param_groups(params: dict, cfg) -> list[Group]:
    """The port's LM params (one dict per layer) grouped as the reference
    stacks them (module docstring), in the reference's leaf order."""
    groups: list[Group] = []
    for top in sorted(params):
        if top != "backbone":
            groups += [Group(k, [t], False)
                       for k, t in tree_paths(params[top], top, sort_keys=True)]
            continue
        bb = params["backbone"]
        for name in sorted([k for k in bb if k != "layers"] + ["segments"]):
            if name != "segments":
                groups += [Group(k, [t], False) for k, t in
                           tree_paths(bb[name], f"backbone/{name}", sort_keys=True)]
                continue
            start = 0
            for si, (pattern, reps) in enumerate(segment_kinds(cfg.block_kinds())):
                for pi in range(len(pattern)):
                    walks = [tree_paths(bb["layers"][start + r * len(pattern) + pi], sort_keys=True)
                             for r in range(reps)]
                    for leaves in zip(*walks):
                        sub = leaves[0][0]
                        if any(path != sub for path, _ in leaves):
                            raise ValueError(f"segment {si} position {pi}: layers differ "
                                             f"in their leaves")
                        groups.append(Group(f"backbone/segments/{si}/{pi}/{sub}",
                                            [t for _, t in leaves], True))
                start += reps * len(pattern)
            if start != len(bb["layers"]):
                raise ValueError(f"{len(bb['layers'])} layers, the config gives {start}")
    return groups


def _zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def _count(groups: list[Group]) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=groups[0].params[0].device)


def adamw(*, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(groups: list[Group]) -> dict:
        return {"count": _count(groups),
                "state": {g.key: {"m": _zeros(g.shape, g.params[0]),
                                  "v": _zeros(g.shape, g.params[0])} for g in groups}}

    @torch.no_grad()
    def update(grads, state: dict, groups: list[Group], lr: torch.Tensor,
               splits: list[Split] | None = None) -> dict:
        count = state["count"].add_(1).to(torch.float32)
        c1 = 1.0 - f32(b1, count) ** count
        c2 = 1.0 - f32(b2, count) ** count
        for group, gs in zip(groups, grads):
            s = state["state"][group.key]
            for i, (p, g) in enumerate(zip(group.params, gs)):
                m_old, v_old = (s["m"][i], s["v"][i]) if group.stacked else (s["m"], s["v"])
                g = g.to(torch.float32)
                m = b1 * m_old + (1 - b1) * g
                v = b2 * v_old + (1 - b2) * g * g
                step = (m / c1) / (torch.sqrt(v / c2) + eps)
                p.copy_(p - lr * (step + weight_decay * p))
                m_old.copy_(m)
                v_old.copy_(v)
        return state

    return Optimizer(init, update)


def adafactor(*, eps: float = 1e-30, clip_threshold: float = 1.0,
              decay: float = 0.8, weight_decay: float = 0.0) -> Optimizer:
    """Factored second-moment Adafactor (momentum-free): the state of an
    (m, n) matrix is m + n floats instead of 2mn."""

    def init(groups: list[Group]) -> dict:
        def one(g: Group) -> dict:
            shape, like = g.shape, g.params[0]
            if len(shape) >= 2:
                return {"vr": _zeros(shape[:-1], like),
                        "vc": _zeros(shape[:-2] + shape[-1:], like)}
            return {"v": _zeros(shape, like)}
        return {"count": _count(groups), "state": {g.key: one(g) for g in groups}}

    @torch.no_grad()
    def update(grads, state: dict, groups: list[Group], lr: torch.Tensor,
               splits: list[Split] | None = None) -> dict:
        count = state["count"].add_(1).to(torch.float32)
        beta = 1.0 - count ** (-decay)
        for i, (group, gs) in enumerate(zip(groups, grads)):
            s = state["state"][group.key]
            if group.stacked:
                g, p = torch.stack([g.to(torch.float32) for g in gs]), torch.stack(group.params)
            else:
                g, p = gs[0].to(torch.float32), group.params[0]
            dims = splits[i].grad if splits else _whole(g.ndim)
            rest = splits[i].state if splits else {k: _whole(t.ndim) for k, t in s.items()}
            g2 = g * g + eps
            if p.ndim >= 2:
                rows, cols = dims[:-1], dims[:-2] + dims[-1:]
                vr = beta * s["vr"] + (1 - beta) * _mean_to(g2, -1, dims, rest["vr"])
                vc = beta * s["vc"] + (1 - beta) * _mean_to(g2, -2, dims, rest["vc"])
                s["vr"].copy_(vr)
                s["vc"].copy_(vc)
                vr, vc = _relayout(vr, rest["vr"], rows), _relayout(vc, rest["vc"], cols)
                denom = vr[..., None] * vc[..., None, :] / (
                    _sum_last(vr, rows)[..., None] + eps)
                step = g * torch.rsqrt(denom + eps)
            else:
                v = beta * _relayout(s["v"], rest["v"], dims) + (1 - beta) * g2
                step = g * torch.rsqrt(v + eps)
                s["v"].copy_(_relayout(v, dims, rest["v"]))
            # update clipping (RMS of step <= clip_threshold)
            rms = torch.sqrt(_mean_all(step * step, dims) + eps)
            step = step / torch.maximum(f32(1.0, rms), rms / f32(clip_threshold, rms))
            new_p = p - lr * (step + weight_decay * p)
            if group.stacked:
                for j, t in enumerate(group.params):
                    t.copy_(new_p[j])
            else:
                p.copy_(new_p)
        return state

    return Optimizer(init, update)


def get_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise ValueError(f"unknown optimizer {name!r}")


__all__ = ["Dims", "Group", "Optimizer", "Split", "adafactor", "adamw", "get_optimizer",
           "param_groups"]
