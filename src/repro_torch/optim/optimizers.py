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

`update(grads, state, groups, lr)` changes the params (float32 leaves that
require grad, written under `torch.no_grad`) and the state in place and
returns the state; `grads` is a list, per group, of the per-layer grads.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

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
    update: Callable[..., dict]     # (grads, state, groups, lr) -> state, in place


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
    def update(grads, state: dict, groups: list[Group], lr: torch.Tensor) -> dict:
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
    def update(grads, state: dict, groups: list[Group], lr: torch.Tensor) -> dict:
        count = state["count"].add_(1).to(torch.float32)
        beta = 1.0 - count ** (-decay)
        for group, gs in zip(groups, grads):
            s = state["state"][group.key]
            if group.stacked:
                g, p = torch.stack([g.to(torch.float32) for g in gs]), torch.stack(group.params)
            else:
                g, p = gs[0].to(torch.float32), group.params[0]
            g2 = g * g + eps
            if p.ndim >= 2:
                vr = beta * s["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(-2)
                denom = vr[..., None] * vc[..., None, :] / (
                    vr.sum(-1, keepdim=True)[..., None] + eps)
                step = g * torch.rsqrt(denom + eps)
                s["vr"].copy_(vr)
                s["vc"].copy_(vc)
            else:
                v = beta * s["v"] + (1 - beta) * g2
                step = g * torch.rsqrt(v + eps)
                s["v"].copy_(v)
            # update clipping (RMS of step <= clip_threshold)
            rms = torch.sqrt(torch.mean(step * step) + eps)
            step = step / torch.maximum(f32(1.0, rms), rms / f32(clip_threshold, rms))
            new_p = p - lr * (step + weight_decay * p)
            if group.stacked:
                for i, t in enumerate(group.params):
                    t.copy_(new_p[i])
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


__all__ = ["Group", "Optimizer", "adafactor", "adamw", "get_optimizer", "param_groups"]
