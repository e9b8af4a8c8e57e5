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
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.quant import f32
from repro_torch.optim import cosine_schedule, get_optimizer, param_groups
from repro_torch.optim.grad_compress import compress_grads, init_error_feedback


class TrainState(NamedTuple):
    step: torch.Tensor
    params: Any
    opt: Any
    ef: Any | None            # error-feedback residual (grad_compress only)


def make_train_state(model, gen: torch.Generator) -> TrainState:
    """Fresh params from `gen` (on the model's device), a zero optimizer
    state and, under `cfg.grad_compress`, a zero residual."""
    params = model.init(gen)
    groups = param_groups(params, model.cfg)
    for group in groups:
        for t in group.params:
            t.requires_grad_(True)
    opt = get_optimizer(model.cfg.optimizer).init(groups)
    ef = init_error_feedback(groups) if model.cfg.grad_compress else None
    return TrainState(torch.zeros((), dtype=torch.int32, device=model.device), params, opt, ef)


def grads_of(model, params, batch: dict, leaves: list[torch.Tensor]):
    """(loss, metrics, grads) of `model.loss_fn(params, batch)`, the loss
    and metrics detached: the grads of `leaves` by `torch.autograd.grad`,
    zeros for a leaf the loss does not reach (as `jax.grad` gives)."""
    loss, metrics = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(model, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000) -> Callable:
    cfg = model.cfg
    optimizer = get_optimizer(cfg.optimizer)
    lr_fn = cosine_schedule(peak_lr, warmup, total_steps)

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        groups = param_groups(state.params, cfg)
        leaves = [t for group in groups for t in group.params]
        k = cfg.microbatches
        if k > 1:
            n = len(next(iter(batch.values()))) // k
            acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in leaves]
            loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
            for j in range(k):
                loss, metrics, grads = grads_of(
                    model, state.params, {key: x[j * n:(j + 1) * n] for key, x in batch.items()},
                    leaves)
                acc = [a + g for a, g in zip(acc, grads)]
                loss_sum = loss_sum + loss
            kf = f32(k, loss_sum)
            flat = [a / kf for a in acc]
            loss = loss_sum / kf
        else:
            loss, metrics, flat = grads_of(model, state.params, batch, leaves)
        grads, i = [], 0
        for group in groups:
            grads.append(flat[i:i + len(group.params)])
            i += len(group.params)

        new_ef = state.ef
        if cfg.grad_compress:
            grads, new_ef = compress_grads(grads, state.ef, groups)

        lr = lr_fn(state.step)
        optimizer.update(grads, state.opt, groups, lr)
        gnorm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for gs in grads for g in gs))
        out_metrics = {"loss": loss, "lr": lr, "grad_norm": gnorm, **metrics}
        return TrainState(state.step + 1, state.params, state.opt, new_ef), out_metrics

    return train_step


__all__ = ["TrainState", "grads_of", "make_train_state", "make_train_step"]
