"""Mixture-of-Experts layer: top-k router, shared + routed experts, chunked
GShard-style capacity dispatch (the deepseek-v3 / kimi-k2 family).

Counterpart of `repro.models.moe`. The token stream is cut into
`moe_seq_chunk`-token chunks (the last one zero-padded); each chunk routes
its tokens (softmax of a float32 router matmul, top-k, gates renormalized
over the k picks), places them in per-expert slots up to the capacity
`max(1, int(chunk * k * capacity_factor / E))` and drops the rest, runs
the routed experts (SwiGLU) on the slots and combines their outputs with
the gates. The shared experts run densely on every token through `mlp`,
and so through `dense` and the multiplier kernels; the router and the
routed experts are float matmuls in the reference, and here too.

Two places where the port must take care to give the reference's bytes:
  * top-k order. `jax.lax.top_k` puts the lower expert index first among
    equal gates, and ties are exact, not rare: a padding row's gates are
    all 1/E. The port sorts stably (`torch.sort(descending=True,
    stable=True)`), which gives the same order.
  * memory. The reference casts all E experts to the model dtype on each
    call. The port casts and runs `EXPERT_GROUP` experts at a time: each
    expert's einsums are the full einsum's, so the bytes are the same.

Expert parallelism. Inside a meshed step whose "model" axis divides E
(`core.collectives.model_split`), each rank holds its E / model experts
(`moe_keep`: wi / wg / wo by their expert dim) and runs them on their
slots: the tokens, the router, the capacity and the dispatch stay global
and replicated over "model"; each rank dispatches the tokens to its
experts' slots, combines their outputs with their gates into a partial
sum of every token, and the partial sums are all-reduced over "model"
(`reduce_from_model`, the tokens' bytes a layer). The float32 sums of the
combine then round in another order than the unsplit einsum's: the step
is the unsplit one within float tolerance, not to the byte. In the
backward, the tokens' cotangents are summed over "model" and the gates'
all-gathered, so the replicated router sees the whole layer's. The shared
experts are a tensor-parallel MLP (`layers.mlp`).
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import (
    copy_to_model,
    model_split,
    reduce_from_model,
    split_to_model,
)
from repro_torch.models.layers import _randn, dense_init, mlp, mlp_init, mlp_keep

Params = dict[str, Any]

#: routed experts cast and run at once: 32 of deepseek-v3's 256 take 2.8
#: GB in bf16, where all of them would take 22.5 GB beside 45 GB of
#: float32 master weights
EXPERT_GROUP = 32


def moe_init(gen: torch.Generator, cfg) -> Params:
    d, ff, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    scale = 1.0 / math.sqrt(d)
    p: Params = {
        "router": dense_init(gen, d, e, scale=0.02),
        # in place: one expert stack is 15 GB at deepseek-v3's width
        "wi": _randn(gen, (e, d, ff)).mul_(scale),
        "wg": _randn(gen, (e, d, ff)).mul_(scale),
        "wo": _randn(gen, (e, ff, d)).mul_(scale),
    }
    if cfg.num_shared_experts:
        p["shared"] = mlp_init(gen, cfg, d_ff=cfg.moe_d_ff * cfg.num_shared_experts)
    return p


def _dispatch_gates(gates: torch.Tensor, top_k: int,
                    capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """GShard top-k dispatch within one chunk. gates: (T, E) float32 router
    probabilities -> (dispatch (T, E, C) 0/1 float32, picked (T, E)
    float32): the k-th pick of every token takes the next free slot of its
    expert (the picks before it, of all tokens, placed first), a pick past
    the capacity C is dropped, and the gates are renormalized over the k
    picks; `picked` holds a token's renormalized gate at each expert it
    picked, so the combine weights are `dispatch * picked[..., None]`."""
    t, e = gates.shape
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :top_k], topi[:, :top_k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    dispatch = torch.zeros((t, e, capacity), dtype=torch.float32, device=gates.device)
    picked = torch.zeros((t, e), dtype=torch.float32, device=gates.device)
    counts = torch.zeros((e,), dtype=torch.int32, device=gates.device)   # slots taken
    for k in range(top_k):
        onehot = F.one_hot(topi[:, k], e).to(torch.int32)                 # (T, E)
        pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1 + counts[None, :]
        counts = counts + onehot.sum(0, dtype=torch.int32)
        pos_tok = pos.gather(1, topi[:, k:k + 1])[:, 0]                    # (T,)
        slot = torch.where(pos_tok < capacity, pos_tok, capacity).long()
        pos_oh = F.one_hot(slot, capacity + 1)[:, :capacity].to(torch.float32)  # drop: zeros
        dispatch = dispatch + onehot.to(torch.float32)[:, :, None] * pos_oh[:, None, :]
        picked = picked + onehot.to(torch.float32) * topv[:, k][:, None]
    return dispatch, picked


def _dispatch_combine(gates: torch.Tensor, top_k: int,
                      capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's pair: (dispatch, combine (T, E, C) float32), the
    combine weights of `_dispatch_gates`."""
    dispatch, picked = _dispatch_gates(gates, top_k, capacity)
    return dispatch, dispatch * picked[:, :, None]


def _experts_partial(p: Params, tok: torch.Tensor, dispatch: torch.Tensor,
                     combine: torch.Tensor) -> torch.Tensor:
    """The experts of `p` on the tokens `tok` (T, D) dispatched to their
    slots (`dispatch`, `combine`: (T, E', C), these experts' columns) ->
    (T, D), their outputs summed into each token with its gates."""
    xe = torch.einsum("tec,td->ecd", dispatch.to(tok.dtype), tok)     # (E', C, D)
    return torch.einsum("tec,ecd->td", combine.to(tok.dtype), _routed_experts(p, xe))


def _routed_experts(p: Params, xe: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts on their slots: xe (E, C, D) -> (E, C, D), in
    xe's dtype, EXPERT_GROUP experts at a time."""
    ye = torch.empty_like(xe)
    for lo in range(0, xe.shape[0], EXPERT_GROUP):
        hi = lo + EXPERT_GROUP
        x = xe[lo:hi]
        h = torch.einsum("ecd,edf->ecf", x, p["wi"][lo:hi].to(xe.dtype))
        g = torch.einsum("ecd,edf->ecf", x, p["wg"][lo:hi].to(xe.dtype))
        ye[lo:hi] = torch.einsum("ecf,efd->ecd", F.silu(g) * h, p["wo"][lo:hi].to(xe.dtype))
    return ye


def shared_d_ff(cfg) -> int:
    return cfg.moe_d_ff * cfg.num_shared_experts


def moe_keep(cfg, prefix: str) -> dict[str, int]:
    """{param path: dim kept split over "model"} of a MoE layer: the
    routed experts by their expert dim where E divides, the shared experts
    as an MLP (`layers.mlp_keep`)."""
    keep = mlp_keep(shared_d_ff(cfg), f"{prefix}/shared") if cfg.num_shared_experts else {}
    if model_split(cfg.num_experts) is not None:
        keep.update({f"{prefix}/{n}": 0 for n in ("wi", "wg", "wo")})
    return keep


def moe_block(p: Params, x: torch.Tensor, cfg, *,
              impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux loss: a float32 scalar, the
    GShard load-balancing term E * sum(mean gate x mean dispatched
    fraction), meaned over the chunks, padding rows included)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    chunk = min(cfg.moe_seq_chunk, b * s)
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    tokens = F.pad(tokens, (0, 0, 0, (-t) % chunk))
    capacity = max(1, int(chunk * k * cfg.capacity_factor / e))
    m = model_split(e)
    lo, n = (m.index * (e // m.size), e // m.size) if m else (0, e)     # this rank's experts

    outs, auxs = [], []
    for tok, tok_m in zip(tokens.split(chunk), copy_to_model(tokens, m).split(chunk)):
        logits = tok.to(torch.float32) @ p["router"]["w"]                # (c, E)
        gates = torch.softmax(logits, dim=-1)
        dispatch, picked = _dispatch_gates(gates, k, capacity)
        mine = dispatch[:, lo:lo + n]
        combine = mine * split_to_model(picked, m, 1)[:, :, None]
        outs.append(_experts_partial(p, tok_m, mine, combine))
        auxs.append((gates.mean(0) * dispatch.sum(2).mean(0)).sum() * e)
    out = reduce_from_model(torch.cat(outs), m)[:t].reshape(b, s, d)
    if "shared" in p:
        out = out + mlp(p["shared"], x, cfg, impl=impl, d_ff=shared_d_ff(cfg))
    return out, torch.stack(auxs).mean()


__all__ = ["EXPERT_GROUP", "moe_block", "moe_init", "moe_keep", "shared_d_ff"]
