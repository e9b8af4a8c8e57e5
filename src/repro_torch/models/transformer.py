"""Backbone assembly: a stack of residual blocks, one Python loop over
layers.

Counterpart of `repro.models.transformer`. The reference groups the layer
kinds into `segment_kinds` segments and runs each as a `lax.scan` over
stacked params (with remat) to keep its XLA program small; the port keeps
one params dict and one cache per layer, in layer order, and loops
(`repro_torch.convert.from_reference_lm_params` unstacks the reference's
segments into that list).

Block kinds, all seven of the reference's: `attn` (self-attention, GQA or
MLA by `cfg.attention`, then the MLP), `moe` (the same attention, then the
MoE layer), `attn_cross` (self-attention, then cross-attention to the
image keys and values scaled by tanh(xgate), then the MLP), `mamba2` /
`mamba2_shared` (the hybrid family), `mlstm` / `slstm` (the xLSTM family).
Every block is pre-norm residual.

Remat: when `cfg.remat` and the forward builds a graph for training (grad
enabled, no caches), each application of a `segment_kinds` pattern (one
layer for a dense stack, the VLM's five, ...) runs under
`torch.utils.checkpoint.checkpoint(use_reentrant=False)`, as the
reference's `jax.checkpoint` wraps `pattern_step`: only the pattern's input
is kept and its forward runs again in the backward. `remat_policy="full"`
keeps nothing else; `"dots"` keeps the outputs of the matmuls with no batch
dimension (`aten.mm` / `aten.addmm`: the float linears, the reference's
`dots_with_no_batch_dims_saveable`) through
`create_selective_checkpoint_contexts` and recomputes the rest, the
batched attention products and the quantized matmuls' integer kernels
included. The recompute is the same arithmetic, so the gradients are
byte-equal with remat on and off. The serving path (caches, or no grad)
never checkpoints.

On a mesh (`runtime.sharding.activation_sharding_ctx`), each layer's
params are this rank's blocks at rest, and `run` gathers a layer's blocks
(`core.collectives.gather_params`) just before its forward: over the FSDP
axes ("data", and "pod" under `fsdp_pod`) and over "model", except the
blocks its tensor- or expert-parallel compute keeps (`layer_keep`). Under
remat the gather is inside the checkpointed span, so the recompute
gathers again, and each layer's gathered block is freed after its
forward; the serving path frees it after the layer too. Mamba2 splits
its heads over "model" (`models.ssm`; its `in_proj` columns and conv
channels by a selection of each z / x / B / C / dt segment). The xLSTM
blocks, which have no tensor-parallel rule, gather over every axis and
compute whole, one layer at a time.

zamba2's weight-shared attention + MLP block (`shared_block`) is built
whenever `cfg.shared_attn_period` is set, and applied only by the
`mamba2_shared` kind, which no config's `block_kinds()` names: the
reference builds and carries it but never applies it (ROADMAP Queue 3,
R7), and so does the port.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch.core.collectives import gather_params
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import (
    apply_norm,
    attn_keep,
    gqa_attention,
    gqa_init,
    kv_proj,
    mla_attention,
    mla_init,
    mla_keep,
    mlp,
    mlp_init,
    mlp_keep,
    norm_init,
)

Params = dict[str, Any]

#: the block kinds with self-attention and an attention cache
ATTN_KINDS = ("attn", "moe", "attn_cross")
#: the block kinds with a tensor-parallel rule over "model"
TP_KINDS = (*ATTN_KINDS, "mamba2")


def split_heads(kind: str, cfg) -> int:
    """The heads a layer of `kind` (in TP_KINDS) splits over "model": the
    query heads of an attention, the SSM heads of Mamba2."""
    return ssm_lib._dims(cfg)[1] if kind == "mamba2" else cfg.num_heads


def segment_kinds(kinds: list[str], max_pattern: int = 8) -> list[tuple[tuple[str, ...], int]]:
    """Compress a kind sequence into (pattern, repeats) segments: the
    reference's layer grouping, which its stacked params follow.

    Greedy: at each position pick the pattern length p <= max_pattern that
    consumes the most layers via repetition (ties -> smallest p).
    """
    segments: list[tuple[tuple[str, ...], int]] = []
    i = 0
    n = len(kinds)
    while i < n:
        best_p, best_consumed = 1, 1
        for p in range(1, min(max_pattern, n - i) + 1):
            pat = kinds[i : i + p]
            reps = 1
            while kinds[i + reps * p : i + (reps + 1) * p] == pat:
                reps += 1
            if reps * p > best_consumed:
                best_p, best_consumed = p, reps * p
        pat = tuple(kinds[i : i + best_p])
        segments.append((pat, best_consumed // best_p))
        i += best_consumed
    return segments


# ------------------------------------------------------------ block defs ----
def _block_init(gen: torch.Generator, kind: str, cfg) -> Params:
    d, dev = cfg.d_model, gen.device
    ln1 = norm_init(d, cfg.norm, device=dev)
    if kind in ATTN_KINDS:
        attn = mla_init(gen, cfg) if cfg.attention == "mla" else gqa_init(gen, cfg)
        p: Params = {"ln1": ln1, "attn": attn, "ln2": norm_init(d, cfg.norm, device=dev)}
        if kind == "moe":
            p["moe"] = moe_lib.moe_init(gen, cfg)
        elif cfg.d_ff:
            p["mlp"] = mlp_init(gen, cfg)
        if kind == "attn_cross":
            p["ln_x"] = norm_init(d, cfg.norm, device=dev)
            p["xattn"] = gqa_init(gen, cfg)
            # the reference's zero init: the gate closes the cross path
            p["xgate"] = torch.zeros((), dtype=torch.float32, device=dev)
        return p
    if kind in ("mamba2", "mamba2_shared"):
        return {"ln1": ln1, "mixer": ssm_lib.mamba2_init(gen, cfg)}
    if kind == "mlstm":
        return {"ln1": ln1, "mixer": xlstm_lib.mlstm_init(gen, cfg)}
    if kind == "slstm":
        return {"ln1": ln1, "mixer": xlstm_lib.slstm_init(gen, cfg)}
    raise ValueError(f"unknown block kind {kind!r}")


def _shared_block_init(gen: torch.Generator, cfg) -> Params | None:
    """zamba2's weight-tied attention + MLP block (the `mamba2_shared`
    kind applies it)."""
    if not cfg.shared_attn_period:
        return None
    d, dev = cfg.d_model, gen.device
    return {"ln1": norm_init(d, cfg.norm, device=dev), "attn": gqa_init(gen, cfg),
            "ln2": norm_init(d, cfg.norm, device=dev), "mlp": mlp_init(gen, cfg)}


def _init_cache_for_kind(kind: str, cfg, batch: int, s_max: int, dtype: torch.dtype,
                         device: torch.device) -> Params:
    """One layer's decode cache, with the reference's shapes and dtypes."""
    def zeros(*shape: int, dt: torch.dtype = torch.float32) -> torch.Tensor:
        return torch.zeros(shape, dtype=dt, device=device)

    if kind in ATTN_KINDS:
        hkv, hdd = cfg.num_kv_heads, cfg.resolved_head_dim
        if cfg.attention == "mla":
            cache = {"c_kv": zeros(batch, s_max, cfg.kv_lora_rank, dt=dtype),
                     "k_rope": zeros(batch, s_max, 1, cfg.qk_rope_dim, dt=dtype)}
        else:
            cache = {"k": zeros(batch, s_max, hkv, hdd, dt=dtype),
                     "v": zeros(batch, s_max, hkv, hdd, dt=dtype)}
        if kind == "attn_cross":
            cache["k_img"] = zeros(batch, cfg.image_tokens, hkv, hdd, dt=dtype)
            cache["v_img"] = zeros(batch, cfg.image_tokens, hkv, hdd, dt=dtype)
        return cache
    if kind in ("mamba2", "mamba2_shared"):
        d_inner, nheads, hd, n = ssm_lib._dims(cfg)
        cache: Params = {"ssm": zeros(batch, nheads, hd, n),
                         "conv": zeros(batch, cfg.ssm_conv_width - 1, d_inner + 2 * n)}
        if kind == "mamba2_shared":
            smax = min(cfg.sliding_window or s_max, s_max)
            hkv, hdd = cfg.num_kv_heads, cfg.resolved_head_dim
            cache["shared_kv"] = {"k": zeros(batch, smax, hkv, hdd, dt=dtype),
                                  "v": zeros(batch, smax, hkv, hdd, dt=dtype)}
        return cache
    if kind == "mlstm":
        d_up, h, dh = xlstm_lib._mlstm_dims(cfg)
        k = cfg.ssm_conv_width or 4
        return {"c": zeros(batch, h, dh, dh), "n": zeros(batch, h, dh),
                "m": zeros(batch, h), "conv": zeros(batch, k - 1, d_up)}
    if kind == "slstm":
        h, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
        return {"h": zeros(batch, h, dh), "c": zeros(batch, h, dh),
                "n": zeros(batch, h, dh) + 1.0, "m": zeros(batch, h, dh)}
    raise ValueError(f"unknown block kind {kind!r}")


def _apply_block(kind: str, p: Params, x: torch.Tensor, cfg, *, positions: torch.Tensor,
                 cache: Params | None, cache_len: torch.Tensor | None,
                 shared_params: Params | None, decode: bool, impl: str,
                 image_embeds: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, Params | None, torch.Tensor | None]:
    """One residual block. Returns (x, new_cache, aux); new_cache is None
    when cache is, aux the MoE layer's loss (None for the other kinds)."""
    if kind in ATTN_KINDS:
        h = apply_norm(p["ln1"], x, cfg.norm)
        if cfg.attention == "mla":
            kv = None if cache is None else {k: cache[k] for k in ("c_kv", "k_rope")}
            o, new_cache = mla_attention(p["attn"], h, cfg, positions=positions,
                                         kv_cache=kv, cache_len=cache_len, impl=impl)
        else:
            kv = None if cache is None else {k: cache[k] for k in ("k", "v")}
            o, new_cache = gqa_attention(p["attn"], h, cfg, positions=positions,
                                         kv_cache=kv, cache_len=cache_len, impl=impl)
        x = x + o
        if kind == "attn_cross":
            hx = apply_norm(p["ln_x"], x, cfg.norm)
            if decode and cache is not None:
                k_img, v_img = cache["k_img"], cache["v_img"]
            else:
                k_img, v_img = kv_proj(p["xattn"], image_embeds, cfg, impl=impl)
            ox, _ = gqa_attention(p["xattn"], hx, cfg, positions=positions,
                                  kv_override=(k_img, v_img), impl=impl)
            x = x + torch.tanh(p["xgate"]).to(x.dtype) * ox
            if new_cache is not None:
                new_cache.update(k_img=k_img, v_img=v_img)
        h2 = apply_norm(p["ln2"], x, cfg.norm)
        aux = None
        if kind == "moe":
            o2, aux = moe_lib.moe_block(p["moe"], h2, cfg, impl=impl)
            x = x + o2
        elif cfg.d_ff:
            x = x + mlp(p["mlp"], h2, cfg, impl=impl)
        return x, new_cache, aux

    if kind in ("mamba2", "mamba2_shared"):
        h = apply_norm(p["ln1"], x, cfg.norm)
        o, new_ssm, new_conv = ssm_lib.mamba2_mixer(
            p["mixer"], h, cfg, ssm_state=cache["ssm"] if cache is not None else None,
            conv_state=cache["conv"] if cache is not None else None, decode=decode,
            impl=impl)
        x = x + o
        new_cache = None
        if cache is not None:
            new_cache = {"ssm": new_ssm,
                         "conv": new_conv if new_conv is not None else cache["conv"]}
        if kind == "mamba2_shared":
            sp = shared_params
            hh = apply_norm(sp["ln1"], x, cfg.norm)
            kv = cache["shared_kv"] if cache is not None else None
            o, new_kv = gqa_attention(sp["attn"], hh, cfg, positions=positions,
                                      kv_cache=kv, cache_len=cache_len, impl=impl)
            x = x + o
            x = x + mlp(sp["mlp"], apply_norm(sp["ln2"], x, cfg.norm), cfg, impl=impl)
            if new_cache is not None:
                new_cache["shared_kv"] = new_kv
        return x, new_cache, None

    if kind == "mlstm":
        h = apply_norm(p["ln1"], x, cfg.norm)
        o, new_state = xlstm_lib.mlstm_block_apply(p["mixer"], h, cfg, state=cache,
                                                   decode=decode, impl=impl)
        return x + o, new_state if cache is not None else None, None

    if kind == "slstm":
        h = apply_norm(p["ln1"], x, cfg.norm)
        o, new_state = xlstm_lib.slstm_apply(p["mixer"], h, cfg, state=cache, impl=impl)
        return x + o, new_state if cache is not None else None, None

    raise ValueError(kind)


def layer_keep(kind: str, cfg) -> dict:
    """{param path in the layer: what its layer keeps of it over "model"}
    of a layer of `kind` (or of "shared_block"): its tensor- and
    expert-parallel weights (`layers`, `moe`, `ssm`), each by the dim it
    keeps split or, for Mamba2's packed projections, a selection
    (`core.collectives.fsdp_gather`); every other leaf is gathered
    whole."""
    if kind in ATTN_KINDS:
        keep = mla_keep(cfg, "attn") if cfg.attention == "mla" else attn_keep(cfg, "attn")
        if kind == "moe":
            keep.update(moe_lib.moe_keep(cfg, "moe"))
        elif cfg.d_ff:
            keep.update(mlp_keep(cfg.d_ff, "mlp"))
        if kind == "attn_cross":
            keep.update(attn_keep(cfg, "xattn"))
        return keep
    if kind == "shared_block":          # zamba2's shared attention + MLP
        return {**attn_keep(cfg, "attn"), **mlp_keep(cfg.d_ff, "mlp")}
    if kind in ("mamba2", "mamba2_shared"):
        return ssm_lib.mamba2_keep(cfg, "mixer")
    return {}


def tp_report(cfg) -> dict[str, str]:
    """How each layer kind of `cfg` computes on the current mesh: "split"
    where all its heads / experts / MLP split over "model", "gathered"
    where nothing does (the divisibility fallback, or a kind with no rule),
    else "split (...)" naming the parts that are gathered. For the dry-run
    record."""
    from repro_torch.core.collectives import model_axis, model_split
    if model_axis() is None:
        return {}
    out = {}
    for kind in dict.fromkeys(cfg.block_kinds()):
        parts = {}
        if kind in ATTN_KINDS:
            parts["attn"] = model_split(cfg.num_heads) is not None
            if cfg.attention != "mla" and parts["attn"]:
                parts["kv"] = cfg.num_kv_heads % model_axis().size == 0
            if kind == "moe":
                parts["experts"] = model_split(cfg.num_experts) is not None
            elif cfg.d_ff:
                parts["mlp"] = model_split(cfg.d_ff) is not None
        elif kind == "mamba2":
            parts["heads"] = model_split(split_heads(kind, cfg)) is not None
        if not parts or not any(parts.values()):
            out[kind] = "gathered"
        elif all(parts.values()):
            out[kind] = "split"
        else:
            out[kind] = "split (gathered: " + ", ".join(k for k, v in parts.items() if not v) + ")"
    return out


# ------------------------------------------------------------- backbone -----
def backbone_init(gen: torch.Generator, cfg) -> Params:
    params: Params = {"layers": [_block_init(gen, kind, cfg) for kind in cfg.block_kinds()],
                      "final_ln": norm_init(cfg.d_model, cfg.norm, device=gen.device)}
    shared = _shared_block_init(gen, cfg)
    if shared is not None:
        params["shared_block"] = shared
    return params


def init_caches(cfg, batch: int, s_max: int, dtype: torch.dtype,
                device: torch.device) -> list[Params]:
    """One cache per layer, in layer order: {"k", "v"} (B, s_max, Hkv, Dh)
    for the attention kinds under GQA, {"c_kv" (B, s_max, r), "k_rope" (B,
    s_max, 1, dr)} under MLA, `attn_cross` adding {"k_img", "v_img"} (B,
    image_tokens, Hkv, Dh); the recurrent states of the other kinds
    (float32)."""
    return [_init_cache_for_kind(kind, cfg, batch, s_max, dtype, device)
            for kind in cfg.block_kinds()]


#: the ops whose outputs `remat_policy="dots"` keeps: matmuls without a
#: batch dimension
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def pattern_runs(cfg) -> list[tuple[int, int]]:
    """(first layer, layers) of each pattern application of the
    `segment_kinds` segments: the spans remat checkpoints."""
    runs, start = [], 0
    for pattern, reps in segment_kinds(cfg.block_kinds()):
        for _ in range(reps):
            runs.append((start, len(pattern)))
            start += len(pattern)
    return runs


def backbone_apply(params: Params, cfg, x: torch.Tensor, *, positions: torch.Tensor,
                   caches: list | None = None, cache_len: torch.Tensor | None = None,
                   image_embeds: torch.Tensor | None = None, decode: bool = False,
                   impl: str = "auto") -> tuple[torch.Tensor, list | None, torch.Tensor]:
    """x: (B, S, D) -> (y, new_caches, aux_loss_sum): the MoE layers' aux
    losses summed (float32, 0 without MoE layers). `image_embeds` (B, T,
    D), projected, feed the `attn_cross` layers' keys and values, except at
    decode, which reads them from the caches. `decode` selects the
    recurrent kinds' O(1) step (the attention kinds read their caches
    either way)."""
    shared = params.get("shared_block")
    kinds = cfg.block_kinds()
    new_caches: list | None = [] if caches is not None else None
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(start: int, n: int, x: torch.Tensor, aux_total: torch.Tensor):
        for i in range(start, start + n):
            p = gather_params(params["layers"][i], layer_keep(kinds[i], cfg))
            sp = (gather_params(shared, layer_keep("shared_block", cfg))
                  if kinds[i] == "mamba2_shared" else None)
            x, nc, aux = _apply_block(kinds[i], p, x, cfg,
                                      positions=positions,
                                      cache=caches[i] if caches is not None else None,
                                      cache_len=cache_len, shared_params=sp,
                                      image_embeds=image_embeds, decode=decode, impl=impl)
            if aux is not None:
                aux_total = aux_total + aux
            if new_caches is not None:
                new_caches.append(nc)
        return x, aux_total

    if cfg.remat and caches is None and torch.is_grad_enabled():
        context = (functools.partial(create_selective_checkpoint_contexts, _dots_policy)
                   if cfg.remat_policy == "dots" else noop_context_fn)
        for start, n in pattern_runs(cfg):
            # the forward draws no random numbers: no RNG state to replay
            x, aux_total = checkpoint(run, start, n, x, aux_total, use_reentrant=False,
                                      preserve_rng_state=False, context_fn=context)
    else:
        x, aux_total = run(0, len(kinds), x, aux_total)
    x = apply_norm(gather_params(params["final_ln"]), x, cfg.norm)
    return x, new_caches, aux_total


__all__ = ["ATTN_KINDS", "TP_KINDS", "backbone_apply", "backbone_init", "init_caches",
           "layer_keep", "pattern_runs", "segment_kinds", "split_heads", "tp_report"]
