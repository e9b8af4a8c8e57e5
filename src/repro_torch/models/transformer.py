"""Backbone assembly: a stack of residual blocks, one Python loop over
layers.

Counterpart of `repro.models.transformer`. The reference groups the layer
kinds into `segment_kinds` segments and runs each as a `lax.scan` over
stacked params (with remat) to keep its XLA program small; the port keeps
one params dict and one cache per layer, in layer order, and loops
(`repro_torch.convert.from_reference_lm_params` unstacks the reference's
segments into that list).

Block kinds: the reference has attn | attn_cross | moe | mamba2 |
mamba2_shared | mlstm | slstm. The port runs `attn` (the dense and audio
families), `mamba2` / `mamba2_shared` (the hybrid family) and `mlstm` /
`slstm` (the xLSTM family); `moe`, `attn_cross` and MLA attention raise
`NotImplementedError` when a model is built (`check_supported`). Every
block is pre-norm residual.

zamba2's weight-shared attention + MLP block (`shared_block`) is built
whenever `cfg.shared_attn_period` is set, and applied only by the
`mamba2_shared` kind, which no config's `block_kinds()` names: the
reference builds and carries it but never applies it (ROADMAP Queue 3,
R7), and so does the port.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import apply_norm, gqa_attention, gqa_init, mlp, mlp_init, norm_init

Params = dict[str, Any]

#: block kinds the port runs.
SUPPORTED_KINDS = ("attn", "mamba2", "mamba2_shared", "mlstm", "slstm")


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


def check_supported(cfg) -> None:
    """Raise `NotImplementedError` for a config whose blocks the port does
    not run yet."""
    missing = sorted(set(cfg.block_kinds()) - set(SUPPORTED_KINDS))
    if missing or cfg.attention != "gqa":
        what = missing or [f"attention={cfg.attention!r}"]
        raise NotImplementedError(
            f"{cfg.name}: block kinds {what} are not ported yet (ROADMAP Queue 1 "
            f"item 1: MoE with MLA, then VLM); the port runs {SUPPORTED_KINDS} "
            f"blocks with GQA attention")


# ------------------------------------------------------------ block defs ----
def _block_init(gen: torch.Generator, kind: str, cfg) -> Params:
    d = cfg.d_model
    ln1 = norm_init(d, cfg.norm, device=gen.device)
    if kind == "attn":
        p: Params = {"ln1": ln1, "attn": gqa_init(gen, cfg),
                     "ln2": norm_init(d, cfg.norm, device=gen.device)}
        if cfg.d_ff:
            p["mlp"] = mlp_init(gen, cfg)
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

    if kind == "attn":
        hkv, hdd = cfg.num_kv_heads, cfg.resolved_head_dim
        return {"k": zeros(batch, s_max, hkv, hdd, dt=dtype),
                "v": zeros(batch, s_max, hkv, hdd, dt=dtype)}
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
                 shared_params: Params | None, decode: bool,
                 impl: str) -> tuple[torch.Tensor, Params | None]:
    """One residual block. Returns (x, new_cache); new_cache is None when
    cache is."""
    if kind == "attn":
        h = apply_norm(p["ln1"], x, cfg.norm)
        o, new_cache = gqa_attention(p["attn"], h, cfg, positions=positions,
                                     kv_cache=cache, cache_len=cache_len, impl=impl)
        x = x + o
        if cfg.d_ff:
            x = x + mlp(p["mlp"], apply_norm(p["ln2"], x, cfg.norm), cfg, impl=impl)
        return x, new_cache

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
        return x, new_cache

    if kind == "mlstm":
        h = apply_norm(p["ln1"], x, cfg.norm)
        o, new_state = xlstm_lib.mlstm_block_apply(p["mixer"], h, cfg, state=cache,
                                                   decode=decode, impl=impl)
        return x + o, new_state if cache is not None else None

    if kind == "slstm":
        h = apply_norm(p["ln1"], x, cfg.norm)
        o, new_state = xlstm_lib.slstm_apply(p["mixer"], h, cfg, state=cache, impl=impl)
        return x + o, new_state if cache is not None else None

    raise ValueError(kind)


# ------------------------------------------------------------- backbone -----
def backbone_init(gen: torch.Generator, cfg) -> Params:
    check_supported(cfg)
    params: Params = {"layers": [_block_init(gen, kind, cfg) for kind in cfg.block_kinds()],
                      "final_ln": norm_init(cfg.d_model, cfg.norm, device=gen.device)}
    shared = _shared_block_init(gen, cfg)
    if shared is not None:
        params["shared_block"] = shared
    return params


def init_caches(cfg, batch: int, s_max: int, dtype: torch.dtype,
                device: torch.device) -> list[Params]:
    """One cache per layer, in layer order: {"k", "v"} (B, s_max, Hkv, Dh)
    for `attn`; the recurrent states of the other kinds (float32)."""
    return [_init_cache_for_kind(kind, cfg, batch, s_max, dtype, device)
            for kind in cfg.block_kinds()]


def backbone_apply(params: Params, cfg, x: torch.Tensor, *, positions: torch.Tensor,
                   caches: list | None = None, cache_len: torch.Tensor | None = None,
                   decode: bool = False,
                   impl: str = "auto") -> tuple[torch.Tensor, list | None, torch.Tensor]:
    """x: (B, S, D) -> (y, new_caches, aux_loss_sum); the aux loss is the
    MoE family's and 0 here. `decode` selects the recurrent kinds' O(1)
    step (the `attn` blocks read the cache either way)."""
    shared = params.get("shared_block")
    new_caches: list | None = [] if caches is not None else None
    for i, (kind, layer) in enumerate(zip(cfg.block_kinds(), params["layers"])):
        x, nc = _apply_block(kind, layer, x, cfg, positions=positions,
                             cache=caches[i] if caches is not None else None,
                             cache_len=cache_len, shared_params=shared, decode=decode,
                             impl=impl)
        if new_caches is not None:
            new_caches.append(nc)
    x = apply_norm(params["final_ln"], x, cfg.norm)
    return x, new_caches, torch.zeros((), dtype=torch.float32, device=x.device)


__all__ = ["SUPPORTED_KINDS", "backbone_apply", "backbone_init", "check_supported",
           "init_caches", "segment_kinds"]
