"""Backbone assembly: a stack of residual blocks, one Python loop over
layers.

Counterpart of `repro.models.transformer`. The reference groups the layer
kinds into `segment_kinds` segments and runs each as a `lax.scan` over
stacked params (with remat) to keep its XLA program small; the port keeps
one params dict and one cache per layer, in layer order, and loops
(`repro_torch.convert.from_reference_lm_params` unstacks the reference's
segments into that list).

Block kinds: the reference has attn | attn_cross | moe | mamba2 |
mamba2_shared | mlstm | slstm. The port runs `attn` (every block of the
dense and audio families); the others raise `NotImplementedError` when a
model is built (`check_supported`). Every block is pre-norm residual.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.layers import apply_norm, gqa_attention, gqa_init, mlp, mlp_init, norm_init

Params = dict[str, Any]

#: block kinds the port runs.
SUPPORTED_KINDS = ("attn",)


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
            f"item 10); the port runs {SUPPORTED_KINDS} blocks with GQA attention")


# ------------------------------------------------------------ block defs ----
def _block_init(gen: torch.Generator, cfg) -> Params:
    d = cfg.d_model
    p: Params = {"ln1": norm_init(d, cfg.norm, device=gen.device),
                 "attn": gqa_init(gen, cfg),
                 "ln2": norm_init(d, cfg.norm, device=gen.device)}
    if cfg.d_ff:
        p["mlp"] = mlp_init(gen, cfg)
    return p


def _apply_block(p: Params, x: torch.Tensor, cfg, *, positions: torch.Tensor,
                 cache: Params | None, cache_len: torch.Tensor | None,
                 impl: str) -> tuple[torch.Tensor, Params | None]:
    """One `attn` residual block. Returns (x, new_cache)."""
    h = apply_norm(p["ln1"], x, cfg.norm)
    o, new_cache = gqa_attention(p["attn"], h, cfg, positions=positions,
                                 kv_cache=cache, cache_len=cache_len, impl=impl)
    x = x + o
    if cfg.d_ff:
        x = x + mlp(p["mlp"], apply_norm(p["ln2"], x, cfg.norm), cfg, impl=impl)
    return x, new_cache


# ------------------------------------------------------------- backbone -----
def backbone_init(gen: torch.Generator, cfg) -> Params:
    check_supported(cfg)
    return {"layers": [_block_init(gen, cfg) for _ in range(cfg.num_layers)],
            "final_ln": norm_init(cfg.d_model, cfg.norm, device=gen.device)}


def init_caches(cfg, batch: int, s_max: int, dtype: torch.dtype,
                device: torch.device) -> list[Params]:
    """One {"k", "v"} (B, s_max, Hkv, Dh) cache per layer."""
    shape = (batch, s_max, cfg.num_kv_heads, cfg.resolved_head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.num_layers)]


def backbone_apply(params: Params, cfg, x: torch.Tensor, *, positions: torch.Tensor,
                   caches: list | None = None, cache_len: torch.Tensor | None = None,
                   impl: str = "auto") -> tuple[torch.Tensor, list | None, torch.Tensor]:
    """x: (B, S, D) -> (y, new_caches, aux_loss_sum); the aux loss is the
    MoE family's and 0 here."""
    new_caches: list | None = [] if caches is not None else None
    for i, layer in enumerate(params["layers"]):
        x, nc = _apply_block(layer, x, cfg, positions=positions,
                             cache=caches[i] if caches is not None else None,
                             cache_len=cache_len, impl=impl)
        if new_caches is not None:
            new_caches.append(nc)
    x = apply_norm(params["final_ln"], x, cfg.norm)
    return x, new_caches, torch.zeros((), dtype=torch.float32, device=x.device)


__all__ = ["SUPPORTED_KINDS", "backbone_apply", "backbone_init", "check_supported",
           "init_caches", "segment_kinds"]
