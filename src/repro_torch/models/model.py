"""Public model API: build_model(cfg, device) -> Model with init / forward /
init_cache / prefill / decode_step / count_params.

Counterpart of `repro.models.model`, for the block kinds the port runs
(`transformer.SUPPORTED_KINDS`); any other config raises
`NotImplementedError` here, at `build_model`.

Input contract per cfg.input_kind:
  tokens   batch = {"tokens" (B, S) int}
  frames   batch = {"frames" (B, S, frame_dim) float} (audio: precomputed
           frame embeddings; encoder-only, no decode)

The model runs on `device` (the CUDA card for None) in the config's dtype.
Its quantized linears take `impl` ('auto': the Hopper kernels on the card,
the reference's semantics on the CPU; 'reference' keeps the reference's
semantics on any device, which on the card runs each kernel's plain
version for the limb family and the float32-summing LNS route).
The loss waits for the training slice (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.platform import resolve_device
from repro_torch.models.layers import dense, dense_init
from repro_torch.models.transformer import (
    backbone_apply,
    backbone_init,
    check_supported,
    init_caches,
)

Params = dict[str, Any]


class Model(NamedTuple):
    cfg: Any
    device: torch.device
    init: Callable[..., Params]                # (generator) -> params
    forward: Callable[..., tuple]              # (params, batch) -> (logits, aux)
    init_cache: Callable[..., list]            # (batch_size, s_max) -> caches
    prefill: Callable[..., tuple]              # -> (logits, caches, cache_len)
    decode_step: Callable[..., tuple]          # -> (logits, caches, cache_len)
    count_params: Callable[[Params], int]


def _embed_init(gen: torch.Generator, cfg) -> Params:
    p: Params = {}
    if cfg.input_kind == "frames":
        p["frame_proj"] = dense_init(gen, cfg.frame_dim, cfg.d_model)
    else:
        p["emb"] = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                               dtype=torch.float32, device=gen.device) * 0.02
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                               scale=1.0 / cfg.d_model**0.5)
    return p


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for item in items for leaf in _leaves(item)]


def build_model(cfg, device: str | torch.device | None = None, *,
                impl: str = "auto") -> Model:
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)

    def as_tensor(a, dt=None) -> torch.Tensor:
        return torch.as_tensor(a).to(dev, dt)

    def embed(params: Params, batch: dict) -> torch.Tensor:
        if cfg.input_kind == "frames":
            return dense(params["frame_proj"], as_tensor(batch["frames"], dtype))
        # a gather of the float32 table then one cast == the reference's cast
        # of the whole table then a gather
        return params["emb"][as_tensor(batch["tokens"], torch.long)].to(dtype)

    def logits_of(params: Params, h: torch.Tensor) -> torch.Tensor:
        if cfg.tie_embeddings:
            return h @ params["emb"].to(h.dtype).T
        return dense(params["head"], h)

    def init(gen: torch.Generator) -> Params:
        if torch.device(gen.device).type != dev.type:
            raise ValueError(f"generator on {gen.device}, model on {dev}")
        return {**_embed_init(gen, cfg), "backbone": backbone_init(gen, cfg)}

    def forward(params: Params, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        x = embed(params, batch)
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32, device=dev)[None, :].expand(b, s)
        h, _, aux = backbone_apply(params["backbone"], cfg, x, positions=positions,
                                   impl=impl)
        return logits_of(params, h), aux

    def init_cache(batch_size: int, s_max: int) -> list:
        return init_caches(cfg, batch_size, s_max, dtype, dev)

    def prefill(params: Params, batch: dict, caches) -> tuple:
        """Returns (last-position logits (B, 1, V), caches, cache_len)."""
        x = embed(params, batch)
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32, device=dev)[None, :].expand(b, s)
        cache_len = torch.zeros((b,), dtype=torch.int32, device=dev)
        h, new_caches, _ = backbone_apply(params["backbone"], cfg, x,
                                          positions=positions, caches=caches,
                                          cache_len=cache_len, impl=impl)
        return logits_of(params, h[:, -1:, :]), new_caches, cache_len + s

    def decode_step(params: Params, tokens, caches, cache_len: torch.Tensor) -> tuple:
        """tokens (B, 1) -> (logits (B, 1, V), caches, cache_len)."""
        if cfg.input_kind == "frames":
            raise ValueError(f"{cfg.name} is encoder-only: no decode step")
        tokens = as_tensor(tokens, torch.long)
        x = params["emb"][tokens].to(dtype)
        positions = cache_len[:, None] + torch.zeros_like(tokens, dtype=torch.int32)
        h, new_caches, _ = backbone_apply(params["backbone"], cfg, x,
                                          positions=positions, caches=caches,
                                          cache_len=cache_len, impl=impl)
        return logits_of(params, h), new_caches, cache_len + tokens.shape[1]

    def count_params(params: Params) -> int:
        return int(sum(t.numel() for t in _leaves(params)))

    return Model(cfg, dev, init, forward, init_cache, prefill, decode_step,
                 count_params)


__all__ = ["Model", "build_model"]
