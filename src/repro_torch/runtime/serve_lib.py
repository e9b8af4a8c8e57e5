"""Serving-step factories: prefill, single-token decode and greedy
generation over a model's KV caches.

Counterpart of `repro.runtime.serve_lib`. `make_serve_step` is the decode
cell's step: one new token against a cache of depth `seq_len`.
"""
from __future__ import annotations

from typing import Callable

import torch


def make_prefill_step(model) -> Callable:
    def prefill_step(params, batch: dict, caches):
        return model.prefill(params, batch, caches)
    return prefill_step


def make_decode_step(model) -> Callable:
    def decode_step(params, tokens, caches, cache_len):
        return model.decode_step(params, tokens, caches, cache_len)
    return decode_step


def make_serve_step(model, *, seq_len: int) -> Callable:
    """Decode-shape cell: one token in, a KV cache of depth seq_len."""
    def serve_step(params, tokens, caches):
        cache_len = torch.full((tokens.shape[0],), seq_len - 1, dtype=torch.int32,
                               device=model.device)
        logits, new_caches, _ = model.decode_step(params, tokens, caches, cache_len)
        return logits, new_caches
    return serve_step


def greedy_generate(model, params, prompt, *, steps: int, s_max: int) -> torch.Tensor:
    """Greedy decoding: prefill the prompt (B, S), then `steps - 1` decode
    steps; -> the (B, steps) int32 tokens, on the model's device."""
    prompt = torch.as_tensor(prompt).to(model.device, torch.long)
    caches = model.init_cache(prompt.shape[0], s_max)
    logits, caches, cache_len = model.prefill(params, {"tokens": prompt}, caches)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    outs = [tok]
    for _ in range(steps - 1):
        logits, caches, cache_len = model.decode_step(params, tok, caches, cache_len)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        outs.append(tok)
    return torch.cat(outs, dim=1)


__all__ = ["greedy_generate", "make_decode_step", "make_prefill_step",
           "make_serve_step"]
