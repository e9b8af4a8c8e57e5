"""Deterministic sharded synthetic LM data.

Counterpart of `repro.data.tokens`, copied (NumPy only): every batch is a
pure function of (seed, step, shard_index) -- no filesystem, no state -- so
a restart re-reads exactly the batches the failed run saw
(`repro_torch.runtime.fault.run_training` relies on this). The batches are
byte-equal to the reference's for every `input_kind`.

Tokens are Zipf-ish draws (more realistic softmax statistics than uniform)
with next-token labels. The modality frontends are stubs: audio frames and
image patch embeddings are seeded normal draws.
"""
from __future__ import annotations

import numpy as np


def _rng(seed: int, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step, shard]))


def lm_batch(cfg, *, batch: int, seq: int, seed: int = 0, step: int = 0,
             shard: int = 0, num_shards: int = 1) -> dict:
    """One shard of the global batch (`batch` rows a shard), NumPy arrays."""
    rng = _rng(seed, step, shard)
    # Zipf over the vocab, clipped: heavier head like natural text.
    v = cfg.vocab_size
    toks = (rng.zipf(1.3, size=(batch, seq + 1)) - 1).clip(0, v - 1).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.input_kind == "frames":
        out = {
            "frames": rng.standard_normal((batch, seq, cfg.frame_dim), dtype=np.float32),
            "labels": (rng.integers(0, v, (batch, seq))).astype(np.int32),
        }
    elif cfg.input_kind == "tokens+image":
        out["image_embeds"] = rng.standard_normal(
            (batch, cfg.image_tokens, cfg.d_model), dtype=np.float32) * 0.02
    return out


def global_batch_iter(cfg, *, global_batch: int, seq: int, seed: int = 0,
                      start_step: int = 0):
    """Single-host iterator over full global batches: (step, batch)."""
    step = start_step
    while True:
        yield step, lm_batch(cfg, batch=global_batch, seq=seq, seed=seed, step=step)
        step += 1


__all__ = ["global_batch_iter", "lm_batch"]
