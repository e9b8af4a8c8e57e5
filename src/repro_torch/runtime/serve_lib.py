"""Serving-step factories: prefill, single-token decode and greedy
generation over a model's KV caches.

Counterpart of `repro.runtime.serve_lib`. `make_serve_step` is the decode
cell's step: one new token against a cache of depth `seq_len`.

With a `mesh` (a named `DeviceMesh` over every rank of the process group,
`repro_torch.launch.mesh`), `make_prefill_step` and `make_serve_step` are
the serving counterparts of the data-parallel train step
(`runtime.train_lib.make_train_step`), where the reference jits its steps
with `param_shardings` / `cache_shardings`:
  * the params rest by `sharding.param_shardings` (DTensors) and are
    gathered whole before the forward;
  * the rows split over the rules' "batch" axes as the resolver takes them
    for the batch's rows ("data", or ("pod", "data"), and "model" under
    `prefer_dp`; an axis the rows do not divide drops out, and the ranks
    along it compute the same rows), with `train_lib.row_split`'s MoE-chunk
    check: a rank's tokens must be whole chunks of the global stream, or
    ValueError;
  * the caches rest by `sharding.cache_shardings`. Before the step each is
    gathered over the mesh dims that split its other dims, so that only
    its batch dim stays split (this rank's rows, whole); afterwards each
    rank writes its block back into the DTensor, and the step returns the
    caches it was given;
  * the logits (and prefill's cache_len) are gathered over the batch
    axes: every rank returns the whole batch's, as the reference's
    replicated outputs;
  * the quantizer's abs-max of an activation spans every rank's rows
    (`sharding.activation_sharding_ctx`, `core.collectives.rows_max`), as
    in training.
Every collective is one of `core.collectives`' counted ones. Without a
mesh the steps are what they were.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

from repro_torch.runtime import sharding as shd


def make_prefill_step(model, mesh=None) -> Callable:
    if mesh is None:
        def prefill_step(params, batch: dict, caches):
            return model.prefill(params, batch, caches)
        return prefill_step

    def prefill_step(params, batch: dict, caches):
        rows, axes = _rows(model.cfg, mesh, batch)
        whole, local = _local_inputs(params, caches, axes)
        with _rows_ctx(axes):
            logits, new_caches, cache_len = model.prefill(
                whole, {k: x[rows] for k, x in batch.items()}, local)
        shd.keep_blocks(caches, new_caches, keep_dim=0)
        return _all_rows(logits, mesh, axes), caches, _all_rows(cache_len, mesh, axes)
    return prefill_step


def make_decode_step(model) -> Callable:
    def decode_step(params, tokens, caches, cache_len, image_embeds=None):
        return model.decode_step(params, tokens, caches, cache_len,
                                 image_embeds=image_embeds)
    return decode_step


def make_serve_step(model, *, seq_len: int, mesh=None) -> Callable:
    """Decode-shape cell: one token in, a KV cache of depth seq_len."""
    def decode(params, tokens, caches):
        cache_len = torch.full((tokens.shape[0],), seq_len - 1, dtype=torch.int32,
                               device=model.device)
        logits, new_caches, _ = model.decode_step(params, tokens, caches, cache_len)
        return logits, new_caches

    if mesh is None:
        return decode

    def serve_step(params, tokens, caches):
        rows, axes = _rows(model.cfg, mesh, {"tokens": tokens})
        whole, local = _local_inputs(params, caches, axes)
        with _rows_ctx(axes):
            logits, new_caches = decode(whole, tokens[rows], local)
        shd.keep_blocks(caches, new_caches, keep_dim=0)
        return _all_rows(logits, mesh, axes), caches
    return serve_step


# ------------------------------------------------------------ the mesh ------
def _rows(cfg, mesh, batch: dict) -> tuple[slice, tuple[str, ...]]:
    """(this rank's rows, the mesh axes they split over) of `batch`."""
    from repro_torch.runtime.train_lib import multi_pod, rank_rows, row_split
    x = next(iter(batch.values()))
    spec = shd.batch_shardings({"x": x}, cfg, mesh, multi_pod=multi_pod(mesh))["x"].spec
    axes = shd.spec_axes(spec[0])
    groups, index = rank_rows(mesh, axes)
    _, per = row_split(dataclasses.replace(cfg, microbatches=1), {"x": x}, groups)
    return slice(index * per, (index + 1) * per), axes


def _rows_ctx(axes: tuple[str, ...]):
    """The rows-split flag while the rows are split (a replicated batch
    needs no global reduction: every rank holds every row)."""
    return shd.activation_sharding_ctx() if axes else contextlib.nullcontext()


def _local_inputs(params, caches, axes: tuple[str, ...]):
    """(the params whole, each cache with only its batch dim split, over
    `axes` as the rows are, or ValueError)."""
    from repro_torch.core.tree import tree_paths
    for path, t in tree_paths(caches):
        split = shd.spec_axes(shd.spec_of(t)[0]) if shd.is_sharded(t) else ()
        if split != axes:
            raise ValueError(f"cache {path}: its batch dim is split over {split}, "
                             f"the rows over {axes}")
    return shd.gather_tree(params), shd.gather_tree(caches, keep_dim=0)


def _all_rows(x: torch.Tensor, mesh, axes: tuple[str, ...]) -> torch.Tensor:
    """`x`, this rank's rows, gathered over the batch axes: every row."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    pl = [Shard(0) if name in axes else Replicate() for name in mesh.mesh_dim_names]
    return shd.gather(DTensor.from_local(x, mesh, pl, run_check=False))


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
