"""Serving-step factories: prefill, single-token decode and greedy
generation over a model's KV caches.

Counterpart of `repro.runtime.serve_lib`. `make_serve_step` is the decode
cell's step: one new token against a cache of depth `seq_len`.

With a `mesh` (a named `DeviceMesh` over every rank of the process group,
`repro_torch.launch.mesh`), `make_prefill_step` and `make_serve_step` are
the serving counterparts of the meshed train step
(`runtime.train_lib.make_train_step`), where the reference jits its steps
with `param_shardings` / `cache_shardings`:
  * the params rest by `sharding.param_shardings` (DTensors) and stay
    sharded: each layer gathers its FSDP blocks just before its forward
    and computes on its "model" shard where the rules split it in whole
    heads, experts or vocab columns (`sharding.activation_sharding_ctx`);
  * the rows split over the rules' "batch" axes as the resolver takes them
    for the batch's rows ("data", or ("pod", "data"), and "model" under
    `prefer_dp`; an axis the rows do not divide drops out, and the ranks
    along it compute the same rows), with `train_lib.row_split`'s MoE-chunk
    check: a rank's tokens must be whole chunks of the global stream, or
    ValueError;
  * the caches rest by `sharding.cache_shardings`: the k and v heads over
    "model" where the kv heads divide it, Mamba2's SSD state on its heads
    and its conv state on its channels. Before the step each is gathered
    over the mesh dims that split its other dims, so that each layer gets
    this rank's rows and, where it splits its heads over "model", this
    rank's heads (`_cache_plan`): an attention's kv heads, Mamba2's SSD
    state; Mamba2's conv state, whose channel blocks straddle its x / B /
    C segments, is gathered whole and this rank's x channels and B / C
    taken (`core.collectives.segment_index`), and after the step the x
    channels are all-gathered back (`gather_segments`). The step writes
    the new keys and values into them in place
    (`models.layers.donated_caches`, the reference's donated caches); each
    rank then writes its block back into the DTensor, and the step returns
    the caches it was given;
  * the logits are gathered over "model" (`Model.prefill` /
    `decode_step`) and over the batch axes (with prefill's cache_len):
    every rank returns the whole batch's, as the reference's replicated
    outputs;
  * the quantizer's abs-max of an activation spans every rank's rows, and
    of a split operand "model" too (`core.collectives`), as in training.
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
        keep, select = _cache_plan(model.cfg, mesh)
        with _split_ctx(model.cfg, mesh, params, axes) as local:
            logits, new_caches, cache_len = model.prefill(
                local, {k: x[rows] for k, x in batch.items()},
                _local_caches(caches, axes, keep, select))
        shd.keep_blocks(caches, _whole_channels(new_caches, select), keep_dim=keep)
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
        keep, select = _cache_plan(model.cfg, mesh)
        with _split_ctx(model.cfg, mesh, params, axes) as local:
            logits, new_caches = decode(local, tokens[rows],
                                        _local_caches(caches, axes, keep, select))
        shd.keep_blocks(caches, _whole_channels(new_caches, select), keep_dim=keep)
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


@contextlib.contextmanager
def _split_ctx(cfg, mesh, params, axes: tuple[str, ...]):
    """The step's split (`sharding.activation_sharding_ctx`) with the rows
    over `axes`; yields this rank's blocks of `params`."""
    from repro_torch.runtime.train_lib import multi_pod
    from repro_torch.models.layers import donated_caches
    local, layouts = shd.local_blocks(params, mesh)
    with shd.activation_sharding_ctx(mesh, cfg, multi_pod=multi_pod(mesh), rows=axes,
                                     layouts=layouts), donated_caches():
        yield local


#: the cache leaves whose heads an attention whose kv heads split over
#: "model" keeps split
_HEAD_LEAVES = ("k", "v", "k_img", "v_img")


def _cache_plan(cfg, mesh):
    """(keep, select) of the caches' leaves: `keep(path, leaf)` the dims
    that stay this rank's block -- the rows, the kv heads of an attention
    that splits them over "model" (`models.layers.attn_splits`), the heads
    of a Mamba2 SSD state that splits them --; `select(path)` (the "model"
    Axis, the conv channels' segments) for a Mamba2 conv state on split
    heads, else None."""
    from repro_torch.core.collectives import mesh_axes
    from repro_torch.models import ssm
    from repro_torch.models.transformer import split_heads
    names = list(mesh.mesh_dim_names)
    m = mesh.size(names.index("model")) if "model" in names else 1
    tp = shd.model_parallel(cfg, mesh) and m > 1
    heads = tp and cfg.num_heads % m == 0 and cfg.num_kv_heads % m == 0
    ssm_split = tp and "mamba2" in cfg.block_kinds() and split_heads("mamba2", cfg) % m == 0
    kinds = cfg.block_kinds()

    def mamba(path: str) -> bool:
        return ssm_split and kinds[int(path.split("/")[0])] == "mamba2"

    def keep(path: str, _) -> tuple[int, ...]:
        leaf = path.split("/")[-1]
        if heads and leaf in _HEAD_LEAVES:
            return (0, 2)
        return (0, 1) if leaf == "ssm" and mamba(path) else (0,)

    def select(path: str):
        if path.split("/")[-1] == "conv" and mamba(path):
            return mesh_axes(mesh)["model"], ssm.segments(cfg)[1]
        return None
    return keep, select


def _local_caches(caches, axes: tuple[str, ...], keep, select):
    """Each cache with only its `keep` dims split (the batch dim over
    `axes`, as the rows are, or ValueError), and this rank's channels of
    a `select`ed one."""
    from repro_torch.core.collectives import segment_index
    from repro_torch.core.tree import tree_map_with_path, tree_paths
    for path, t in tree_paths(caches):
        split = shd.spec_axes(shd.spec_of(t)[0]) if shd.is_sharded(t) else ()
        if split != axes:
            raise ValueError(f"cache {path}: its batch dim is split over {split}, "
                             f"the rows over {axes}")

    def local(path: str, t):
        out = shd.gather(t, keep(path, t), copy=False)
        sel = select(path)
        return out if sel is None else out.index_select(-1, segment_index(sel[1], sel[0],
                                                                          out.device))
    return tree_map_with_path(local, caches)


def _whole_channels(caches, select):
    """The step's new caches with each `select`ed conv state's channels
    whole again (`core.collectives.gather_segments`)."""
    from repro_torch.core.collectives import gather_segments
    from repro_torch.core.tree import tree_map_with_path

    def whole(path: str, t):
        sel = select(path)
        return t if sel is None else gather_segments(t, sel[0], t.ndim - 1, sel[1])
    return tree_map_with_path(whole, caches)


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
