"""The per-backend tuning cache consulted by the conv datapath: block
winners plus full execution plans.

Counterpart of `repro.tuning.cache`, with the same v2 file -- one
committable JSON file per backend, `blocks_<backend>.json` beside this
module (`blocks_cuda.json` is written by `python -m
repro_torch.tuning.autotune` on the card):

    {
      "meta": {"backend": "cuda", "generated": "<ISO-8601>", "version": 2},
      "blocks": {"<kind>/<mult_impl>/n8x480x640/k5x5": {
                   "block_rows": 32, "block_cols": 64, "batch_fold": false,
                   "us_per_call": 12.3}, ...},
      "plans": {"gaussian5/n8x480x640": {"dataflow": "fused",
                  "mult_impl": "kcm", "block_rows": 32, "block_cols": 64,
                  "batch_fold": false, "us_per_call": 12.3, ...}, ...}
    }

The port's `meta` may carry more (the autotune CLI records the card's
name and power limit, and its chunk sweep of the recurse kernels). Legacy
v1 files (`configs` at top level) migrate on load as the reference's do.
The backend key is the torch device type ('cuda' | 'cpu',
`backend_key`). The directory override is the port's own,
`REPRO_TORCH_TUNE_CACHE`: the reference's `blocks_cpu.json` holds TPU /
interpret grids and is never read here.

The (n, h, w) of a key is always the shape the conv pass itself runs
with: under `exec='sharded'` the shard-local band
(`repro_torch.distribute.shard_local_shape`), under `exec='streamed'` the
tile-local batch `(tile_batch, tile_h + 2*ph, tile_w + 2*pw)`, never the
global image.

`resolve_blocks` is the single block lookup path: explicit per-call values
win, then the cache, then `default_blocks`. On the 'cuda' backend a cached
entry off the kernels' menu (or folded) is clamped to the menu
(`clamp_tile`), never raised on: a poisoned cache costs time, not bytes.
"""
from __future__ import annotations

import json
import os
import pathlib
import time
from functools import lru_cache

import torch

from repro_torch.core.platform import resolve_device
from repro_torch.tuning.blocks import (
    BlockConfig,
    clamp_tile,
    default_blocks,
    route_of,
)

CACHE_VERSION = 2
#: environment variable naming the cache directory (default: this package)
CACHE_ENV = "REPRO_TORCH_TUNE_CACHE"


def backend_key(device: str | torch.device | None = None) -> str:
    """Platform key of `device`: its torch device type ('cuda' | 'cpu').
    `None` is the default device, the card (raises without one)."""
    return resolve_device(device).type


def cache_dir() -> pathlib.Path:
    env = os.environ.get(CACHE_ENV)
    return pathlib.Path(env) if env else pathlib.Path(__file__).parent


def cache_path(backend: str | None = None) -> pathlib.Path:
    return cache_dir() / f"blocks_{backend or backend_key()}.json"


def config_key(kind: str, n: int, h: int, w: int, kh: int, kw: int,
               mult_impl: str) -> str:
    return f"{kind}/{mult_impl}/n{n}x{h}x{w}/k{kh}x{kw}"


def cache_timestamp() -> str:
    """BENCH_TIMESTAMP when set (pinned, reproducible artifacts), else UTC."""
    return os.environ.get("BENCH_TIMESTAMP") or time.strftime(
        "%Y-%m-%dT%H:%M:%SZ", time.gmtime())


@lru_cache(maxsize=None)
def _load(path: str) -> dict:
    """-> {"meta", "blocks", "plans"}, migrating legacy v1 files (top-level
    `configs` = the old flat block mapping, no plans)."""
    empty = {"meta": {}, "blocks": {}, "plans": {}}
    p = pathlib.Path(path)
    if not p.exists():
        return empty
    try:
        data = json.loads(p.read_text())
    except (OSError, json.JSONDecodeError):
        return empty
    if not isinstance(data, dict):
        return empty
    meta = data.get("meta") if isinstance(data.get("meta"), dict) else {}
    if "configs" in data:                       # v1: flat block mapping
        return {"meta": meta, "blocks": data.get("configs") or {}, "plans": {}}
    return {"meta": meta, "blocks": data.get("blocks") or {},
            "plans": data.get("plans") or {}}


def load_cache(backend: str | None = None) -> dict:
    """Block section: key -> {block_rows, block_cols, batch_fold,
    us_per_call} (v1 files migrate transparently)."""
    return _load(str(cache_path(backend)))["blocks"]


def load_plans(backend: str | None = None) -> dict:
    """Plan section: plan_key -> full PlanConfig entry; empty for v1."""
    return _load(str(cache_path(backend)))["plans"]


def load_meta(backend: str | None = None) -> dict:
    """The file's `meta` (backend, generated, version, and what the
    autotune CLI recorded of the card)."""
    return _load(str(cache_path(backend)))["meta"]


#: bumped by every invalidate; memo layers compare it to drop stale entries.
_GENERATION = 0


def cache_generation() -> int:
    return _GENERATION


def invalidate_cache() -> None:
    """Drop the in-process caches (after writes, env or backend changes, or
    in tests) -- the raw file load and the memoised resolutions -- and
    every memoised plan downstream (the serve executor's plan memo)."""
    global _GENERATION
    _GENERATION += 1
    _load.cache_clear()
    resolve_blocks_cached.cache_clear()


def store_cache(configs: dict, plans: dict | None = None,
                backend: str | None = None, *,
                meta: dict | None = None) -> pathlib.Path:
    """Write the committable per-backend cache file; returns its path.

    `configs` is the block section; `plans=None` keeps the file's plan
    section, `plans={...}` replaces it. `meta` adds keys to the file's
    meta (backend, generated and version are always this call's). Keys are
    sorted and `generated` honours BENCH_TIMESTAMP, so a regeneration is
    byte-deterministic up to the measured winners."""
    backend = backend or backend_key()
    path = cache_path(backend)
    if plans is None:
        plans = load_plans(backend)
    payload = {
        "meta": {**(meta or {}), "backend": backend,
                 "generated": cache_timestamp(), "version": CACHE_VERSION},
        "blocks": {k: configs[k] for k in sorted(configs)},
        "plans": {k: plans[k] for k in sorted(plans)},
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    invalidate_cache()
    return path


def _cached_blocks(entry: dict, kind: str, kh: int, kw: int,
                   backend: str) -> BlockConfig | None:
    """A block entry as a BlockConfig the backend can run (clamped to the
    card's menu on 'cuda'), or None when malformed."""
    try:
        br = int(entry["block_rows"])
        bc = entry["block_cols"]
        bc = None if bc is None else int(bc)
        fold = bool(entry["batch_fold"])
    except (KeyError, TypeError, ValueError):
        return None
    if backend == "cuda":
        return BlockConfig(*clamp_tile(route_of(kind, kh, kw), br, bc), False)
    return BlockConfig(br, bc, fold)


def resolve_blocks(
    kind: str,
    n: int,
    h: int,
    w: int,
    kh: int,
    kw: int,
    mult_impl: str,
    *,
    block_rows: int | None = None,
    block_cols: int | None = None,
    batch_fold: bool | None = None,
    backend: str | None = None,
) -> BlockConfig:
    """Tuned-cache lookup with explicit-override and heuristic fallback.

    Any explicitly supplied field wins unconditionally. Unset fields come
    from the backend's cache only when its entry for this exact (kind,
    shape, mult_impl) agrees with every explicit field; on disagreement or
    a miss `default_blocks` fills the gaps with the caller's fold decision
    pinned. `block_cols` has no "explicitly full width" spelling on the
    CPU vocabulary -- pass `block_cols=w`."""
    if None not in (block_rows, block_cols, batch_fold):
        # fully explicit: nothing to look up (the serve hot path)
        return BlockConfig(int(block_rows), int(block_cols), bool(batch_fold))
    backend = backend or backend_key()
    base: BlockConfig | None = None
    entry = load_cache(backend).get(config_key(kind, n, h, w, kh, kw, mult_impl))
    if entry:
        cached = _cached_blocks(entry, kind, kh, kw, backend)
        if cached is not None and (
                (block_rows is None or int(block_rows) == cached.block_rows)
                and (block_cols is None or block_cols == cached.block_cols)
                and (batch_fold is None
                     or bool(batch_fold) == cached.batch_fold)):
            base = cached
    if base is None:
        base = default_blocks(kind, n, h, w, kh, kw, batch_fold=batch_fold,
                              backend=backend)
    return BlockConfig(
        base.block_rows if block_rows is None else int(block_rows),
        base.block_cols if block_cols is None else int(block_cols),
        base.batch_fold if batch_fold is None else bool(batch_fold),
    )


@lru_cache(maxsize=None)
def resolve_blocks_cached(kind: str, n: int, h: int, w: int, kh: int,
                          kw: int, mult_impl: str,
                          backend: str | None = None) -> BlockConfig:
    """Memoised default-field `resolve_blocks` for steady-state dispatch;
    `invalidate_cache()` clears it with the file cache."""
    return resolve_blocks(kind, n, h, w, kh, kw, mult_impl, backend=backend)


__all__ = ["CACHE_ENV", "CACHE_VERSION", "backend_key", "cache_dir",
           "cache_generation", "cache_path", "cache_timestamp", "config_key",
           "invalidate_cache", "load_cache", "load_meta", "load_plans",
           "resolve_blocks", "resolve_blocks_cached", "store_cache"]
