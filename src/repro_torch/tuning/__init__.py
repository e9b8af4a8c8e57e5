"""Autotuning for the conv datapath: the tile menu, the plans and the cache.

Counterpart of `repro.tuning`. Layers:
  blocks.py   -- `BlockConfig`, the Hopper kernels' tile menu (`TILE_MENU`,
                 `kernel_route`) and the cache-miss heuristic per backend
                 (`default_blocks`);
  plans.py    -- `PlanConfig` (dataflow x mult_impl x blocks) and the plan
                 lookup path (`resolve_plan`: explicit > cached > defaults);
  cache.py    -- the committable per-backend JSON cache (v2: blocks and
                 plans sections, v1 migration) and the block lookup path
                 (`resolve_blocks`: explicit > cached > heuristic);
  autotune.py -- the sweeping tuner that fills both sections, with
                 roofline-pruned plan sweeps and the recurse kernels' chunk
                 sweep (`python -m repro_torch.tuning.autotune`, on the card).
"""
from repro_torch.tuning.blocks import (
    TILE_MENU,
    BlockConfig,
    choose_block_rows,
    default_blocks,
    kernel_route,
    min_block_cols,
    min_block_rows,
)
from repro_torch.tuning.cache import (
    CACHE_VERSION,
    backend_key,
    cache_generation,
    cache_path,
    config_key,
    invalidate_cache,
    load_cache,
    load_plans,
    resolve_blocks,
    resolve_blocks_cached,
    store_cache,
)
from repro_torch.tuning.plans import (
    DATAFLOWS,
    PlanConfig,
    PlanTile,
    allowed_dataflows,
    plan_key,
    resolve_plan,
    sanitize_plan,
)

__all__ = [
    "CACHE_VERSION",
    "DATAFLOWS",
    "TILE_MENU",
    "BlockConfig",
    "PlanConfig",
    "PlanTile",
    "allowed_dataflows",
    "backend_key",
    "cache_generation",
    "cache_path",
    "choose_block_rows",
    "config_key",
    "default_blocks",
    "invalidate_cache",
    "kernel_route",
    "load_cache",
    "load_plans",
    "min_block_cols",
    "min_block_rows",
    "plan_key",
    "resolve_blocks",
    "resolve_blocks_cached",
    "resolve_plan",
    "sanitize_plan",
    "store_cache",
]
