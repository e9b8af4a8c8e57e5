"""The tuning cache's process-wide bookkeeping for the port.

Counterpart of the part of `repro.tuning.cache` that the serving layer
reads: `backend_key` (the platform key cost models and caches are filed
under), and `cache_generation` / `invalidate_cache`, which downstream memo
layers (the serve executor's per-bucket plan memo) compare to drop stale
resolutions. The reference's committable per-backend block and plan cache
(`blocks_<backend>.json`, `store_cache`, `resolve_blocks`) has nothing to
choose on the card yet -- each kernel route has one tile shape
(`repro_torch.filters.conv.ROUTE_TILES`) -- and waits for ROADMAP Queue 1
item 5.
"""
from __future__ import annotations

import torch

from repro_torch.core.platform import resolve_device


def backend_key(device: str | torch.device | None = None) -> str:
    """Platform key of `device`: its torch device type ('cuda' | 'cpu').
    `None` is the default device, the card (raises without one)."""
    return resolve_device(device).type


#: bumped by every invalidate; memo layers compare it to drop stale entries.
_GENERATION = 0


def cache_generation() -> int:
    return _GENERATION


def invalidate_cache() -> None:
    """Drop every memoised plan resolution downstream (after an env or
    backend change, or in tests)."""
    global _GENERATION
    _GENERATION += 1


__all__ = ["backend_key", "cache_generation", "invalidate_cache"]
