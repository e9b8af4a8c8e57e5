"""Execution-plan resolution for the filter datapath, and the plan memo's
cache generation."""
from repro_torch.tuning.cache import backend_key, cache_generation, invalidate_cache
from repro_torch.tuning.plans import (
    DATAFLOWS,
    PlanConfig,
    PlanTile,
    allowed_dataflows,
    resolve_plan,
)

__all__ = ["DATAFLOWS", "PlanConfig", "PlanTile", "allowed_dataflows",
           "backend_key", "cache_generation", "invalidate_cache", "resolve_plan"]
