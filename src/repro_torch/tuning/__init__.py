"""Execution-plan resolution for the filter datapath."""
from repro_torch.tuning.plans import (
    DATAFLOWS,
    PlanConfig,
    allowed_dataflows,
    resolve_plan,
)

__all__ = ["DATAFLOWS", "PlanConfig", "allowed_dataflows", "resolve_plan"]
