"""Execution plans for the filter datapath.

Counterpart of `repro.tuning.plans`. A `PlanConfig` names the dataflow and
the tap-product implementation of one `apply_filter` call:

  * `dataflow`  -- 'direct' (one KxK pass), 'two_pass' (separable row then
                   column passes with an int32 intermediate in device
                   memory) or 'fused' (both 1-D passes in one kernel);
  * `mult_impl` -- 'kcm' | 'recurse', or 'auto' to defer to the pass-level
                   resolution.

The reference also tunes its TPU grid and consults a per-backend plan
cache; the port has no plan cache yet, so `resolve_plan` is the
reference's cache-miss path: separable specs run fused, explicit arguments
win. Every plan gives the same bytes.
"""
from __future__ import annotations

from typing import NamedTuple

DATAFLOWS = ("direct", "two_pass", "fused")


class PlanConfig(NamedTuple):
    """One execution plan of the filter datapath."""

    dataflow: str               # 'direct' | 'two_pass' | 'fused'
    mult_impl: str              # 'recurse' | 'kcm' | 'auto' (= defer)


def allowed_dataflows(separable_ok: bool, separable: bool | None,
                      fused: bool | None) -> tuple[str, ...]:
    """Dataflows the caller's explicit `separable=`/`fused=` arguments
    admit, most-preferred first (the head is the default)."""
    if not separable_ok or separable is False:
        return ("direct",)
    if fused is True:
        return ("fused",)
    if fused is False:
        return ("two_pass",)
    if separable is True:
        return ("fused", "two_pass")
    return ("fused", "two_pass", "direct")


def resolve_plan(*, separable_ok: bool, mult_impl: str = "auto",
                 separable: bool | None = None,
                 fused: bool | None = None) -> PlanConfig:
    """The plan for a call: explicit arguments, else the default dataflow
    (fused when the spec separates, else direct)."""
    return PlanConfig(allowed_dataflows(separable_ok, separable, fused)[0],
                      mult_impl)


__all__ = ["DATAFLOWS", "PlanConfig", "allowed_dataflows", "resolve_plan"]
