"""Execution plans for the filter datapath.

Counterpart of `repro.tuning.plans`. A `PlanConfig` names the dataflow and
the tap-product implementation of one `apply_filter` call:

  * `dataflow`  -- 'direct' (one KxK pass), 'two_pass' (separable row then
                   column passes with an int32 intermediate in device
                   memory) or 'fused' (both 1-D passes in one kernel);
  * `mult_impl` -- 'kcm' | 'recurse', or 'auto' to defer to the pass-level
                   resolution.

The reference also tunes its TPU grid (block_rows, block_cols,
batch_fold) and consults a per-backend plan cache. On the card the grid is
not a choice: each kernel route launches one tile shape, which
`PlanTile` spells for the cost model and the serving trace
(`repro_torch.filters.pipeline.plan_tile`). With no plan cache yet,
`resolve_plan` is the reference's cache-miss path: separable specs run
fused, explicit arguments win. Every plan gives the same bytes.
"""
from __future__ import annotations

from typing import NamedTuple

DATAFLOWS = ("direct", "two_pass", "fused")


class PlanConfig(NamedTuple):
    """One execution plan of the filter datapath."""

    dataflow: str               # 'direct' | 'two_pass' | 'fused'
    mult_impl: str              # 'recurse' | 'kcm' | 'auto' (= defer)


class PlanTile(NamedTuple):
    """The output tile one block of a plan's kernels computes, as the
    route launches it: the persistent kernels' 32x64 (`csrc/staging.cuh`)
    or the tiled kernels' 16x32. The kernels never fold a batch into
    rows, so `batch_fold` is False."""

    route: str                  # 'persistent' | 'tiled'
    block_rows: int
    block_cols: int
    batch_fold: bool = False


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


__all__ = ["DATAFLOWS", "PlanConfig", "PlanTile", "allowed_dataflows",
           "resolve_plan"]
