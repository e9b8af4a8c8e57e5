"""Full execution plans for the filter datapath.

Counterpart of `repro.tuning.plans`. A `PlanConfig` names everything the
tuner may choose for one (filter, batch/image shape) point:

  * `dataflow`  -- 'direct' (one KxK pass), 'two_pass' (separable row then
                   column passes with an int32 intermediate in device
                   memory) or 'fused' (both 1-D passes in one kernel);
  * `mult_impl` -- 'kcm' | 'recurse', or 'auto' to defer to the pass-level
                   resolution;
  * `block_rows` / `block_cols` / `batch_fold` -- the grid fields
                   (`repro_torch.tuning.blocks`); None defers to the
                   pass-level block cache and heuristic. On the card they
                   name a tile of the kernels' menu; on the CPU the
                   reference's grid vocabulary, which the plain versions
                   ignore.

Tuned entries (the `plans` section of the v2 cache) are fully concrete;
the deferring spellings make an untuned resolution reproduce the
reference's cache-miss plan (separable specs run fused). `resolve_plan` is
the lookup: explicit arguments win, then the cached plan (where it agrees
with them), then those defaults.

Every plan gives the same bytes, so a wrong -- even poisoned -- cache
entry can only cost time. `sanitize_plan` enforces that: it clamps a
cached entry's grid to what the backend runs (the reference's kernel
floors on the CPU, the kernels' menu on the card, where a fold is
dropped) instead of letting it trip the explicit-argument checks of the
conv passes, and rejects an entry whose dataflow the filter cannot run.
`PlanTile` is the tile a plan launches on the card
(`repro_torch.filters.pipeline.plan_tile`), for the cost model and the
serving trace.
"""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.tuning.blocks import (
    TILE_MENU,
    clamp_tile,
    kernel_route,
    min_block_cols,
    min_block_rows,
    round_up,
)
from repro_torch.tuning.cache import backend_key, load_plans

#: dataflow vocabulary of the plan search space.
DATAFLOWS = ("direct", "two_pass", "fused")

#: concrete tap-product implementations a tuned plan may pin ('auto' is the
#: deferring spelling, never stored).
PLAN_MULT_IMPLS = ("recurse", "kcm")


class PlanConfig(NamedTuple):
    """One full execution plan of the filter datapath."""

    dataflow: str                       # 'direct' | 'two_pass' | 'fused'
    mult_impl: str                      # 'recurse' | 'kcm' | 'auto' (= defer)
    block_rows: int | None = None       # None = defer to the pass level
    block_cols: int | None = None       # None = defer (a tuned CPU entry
                                        # spells a full-width tile as w)
    batch_fold: bool | None = None      # None = defer

    def as_dict(self) -> dict:
        return {"dataflow": self.dataflow, "mult_impl": self.mult_impl,
                "block_rows": self.block_rows, "block_cols": self.block_cols,
                "batch_fold": self.batch_fold}


class PlanTile(NamedTuple):
    """The output tile one block of a plan's kernels computes on the card:
    the route (`kernel_route`) and a tile of its menu (`TILE_MENU`). The
    kernels never fold a batch into rows, so `batch_fold` is False."""

    route: str                  # 'persistent' | 'tiled'
    block_rows: int
    block_cols: int
    batch_fold: bool = False


def plan_key(name: str, n: int, h: int, w: int) -> str:
    """Plan-cache key: filter name x the (n, h, w) the pipeline runs with
    (shard- or tile-local under distributed execution)."""
    return f"{name}/n{n}x{h}x{w}"


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


def plan_routes(dataflow: str, kh: int, kw: int) -> set[str]:
    """The kernel routes a dataflow's passes take for a (kh, kw) filter."""
    if dataflow == "fused":
        return {kernel_route(kh, kw, fused=True)}
    if dataflow == "two_pass":
        return {kernel_route(1, kw), kernel_route(kh, 1)}
    return {kernel_route(kh, kw)}


def sanitize_plan(plan: PlanConfig, n: int, h: int, w: int, kh: int,
                  kw: int, *, backend: str = "cpu") -> PlanConfig | None:
    """Clamp a cache-sourced plan to what the backend runs; None if unusable.

    Cached fields are not explicit caller arguments, so they never trip the
    conv passes' fail-loud checks. 'cpu': the reference's rule -- block_rows
    floors at the fused pass's halo depth and ceils at one band over the
    (folded) height, block_cols floors at the column-halo minimum and any
    tile at least as wide as the image means full width. 'cuda': the grid
    becomes the nearest menu tile of the dataflow's route (`clamp_tile`),
    without a fold; a two-pass plan whose passes take different routes
    defers its grid to each pass."""
    if plan.dataflow not in DATAFLOWS:
        return None
    if plan.mult_impl not in PLAN_MULT_IMPLS:
        return None
    br, bc, fold = plan.block_rows, plan.block_cols, plan.batch_fold
    fold = None if fold is None else bool(fold)
    if backend == "cuda":
        if (br, bc, fold) == (None, None, None):
            return plan
        routes = plan_routes(plan.dataflow, kh, kw)
        if len(routes) != 1:
            return plan._replace(block_rows=None, block_cols=None, batch_fold=None)
        route = routes.pop()
        rows, cols = clamp_tile(route, TILE_MENU[route][0][0] if br is None else br, bc)
        return plan._replace(block_rows=rows, block_cols=cols, batch_fold=False)
    ph = kh // 2
    if br is not None:
        tall = n * (h + 2 * ph) if fold else h
        br = min(max(int(br), min_block_rows(kh)), round_up(tall, 8))
    if bc is not None:
        bc = min(int(bc), w)
        if bc < w:
            bc = max(bc, min_block_cols(kw))
    return plan._replace(block_rows=br, block_cols=bc, batch_fold=fold)


def _entry_plan(entry: dict) -> PlanConfig | None:
    """A cache entry's PlanConfig, or None when the entry is malformed."""
    try:
        return PlanConfig(str(entry["dataflow"]), str(entry["mult_impl"]),
                          int(entry["block_rows"]),
                          int(entry["block_cols"]),
                          bool(entry["batch_fold"]))
    except (KeyError, TypeError, ValueError):
        return None


def resolve_plan(
    name: str,
    n: int,
    h: int,
    w: int,
    kh: int,
    kw: int,
    *,
    separable_ok: bool,
    mult_impl: str = "auto",
    separable: bool | None = None,
    fused: bool | None = None,
    block_rows: int | None = None,
    block_cols: int | None = None,
    batch_fold: bool | None = None,
    backend: str | None = None,
) -> PlanConfig:
    """The single plan lookup path: explicit > cached > cache-miss defaults.

    Field-wise precedence as the reference's: every explicit argument wins;
    the cached plan of `backend` donates its other fields only where it
    agrees -- a dataflow the caller's `separable=` / `fused=` exclude
    rejects the entry, a pinned `mult_impl` that differs keeps the entry's
    dataflow but drops its grid, and any disagreeing explicit grid field
    drops the entry's grid as a unit; what stays unset defers downstream
    (fused when the spec separates, else direct; 'auto'; the pass-level
    block resolution). `backend` None is the default device's, the card's."""
    allowed = allowed_dataflows(separable_ok, separable, fused)
    if (len(allowed) == 1 and mult_impl != "auto"
            and None not in (block_rows, block_cols, batch_fold)):
        # fully explicit call: nothing to look up (the serve hot path)
        return PlanConfig(allowed[0], mult_impl, int(block_rows),
                          int(block_cols), bool(batch_fold))
    backend = backend or backend_key()
    cand: PlanConfig | None = None
    entry = load_plans(backend).get(plan_key(name, n, h, w))
    if entry:
        cand = _entry_plan(entry)
        if cand is not None:
            cand = sanitize_plan(cand, n, h, w, kh, kw, backend=backend)
        if cand is not None and cand.dataflow not in allowed:
            cand = None
        if cand is not None:
            if mult_impl != "auto" and cand.mult_impl != mult_impl:
                cand = cand._replace(mult_impl=mult_impl, block_rows=None,
                                     block_cols=None, batch_fold=None)
            elif any(
                exp is not None and exp != got
                for exp, got in ((block_rows, cand.block_rows),
                                 (block_cols, cand.block_cols),
                                 (None if batch_fold is None
                                  else bool(batch_fold), cand.batch_fold))
            ):
                cand = cand._replace(block_rows=None, block_cols=None,
                                     batch_fold=None)
    if cand is None:
        cand = PlanConfig(allowed[0], mult_impl, None, None, None)
    return PlanConfig(
        cand.dataflow,
        cand.mult_impl if mult_impl == "auto" else mult_impl,
        cand.block_rows if block_rows is None else int(block_rows),
        cand.block_cols if block_cols is None else int(block_cols),
        cand.batch_fold if batch_fold is None else bool(batch_fold),
    )


__all__ = ["DATAFLOWS", "PLAN_MULT_IMPLS", "PlanConfig", "PlanTile",
           "allowed_dataflows", "plan_key", "plan_routes", "resolve_plan",
           "sanitize_plan"]
