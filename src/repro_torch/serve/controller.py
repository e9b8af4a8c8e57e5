"""Adaptive batching controller: the per-bucket target-latency feedback
loop (DESIGN.md §13).

Counterpart of `repro.serve.controller`: plain Python, copied with the
imports renamed and the decisions kept the same.

The static §10 flush policy holds every bucket to one (max_batch,
max_delay) pair: coalescing buys throughput but every request waits out the
same flush deadline whether its SLO is 10 ms or 10 s. The controller
replaces the static pair with a per-bucket choice derived from a **warm
plan-cost ledger**:

  * **predicted service time** `s(n)` for a bucket at traced batch size
    `n` starts from the §11 plan machinery -- the bucket's resolved
    `PlanConfig` priced by the analytic conv roofline
    (`repro_torch.roofline.conv_model.plan_cost`) -- scaled by an online
    calibration factor (EWMA of observed/predicted, exactly the
    `sweep_plan` trick from autotune.py), and is replaced by a per-(bucket,
    n) EWMA of *observed* dispatch service times as soon as the first real
    batch lands. Unobserved sizes interpolate from the nearest observed
    size by model-cost ratio, so one observation calibrates the whole
    pow-2 ladder.
  * **flush size** converges to the largest power-of-two batch whose
    predicted tail latency fits the bucket's SLO: choose the largest
    `n <= max_batch` with `safety * s(n) <= slo_budget`, where the budget
    is the tightest *remaining* SLO over the queued requests (absolute
    `req.slo` minus now) and `safety` absorbs service-time jitter (the
    p99-over-mean margin).
  * **flush deadline** is the leftover budget: `slo_budget - safety *
    s(n)` -- the longest the bucket can afford to keep collecting before
    dispatching still meets the SLO. A bucket with no SLO'd requests
    falls back to the static pair, so untargeted traffic behaves exactly
    as §10 shipped.

Every choice is pure policy: outputs are bit-identical across batch
sizes and flush times (§10), so the controller can never affect bytes --
only where each request's latency lands (asserted under load in
tests/test_serve_slo.py and guarded by `scripts/check.sh --smoke-slo`).
"""
from __future__ import annotations

import threading
from typing import Iterable

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.request import FilterRequest
from repro_torch.serve.workload import Workload, resolve_workloads

#: tail-latency safety margin over the mean service-time estimate: the
#: controller treats `safety * s(n)` as the batch's p99. Absorbs both
#: EWMA lag and dispatch jitter (host-clock dispatch timing is noisy).
DEFAULT_SAFETY = 1.5

#: EWMA step for observed service times and the model calibration.
DEFAULT_ALPHA = 0.3

#: service-time floor (seconds) -- keeps a zero/absurd model prediction
#: from claiming infinite affordable batch size before the first
#: observation lands.
MIN_SERVICE_S = 1e-5


def _pow2_ladder(max_batch: int) -> tuple[int, ...]:
    """The traced batch sizes the executor can actually dispatch
    (pow-2 rounding, §10): 1, 2, 4, ... max_batch."""
    ladder = []
    n = 1
    while n < max_batch:
        ladder.append(n)
        n <<= 1
    ladder.append(max_batch)
    return tuple(ladder)


class AdaptiveBatchController:
    """Per-bucket (flush_size, flush_delay) from the plan-cost ledger.

    Thread-safe: the server's worker thread calls `params` (under the
    server condition) and `observe` (outside it) while `stats()` serves
    operator reads. Plugs into `ShapeBucketedBatcher` as its
    `FlushPolicy`.
    """

    def __init__(self, max_batch: int, max_delay_s: float, *,
                 safety: float = DEFAULT_SAFETY,
                 alpha: float = DEFAULT_ALPHA,
                 backend: str | None = None,
                 workloads: dict[str, Workload] | None = None,
                 metrics: MetricsRegistry | None = None) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._workloads = resolve_workloads(workloads)
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self.safety = float(safety)
        self.alpha = float(alpha)
        self._backend = backend
        self._lock = threading.Lock()
        self._ladder = _pow2_ladder(self.max_batch)
        self._observed: dict[tuple[str, int], float] = {}   # EWMA seconds
        self._bounds: dict[tuple[str, int], float] = {}     # model seconds
        self._calibration = 1.0          # EWMA of observed / model bound
        self._calibrated = False
        self._chosen: dict[str, int] = {}        # bucket -> last flush size
        # §15: decision counters live in the metrics registry (the server
        # shares its own; a standalone controller mints a private one)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c_decisions = self.metrics.counter(
            "serve_controller_decisions_total")

    # ------------------------------------------------------------ cost model
    def _model_bound(self, key: str, req: FilterRequest, n: int) -> float:
        """Analytic lower bound (seconds) of this bucket's `n`-sized
        dispatch -- delegated to the request's workload class (§14; the
        filter workload prices its resolved §11 plan with the conv
        roofline), memoised per (bucket, n). A workload without a model
        contributes the observation floor until real dispatches land."""
        memo = (key, n)
        bound = self._bounds.get(memo)
        if bound is None:
            wl = self._workloads.get(req.workload)
            cost = (wl.model_bound(req, n, backend=self._backend)
                    if wl is not None else None)
            bound = max(cost if cost is not None else MIN_SERVICE_S,
                        MIN_SERVICE_S)
            self._bounds[memo] = bound
        return bound

    def predict_s(self, key: str, req: FilterRequest, n: int) -> float:
        """Predicted mean service time (seconds) of one `n`-sized dispatch
        of this bucket: observed EWMA > nearest-observed scaled by model
        ratio > calibrated model bound (cold start)."""
        with self._lock:
            obs = self._observed.get((key, n))
            if obs is not None:
                return obs
            bound = self._model_bound(key, req, n)
            # nearest observed size of the SAME bucket anchors the model:
            # scale its EWMA by the model-cost ratio between the two sizes
            anchors = [(m, t) for (k, m), t in self._observed.items()
                       if k == key]
            if anchors:
                m, t = min(anchors, key=lambda a: abs(a[0] - n))
                return t * bound / self._model_bound(key, req, m)
            return bound * self._calibration

    def observe(self, key: str, req: FilterRequest, n_traced: int,
                service_s: float) -> None:
        """Fold one measured dispatch (traced size `n_traced`, wall
        `service_s`) into the ledger and the global model calibration."""
        service_s = max(float(service_s), MIN_SERVICE_S)
        with self._lock:
            memo = (key, n_traced)
            old = self._observed.get(memo)
            self._observed[memo] = (
                service_s if old is None
                else (1 - self.alpha) * old + self.alpha * service_s)
            bound = self._model_bound(key, req, n_traced)
            ratio = service_s / bound
            self._calibration = (
                ratio if not self._calibrated
                else (1 - self.alpha) * self._calibration
                + self.alpha * ratio)
            self._calibrated = True

    # ---------------------------------------------------------- flush policy
    def params(self, key: str,
               queue: tuple[FilterRequest, ...]) -> tuple[int, float]:
        """The bucket's (flush_size, flush_delay_s) -- the FlushPolicy
        hook. Largest pow-2 batch whose predicted tail fits the tightest
        queued SLO budget; the leftover budget becomes the flush deadline.
        No SLO in the queue -> the static §10 pair."""
        slos = [r.slo for r in queue if r.slo is not None]
        if not slos or not queue:
            with self._lock:
                self._c_decisions.inc(kind="static")
                self._chosen[key] = self.max_batch
            return self.max_batch, self.max_delay_s
        req = queue[0]
        # remaining budget of the tightest SLO, measured from the oldest
        # queued request's own submission (its wait already spent budget)
        budget = min(slos) - req.submitted
        size = 1
        for n in self._ladder:
            if self.safety * self.predict_s(key, req, n) <= budget:
                size = n
            else:
                break
        tail = self.safety * self.predict_s(key, req, size)
        delay = max(0.0, budget - tail)
        with self._lock:
            self._c_decisions.inc(kind="slo")
            self._chosen[key] = size
        return size, delay

    @property
    def decisions(self) -> int:
        """params() calls that saw an SLO (registry-backed, §15)."""
        return self._c_decisions.value(kind="slo")

    @property
    def static_decisions(self) -> int:
        """params() calls that fell back to the static pair (§15)."""
        return self._c_decisions.value(kind="static")

    def stats(self) -> dict:
        """Operator snapshot: last chosen flush size per bucket, ledger
        occupancy, calibration factor, decision counters."""
        with self._lock:
            return {"chosen": dict(self._chosen),
                    "ledger": len(self._observed),
                    "calibration": round(self._calibration, 4),
                    "decisions": self.decisions,
                    "static_decisions": self.static_decisions}


def tightest_slo(queue: Iterable[FilterRequest]) -> float | None:
    """Smallest absolute SLO instant among `queue`, or None."""
    slos = [r.slo for r in queue if r.slo is not None]
    return min(slos) if slos else None


__all__ = ["AdaptiveBatchController", "DEFAULT_ALPHA", "DEFAULT_SAFETY",
           "MIN_SERVICE_S", "tightest_slo"]
