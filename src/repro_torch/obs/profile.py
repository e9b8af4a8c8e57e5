"""Roofline-calibrated dispatch profiling (DESIGN.md §15).

The §13 controller and the §11 autotuner both *price* work with the
analytic conv roofline (`repro_torch.roofline.conv_model.plan_cost`, surfaced
per workload through `Workload.model_bound`) -- but until now nobody
measured how far reality drifts from those prices per bucket. The
`DispatchProfiler` closes that gap: the executor times every dispatch
(`time.perf_counter` around the workload's `execute`, which in the port
ends in one synchronizing copy of the batch to host memory, so the time
covers the device work and not only the kernel launches) and records the
**drift ratio** `observed_s / predicted_s` into a histogram keyed by
(bucket, resolved plan tag).

Drift semantics:

  * **ratio ~ 1** -- the model prices this bucket's plan well; the
    controller's cold-start predictions and the autotuner's pruning
    thresholds can be trusted for it.
  * **ratio >> 1** (right-hand buckets) -- the dispatch runs far over its
    analytic lower bound: host launch and copy cost, a cold kernel build
    caught in the timing, or a plan whose tile organization the model
    does not capture. Persistent high drift on one bucket is the signal
    to re-tune it (DESIGN.md §11) or to distrust its SLO sizing (§13).
  * **ratio < 1** -- the "lower bound" was beaten: the model is
    mis-pricing (e.g. a fused plan whose intermediate never materializes).

Predictions are memoised per (bucket, traced n) -- `model_bound` resolves
a §11 plan, which is not hot-path cheap -- and both sides land in the
owning `MetricsRegistry`:

    serve_dispatch_seconds{bucket,plan}        observed wall histogram
    serve_dispatch_drift{bucket,plan}          observed/predicted histogram
    serve_dispatch_predicted_seconds{bucket}   memoised model price (gauge)

`summary()` folds those into the per-(bucket, plan) table `stats()["profile"]`
reports and `benchmarks/serve_bench.py` turns into the drift bench rows.
Profiling shares tracing's cost contract: `ServerConfig(profile=False)`
means no profiler object at all, so the hot path pays one None test.
"""
from __future__ import annotations

import threading

from repro_torch.obs.metrics import MetricsRegistry

#: drift-ratio histogram bounds (log-ish ladder around 1.0x).
DRIFT_BUCKETS = (0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)

#: observed dispatch-wall histogram bounds (seconds).
SERVICE_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0,
                   3.0, 10.0)


class DispatchProfiler:
    """Times dispatches against their roofline price (DESIGN.md §15)."""

    def __init__(self, metrics: MetricsRegistry | None = None, *,
                 backend: str | None = None) -> None:
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.backend = backend
        self._lock = threading.Lock()
        self._predicted: dict[tuple[str, int], float | None] = {}
        self._drift = self.metrics.histogram("serve_dispatch_drift",
                                             buckets=DRIFT_BUCKETS)
        self._seconds = self.metrics.histogram("serve_dispatch_seconds",
                                               buckets=SERVICE_BUCKETS)
        self._price = self.metrics.gauge("serve_dispatch_predicted_seconds")

    # ------------------------------------------------------------ prediction
    def predicted(self, workload, key: str, req, traced_n: int
                  ) -> float | None:
        """The bucket's memoised roofline price at `traced_n` (seconds),
        or None when the workload has no cost model. Never raises into
        the dispatch path: a mis-priced bucket records observations only."""
        memo = (key, traced_n)
        with self._lock:
            if memo in self._predicted:
                return self._predicted[memo]
        try:
            bound = workload.model_bound(req, traced_n, backend=self.backend)
        except Exception:                                  # noqa: BLE001
            bound = None
        with self._lock:
            self._predicted[memo] = bound
        if bound is not None:
            self._price.set(bound, bucket=key, n=traced_n)
        return bound

    # ------------------------------------------------------------- recording
    def record(self, key: str, plan: str, predicted_s: float | None,
               observed_s: float) -> None:
        """Fold one timed dispatch into the (bucket, plan) histograms."""
        self._seconds.observe(observed_s, bucket=key, plan=plan)
        if predicted_s is not None and predicted_s > 0:
            self._drift.observe(observed_s / predicted_s,
                                bucket=key, plan=plan)

    # --------------------------------------------------------------- summary
    def summary(self) -> dict:
        """Drift table keyed "<bucket>|<plan>": observation count, mean
        observed wall, mean drift ratio, and the drift histogram --
        the `stats()["profile"]` payload and the bench-row source."""
        out: dict = {}
        for labels in self._seconds.labels():
            kv = dict(labels)
            sec = self._seconds.series(**kv)
            drift = self._drift.series(**kv)
            entry = {"bucket": kv.get("bucket", "?"),
                     "plan": kv.get("plan", "?"),
                     "n_obs": sec["count"],
                     "observed_mean_s": (sec["sum"] / sec["count"]
                                         if sec["count"] else 0.0)}
            if drift is not None and drift["count"]:
                entry["drift_mean"] = drift["sum"] / drift["count"]
                entry["drift_hist"] = drift["buckets"]
            out[f"{entry['bucket']}|{entry['plan']}"] = entry
        return out


__all__ = ["DRIFT_BUCKETS", "DispatchProfiler", "SERVICE_BUCKETS"]
