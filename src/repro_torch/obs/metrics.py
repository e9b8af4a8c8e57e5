"""Thread-safe bounded metrics registry (DESIGN.md §15).

Counterpart of `repro.obs.metrics`: plain Python, copied with the
imports renamed and the decisions kept the same.

One `MetricsRegistry` replaces the serving layer's scattered ad-hoc dict
counters (`server._stats`, the executor's warm/plan ledgers, the gate's
rejection tallies, the pool's health counts): every component writes
named counters/gauges/histograms with small label sets into one registry,
and `snapshot()` reads them all under ONE lock -- which is what makes
`server.stats()` a *consistent* snapshot. Previously a flush landing
between two reads could report `served + failed + shed > submitted`;
with every conservation counter in one registry and batch outcomes
applied inside one `hold()`, the accounting identity

    submitted >= served + failed + shed + shed_overload

holds at every observable instant (tests/test_obs.py).

Design points:

  * **get-or-create handles** -- `registry.counter("serve_served_total")`
    returns the same `Counter` every time; handles share the registry's
    re-entrant lock, so a multi-metric update wrapped in `hold()` is
    atomic with respect to `snapshot()`.
  * **label sets** -- each update names labels
    (`c.inc(priority="high")`); one (metric, sorted-labels) pair is one
    *series*. `value()` reads one series, `total()` sums a metric,
    `group_by("label")` folds series into the historical dict shapes
    (`occupancy`, `flush_reasons`, ...) `stats()` has always reported.
  * **bounded** -- the registry caps total live series (`max_series`);
    updates that would mint a series past the cap are dropped and
    counted in `dropped_series` instead of growing memory without limit
    (the plan-memo LRU lesson of DESIGN.md §13 applied to telemetry).
  * **histograms** -- fixed bucket bounds chosen at creation; `observe`
    is O(buckets). The §15 drift histograms (`repro_torch.obs.profile`) and
    request-latency histograms live here.

The registry is plain bookkeeping on the caller's thread -- no I/O, no
background thread -- so leaving it always-on costs what the old dict
counters cost. Lock-order contract: the registry lock is INNERMOST.
Components may update metrics while holding their own locks; nothing in
this module ever calls back out, so it can never participate in a lock
cycle.
"""
from __future__ import annotations

import threading
from typing import Iterable

#: default bound on live (metric, label-set) series per registry.
DEFAULT_MAX_SERIES = 4096

#: default histogram bucket upper bounds (seconds-flavored: 100us..10s).
DEFAULT_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0,
                   3.0, 10.0)


def _series_key(labels: dict) -> tuple:
    """Canonical hashable series key: sorted (label, value) pairs."""
    return tuple(sorted(labels.items()))


def _series_name(key: tuple) -> str:
    """Human/JSON spelling of a series key ('' for the unlabeled one)."""
    return ",".join(f"{k}={v}" for k, v in key)


class _Metric:
    """Shared handle plumbing: one named metric, many labeled series."""

    kind = "metric"

    def __init__(self, registry: "MetricsRegistry", name: str) -> None:
        self.registry = registry
        self.name = name
        self._series: dict[tuple, object] = {}

    def _slot(self, labels: dict, default):
        """The series' mutable slot, or None when the registry is at its
        series cap (the update is then dropped and counted). Caller holds
        the registry lock."""
        key = _series_key(labels)
        slot = self._series.get(key)
        if slot is None:
            if not self.registry._admit_series():
                return None
            slot = self._series[key] = default()
        return slot

    def labels(self) -> list[tuple]:
        with self.registry._lock:
            return list(self._series)


class Counter(_Metric):
    """Monotonic counter with label sets."""

    kind = "counter"

    def inc(self, amount: float = 1, **labels) -> None:
        with self.registry._lock:
            key = _series_key(labels)
            if key in self._series:
                self._series[key] += amount          # type: ignore[operator]
            elif self.registry._admit_series():
                self._series[key] = amount

    def value(self, **labels):
        """One series' value (0 when it never incremented)."""
        with self.registry._lock:
            return self._series.get(_series_key(labels), 0)

    def total(self, **fixed):
        """Sum over every series matching the `fixed` label subset."""
        with self.registry._lock:
            fixed_items = set(fixed.items())
            return sum(v for k, v in self._series.items()
                       if fixed_items <= set(k))

    def group_by(self, label: str, **fixed) -> dict:
        """Fold matching series into {label_value: summed value} -- the
        bridge back to the historical `stats()` dict shapes."""
        with self.registry._lock:
            fixed_items = set(fixed.items())
            out: dict = {}
            for key, v in self._series.items():
                if not fixed_items <= set(key):
                    continue
                kv = dict(key)
                if label in kv:
                    out[kv[label]] = out.get(kv[label], 0) + v
            return out


class Gauge(_Metric):
    """Last-write-wins (or add/sub) instantaneous value."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self.registry._lock:
            key = _series_key(labels)
            if key in self._series or self.registry._admit_series():
                self._series[key] = value

    def add(self, delta: float, **labels) -> None:
        with self.registry._lock:
            key = _series_key(labels)
            if key in self._series:
                self._series[key] += delta           # type: ignore[operator]
            elif self.registry._admit_series():
                self._series[key] = delta

    def value(self, **labels):
        with self.registry._lock:
            return self._series.get(_series_key(labels), 0)

    def group_by(self, label: str, **fixed) -> dict:
        with self.registry._lock:
            fixed_items = set(fixed.items())
            out: dict = {}
            for key, v in self._series.items():
                if not fixed_items <= set(key):
                    continue
                kv = dict(key)
                if label in kv:
                    out[kv[label]] = out.get(kv[label], 0) + v
            return out


class Histogram(_Metric):
    """Fixed-bound histogram; one (count, sum, bucket-counts) per series."""

    kind = "histogram"

    def __init__(self, registry: "MetricsRegistry", name: str,
                 buckets: Iterable[float] = DEFAULT_BUCKETS) -> None:
        super().__init__(registry, name)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")

    def observe(self, value: float, **labels) -> None:
        with self.registry._lock:
            slot = self._slot(
                labels, lambda: [0, 0.0, [0] * (len(self.buckets) + 1)])
            if slot is None:
                return
            slot[0] += 1
            slot[1] += value
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    slot[2][i] += 1
                    break
            else:
                slot[2][-1] += 1                     # the +inf bucket

    def series(self, **labels) -> dict | None:
        """One series' {count, sum, buckets} snapshot, or None."""
        with self.registry._lock:
            slot = self._series.get(_series_key(labels))
            if slot is None:
                return None
            return self._render(slot)

    def _render(self, slot) -> dict:
        buckets = {f"le_{b:g}": n for b, n in zip(self.buckets, slot[2])}
        buckets["le_inf"] = slot[2][-1]
        return {"count": slot[0], "sum": slot[1], "buckets": buckets}


class MetricsRegistry:
    """The one place serving telemetry lives (DESIGN.md §15)."""

    def __init__(self, max_series: int = DEFAULT_MAX_SERIES) -> None:
        self.max_series = max(int(max_series), 1)
        self._lock = threading.RLock()
        self._metrics: dict[str, _Metric] = {}
        self._n_series = 0
        self.dropped_series = 0

    # ------------------------------------------------------------- handles
    def _get(self, name: str, kind, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = kind(self, name, **kw)
            elif not isinstance(m, kind):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, not {kind.kind}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, Histogram, buckets=buckets)

    def _admit_series(self) -> bool:
        """Mint one series slot, or refuse at the cap (caller holds the
        lock). Refused updates are counted, never raised: telemetry must
        not fail serving."""
        if self._n_series >= self.max_series:
            self.dropped_series += 1
            return False
        self._n_series += 1
        return True

    # ------------------------------------------------------------ snapshot
    def hold(self):
        """Re-entrant lock context: wrap multi-metric updates (or reads)
        that must be atomic with respect to `snapshot()` -- the §15
        consistent-snapshot primitive `server.stats()` is built on."""
        return self._lock

    def snapshot(self) -> dict:
        """Every series of every metric, read under one lock acquisition."""
        with self._lock:
            counters: dict = {}
            gauges: dict = {}
            histograms: dict = {}
            for name, m in sorted(self._metrics.items()):
                if isinstance(m, Histogram):
                    histograms[name] = {
                        _series_name(k): m._render(slot)
                        for k, slot in m._series.items()}
                elif isinstance(m, Counter):
                    counters[name] = {_series_name(k): v
                                      for k, v in m._series.items()}
                else:
                    gauges[name] = {_series_name(k): v
                                    for k, v in m._series.items()}
            return {"counters": counters, "gauges": gauges,
                    "histograms": histograms, "series": self._n_series,
                    "dropped_series": self.dropped_series}


__all__ = ["Counter", "DEFAULT_BUCKETS", "DEFAULT_MAX_SERIES", "Gauge",
           "Histogram", "MetricsRegistry"]
