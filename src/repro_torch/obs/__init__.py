"""`repro_torch.obs` -- unified serving telemetry (DESIGN.md §15).

Counterpart of `repro.obs`: plain Python, copied with the imports renamed.
The trace's JSONL schema is the reference's, so `repro.obs.snapshot` reads
the port's traces and this package's `snapshot` reads the reference's.

Three cooperating pieces, all optional-by-default and zero-cost when off:

  metrics.py  -- `MetricsRegistry`: thread-safe bounded
                 counters/gauges/histograms with label sets. The serving
                 layer's one source of operational truth: every counter
                 that used to live in an ad-hoc dict (server, admission
                 gate, batcher outcomes, executor ledgers, controller,
                 pool) now lives here, and `server.stats()` reads them
                 under ONE lock -- a consistent snapshot by construction.
  trace.py    -- per-request spans (`submit -> admit -> enqueue -> flush
                 -> dispatch -> fulfil|shed|fail`) plus fault/shard/tile/
                 infer events on the same stream; JSONL and Perfetto
                 (Chrome trace-event) export; `NOOP` when off.
  profile.py  -- `DispatchProfiler`: every dispatch timed against its
                 roofline price (`Workload.model_bound`), drift histogram
                 per (bucket, plan).

Operator CLI: `python -m repro_torch.obs.snapshot trace.jsonl [--chrome out]`.

Wiring: `ServerConfig(trace=..., profile=True)` on `ImageFilterServer`
(DESIGN.md §10/§15); standalone components accept `metrics=`/`trace=`
and default to private registries / the no-op recorder.
"""
from __future__ import annotations

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.profile import DispatchProfiler
from repro_torch.obs.trace import (
    NOOP,
    STAGES,
    TERMINALS,
    NoopRecorder,
    TraceRecorder,
    chrome_trace,
    emit,
    resolve_trace,
    trace_scope,
    tracing,
)

__all__ = [
    "NOOP",
    "STAGES",
    "TERMINALS",
    "Counter",
    "DispatchProfiler",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NoopRecorder",
    "TraceRecorder",
    "chrome_trace",
    "emit",
    "resolve_trace",
    "trace_scope",
    "tracing",
]
