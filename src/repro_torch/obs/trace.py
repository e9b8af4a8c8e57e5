"""Per-request trace spans for the serving stack (DESIGN.md §15).

Counterpart of `repro.obs.trace`: plain Python, copied with the
imports renamed and the decisions kept the same.

A trace is a flat, timestamped event stream covering one request's whole
life across the §10-§14 machinery:

    submit -> admit -> enqueue -> flush -> dispatch -> fulfil | shed | fail

Every event is one small dict: `ts` (the recorder's clock), `event` (the
stage name), `seq` (the request's admission sequence number -- the span
id), plus stage context (bucket key, priority, tenant, workload, exec
mode, the resolved §11 plan tag on dispatch, the flush reason, the shed
cause, ...). Non-request events ride the same stream with `seq=None`:
admission rejections, §12 fault injections (`runtime/fault.py` tags every
firing), per-shard and per-tile scale-out dispatches
(`distribute/sharded.py` / `streamed.py`), and infer jit-memo activity.

Two recorders:

  * `NOOP` -- the zero-cost-when-off contract: `enabled` is False and
    every instrumented site guards on it before building a field dict,
    so tracing off costs one attribute test per site.
  * `TraceRecorder` -- in-memory ring (bounded at `max_events`; overflow
    is counted, never grown) with optional write-through JSONL
    (`path=`). Exports: `write_jsonl()` (one event per line, the
    `python -m repro_torch.obs.snapshot` input) and `write_chrome()` (Chrome
    trace-event JSON: open the file in https://ui.perfetto.dev and every
    bucket becomes a track of queued/dispatch slices).

Sites that don't hold a recorder reference (the distribute shard/tile
loops, the fault injector) publish through the module-level scope stack,
mirroring `runtime.fault`'s `_ACTIVE` pattern: `ImageFilterServer` pushes
its recorder for its lifetime, tests use `trace_scope(rec)`, and `emit()`
is a no-op list check when nothing is active.

Invariants (tests/test_obs.py; `scripts/check.sh --smoke-obs`):
every submitted request's span carries exactly one terminal event
(fulfil / shed / fail), and its stage timestamps are monotone in the
order above. Tracing never touches payload bytes -- served outputs stay
bit-identical with tracing on.
"""
from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from typing import Iterator

#: request life-cycle stages, in span order.
STAGES = ("submit", "admit", "enqueue", "flush", "dispatch",
          "fulfil", "shed", "fail")

#: exactly one of these ends every submitted request's span.
TERMINALS = ("fulfil", "shed", "fail")

#: non-request event kinds sharing the stream (seq=None or contextual).
AUX_EVENTS = ("reject", "fault", "shard", "tile", "infer")

#: in-memory event bound; overflow increments `dropped`, never grows.
DEFAULT_MAX_EVENTS = 200_000


class NoopRecorder:
    """Tracing off: one attribute test per instrumented site."""

    enabled = False

    def event(self, name: str, **fields) -> None:
        pass


#: the shared off-switch -- `ServerConfig(trace=None)` resolves to this.
NOOP = NoopRecorder()


class TraceRecorder:
    """Bounded in-memory trace with optional JSONL write-through."""

    enabled = True

    def __init__(self, path: str | None = None, *,
                 clock=time.monotonic,
                 max_events: int = DEFAULT_MAX_EVENTS) -> None:
        self.clock = clock
        self.path = None if path is None else str(path)
        self.max_events = max(int(max_events), 1)
        self.dropped = 0
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._file = None
        if self.path is not None:
            self._file = open(self.path, "w", encoding="utf-8")

    # ------------------------------------------------------------ recording
    def event(self, name: str, *, ts: float | None = None, **fields) -> None:
        """Append one event. `ts=None` stamps the recorder's clock;
        callers that observed the instant earlier (e.g. `submit` buffered
        until the seq exists) pass it explicitly. Thread-safe; never
        raises into the serving path."""
        if ts is None:
            ts = self.clock()
        ev = {"ts": ts, "event": name}
        ev.update(fields)
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(ev)
            if self._file is not None:
                try:
                    self._file.write(json.dumps(ev, default=str) + "\n")
                except (OSError, ValueError):
                    pass

    @classmethod
    def from_events(cls, events: list[dict]) -> "TraceRecorder":
        """Rehydrate a recorder from an exported event list (the
        `repro_torch.obs.snapshot` CLI reading a JSONL trace back)."""
        rec = cls(max_events=max(len(events), 1))
        rec._events = [dict(ev) for ev in events]
        return rec

    # -------------------------------------------------------------- reading
    def events(self, name: str | None = None) -> list[dict]:
        """Snapshot of recorded events (optionally one kind), in record
        order. Events carry explicit `ts`, so record order is advisory."""
        with self._lock:
            evs = list(self._events)
        if name is None:
            return evs
        return [e for e in evs if e["event"] == name]

    def spans(self) -> dict[int, list[dict]]:
        """Per-request event groups: {seq: events sorted by (ts, stage
        order)}. Events without a seq (rejections, faults, shard/tile
        detail) are excluded -- `events()` has them."""
        order = {s: i for i, s in enumerate(STAGES)}
        out: dict[int, list[dict]] = {}
        for ev in self.events():
            seq = ev.get("seq")
            if seq is None:
                continue
            out.setdefault(seq, []).append(ev)
        for evs in out.values():
            evs.sort(key=lambda e: (e["ts"], order.get(e["event"], 99)))
        return out

    def summary(self) -> dict:
        """Operator roll-up: event counts, terminal accounting, and
        per-bucket queue-wait / dispatch-to-terminal extents (seconds)."""
        evs = self.events()
        counts: dict[str, int] = {}
        for ev in evs:
            counts[ev["event"]] = counts.get(ev["event"], 0) + 1
        spans = self.spans()
        terminals = {s: 0 for s in TERMINALS}
        waits: dict[str, list[float]] = {}
        services: dict[str, list[float]] = {}
        for seq, events in spans.items():
            by = {e["event"]: e for e in events}
            for t in TERMINALS:
                if t in by:
                    terminals[t] += 1
            bucket = next((e["bucket"] for e in events if "bucket" in e), "?")
            if "enqueue" in by and "flush" in by:
                waits.setdefault(bucket, []).append(
                    by["flush"]["ts"] - by["enqueue"]["ts"])
            term = next((by[t] for t in TERMINALS if t in by), None)
            if "dispatch" in by and term is not None:
                services.setdefault(bucket, []).append(
                    term["ts"] - by["dispatch"]["ts"])
        return {"events": counts, "spans": len(spans),
                "terminals": terminals, "dropped": self.dropped,
                "queue_wait_s": {k: _extent(v) for k, v in waits.items()},
                "dispatch_s": {k: _extent(v) for k, v in services.items()}}

    # ------------------------------------------------------------- exporting
    def write_jsonl(self, path: str) -> int:
        """One JSON event per line; returns the event count."""
        evs = self.events()
        with open(path, "w", encoding="utf-8") as f:
            for ev in evs:
                f.write(json.dumps(ev, default=str) + "\n")
        return len(evs)

    def write_chrome(self, path: str) -> int:
        """Chrome trace-event JSON (Perfetto-loadable); returns the slice
        count. See `chrome_trace` for the layout."""
        doc = chrome_trace(self.events())
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        return len(doc["traceEvents"])

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                finally:
                    self._file = None

    def __enter__(self) -> "TraceRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _extent(vals: list[float]) -> dict:
    return {"n": len(vals), "min": min(vals), "max": max(vals),
            "mean": sum(vals) / len(vals)}


def chrome_trace(events: list[dict]) -> dict:
    """Fold a flat event list into Chrome trace-event JSON: one Perfetto
    track (tid) per bucket; per request a 'queued' slice (enqueue->flush)
    and a 'dispatch' slice (dispatch->terminal), sheds/fails/faults as
    instant markers. Timestamps are microseconds relative to the earliest
    event (Perfetto renders absolute monotonic epochs poorly)."""
    order = {s: i for i, s in enumerate(STAGES)}
    spans: dict[int, list[dict]] = {}
    aux: list[dict] = []
    t0 = min((e["ts"] for e in events), default=0.0)
    for ev in events:
        if ev.get("seq") is not None and ev["event"] in order:
            spans.setdefault(ev["seq"], []).append(ev)
        else:
            aux.append(ev)

    tids: dict[str, int] = {}

    def tid_for(bucket: str) -> int:
        return tids.setdefault(bucket, len(tids) + 1)

    def us(ts: float) -> float:
        return (ts - t0) * 1e6

    out: list[dict] = []
    for seq, evs in sorted(spans.items()):
        by: dict[str, dict] = {}
        for ev in sorted(evs, key=lambda e: (e["ts"],
                                             order.get(e["event"], 99))):
            by.setdefault(ev["event"], ev)
        bucket = next((e.get("bucket") for e in evs if e.get("bucket")), "?")
        tid = tid_for(bucket)
        args = {k: v for k, v in by.get("submit", by.get("enqueue", {})).items()
                if k not in ("ts", "event")}
        if "enqueue" in by and "flush" in by:
            out.append({"name": f"queued seq={seq}", "cat": "queue",
                        "ph": "X", "ts": us(by["enqueue"]["ts"]),
                        "dur": max(us(by["flush"]["ts"])
                                   - us(by["enqueue"]["ts"]), 0.0),
                        "pid": 1, "tid": tid, "args": args})
        term = next((by[t] for t in TERMINALS if t in by), None)
        if "dispatch" in by and term is not None:
            d_args = dict(args)
            d_args.update({k: v for k, v in by["dispatch"].items()
                           if k not in ("ts", "event")})
            out.append({"name": f"dispatch seq={seq}",
                        "cat": f"dispatch.{term['event']}", "ph": "X",
                        "ts": us(by["dispatch"]["ts"]),
                        "dur": max(us(term["ts"])
                                   - us(by["dispatch"]["ts"]), 0.0),
                        "pid": 1, "tid": tid, "args": d_args})
        for kind in ("shed", "fail"):
            if kind in by:
                out.append({"name": f"{kind} seq={seq}", "cat": kind,
                            "ph": "i", "ts": us(by[kind]["ts"]), "s": "t",
                            "pid": 1, "tid": tid, "args": args})
    for ev in aux:
        out.append({"name": ev["event"], "cat": "aux", "ph": "i",
                    "ts": us(ev["ts"]), "s": "g", "pid": 1, "tid": 0,
                    "args": {k: v for k, v in ev.items()
                             if k not in ("ts", "event")}})
    meta = [{"name": "thread_name", "ph": "M", "pid": 1, "tid": 0,
             "args": {"name": "events"}}]
    meta += [{"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
              "args": {"name": bucket}}
             for bucket, tid in sorted(tids.items(), key=lambda kv: kv[1])]
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


# --------------------------------------------------------------- scope stack
#: Active recorder stack -- shared across threads on purpose, exactly like
#: `runtime.fault._ACTIVE`: the server (or a test scope) activates its
#: recorder; the distribute shard/tile loops and the fault injector emit
#: into every active recorder without holding a reference.
_ACTIVE: list = []


def push(recorder) -> None:
    """Activate `recorder` for module-level `emit()` until `pop()`."""
    _ACTIVE.append(recorder)


def pop(recorder) -> None:
    if recorder in _ACTIVE:
        _ACTIVE.remove(recorder)


@contextmanager
def trace_scope(recorder) -> Iterator:
    """Scoped activation (the test-facing spelling of push/pop)."""
    push(recorder)
    try:
        yield recorder
    finally:
        pop(recorder)


def tracing() -> bool:
    """True when any recorder is active -- instrumented sites guard field
    construction on this, keeping tracing-off zero cost."""
    return bool(_ACTIVE)


def emit(name: str, **fields) -> None:
    """Record one event into every active recorder (no-op when none)."""
    if _ACTIVE:
        for rec in list(_ACTIVE):
            rec.event(name, **fields)


def resolve_trace(spec, *, clock=time.monotonic):
    """`ServerConfig.trace` -> a recorder: None/False -> `NOOP`, True ->
    in-memory `TraceRecorder`, a path string -> write-through JSONL, an
    existing recorder object (anything with `.event`) -> itself."""
    if spec is None or spec is False:
        return NOOP
    if spec is True:
        return TraceRecorder(clock=clock)
    if isinstance(spec, str):
        return TraceRecorder(spec, clock=clock)
    if hasattr(spec, "event"):
        return spec
    raise TypeError(f"trace must be None, bool, a path, or a recorder; "
                    f"got {type(spec).__name__}")


__all__ = ["AUX_EVENTS", "DEFAULT_MAX_EVENTS", "NOOP", "NoopRecorder",
           "STAGES", "TERMINALS", "TraceRecorder", "chrome_trace", "emit",
           "pop", "push", "resolve_trace", "trace_scope", "tracing"]
