"""Shape-bucketed micro-batcher (DESIGN.md §10/§13).

Counterpart of `repro.serve.batcher`: plain Python, copied with the
imports renamed and the decisions kept the same.

Pure flush-policy state machine, deliberately free of threads and locks:
the server drives it under its own condition variable, and tests drive it
with a fake clock. Requests land in per-`bucket_key` FIFO queues -- one
bucket per (H, W) × filter × method × mult_impl × exec × nbits × priority,
the set of fields one `apply_filter` call can serve -- and a bucket
flushes as one `MicroBatch` when either trigger fires:

  * **size**     -- the bucket holds its flush size: pop exactly that
                    many, leaving any remainder with its original arrival
                    times (a hot bucket flushes continuously);
  * **deadline** -- the *oldest* request has waited out the bucket's
                    flush deadline: pop up to the flush size (latency
                    floor under light traffic);
  * **drain**    -- shutdown or an explicit flush: pop everything.

The flush size and deadline are **per bucket** since §13: an optional
`policy(key, queue) -> (flush_size, flush_delay_s)` hook -- the adaptive
batching controller (`repro_torch.serve.controller`) -- overrides the static
`max_batch` / `max_delay_s` pair, so a latency-tight bucket flushes small
and early while a bulk bucket coalesces wide. `max_batch` stays the hard
occupancy ceiling; a policy can only narrow it.

**Priority ordering** (§13): `ready()` and `drain()` return batches in
priority-rank order (high before normal before low, FIFO within a rank),
so one flush cycle dispatches latency-sensitive buckets first.

**Shedding** (DESIGN.md §12/§13): before triggers are evaluated, requests
whose own `deadline` has passed are swept out of their queues into the
shed list (`take_shed()`, cause 'deadline'), so an expired request never
burns a dispatch and never pads a coalesced batch -- the server fails its
future and releases its admission slot. `next_deadline()` accounts for
request deadlines too, so the worker wakes to shed promptly. Under
overload the server additionally calls `shed_overload(weight)`: queued
requests are swept newest-first from the *lowest* priority rank upward
(cause 'overload', the highest rank -- 'high' -- is never overload-shed)
until `weight` admission slots are freed, so low-priority work is dropped
before high-priority work degrades.

Exactly-once by construction: a request lives in exactly one bucket queue
until it is popped into exactly one `MicroBatch` *or* swept into the shed
list exactly once (asserted under concurrent mixed-shape load in
tests/test_serve.py and under chaos schedules in
tests/test_fault_tolerance.py).

Tracing (DESIGN.md §15): with a `trace=` recorder the batcher emits one
'enqueue' event per `add()` (stamped with the request's own submission
instant) and one 'flush' event per popped request (the flush reason and
batch size attached) -- the queue-wait segment of the per-request span.
The default `NOOP` recorder keeps tracing-off at one attribute test.
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from typing import Callable, NamedTuple

from repro_torch.obs.trace import NOOP
from repro_torch.serve.request import FilterRequest, PRIORITIES

FLUSH_REASONS = ("size", "deadline", "drain")

#: why a request was swept to the shed list (DESIGN.md §12/§13).
SHED_CAUSES = ("deadline", "overload")

#: per-bucket flush policy: (bucket_key, queue snapshot) ->
#: (flush_size, flush_delay_s). None = the static pair.
FlushPolicy = Callable[[str, tuple[FilterRequest, ...]], tuple[int, float]]


class MicroBatch(NamedTuple):
    """One flushed bucket slice, ready for the executor."""

    key: str                         # the shared bucket_key
    requests: tuple[FilterRequest, ...]
    reason: str                      # member of FLUSH_REASONS


class ShedRequest(NamedTuple):
    """One swept request plus why it was shed (member of SHED_CAUSES)."""

    request: FilterRequest
    cause: str


class ShapeBucketedBatcher:
    """Bucket queues + the flush triggers. Not thread-safe by design."""

    def __init__(self, max_batch: int, max_delay_s: float,
                 clock: Callable[[], float] = time.monotonic, *,
                 policy: FlushPolicy | None = None, trace=NOOP) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_delay_s < 0:
            raise ValueError(f"max_delay_s must be >= 0, got {max_delay_s}")
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self.clock = clock
        self.policy = policy
        self.trace = trace
        # insertion-ordered so equal deadlines flush in arrival order
        self._buckets: OrderedDict[str, deque[FilterRequest]] = OrderedDict()
        self._shed: list[ShedRequest] = []

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self._buckets.values())

    def _params(self, key: str, q: deque[FilterRequest]) -> tuple[int, float]:
        """The bucket's (flush_size, flush_delay_s): the policy's choice
        clamped to the static pair (a controller can only narrow -- the
        static `max_batch` stays the hard occupancy ceiling and
        `max_delay_s` the worst-case hold)."""
        if self.policy is None:
            return self.max_batch, self.max_delay_s
        size, delay = self.policy(key, tuple(q))
        return (min(max(1, int(size)), self.max_batch),
                min(max(0.0, float(delay)), self.max_delay_s))

    def _sweep_expired(self, now: float) -> None:
        """Move every expired request from its queue to the shed list."""
        for key in list(self._buckets):
            q = self._buckets[key]
            if not any(r.expired(now) for r in q):
                continue
            live = deque(r for r in q if not r.expired(now))
            self._shed.extend(ShedRequest(r, "deadline")
                              for r in q if r.expired(now))
            if live:
                self._buckets[key] = live
            else:
                del self._buckets[key]

    def shed_overload(self, weight: int) -> int:
        """Sweep queued requests into the shed list (cause 'overload')
        until at least `weight` admission slots are freed, newest-first
        from the lowest priority rank upward; the highest rank is never
        overload-shed. Returns the weight actually freed (may fall short
        when only protected work is queued)."""
        freed = 0
        for rank in range(len(PRIORITIES) - 1, 0, -1):
            for key in list(self._buckets):
                q = self._buckets[key]
                if not q or q[0].rank != rank:
                    continue
                while q and freed < weight:
                    r = q.pop()                      # newest first
                    self._shed.append(ShedRequest(r, "overload"))
                    freed += r.weight
                if not q:
                    del self._buckets[key]
                if freed >= weight:
                    return freed
        return freed

    def take_shed(self) -> list[ShedRequest]:
        """Requests swept since the last call (FIFO, with their shed
        cause); the caller owns failing their futures and releasing their
        admission slots."""
        shed, self._shed = self._shed, []
        return shed

    def add(self, req: FilterRequest) -> str:
        """Queue one admitted request; returns its bucket key."""
        key = req.key
        self._buckets.setdefault(key, deque()).append(req)
        if self.trace.enabled:
            self.trace.event("enqueue", ts=req.submitted, seq=req.seq,
                             bucket=key, priority=req.priority,
                             tenant=req.tenant, workload=req.workload,
                             weight=req.weight)
        return key

    def _pop(self, key: str, count: int, reason: str,
             now: float | None = None) -> MicroBatch:
        q = self._buckets[key]
        batch = tuple(q.popleft() for _ in range(min(count, len(q))))
        if not q:
            del self._buckets[key]
        if self.trace.enabled:
            ts = self.clock() if now is None else now
            for r in batch:
                self.trace.event("flush", ts=ts, seq=r.seq, bucket=key,
                                 reason=reason, n=len(batch))
        return MicroBatch(key, batch, reason)

    def _ordered_keys(self) -> list[str]:
        """Bucket keys in flush order: priority rank first (high flushes
        before low), insertion order within a rank (§13)."""
        keys = list(self._buckets)
        return sorted(keys, key=lambda k: self._buckets[k][0].rank)

    def ready(self, now: float | None = None) -> list[MicroBatch]:
        """All batches whose size or deadline trigger has fired at `now`,
        high-priority buckets first (expired requests are swept to the
        shed list beforehand, never batched)."""
        now = self.clock() if now is None else now
        self._sweep_expired(now)
        out = []
        for key in self._ordered_keys():
            while key in self._buckets:
                q = self._buckets[key]
                size, delay = self._params(key, q)
                if len(q) >= size:
                    out.append(self._pop(key, size, "size", now))
                elif now - q[0].submitted >= delay:
                    out.append(self._pop(key, size, "deadline", now))
                else:
                    break
        return out

    def next_deadline(self) -> float | None:
        """Earliest future instant a deadline trigger *or* a request-shed
        deadline can fire (the server's sleep bound), or None when nothing
        is pending."""
        cands = []
        for key, q in self._buckets.items():
            _, delay = self._params(key, q)
            cands.append(q[0].submitted + delay)
            cands.extend(r.deadline for r in q if r.deadline is not None)
        return min(cands) if cands else None

    def drain(self) -> list[MicroBatch]:
        """Flush every bucket regardless of triggers (shutdown path),
        high-priority buckets first. Expired requests still shed rather
        than flush: their deadline passed, so serving them on shutdown
        would violate it anyway."""
        now = self.clock()
        self._sweep_expired(now)
        out = []
        for key in self._ordered_keys():
            while key in self._buckets:
                out.append(self._pop(key, self.max_batch, "drain", now))
        return out


__all__ = ["FLUSH_REASONS", "SHED_CAUSES", "FlushPolicy", "MicroBatch",
           "ShapeBucketedBatcher", "ShedRequest"]
