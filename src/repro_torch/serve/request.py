"""Request/response vocabulary of the serving layer (DESIGN.md §10/§13).

Counterpart of `repro.serve.request`: plain Python, copied with the
imports renamed and the decisions kept the same.

A `FilterRequest` is one client image plus its full datapath routing --
the bank filter, multiplier method, tap-product implementation, pixel
width and execution mode -- and, since §13, its *service level*: a
priority class, a tenant, and an optional latency SLO. The micro-batcher
coalesces concurrent requests whose `bucket_key` agrees -- same (H, W),
same routing, same priority class -- into one (N, H, W) batch riding the
§8 batch fold, so the key names exactly the fields that must match for
two requests to share one `apply_filter` call (and one compiled
executable). Results come back through a `FilterFuture`.

`serve_key` extends a bucket key with the coalesced batch size: it is the
warm-start cache key (shape bucket × filter × mult_impl × exec, plus the
padded N the dispatch actually runs with).

Service-level fields (DESIGN.md §13):

  * `priority`  -- one of `PRIORITIES` ('high' | 'normal' | 'low');
                   buckets are homogeneous in priority, high-priority
                   buckets flush first, and under overload low-priority
                   queued work is shed before high-priority work degrades;
  * `tenant`    -- the quota account the request's admission weight is
                   charged to (per-tenant in-flight caps, admission.py);
  * `slo`       -- absolute target-completion instant (admission clock
                   domain, from the client's `slo_ms`): the adaptive
                   batching controller (controller.py) picks the bucket's
                   flush size and deadline so its predicted p99 fits the
                   tightest queued SLO;
  * `weight`    -- admission slots this request occupies
                   (`request_weight`: ceil(pixels / WEIGHT_UNIT_PX), so a
                   satellite-sized frame cannot hide behind the same
                   single slot as a thumbnail).

A request may also carry an absolute `deadline` (admission clock domain):
requests still queued past it are *shed* at flush time with
`DeadlineExceeded` instead of burning a dispatch (DESIGN.md §12).
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

#: priority classes, most-important first. Buckets never mix classes.
PRIORITIES = ("high", "normal", "low")

#: priority -> flush/shed rank (lower flushes first, sheds last).
PRIORITY_RANK = {p: i for i, p in enumerate(PRIORITIES)}

#: pixels per admission slot for the weighted accounting (DESIGN.md §13):
#: one 128x128 request costs 1 slot, a 512x512 costs 16.
WEIGHT_UNIT_PX = 128 * 128


def request_weight(h: int, w: int) -> int:
    """Weighted admission slots one (h, w) request occupies (>= 1)."""
    return max(1, -(-int(h) * int(w) // WEIGHT_UNIT_PX))


class DeadlineExceeded(RuntimeError):
    """The request's deadline expired while it was still queued; it was
    shed at flush time without being dispatched (DESIGN.md §12)."""


def bucket_key(filt: str, method: str, mult_impl: str, exec_mode: str,
               nbits: int, h: int, w: int, priority: str = "normal",
               workload: str = "filter") -> str:
    """Coalescing key: requests sharing it may ride one micro-batch.
    Priority is part of the key (DESIGN.md §13): classes never coalesce,
    so shedding or deprioritising 'low' can never touch a 'high' batch.
    A non-default workload class (DESIGN.md §14) is appended as a suffix --
    filter keys keep their historical spelling, and the exec mode stays
    the 4th segment (the pool's `_native_mode` contract) -- so distinct
    workloads can never share a batch."""
    key = (f"{filt}/{method}/{mult_impl}/{exec_mode}/b{nbits}/{h}x{w}"
           f"/{priority}")
    return key if workload == "filter" else f"{key}/{workload}"


def serve_key(bucket: str, n: int) -> str:
    """Warm compile-cache key: one per (bucket, traced batch size)."""
    return f"{bucket}/n{n}"


class FilterFuture:
    """Synchronous future fulfilled by the server's worker thread.

    Exactly one of `set_result` / `set_exception` is ever called (the
    batcher's exactly-once guarantee, asserted in tests/test_serve.py);
    `result()` blocks until then and re-raises any server-side failure.
    `done()` / `failed()` / `exception()` are the public, non-blocking
    outcome API the server's per-request accounting reads (DESIGN.md §12).
    """

    __slots__ = ("_event", "_value", "_error")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._value: np.ndarray | None = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        """True once the future is fulfilled (result or exception)."""
        return self._event.is_set()

    def failed(self) -> bool:
        """True iff fulfilled with an exception. Never blocks."""
        return self._event.is_set() and self._error is not None

    def exception(self) -> BaseException | None:
        """The fulfilment exception, or None (unfulfilled or succeeded)."""
        return self._error if self._event.is_set() else None

    def set_result(self, value: np.ndarray) -> None:
        assert not self._event.is_set(), "future fulfilled twice"
        self._value = value
        self._event.set()

    def set_exception(self, err: BaseException) -> None:
        assert not self._event.is_set(), "future fulfilled twice"
        self._error = err
        self._event.set()

    def result(self, timeout: float | None = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError("filter request still pending")
        if self._error is not None:
            raise self._error
        assert self._value is not None
        return self._value


@dataclasses.dataclass
class FilterRequest:
    """One admitted request: the image, its routing, and its future."""

    img: np.ndarray              # (H, W) grayscale, any integer dtype
    filt: str
    method: str
    mult_impl: str
    exec: str
    nbits: int
    future: FilterFuture
    submitted: float             # admission clock() -- the flush deadline base
    seq: int                     # admission order (FIFO within a bucket)
    deadline: float | None = None   # absolute shed deadline (clock domain)
    priority: str = "normal"     # member of PRIORITIES (DESIGN.md §13)
    tenant: str = "default"      # quota account (admission.py)
    slo: float | None = None     # absolute SLO instant (controller target)
    weight: int = 1              # weighted admission slots (request_weight)
    workload: str = "filter"     # serving workload class (DESIGN.md §14)

    @property
    def key(self) -> str:
        h, w = self.img.shape
        return bucket_key(self.filt, self.method, self.mult_impl, self.exec,
                          self.nbits, h, w, self.priority, self.workload)

    @property
    def rank(self) -> int:
        """Flush/shed rank of the request's priority class (0 = high)."""
        return PRIORITY_RANK[self.priority]

    def expired(self, now: float) -> bool:
        """True when the request carries a deadline that has passed."""
        return self.deadline is not None and now >= self.deadline


__all__ = ["DeadlineExceeded", "FilterFuture", "FilterRequest", "PRIORITIES",
           "PRIORITY_RANK", "WEIGHT_UNIT_PX", "bucket_key", "request_weight",
           "serve_key"]
