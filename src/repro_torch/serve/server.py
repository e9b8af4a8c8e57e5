"""`ImageFilterServer` -- the online serving loop (DESIGN.md §10) with the
§12 fault-tolerance surface, the §13 service-level machinery and the §15
observability layer, on the port's device.

Counterpart of `repro.serve.server`. One worker thread owns all device
dispatch, under an explicit `torch.cuda.device(...)` on the card; client
threads only validate and wait. `submit()` admits a request through the
backpressure gate, drops it into the shape-bucketed micro-batcher and
returns a `FilterFuture`; the worker sleeps until the earliest bucket
deadline (or a size trigger's notify), flushes every ready bucket through
the executor and fulfils the futures. Admission slots are held until
fulfilment, so `max_pending` bounds queued plus executing work in
weighted slots.

    with ImageFilterServer(ServerConfig(max_batch=8)) as srv:   # the card
        srv.warmup(shapes=[(480, 640)], filters=["gaussian5"])
        fut = srv.submit(img, "gaussian5", method="refmlm",
                         priority="high", tenant="cam-a", slo_ms=50.0)
        out = fut.result()  # CPU uint8, == apply_filter(img, ...).cpu()

`ServerConfig.device` takes the reference's `interpret=` place: `None` is
the CUDA card and raises without one (`core.platform.resolve_device`);
`device='cpu'` runs the kernels' plain versions, as the tests do. Every
dispatch ends in one synchronizing copy of its batch to host memory, so
served results are CPU tensors and a device error lands in the dispatch
that caused it.

Service levels (DESIGN.md §13), as the reference's: SLO-adaptive batching
(`adaptive=True`), priority classes and per-tenant weighted quotas, and
overload shedding of queued low-priority work (`overload_shed=True`).

Failure handling (DESIGN.md §12), as the reference's: deadline-expired
requests shed (`DeadlineExceeded`) instead of burning a dispatch,
executor faults bisect so only genuinely poisoned requests fail, and a
catch-all around every batch keeps the worker alive and flips the server
to the degraded state. Bisection isolates host-side and injected faults
(`repro_torch.runtime.fault`); a sticky CUDA fault (an illegal address,
a device-side assert) poisons the CUDA context for every later dispatch
and is out of its scope.

Execution modes, as the reference's: a request's `exec` (or
`ServerConfig.exec`) routes its bucket through `exec='local'`, 'sharded'
(over `ServerConfig.devices` of the server's device type) or 'streamed'
(in `ServerConfig.tile` tiles, `tile_batch` a call); the degraded-exec
ladder serves a scale-out bucket that keeps failing on the local path.
With `ServerConfig.pool` (one device-id tuple, int or None per member)
dispatch goes through `repro_torch.serve.pool.ExecutorPool`:
rendezvous-routed members over explicit device subsets, where a member
failing `drain_after` consecutive scale-out dispatches is probed and
rebuilt on its surviving devices or retired. On one card a pool is
`pool=((0,), (0,))`, two members on device 0.

Observability (DESIGN.md §15), as the reference's: one metrics registry
read under one lock by `stats()`, tracing (`trace=`: None, True, a JSONL
path or a `TraceRecorder`, the reference's schema), and dispatch profiling
against the roofline (`profile=True`, implied by tracing).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Sequence
from typing import Callable

import torch

from repro_torch.core.platform import resolve_device
from repro_torch.filters.pipeline import EXEC_MODES
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.profile import DispatchProfiler
from repro_torch.obs.trace import NOOP, resolve_trace
from repro_torch.serve.admission import (
    AdmissionGate,
    ServerClosed,
    ServerDegraded,
    ServerOverloaded,
)
from repro_torch.serve.batcher import MicroBatch, ShapeBucketedBatcher
from repro_torch.serve.controller import AdaptiveBatchController
from repro_torch.serve.executor import BatchExecutor, next_pow2
from repro_torch.serve.pool import ExecutorPool
from repro_torch.serve.request import (
    PRIORITIES,
    DeadlineExceeded,
    FilterFuture,
    FilterRequest,
)
from repro_torch.serve.workload import Workload, resolve_workloads
from repro_torch.tuning.cache import backend_key


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Serving policy knobs (flush triggers, backpressure, exec routing,
    §13 service levels, §15 observability)."""

    max_batch: int = 8              # size flush trigger / occupancy ceiling
    max_delay_ms: float = 2.0       # deadline flush trigger (oldest wait)
    max_pending: int = 256          # admission gate: in-flight weight bound
    admission_timeout_s: float = 10.0
    pad_pow2: bool = True           # round traced batch up to a power of two
    exec: str = "local"             # default execution mode
    device: str | torch.device | None = None   # None = the CUDA card
    devices: int | Sequence[int] | None = None  # sharded-exec mesh
    tile: tuple[int, int] = (256, 256)   # streamed-exec tile shape
    tile_batch: int = 8
    # ------------------------------- fault tolerance (DESIGN.md §12)
    default_deadline_ms: float | None = None  # per-request shed deadline
    fail_fast_degraded: bool = False    # degraded server refuses admission
    degrade_after: int = 2          # consecutive scale-out dispatch failures
    #                                 before a bucket falls back to local
    # ------------------------------- service levels (DESIGN.md §13)
    adaptive: bool = False          # SLO-driven per-bucket flush policy
    overload_shed: bool = False     # shed low-priority work for blocked
    #                                 admissions (off = strict backpressure)
    tenant_quota: int | None = None         # uniform per-tenant weight cap
    tenant_quotas: dict[str, int] | None = None  # per-tenant overrides
    plan_memo_max: int = 256        # LRU bound of the per-bucket plan memo
    pool: tuple | None = None       # elastic pool: one device-id tuple (or
    #                                 int / None) per member (DESIGN.md §13)
    drain_after: int = 3            # member consecutive scale-out failures
    #                                 before the pool probes and drains it
    # ------------------------------- workload classes (DESIGN.md §14)
    workloads: dict[str, Workload] | None = None  # extra classes beyond
    #                                 the built-in 'filter' (e.g. 'infer')
    # ------------------------------- observability (DESIGN.md §15)
    trace: object = None            # None | True | jsonl path | recorder
    profile: bool = False           # roofline drift profiling (tracing
    #                                 implies it)


class ImageFilterServer:
    """Shape-bucketed micro-batching server over the REFMLM datapath."""

    def __init__(self, config: ServerConfig | None = None, *,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.config = config or ServerConfig()
        if self.config.exec not in EXEC_MODES:
            raise ValueError(f"exec must be one of {EXEC_MODES}, got "
                             f"{self.config.exec!r}")
        # no card and no explicit device raises here, before any trace
        # file opens or any thread starts
        device = resolve_device(self.config.device)
        self._clock = clock
        self._workloads = resolve_workloads(self.config.workloads)
        # ---------------------------------------- §15 observability layer
        self.metrics = MetricsRegistry()
        self.trace = resolve_trace(self.config.trace, clock=clock)
        self._owns_trace = (self.trace is not NOOP
                            and self.trace is not self.config.trace)
        m = self.metrics
        self._c_submitted = m.counter("serve_submitted_total")
        self._c_served = m.counter("serve_served_total")
        self._c_failed = m.counter("serve_failed_total")
        self._c_shed = m.counter("serve_shed_total")
        self._c_fast_failed = m.counter("serve_fast_failed_total")
        self._c_errors = m.counter("serve_worker_errors_total")
        self._c_batches = m.counter("serve_batches_total")
        self._c_occupancy = m.counter("serve_batch_occupancy_total")
        self._h_latency = m.histogram("serve_request_latency_seconds")
        self._last_error: str | None = None
        # ------------------------------------------------ serving machinery
        self._gate = AdmissionGate(
            self.config.max_pending, self.config.admission_timeout_s, clock,
            tenant_quota=self.config.tenant_quota,
            tenant_quotas=self.config.tenant_quotas,
            on_wait=self._on_gate_wait if self.config.overload_shed else None,
            metrics=self.metrics)
        backend = backend_key(device)
        self._profiler = (DispatchProfiler(self.metrics, backend=backend)
                          if self.config.profile or self.trace.enabled
                          else None)
        self._controller = (
            AdaptiveBatchController(self.config.max_batch,
                                    self.config.max_delay_ms / 1e3,
                                    workloads=self._workloads,
                                    metrics=self.metrics,
                                    backend=backend)
            if self.config.adaptive else None)
        exec_kw = dict(
            device=device, pad_pow2=self.config.pad_pow2,
            tile=self.config.tile, tile_batch=self.config.tile_batch,
            degrade_after=self.config.degrade_after,
            plan_memo_max=self.config.plan_memo_max,
            workloads=self._workloads, metrics=self.metrics,
            trace=self.trace, profiler=self._profiler)
        if self.config.pool is not None:
            self._executor: BatchExecutor | ExecutorPool = ExecutorPool(
                self.config.pool, drain_after=self.config.drain_after,
                **exec_kw)
        else:
            self._executor = BatchExecutor(devices=self.config.devices,
                                           **exec_kw)
        self._batcher = ShapeBucketedBatcher(
            self.config.max_batch, self.config.max_delay_ms / 1e3, clock,
            policy=self._controller.params if self._controller else None,
            trace=self.trace)
        self._cond = threading.Condition()
        self._seq = 0
        self._closing = False
        self._drain = True
        self._healthy = True            # False once the worker catch-all fired
        self._shed_need = 0             # weight blocked at the gate (§13)
        if self.trace.enabled:
            # activate for the scope-stack emitters (§15): distribute
            # shard/tile dispatches and §12 fault injections land in the
            # same trace without holding a recorder reference
            obs_trace.push(self.trace)
        self._worker = threading.Thread(target=self._loop,
                                        name="repro-torch-serve-worker",
                                        daemon=True)
        self._worker.start()

    # ------------------------------------------------------------ client API
    def submit(self, img, filt: str, *, method: str = "refmlm",
               mult_impl: str = "auto", nbits: int = 8,
               exec: str | None = None,
               deadline_ms: float | None = None,
               timeout: float | None = None,
               priority: str = "normal", tenant: str = "default",
               slo_ms: float | None = None,
               workload: str = "filter") -> FilterFuture:
        """Admit one request; returns its `FilterFuture`.

        `workload` selects the §14 serving class ('filter' by default;
        extra classes come from `ServerConfig.workloads`), and `filt`
        names that workload's target -- a bank filter, or e.g. an infer
        model. Validation happens here, on the client thread, so a bad
        request fails fast instead of poisoning a coalesced batch: `exec`
        must be one of `EXEC_MODES`, `priority` a §13 class, and the
        payload must pass the workload's own validation (for 'filter': a
        known filter name, a known `mult_impl`, one 2-D or (H, W, 1)
        frame). Blocks
        while the server (or `tenant`'s quota) is out of weighted
        in-flight slots (up to `timeout`, then `ServerOverloaded` /
        `TenantOverQuota`).

        `deadline_ms` (default `config.default_deadline_ms`) is the §12
        shed deadline: if the request is still queued that long after
        admission, it is shed with `DeadlineExceeded` instead of being
        dispatched. `slo_ms` is the §13 latency target the adaptive
        controller sizes this bucket's flushes against (softer than a
        deadline: it shapes batching, it never sheds). On a degraded
        server with `fail_fast_degraded`, raises `ServerDegraded` without
        taking an admission slot.
        """
        t_sub = self._clock() if self.trace.enabled else 0.0
        exec_mode = self.config.exec if exec is None else exec
        if exec_mode not in EXEC_MODES:
            raise ValueError(f"exec must be one of {EXEC_MODES}, got "
                             f"{exec_mode!r}")
        if priority not in PRIORITIES:
            raise ValueError(f"priority must be one of {PRIORITIES}, got "
                             f"{priority!r}")
        wl = self._workloads.get(workload)
        if wl is None:
            raise ValueError(f"unknown workload {workload!r}; registered: "
                             f"{tuple(self._workloads)}")
        arr = wl.validate(img, target=filt, method=method,
                          mult_impl=mult_impl, exec_mode=exec_mode,
                          nbits=int(nbits))
        if self._closing:
            raise ServerClosed("server is closed")
        if self.config.fail_fast_degraded and not self._is_healthy():
            self._c_fast_failed.inc()
            raise ServerDegraded(
                "server is degraded; refusing admission (fail_fast_degraded)")
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        weight = wl.weight(arr)
        try:
            self._gate.acquire(weight, tenant, timeout)
        except Exception as err:
            if self.trace.enabled:
                # rejected admissions never get a seq: they ride the
                # stream as aux events, outside the exactly-once invariant
                self.trace.event("reject", ts=t_sub, tenant=tenant,
                                 priority=priority, workload=workload,
                                 target=filt, error=type(err).__name__)
            raise
        future = FilterFuture()
        with self._cond:
            if self._closing:
                self._gate.release(weight, tenant)
                raise ServerClosed("server is closed")
            self._seq += 1
            now = self._clock()
            deadline = None if deadline_ms is None else now + deadline_ms / 1e3
            slo = None if slo_ms is None else now + slo_ms / 1e3
            req = FilterRequest(img=arr, filt=filt, method=method,
                                mult_impl=mult_impl, exec=exec_mode,
                                nbits=int(nbits), future=future,
                                submitted=now, seq=self._seq,
                                deadline=deadline, priority=priority,
                                tenant=tenant, slo=slo, weight=weight,
                                workload=workload)
            if self.trace.enabled:
                # stamped with the instants buffered before the seq existed
                key = req.key
                self.trace.event("submit", ts=t_sub, seq=req.seq, bucket=key,
                                 priority=priority, tenant=tenant,
                                 workload=workload, exec=exec_mode,
                                 weight=weight)
                self.trace.event("admit", ts=now, seq=req.seq, bucket=key)
            self._batcher.add(req)
            self._c_submitted.inc()
            self._cond.notify_all()
        return future

    def warmup(self, shapes, filters=("gaussian3",), *, methods=("refmlm",),
               mult_impls=("auto",), execs=None, batches=(1,),
               nbits: int = 8, priorities=("normal",),
               workload: str = "filter") -> list[str]:
        """Run the cross product of serve points once (the kernel build,
        the ROM and plan caches); returns the warmed `serve_key`s (see
        `repro_torch.serve.warmup` for the CLI). `workload` picks the §14
        class being warmed; `filters` then names that workload's targets
        (infer model names for 'infer')."""
        from repro_torch.serve.warmup import sweep
        execs = (self.config.exec,) if execs is None else tuple(execs)
        for em in execs:
            if em not in EXEC_MODES:
                raise ValueError(f"exec must be one of {EXEC_MODES}, got {em!r}")
        return sweep(self._executor, shapes, filters, methods, mult_impls,
                     execs, batches, nbits=nbits, priorities=priorities,
                     workload=workload)

    def _is_healthy(self) -> bool:
        """Healthy = no worker catch-all error and no exec-mode fallback."""
        return self._healthy and not self._executor.degraded_mode

    def _on_gate_wait(self, weight: int) -> None:
        """The gate's §13 overload hint (called from a blocked submitter's
        thread, no gate lock held): record the blocked weight and wake the
        worker so it can shed low-priority queued work."""
        with self._cond:
            self._shed_need += max(1, int(weight))
            self._cond.notify_all()

    def stats(self) -> dict:
        """Counters + occupancy histogram + warm-cache ledger + the §12
        fault/health surface + the §13 service-level surface + the §15
        profile table.

        The request conservation counters (submitted / served / failed /
        shed / pending / rejected / tenants) are read under ONE registry
        lock (`metrics.hold()`, DESIGN.md §15), so the snapshot is
        consistent: `served + failed + shed + shed_overload <= submitted`
        holds no matter how the worker races this call. The executor /
        controller surfaces are monotonic operational detail read after
        the core snapshot (their own locks must stay outside the registry
        lock -- the §15 lock-order contract)."""
        with self.metrics.hold():
            served_priority = {p: self._c_served.value(priority=p)
                               for p in PRIORITIES}
            snap = {
                "submitted": self._c_submitted.value(),
                "served": sum(served_priority.values()),
                "failed": self._c_failed.value(),
                "shed": self._c_shed.value(cause="deadline"),
                "shed_overload": self._c_shed.value(cause="overload"),
                "fast_failed": self._c_fast_failed.value(),
                "errors": self._c_errors.value(),
                "last_error": self._last_error,
                "batches": self._c_batches.total(),
                "occupancy": {int(k): v for k, v in
                              self._c_occupancy.group_by("n").items()},
                "flush_reasons": self._c_batches.group_by("reason"),
                "served_priority": served_priority,
            }
            gate = self._gate.snapshot()     # registry-only reads (§15)
            snap["pending"] = gate["pending"]
            snap["pressure"] = gate["pressure"]
            snap["rejected"] = gate["rejected"]
            snap["tenants"] = gate["tenants"]
        ex = self._executor.stats()
        snap["compile"] = {"warmed": ex["warmed"], "hits": ex["hits"],
                           "misses": ex["misses"]}
        snap["plan_memo"] = ex["plan_memo"]
        if "pool" in ex:
            snap["pool"] = ex["pool"]
        if self._controller is not None:
            snap["controller"] = self._controller.stats()
        snap.update(self._executor.fault_stats())
        if self._profiler is not None:
            snap["profile"] = self._profiler.summary()
        snap["healthy"] = self._is_healthy()
        snap["state"] = "healthy" if snap["healthy"] else "degraded"
        return snap

    def close(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop the worker. `drain=True` flushes and serves everything still
        queued first; `drain=False` fails pending futures with
        `ServerClosed`."""
        with self._cond:
            if self._closing:
                self._worker.join(timeout)
                return
            self._closing = True
            self._drain = drain
            self._cond.notify_all()
        self._worker.join(timeout)
        if self.trace.enabled:
            obs_trace.pop(self.trace)
            if self._owns_trace:
                self.trace.close()       # flush the JSONL write-through

    def __enter__(self) -> "ImageFilterServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=True)

    # ---------------------------------------------------------- worker loop
    def _shed_for_overload(self) -> None:
        """Free queued low-priority weight for blocked admissions (§13).
        Caller holds `self._cond`; the swept requests surface through
        `take_shed()` with cause 'overload'."""
        if self._shed_need > 0:
            need, self._shed_need = self._shed_need, 0
            self._batcher.shed_overload(need)

    def _loop(self) -> None:
        device = self._executor.device
        with (torch.cuda.device(device) if device.type == "cuda"
              else contextlib.nullcontext()):
            self._serve()

    def _serve(self) -> None:
        while True:
            with self._cond:
                self._shed_for_overload()
                batches = self._batcher.ready(self._clock())
                shed = self._batcher.take_shed()
                while not batches and not shed and not self._closing:
                    deadline = self._batcher.next_deadline()
                    wait = (None if deadline is None
                            else max(deadline - self._clock(), 1e-4))
                    self._cond.wait(wait)
                    self._shed_for_overload()
                    batches = self._batcher.ready(self._clock())
                    shed = self._batcher.take_shed()
                closing = self._closing
                if closing and not batches:
                    batches = self._batcher.drain()
                    shed += self._batcher.take_shed()
                drain = self._drain
            self._fail_shed(shed)
            if closing and not drain:
                for b in batches:
                    self._fail_batch(b, ServerClosed("server closed undrained"))
                return
            for batch in batches:
                self._run(batch)
            if closing and not batches:
                return

    def _fail_shed(self, shed) -> None:
        """Fail swept requests and free their slots -- they never reach a
        dispatch. Cause 'deadline' is the §12 expiry path
        (`DeadlineExceeded`); cause 'overload' is the §13 load-shed path
        (`ServerOverloaded` -- their slots go to higher-priority work)."""
        if not shed:
            return
        for item in shed:
            req = item.request
            if not req.future.done():
                if item.cause == "overload":
                    req.future.set_exception(ServerOverloaded(
                        f"request seq={req.seq} shed under overload "
                        f"(priority {req.priority}, bucket {req.key})"))
                else:
                    req.future.set_exception(DeadlineExceeded(
                        f"request seq={req.seq} shed: deadline expired "
                        f"before dispatch (bucket {req.key})"))
                if self.trace.enabled:
                    self.trace.event("shed", seq=req.seq, bucket=req.key,
                                     cause=item.cause)
            self._gate.release(req.weight, req.tenant)
        with self.metrics.hold():
            for item in shed:
                self._c_shed.inc(cause=item.cause)

    def _release_batch(self, batch: MicroBatch) -> None:
        for req in batch.requests:
            self._gate.release(req.weight, req.tenant)

    def _fail_batch(self, batch: MicroBatch, err: BaseException) -> None:
        for req in batch.requests:
            if not req.future.done():
                req.future.set_exception(err)
                if self.trace.enabled:
                    self.trace.event("fail", seq=req.seq, bucket=batch.key,
                                     cause="closed", error=repr(err))
        self._release_batch(batch)

    def _run(self, batch: MicroBatch) -> None:
        t0 = self._clock()
        try:
            self._executor.run(batch)    # fulfils every future exactly once
        except BaseException as err:     # noqa: BLE001 -- §12 catch-all:
            # run() never raises by contract, but a serving-layer bug must
            # degrade the server, not hang its futures or leak its slots
            for req in batch.requests:
                if not req.future.done():
                    req.future.set_exception(err)
                    if self.trace.enabled:
                        self.trace.event("fail", seq=req.seq,
                                         bucket=batch.key, cause="worker",
                                         error=repr(err))
            with self._cond:
                self._healthy = False
            with self.metrics.hold():
                self._c_errors.inc()
                self._last_error = repr(err)
        now = self._clock()
        if self._controller is not None and batch.requests:
            # feed the §13 observed-service ledger with the traced batch
            # size this dispatch actually compiled for
            n = len(batch.requests)
            traced = next_pow2(n) if self.config.pad_pow2 else n
            self._controller.observe(batch.key, batch.requests[0], traced,
                                     now - t0)
        served = [r for r in batch.requests if not r.future.failed()]
        # one lock acquisition for the whole batch outcome (§15): a
        # concurrent stats() sees all of it or none of it
        with self.metrics.hold():
            self._c_batches.inc(reason=batch.reason)
            self._c_occupancy.inc(n=len(batch.requests))
            for r in served:
                self._c_served.inc(priority=r.priority)
            if len(batch.requests) - len(served):
                self._c_failed.inc(len(batch.requests) - len(served))
        for r in served:
            self._h_latency.observe(now - r.submitted, priority=r.priority)
        self._release_batch(batch)


__all__ = ["ImageFilterServer", "ServerConfig"]
