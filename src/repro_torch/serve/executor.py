"""Micro-batch executor: flushed buckets -> the filter datapath
(DESIGN.md §10), with the failure-isolation machinery of DESIGN.md §12.

Counterpart of `repro.serve.executor`, on the port's device. One
`MicroBatch` becomes one workload dispatch (DESIGN.md §14): for the
default filter workload one `apply_filter` call on the executor's torch
device, where the requests stack into an (N, H, W) batch and split back
per request; for the infer workload one batched quantized forward pass
(`repro_torch.infer.serving`). A dispatch ends in one synchronizing copy of
the batch to host memory, inside the bisection's `try`: a device error is
raised in the dispatch it belongs to, and the profiler and the controller
time device work, not launches. Served outputs are CPU tensors, the same
bytes whichever coalesced batch served them (each image gets its own zero
padding).

Two steady-state amortisations:

  * **per-bucket plan resolution** -- the plan (dataflow and resolved
    mult_impl, `repro_torch.filters.resolve_filter_plan`) of a (bucket,
    traced batch size) is resolved once and pinned on every dispatch, with
    the tile its route launches (`plan_tile`) for the trace and drift
    labels. The memo is an LRU bounded at `plan_memo_max` entries and
    follows `repro_torch.tuning.cache_generation`; `stats()` reports
    `plan_hits` / `plan_misses` / `plan_evicts`;
  * **power-of-two batch rounding** -- the coalesced batch zero-pads up to
    the next power of two, bounding the batch sizes a bucket runs at
    log2(max_batch)+1. The `warmed`/`hits`/`misses` ledger keyed by
    `serve_key` is the warm-start bookkeeping: `repro_torch.serve.warmup`
    runs each point once (the kernel build, the ROM and plan caches) so a
    first request pays none of it.

Failure handling (DESIGN.md §12), as the reference's:

  * **bisect-and-retry isolation** -- when a dispatch raises, the batch is
    split in half and each half re-dispatched; singletons that still raise
    get the exception on their own future. Coalescing is batch-invariant,
    so re-serving an innocent neighbor in a smaller batch returns the same
    bytes. Counted in `retries` / `isolated`. This isolates host-side and
    injected faults; a sticky CUDA error poisons the context for every
    later dispatch and is out of its scope.
  * **per-bucket degraded fallback** -- a scale-out bucket ('sharded' over
    `devices`, 'streamed' in `tile` tiles, `repro_torch.distribute`) that
    fails `degrade_after` consecutive dispatches is pinned to the
    bit-identical local path and counted in `degraded`.
  * **leak-proof fulfilment** -- `run()` never raises and fulfils every
    future exactly once.

The chaos harness (`repro_torch.runtime.fault`) probes `SITE_EXECUTE` on
every dispatch with the serve key, the exec mode, the executor's `name`
(when set) and the batch's request sequence numbers. An `on_dispatch(key,
mode, ok)` callback hears every dispatch's outcome with the exec mode
actually used: the health feed of the elastic pool
(`repro_torch.serve.pool`), whose members are executors with a `name`.

Telemetry (DESIGN.md §15): the ledger counters live in a
`repro_torch.obs.MetricsRegistry`; with a `trace=` recorder every dispatch
emits per-request 'dispatch' events (serve key, exec mode, traced batch
size, plan tag) and every fulfilment or isolated failure its terminal
event; with a `profiler=`, every dispatch is timed against its roofline
price.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Sequence

import torch

from repro_torch.core.platform import resolve_device
from repro_torch.filters.pipeline import plan_tile, resolve_filter_plan
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NOOP
from repro_torch.runtime.fault import SITE_EXECUTE
from repro_torch.runtime.fault import probe as fault_probe
from repro_torch.serve.batcher import MicroBatch
from repro_torch.serve.request import FilterRequest, bucket_key, serve_key
from repro_torch.serve.workload import Workload, resolve_workloads
from repro_torch.tuning.cache import backend_key, cache_generation

#: the scale-out exec modes (`repro_torch.distribute`), which the degraded
#: ladder falls back from
SCALE_OUT_MODES = ("sharded", "streamed")


def next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1)).bit_length()


class BatchExecutor:
    """Stateless-per-request executor with the per-bucket plan memo."""

    def __init__(self, *, device: str | torch.device | None = None,
                 pad_pow2: bool = True,
                 devices: int | Sequence[int] | None = None,
                 tile: tuple[int, int] = (256, 256),
                 tile_batch: int = 8, degrade_after: int = 2,
                 plan_memo_max: int = 256, name: str = "",
                 on_dispatch: Callable[[str, str, bool], None] | None = None,
                 workloads: dict[str, Workload] | None = None,
                 metrics: MetricsRegistry | None = None,
                 trace=NOOP, profiler=None) -> None:
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            # the card the dispatches run on, by index: the infer workload
            # compares it with where its models live ('cuda:0')
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.backend = backend_key(self.device)
        self.workloads = resolve_workloads(workloads)
        self.pad_pow2 = pad_pow2
        self.devices = (tuple(devices) if isinstance(devices, (list, tuple))
                        else devices)
        self.tile = tuple(tile)
        self.tile_batch = int(tile_batch)
        self.degrade_after = max(int(degrade_after), 1)
        self.plan_memo_max = max(int(plan_memo_max), 1)
        self.name = str(name)
        self.on_dispatch = on_dispatch
        self._lock = threading.Lock()
        self._plans: OrderedDict[tuple, dict] = OrderedDict()
        self._plans_gen = cache_generation()
        self.warmed: set[str] = set()
        # ------------------------------ §15 telemetry (registry-backed)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._trace = trace
        self.profiler = profiler
        m = self.metrics
        self._c_hits = m.counter("serve_compile_hits_total")
        self._c_misses = m.counter("serve_compile_misses_total")
        self._c_plan_hits = m.counter("serve_plan_hits_total")
        self._c_plan_misses = m.counter("serve_plan_misses_total")
        self._c_plan_evicts = m.counter("serve_plan_evicts_total")
        self._c_retries = m.counter("serve_retries_total")
        self._c_isolated = m.counter("serve_isolated_total")
        self._c_degraded = m.counter("serve_degraded_total")
        # ------------------------------ §12 fault-tolerance state
        self.failures: dict[str, int] = {}   # bucket -> consecutive failures
        self._fallback: set[str] = set()     # buckets pinned to local exec

    # ------------------------------------------------ registry-backed ledger
    @property
    def hits(self) -> int:
        return self._c_hits.value(member=self.name)

    @property
    def misses(self) -> int:
        return self._c_misses.value(member=self.name)

    @property
    def plan_hits(self) -> int:
        return self._c_plan_hits.value(member=self.name)

    @property
    def plan_misses(self) -> int:
        return self._c_plan_misses.value(member=self.name)

    @property
    def plan_evicts(self) -> int:
        return self._c_plan_evicts.value(member=self.name)

    @property
    def retries(self) -> int:
        return self._c_retries.value(member=self.name)

    @property
    def isolated(self) -> int:
        return self._c_isolated.value(member=self.name)

    @property
    def degraded(self) -> dict[str, int]:
        """bucket -> §12 local-fallback dispatch count (this member's)."""
        return self._c_degraded.group_by("bucket", member=self.name)

    # -------------------------------------------------- per-bucket plan memo
    def _plan(self, filt: str, method: str, mult_impl: str, n: int, h: int,
              w: int) -> dict:
        """Explicit plan fields for a local-exec (n, h, w) dispatch of
        `filt`: the dataflow, the resolved mult_impl and the tile it
        launches on the card (`plan_tile`, the plan's menu tile there),
        resolved once per (bucket, traced batch size) through the
        executor's backend and pinned on every later call. The memo follows the
        tuning cache's generation, so an `invalidate_cache()` drops stale
        pinned plans, and is LRU-bounded at `plan_memo_max` entries so
        long-tail shape traffic cannot grow it without limit."""
        memo_key = (filt, method, mult_impl, n, h, w)
        with self._lock:
            gen = cache_generation()
            if gen != self._plans_gen:
                self._plans.clear()
                self._plans_gen = gen
            plan = self._plans.get(memo_key)
            if plan is not None:
                self._c_plan_hits.inc(member=self.name)
                self._plans.move_to_end(memo_key)
                return plan
            self._c_plan_misses.inc(member=self.name)
        cfg = resolve_filter_plan(filt, n, h, w, method=method,
                                  mult_impl=mult_impl, backend=self.backend)
        tile = plan_tile(filt, cfg)
        plan = {"separable": cfg.dataflow != "direct",
                "fused": cfg.dataflow == "fused",
                "mult_impl": cfg.mult_impl,
                "route": tile.route,
                "block_rows": tile.block_rows,
                "block_cols": tile.block_cols,
                "batch_fold": tile.batch_fold}
        with self._lock:
            self._plans[memo_key] = plan
            self._plans.move_to_end(memo_key)
            while len(self._plans) > self.plan_memo_max:
                self._plans.popitem(last=False)
                self._c_plan_evicts.inc(member=self.name)
        return plan

    def _exec_kw(self, exec_mode: str, filt: str, method: str,
                 mult_impl: str, n: int, h: int, w: int) -> dict:
        """`apply_filter` kwargs of one dispatch. Local: the memoised
        plan's dataflow and resolved mult_impl, and on the card its tile,
        which makes the call fully explicit (the CPU's plain versions take
        no tile). Scale-out modes forward the request's mult_impl with the
        executor's `devices`, or its `tile` (never larger than the image)
        and `tile_batch`."""
        if exec_mode == "local":
            p = self._plan(filt, method, mult_impl, n, h, w)
            kw = {"separable": p["separable"], "fused": p["fused"],
                  "mult_impl": p["mult_impl"]}
            if self.backend == "cuda":
                kw.update(block_rows=p["block_rows"],
                          block_cols=p["block_cols"], batch_fold=False)
            return kw
        if exec_mode == "sharded":
            return {"exec": "sharded", "devices": self.devices,
                    "mult_impl": mult_impl}
        if exec_mode == "streamed":
            th, tw = min(self.tile[0], h), min(self.tile[1], w)
            return {"exec": "streamed", "tile": (th, tw),
                    "tile_batch": self.tile_batch, "mult_impl": mult_impl}
        raise ValueError(f"unknown exec mode {exec_mode!r}")

    def _plan_tag(self, mode: str, r0: FilterRequest, traced_n: int) -> str:
        """Compact spelling of the dispatch's plan for the §15 trace/drift
        labels: dataflow, mult_impl and the route's tile for a local filter
        dispatch (the reference's spelling, the tile read from the route),
        the exec mode (+ workload) otherwise. Only computed when tracing or
        profiling is on; the memo makes it a plan-memo hit."""
        if mode == "local" and r0.workload == "filter":
            h, w = r0.img.shape
            p = self._plan(r0.filt, r0.method, r0.mult_impl, traced_n, h, w)
            df = ("fused" if p["fused"]
                  else "two_pass" if p["separable"] else "direct")
            tag = (f"{df}/{p['mult_impl']}"
                   f"/br{p['block_rows']}xbc{p['block_cols']}")
            return tag + ("/fold" if p["batch_fold"] else "")
        return f"{mode}/{r0.workload}"

    # ------------------------------------------------------------- execution
    def execute(self, key: str, requests: tuple[FilterRequest, ...], *,
                exec_override: str | None = None) -> list[torch.Tensor]:
        """One dispatch of a coalesced bucket slice, no retry; returns one
        output per request. `exec_override` is the §12 fallback hook."""
        r0 = requests[0]
        n = len(requests)
        traced_n = next_pow2(n) if self.pad_pow2 else n
        skey = serve_key(key, traced_n)
        with self._lock:
            warm = skey in self.warmed
            if not warm:
                self.warmed.add(skey)
        if warm:
            self._c_hits.inc(member=self.name)
        else:
            self._c_misses.inc(member=self.name)
        mode = r0.exec if exec_override is None else exec_override
        tag = f"|member={self.name}" if self.name else ""
        fault_probe(SITE_EXECUTE, key=f"{skey}|exec={mode}{tag}",
                    seqs=tuple(r.seq for r in requests))
        wl = self.workloads.get(r0.workload)
        if wl is None:
            raise KeyError(f"no workload {r0.workload!r} registered "
                           f"(have: {tuple(self.workloads)})")
        prof = self.profiler
        plan = (self._plan_tag(mode, r0, traced_n)
                if prof is not None or self._trace.enabled else None)
        if self._trace.enabled:
            for r in requests:
                self._trace.event("dispatch", seq=r.seq, bucket=key,
                                  skey=skey, exec=mode, n=n,
                                  traced_n=traced_n, plan=plan,
                                  member=self.name, workload=r0.workload)
        if prof is None:
            return wl.execute(self, requests, traced_n, mode)
        predicted = prof.predicted(wl, key, r0, traced_n)
        t0 = time.perf_counter()
        outs = wl.execute(self, requests, traced_n, mode)
        prof.record(key, plan, predicted, time.perf_counter() - t0)
        return outs

    def _report(self, key: str, mode: str, ok: bool) -> None:
        """Tell the owning pool (if any) how one dispatch went -- the §13
        health feed. A reporter fault never corrupts fulfilment."""
        if self.on_dispatch is not None:
            try:
                self.on_dispatch(key, mode, ok)
            except Exception:                              # noqa: BLE001
                pass

    def _dispatch(self, key: str, requests: tuple[FilterRequest, ...]
                  ) -> list[torch.Tensor]:
        """`execute` under the per-bucket degraded-exec ladder (§12): a
        scale-out bucket that failed `degrade_after` consecutive dispatches
        is pinned to the bit-identical local path. Every dispatch outcome,
        with the exec mode actually used, feeds `on_dispatch` (§13)."""
        mode = requests[0].exec
        scale_out = mode in SCALE_OUT_MODES
        if scale_out and key in self._fallback:
            outs = self.execute(key, requests, exec_override="local")
            self._report(key, "local", True)
            self._c_degraded.inc(member=self.name, bucket=key)
            return outs
        try:
            outs = self.execute(key, requests)
        except BaseException:                              # noqa: BLE001
            self._report(key, mode, False)
            if scale_out:
                with self._lock:
                    nfail = self.failures.get(key, 0) + 1
                    self.failures[key] = nfail
                    if nfail >= self.degrade_after:
                        self._fallback.add(key)
                if key in self._fallback:
                    outs = self.execute(key, requests, exec_override="local")
                    self._report(key, "local", True)
                    self._c_degraded.inc(member=self.name, bucket=key)
                    return outs
            raise
        self._report(key, mode, True)
        if scale_out:
            with self._lock:
                self.failures[key] = 0
        return outs

    def _fulfil(self, key: str, requests: tuple[FilterRequest, ...], *,
                retry: bool = False) -> None:
        """Dispatch + fulfil with bisection isolation: a failing batch
        splits in half and each half re-dispatches, so only requests that
        fail *alone* keep the exception (§12). Byte-safe: outputs are
        batch-invariant (§10), so a re-served neighbor gets the same bits."""
        if retry:
            self._c_retries.inc(member=self.name)
        try:
            outs = self._dispatch(key, requests)
        except BaseException as err:                       # noqa: BLE001
            if len(requests) == 1:
                self._c_isolated.inc(member=self.name)
                if not requests[0].future.done():
                    requests[0].future.set_exception(err)
                    if self._trace.enabled:
                        self._trace.event("fail", seq=requests[0].seq,
                                          bucket=key, cause="isolated",
                                          error=repr(err))
                return
            mid = len(requests) // 2
            self._fulfil(key, requests[:mid], retry=True)
            self._fulfil(key, requests[mid:], retry=True)
            return
        for req, out in zip(requests, outs):
            if not req.future.done():
                req.future.set_result(out)
                if self._trace.enabled:
                    self._trace.event("fulfil", seq=req.seq, bucket=key)

    def run(self, batch: MicroBatch) -> None:
        """Execute and fulfil -- every future resolves exactly once, to its
        own request's output or to its own (isolated) failure. Never
        raises: any error escaping the isolation machinery itself lands on
        the still-unresolved futures, so none can hang (§12)."""
        try:
            self._fulfil(batch.key, batch.requests)
        except BaseException as err:                       # noqa: BLE001
            for req in batch.requests:
                if not req.future.done():
                    req.future.set_exception(err)
                    if self._trace.enabled:
                        self._trace.event("fail", seq=req.seq,
                                          bucket=batch.key,
                                          cause="executor", error=repr(err))

    @property
    def degraded_mode(self) -> bool:
        """True once any bucket has been pinned to the local fallback."""
        return bool(self._fallback)

    def fault_stats(self) -> dict:
        """Snapshot of the §12 counters (the server's stats() source)."""
        with self._lock:
            failures = dict(self.failures)
        return {"retries": self.retries, "isolated": self.isolated,
                "degraded": self.degraded,
                "dispatch_failures": failures}

    def stats(self) -> dict:
        """Full executor snapshot: the warm compile ledger, the §13
        LRU plan-memo counters, and the §12 fault counters."""
        with self._lock:
            warmed = len(self.warmed)
            plan_size = len(self._plans)
        snap = {"warmed": warmed, "hits": self.hits,
                "misses": self.misses,
                "plan_memo": {"size": plan_size,
                              "max": self.plan_memo_max,
                              "hits": self.plan_hits,
                              "misses": self.plan_misses,
                              "evicts": self.plan_evicts}}
        snap.update(self.fault_stats())
        return snap

    # ---------------------------------------------------------------- warmup
    def warm(self, shape: tuple[int, int], filt: str, *,
             method: str = "refmlm", mult_impl: str = "auto",
             exec_mode: str = "local", nbits: int = 8, n: int = 1,
             priority: str = "normal", workload: str = "filter") -> str:
        """Run one (bucket, batch size) point with a zero dummy batch: the
        kernels' build on first use, the ROM and plan caches, the plan
        memo; returns the serve_key it warmed. `priority` only names the
        warmed ledger bucket (classes never coalesce, §13). `workload`
        selects the §14 workload class (filter by default; `filt` then
        names that workload's target, e.g. an infer model)."""
        h, w = shape
        traced_n = next_pow2(n) if self.pad_pow2 else n
        key = bucket_key(filt, method, mult_impl, exec_mode, nbits, h, w,
                         priority, workload)
        self.workloads[workload].warm(
            self, (h, w), filt, method=method, mult_impl=mult_impl,
            exec_mode=exec_mode, nbits=nbits, traced_n=traced_n)
        skey = serve_key(key, traced_n)
        with self._lock:
            self.warmed.add(skey)
        return skey


__all__ = ["BatchExecutor", "SCALE_OUT_MODES", "next_pow2"]
