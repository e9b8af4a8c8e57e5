"""Elastic executor pool: serving failover over device subsets
(DESIGN.md §13).

Counterpart of `repro.serve.pool`, with the decisions kept the same. One
`ExecutorPool` owns N `BatchExecutor` members, each pinned to its own
explicit device-id subset (the ids of `repro_torch.distribute.mesh`: the
CUDA devices of this process, or the logical CPU shards with
`device='cpu'`). Buckets are assigned to members by **rendezvous
hashing** -- every bucket key scores every *active* member with a stable
keyed hash and is served by the top scorer -- so membership changes move
only the buckets that must move: a drained member's buckets re-rendezvous
onto the survivors while every other bucket stays put (warm kernels, plan
memos and the §12 per-bucket fault state all stay hot).

Health is fed by the members' `on_dispatch(key, mode, ok)` reports: the
pool counts each member's *consecutive scale-out dispatch failures* -- a
scale-out success resets the count; a bit-identical local-fallback
success does not, because it means the member's mesh is still broken --
and at `drain_after` the member is drained:

  1. **probe** each of its device ids (`repro_torch.runtime.elastic.
     probe_device`: one trivial dispatch on a one-device mesh, through the
     same `SITE_SHARD` `dev<id>` chaos hook as real traffic);
  2. **rebuild** -- if some but not all ids survive, the member gets a
     fresh executor over `surviving_devices(...)`: same name, same
     rendezvous placement, smaller mesh;
  3. **retire** -- if no id survives (or all do, meaning the failures are
     not a device loss the pool can shrink around), the member goes
     `dead` and its buckets rebalance to the remaining members.

The last active member is never drained -- its own §12 per-bucket local
fallback is the final line of defence -- so `route()` always has a target
and the pool degrades to a single-executor server.

Every member serves through the same bit-identical datapath, so which
member -- or which rebuilt mesh -- serves a bucket never changes an output
byte. The pool quacks like a `BatchExecutor` where the server cares
(`run`, `warm`, `stats`, `fault_stats`, `degraded_mode`, the warm-cache
ledger, `device`), so `ImageFilterServer` holds either behind
one attribute. The pool and its members share one metrics registry
(member ledgers are told apart by their `member=` label), and a `trace=`
recorder in `executor_kw` flows to every member.
"""
from __future__ import annotations

import hashlib
import threading
from typing import Sequence

from repro_torch.distribute.mesh import device_count
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.batcher import MicroBatch
from repro_torch.serve.executor import SCALE_OUT_MODES, BatchExecutor
from repro_torch.serve.request import bucket_key

#: pool-member lifecycle states.
MEMBER_STATES = ("active", "dead")


def rendezvous_score(member: str, key: str) -> int:
    """Stable keyed score of (member, bucket) -- highest-random-weight
    hashing: each bucket is served by its top-scoring active member, so
    removing one member re-routes only that member's buckets."""
    digest = hashlib.blake2b(f"{member}|{key}".encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "big")


def _resolve_ids(spec, index: int, device) -> tuple[int, ...]:
    """One member spec -> its explicit device-id tuple. `None` means all
    visible devices of `device`'s type; an int the first that-many ids; a
    sequence is taken verbatim (so a rebuilt mesh can name exactly the
    survivors)."""
    if spec is None:
        return tuple(range(device_count(device)))
    if isinstance(spec, int):
        ids = tuple(range(device_count(device)))
        if spec > len(ids):
            raise ValueError(f"pool member {index} wants {spec} devices, "
                             f"only {len(ids)} visible")
        return ids[:spec]
    return tuple(int(i) for i in spec)


class PoolMember:
    """One executor, its device subset and its health counters.

    Health logic state (`state`, `consecutive`, `draining`) stays plain
    attributes under the pool's lock; the monotonic tallies live in the
    shared metrics registry, labelled by member name, and read back
    through properties."""

    def __init__(self, name: str, device_ids: tuple[int, ...],
                 executor: BatchExecutor, metrics: MetricsRegistry) -> None:
        self.name = name
        self.device_ids = device_ids
        self.executor = executor
        self.state = "active"
        self.draining = False           # re-entrancy guard for the drain
        self.consecutive = 0            # consecutive scale-out failures
        self._c_dispatches = metrics.counter("serve_pool_dispatches_total")
        self._c_failed = metrics.counter("serve_pool_dispatch_failed_total")
        self._c_routes = metrics.counter("serve_pool_routes_total")
        self._c_rebuilds = metrics.counter("serve_pool_member_rebuilds_total")

    @property
    def dispatches(self) -> int:
        return self._c_dispatches.value(member=self.name)

    @property
    def failed(self) -> int:
        return self._c_failed.value(member=self.name)

    @property
    def routes(self) -> int:
        return self._c_routes.value(member=self.name)

    @property
    def rebuilds(self) -> int:
        return self._c_rebuilds.value(member=self.name)


class ExecutorPool:
    """Rendezvous-routed executors with probe-and-rebuild failover.

    `executor_kw` is every member's `BatchExecutor` keywords (`device`
    among them: the device type the member ids name)."""

    def __init__(self, members: Sequence[Sequence[int] | int | None], *,
                 drain_after: int = 3, **executor_kw) -> None:
        if not members:
            raise ValueError("pool needs at least one member")
        self.drain_after = max(int(drain_after), 1)
        kw = dict(executor_kw)
        for name in ("devices", "name", "on_dispatch"):
            kw.pop(name, None)
        # one shared registry: member ledgers key by member= label
        if kw.get("metrics") is None:
            kw["metrics"] = MetricsRegistry()
        self.metrics = kw["metrics"]
        self._executor_kw = kw
        self._c_drains = self.metrics.counter("serve_pool_drains_total")
        self._c_rebuilds = self.metrics.counter("serve_pool_rebuilds_total")
        self._c_refused = self.metrics.counter("serve_pool_drain_refused_total")
        self._lock = threading.Lock()
        self._members: dict[str, PoolMember] = {}
        for i, spec in enumerate(members):
            name = f"m{i}"
            ids = _resolve_ids(spec, i, kw.get("device"))
            self._members[name] = PoolMember(
                name, ids, self._make_executor(name, ids), self.metrics)
        self.device = next(iter(self._members.values())).executor.device

    def _make_executor(self, name: str, ids: tuple[int, ...]) -> BatchExecutor:
        return BatchExecutor(devices=ids, name=name,
                             on_dispatch=self._reporter(name),
                             **self._executor_kw)

    def _reporter(self, name: str):
        def report(key: str, mode: str, ok: bool) -> None:
            self._on_dispatch(name, key, mode, ok)
        return report

    # ---------------------------------------------------------------- routing
    def members(self) -> list[PoolMember]:
        with self._lock:
            return list(self._members.values())

    def active_members(self) -> list[PoolMember]:
        with self._lock:
            return [m for m in self._members.values() if m.state == "active"]

    def route(self, key: str) -> PoolMember:
        """The active member serving `key` (top rendezvous score)."""
        with self._lock:
            actives = [m for m in self._members.values() if m.state == "active"]
            if not actives:
                raise RuntimeError("executor pool has no active members")
            best = max(actives, key=lambda m: rendezvous_score(m.name, key))
            best._c_routes.inc(member=best.name)
            return best

    def run(self, batch: MicroBatch) -> None:
        """Serve one flushed bucket on its routed member. Inherits the
        member executor's never-raises, exactly-once contract (§12)."""
        self.route(batch.key).executor.run(batch)

    # ----------------------------------------------------------------- health
    @staticmethod
    def _native_mode(key: str) -> str:
        """The exec mode a bucket was submitted under: the 4th segment of
        its `bucket_key`."""
        parts = key.split("/")
        return parts[3] if len(parts) > 3 else ""

    def _on_dispatch(self, name: str, key: str, mode: str, ok: bool) -> None:
        """The §13 health feed: one call per member dispatch, with the exec
        mode actually used. For a scale-out bucket only a dispatch that
        succeeded on the scale-out mesh resets the member's count; an
        outright failure and a bit-identical local-fallback serve both
        count as evidence that the mesh is broken."""
        drain = False
        with self._lock:
            m = self._members.get(name)
            if m is None:
                return
            m._c_dispatches.inc(member=name)
            if not ok:
                m._c_failed.inc(member=name)
            if m.state == "active" and self._native_mode(key) in SCALE_OUT_MODES:
                if ok and mode in SCALE_OUT_MODES:
                    m.consecutive = 0
                elif not ok or mode == "local":
                    m.consecutive += 1
                    drain = m.consecutive >= self.drain_after and not m.draining
            if drain:
                m.draining = True
        if drain:
            self._drain(name)

    def _drain(self, name: str) -> None:
        """Probe the member's devices and rebuild or retire it. Called with
        `draining` set; the probes run without the lock (they dispatch real
        work)."""
        from repro_torch.runtime.elastic import surviving_devices
        with self._lock:
            m = self._members[name]
            actives = [x for x in self._members.values() if x.state == "active"]
            if len(actives) <= 1:
                # never retire the last member: its own per-bucket local
                # fallback (§12) is the final line of defence
                self._c_refused.inc()
                m.consecutive = 0
                m.draining = False
                return
            ids = m.device_ids
        survivors = surviving_devices(ids, self.device)
        with self._lock:
            if survivors and len(survivors) < len(ids):
                m.device_ids = survivors
                m.executor = self._make_executor(name, survivors)
                m.consecutive = 0
                m._c_rebuilds.inc(member=name)
                self._c_rebuilds.inc()
            else:
                # nothing survived, or everything did (the failures are not
                # a shrinkable device loss): retire the member and let its
                # buckets re-rendezvous onto the survivors
                m.state = "dead"
                self._c_drains.inc()
            m.draining = False

    # --------------------------------------- BatchExecutor-compatible surface
    def warm(self, shape: tuple[int, int], filt: str, *,
             method: str = "refmlm", mult_impl: str = "auto",
             exec_mode: str = "local", nbits: int = 8, n: int = 1,
             priority: str = "normal", workload: str = "filter") -> str:
        """Warm one serve point on the member that will serve it (the
        signature of `BatchExecutor.warm`, so `warmup.sweep` and
        `ImageFilterServer.warmup()` drive pools unchanged)."""
        h, w = shape
        key = bucket_key(filt, method, mult_impl, exec_mode, nbits, h, w,
                         priority, workload)
        return self.route(key).executor.warm(
            (h, w), filt, method=method, mult_impl=mult_impl,
            exec_mode=exec_mode, nbits=nbits, n=n, priority=priority,
            workload=workload)

    @property
    def warmed(self) -> set:
        out: set = set()
        for m in self.members():
            out |= m.executor.warmed
        return out

    @property
    def hits(self) -> int:
        return sum(m.executor.hits for m in self.members())

    @property
    def misses(self) -> int:
        return sum(m.executor.misses for m in self.members())

    @property
    def drains(self) -> int:
        """Members retired (dead)."""
        return self._c_drains.value()

    @property
    def rebuilds(self) -> int:
        """Members rebuilt on fewer devices."""
        return self._c_rebuilds.value()

    @property
    def drain_refused(self) -> int:
        """Last-member drains refused."""
        return self._c_refused.value()

    @property
    def degraded_mode(self) -> bool:
        """True while any *active* member has a bucket pinned to the §12
        local fallback. Dead members do not count: their buckets now live,
        undegraded, on the survivors."""
        return any(m.executor.degraded_mode for m in self.active_members())

    def fault_stats(self) -> dict:
        """The §12 counters summed over members (the server merges this
        into its stats() like a single executor's)."""
        agg = {"retries": 0, "isolated": 0, "degraded": {},
               "dispatch_failures": {}}
        for m in self.members():
            fs = m.executor.fault_stats()
            agg["retries"] += fs["retries"]
            agg["isolated"] += fs["isolated"]
            for field in ("degraded", "dispatch_failures"):
                for k, v in fs[field].items():
                    agg[field][k] = agg[field].get(k, 0) + v
        return agg

    def stats(self) -> dict:
        """Executor-shaped snapshot plus the `pool` membership detail."""
        members = self.members()
        plan = {"size": 0, "max": 0, "hits": 0, "misses": 0, "evicts": 0}
        for m in members:
            pm = m.executor.stats()["plan_memo"]
            for k in plan:
                plan[k] += pm[k]
        with self._lock:
            detail = {m.name: {"state": m.state,
                               "devices": list(m.device_ids),
                               "dispatches": m.dispatches,
                               "failed": m.failed,
                               "consecutive": m.consecutive,
                               "routes": m.routes,
                               "rebuilds": m.rebuilds}
                      for m in self._members.values()}
            pool = {"members": detail,
                    "active": sum(1 for m in self._members.values()
                                  if m.state == "active"),
                    "drains": self.drains, "rebuilds": self.rebuilds,
                    "drain_refused": self.drain_refused}
        snap = {"warmed": len(self.warmed), "hits": self.hits,
                "misses": self.misses, "plan_memo": plan, "pool": pool}
        snap.update(self.fault_stats())
        return snap


__all__ = ["ExecutorPool", "MEMBER_STATES", "PoolMember", "rendezvous_score"]
