"""The deterministic fault-injection harness the serving fault layer is
tested with (DESIGN.md §12).

Counterpart of the §12 injection API of `repro.runtime.fault`: the probe
sites, the `FaultInjector` rules (`at_call`, `every`, `on_key`,
`at_index`, `poison`), `fault_scope`, `probe` and `InjectedFault`, copied
with the decisions kept the same. The reference module's training-loop
pieces (`run_training`, `StragglerMonitor` and the step-fault API) wait
for the port's training scaffolding (ROADMAP Queue 1 item 10).

Instrumented code calls the module-level `probe(site, ...)` at well-known
sites; a probe is a no-op unless a `fault_scope(injector)` is active, so
production dispatch pays one list check. Rules are deterministic functions
of the probe stream -- no randomness, no wall clock -- which is what lets
the chaos tests replay exact schedules:

    inj = (FaultInjector()
           .at_call(SITE_EXECUTE, 3)            # fail the 3rd executor call
           .poison(SITE_EXECUTE, 7))            # fail any batch holding seq 7
    with fault_scope(inj):
        ... drive ImageFilterServer ...

Probe sites: SITE_EXECUTE = "serve.execute", one per `BatchExecutor`
dispatch (key `serve_key|exec=<mode>`, seqs the batch's request sequence
numbers: the poison target). SITE_SHARD and SITE_TILE name the reference's
`distribute` sites, which the port does not run yet (ROADMAP Queue 1 item
8). `probe` raises `InjectedFault`; every firing is recorded in
`injector.events` so tests can assert the schedule actually happened.
"""
from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager
from typing import Iterator, Sequence

from repro_torch.obs.trace import emit as trace_emit

#: Instrumented dispatch sites (see the module docstring).
SITE_EXECUTE = "serve.execute"
SITE_SHARD = "distribute.shard"
SITE_TILE = "stream.tile"


class InjectedFault(RuntimeError):
    pass


@dataclasses.dataclass
class FaultRule:
    """One deterministic trigger: all set criteria must match the probe.

    `nth`/`every` match the per-site call counter (1-based); `key` is a
    substring match on the probe key; `[index_lo, index_hi)` bounds the
    probe index; `seqs` intersects the probe's request sequence numbers.
    `times` caps how often the rule fires (None = forever -- a persistently
    poisoned request, as opposed to a transient blip).
    """

    site: str
    nth: int | None = None
    every: int | None = None
    key: str | None = None
    index_lo: int | None = None
    index_hi: int | None = None
    seqs: frozenset = frozenset()
    times: int | None = 1
    fired: int = 0

    def matches(self, call_no: int, key: str | None, index: int | None,
                seqs: Sequence[int]) -> bool:
        if self.times is not None and self.fired >= self.times:
            return False
        if self.nth is not None and call_no != self.nth:
            return False
        if self.every is not None and call_no % self.every != 0:
            return False
        if self.key is not None and (key is None or self.key not in key):
            return False
        if self.index_lo is not None and (index is None
                                          or index < self.index_lo):
            return False
        if self.index_hi is not None and (index is None
                                          or index >= self.index_hi):
            return False
        if self.seqs and not (self.seqs & set(seqs)):
            return False
        return True

    def describe(self) -> str:
        bits = [f"site={self.site}"]
        for f in ("nth", "every", "key", "index_lo", "index_hi"):
            v = getattr(self, f)
            if v is not None:
                bits.append(f"{f}={v}")
        if self.seqs:
            bits.append(f"seqs={sorted(self.seqs)}")
        return " ".join(bits)


class FaultInjector:
    """Deterministic fault schedule of §12 probe rules.

    Thread-safe -- the serving worker thread probes while the test thread
    owns the scope. Constructors chain (`inj.at_call(...).poison(...)`).
    """

    def __init__(self) -> None:
        self.rules: list[FaultRule] = []
        self.calls: dict[str, int] = {}
        self.events: list[tuple] = []     # (site, call_no, key, index, rule)
        self._lock = threading.Lock()

    # ------------------------------------------------------- rule construction
    def rule(self, **kw) -> "FaultInjector":
        self.rules.append(FaultRule(**kw))
        return self

    def at_call(self, site: str, nth: int, *,
                times: int | None = 1) -> "FaultInjector":
        """Fail the `nth` (1-based) probe at `site` -- a transient blip by
        default (`times=1`): retries of the same dispatch succeed."""
        return self.rule(site=site, nth=nth, times=times)

    def every(self, site: str, k: int, *,
              times: int | None = None) -> "FaultInjector":
        """Fail every `k`-th probe at `site` (a steady fault *rate*)."""
        return self.rule(site=site, every=k, times=times)

    def on_key(self, site: str, key: str, *,
               times: int | None = None) -> "FaultInjector":
        """Fail any probe at `site` whose key contains `key` (e.g. a named
        shard, an exec mode, one serve bucket). Persistent by default."""
        return self.rule(site=site, key=key, times=times)

    def at_index(self, site: str, lo: int, hi: int | None = None, *,
                 times: int | None = 1) -> "FaultInjector":
        """Fail probes whose index falls in `[lo, hi)` (`hi=None` means
        `lo+1` -- one tile / one shard). One firing by default: the
        crash-then-resume scenario."""
        return self.rule(site=site, index_lo=lo,
                         index_hi=lo + 1 if hi is None else hi, times=times)

    def poison(self, site: str, *seqs: int) -> "FaultInjector":
        """Permanently fail any probe at `site` carrying one of these
        request sequence numbers -- the deterministically poisoned request
        the bisection retry (DESIGN.md §12) must isolate."""
        return self.rule(site=site, seqs=frozenset(seqs), times=None)

    # --------------------------------------------------------------- probing
    def probe(self, site: str, *, key: str | None = None,
              index: int | None = None, seqs: Sequence[int] = ()) -> None:
        """Raise `InjectedFault` when any rule matches this probe."""
        with self._lock:
            call_no = self.calls.get(site, 0) + 1
            self.calls[site] = call_no
            for r in self.rules:
                if r.site == site and r.matches(call_no, key, index, seqs):
                    r.fired += 1
                    self.events.append((site, call_no, key, index,
                                        r.describe()))
                    # tag the firing into any active trace (DESIGN.md
                    # §15) so a chaos run's injected faults line up
                    # with the request spans they poisoned
                    trace_emit("fault", site=site, call=call_no, key=key,
                               index=index, rule=r.describe())
                    raise InjectedFault(
                        f"injected fault at {site} call {call_no} "
                        f"(key={key!r}, index={index}): {r.describe()}")


#: Active injector stack -- shared across threads on purpose: the test
#: thread opens the scope, the serving worker thread hits the probes.
_ACTIVE: list[FaultInjector] = []


@contextmanager
def fault_scope(injector: FaultInjector) -> Iterator[FaultInjector]:
    """Activate `injector` for every `probe()` until the scope exits."""
    _ACTIVE.append(injector)
    try:
        yield injector
    finally:
        _ACTIVE.remove(injector)


def probe(site: str, *, key: str | None = None, index: int | None = None,
          seqs: Sequence[int] = ()) -> None:
    """Instrumentation hook: no-op unless a `fault_scope` is active."""
    if _ACTIVE:
        for injector in list(_ACTIVE):
            injector.probe(site, key=key, index=index, seqs=seqs)


__all__ = ["FaultInjector", "FaultRule", "InjectedFault", "SITE_EXECUTE",
           "SITE_SHARD", "SITE_TILE", "fault_scope", "probe"]
