"""Admission control for the serving queue (DESIGN.md §10/§13).

Counterpart of `repro.serve.admission`: plain Python, copied with the
imports renamed and the decisions kept the same.

The gate bounds the *weighted* number of in-flight requests -- admitted
but not yet completed -- so a traffic burst turns into client-side
backpressure (`submit` blocking, then `ServerOverloaded`) instead of
unbounded queue growth. A slot is held from admission until the request's
future is fulfilled, so the bound covers queued AND executing work: the
server's peak memory is `max_pending` weight units of images plus one
micro-batch.

§13 extends the single counter with **weighted slot accounting and
per-tenant quotas**: each request charges `weight` slots
(`repro_torch.serve.request.request_weight` -- proportional to its pixel count,
so a satellite frame cannot hide behind a thumbnail's slot) against both
the global `max_pending` bound and its tenant's `tenant_quota`. A tenant
at quota blocks (then raises `TenantOverQuota`) while other tenants keep
admitting -- one bulk tenant can no longer starve the latency-sensitive
one. Acquisition is all-or-nothing: a request never holds global slots
while waiting for tenant headroom, so two tenants cannot deadlock the
gate.

`on_wait(weight)` is the §13 overload signal: it fires (outside the gate
lock) whenever an acquire of `weight` slots is about to block, letting
the server wake its worker to shed low-priority queued work instead of
keeping a high-priority submitter waiting behind it.

Telemetry (DESIGN.md §15): the gate's counters live in a
`repro_torch.obs.MetricsRegistry` -- the server passes its own so
`server.stats()` can read admission state in the same consistent
snapshot as the request counters; a standalone gate mints a private
registry. The gate's own `_cond`-guarded integers stay the admission
*logic*'s source of truth (the registry is telemetry, never control
flow), mirrored into gauges on every acquire/release. `snapshot()` and
`tenant_stats()` read the registry only -- no `_cond` -- so the server
may call them while holding the registry lock without inverting the
`component-lock -> registry-lock` order.
"""
from __future__ import annotations

import threading
import time
from typing import Callable

from repro_torch.obs.metrics import MetricsRegistry


class ServerOverloaded(RuntimeError):
    """Admission timed out: the server is at `max_pending` in-flight
    weighted slots and none freed up within the admission timeout."""


class TenantOverQuota(ServerOverloaded):
    """Admission timed out on the *tenant* bound: this tenant is at its
    per-tenant in-flight quota (other tenants may still be admitting)."""


class ServerClosed(RuntimeError):
    """Submission after `close()` -- the worker is no longer flushing."""


class ServerDegraded(RuntimeError):
    """Fast-fail admission: the server is in the degraded state (a worker
    fault or an exec-mode fallback, DESIGN.md §12) and was configured with
    `fail_fast_degraded=True`, so new work is refused immediately instead
    of queueing behind a possibly-slow degraded path."""


class AdmissionGate:
    """Weighted counting gate with per-tenant quotas and a bounded wait."""

    def __init__(self, max_pending: int, timeout_s: float,
                 clock=time.monotonic, *,
                 tenant_quota: int | None = None,
                 tenant_quotas: dict[str, int] | None = None,
                 on_wait: Callable[[int], None] | None = None,
                 metrics: MetricsRegistry | None = None) -> None:
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.max_pending = int(max_pending)
        self.timeout_s = float(timeout_s)
        self.tenant_quota = None if tenant_quota is None else int(tenant_quota)
        self.tenant_quotas = dict(tenant_quotas or {})
        self.on_wait = on_wait
        self._clock = clock
        self._cond = threading.Condition()
        self._inflight = 0                       # weighted slots
        self._tenants: dict[str, int] = {}       # tenant -> weighted slots
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c_rejected = self.metrics.counter(
            "serve_admission_rejected_total")
        self._c_tenant_rejected = self.metrics.counter(
            "serve_admission_tenant_rejected_total")
        self._g_inflight = self.metrics.gauge(
            "serve_admission_inflight_weight")
        self._g_tenant = self.metrics.gauge(
            "serve_admission_tenant_inflight")

    def quota_for(self, tenant: str) -> int:
        """The tenant's weighted in-flight cap (explicit > uniform > the
        global bound -- quotas can only narrow admission, never widen)."""
        q = self.tenant_quotas.get(tenant, self.tenant_quota)
        return self.max_pending if q is None else min(int(q), self.max_pending)

    @property
    def inflight(self) -> int:
        with self._cond:
            return self._inflight

    @property
    def rejected(self) -> int:
        return self._c_rejected.value()

    def pressure(self) -> float:
        """Weighted in-flight load as a fraction of `max_pending` (the
        server's overload-shed trigger, DESIGN.md §13)."""
        with self._cond:
            return self._inflight / self.max_pending

    def tenant_stats(self) -> dict[str, dict[str, int]]:
        """Per-tenant {inflight, quota, rejected} snapshot (operator API).
        Registry-only reads (§15): safe under the server's `hold()`."""
        inflight = self._g_tenant.group_by("tenant")
        rejected = self._c_tenant_rejected.group_by("tenant")
        tenants = ({t for t, v in inflight.items() if v}
                   | {t for t, v in rejected.items() if v})
        return {t: {"inflight": inflight.get(t, 0),
                    "quota": self.quota_for(t),
                    "rejected": rejected.get(t, 0)}
                for t in sorted(tenants)}

    def snapshot(self) -> dict:
        """Registry-only gate surface for the server's one-lock stats()
        snapshot (DESIGN.md §15): never touches the gate's `_cond`."""
        pending = self._g_inflight.value()
        return {"pending": pending,
                "pressure": pending / self.max_pending,
                "rejected": self._c_rejected.value(),
                "tenants": self.tenant_stats()}

    def _fits(self, weight: int, tenant: str, quota: int) -> bool:
        return (self._inflight + weight <= self.max_pending
                and self._tenants.get(tenant, 0) + weight <= quota)

    def acquire(self, weight: int = 1, tenant: str = "default",
                timeout: float | None = None) -> None:
        """Take `weight` in-flight slots for `tenant`, blocking up to
        `timeout` (None = the gate's default). Raises `ServerOverloaded`
        (global bound) or `TenantOverQuota` (tenant bound) when the slots
        never free up. All-or-nothing: both bounds must fit at once."""
        weight = max(1, int(weight))
        quota = self.quota_for(tenant)
        if weight > quota:
            # oversized request: would never fit -- fail loud, don't hang
            self._c_tenant_rejected.inc(tenant=tenant)
            raise TenantOverQuota(
                f"request weight {weight} exceeds tenant {tenant!r} quota "
                f"{quota} outright")
        timeout = self.timeout_s if timeout is None else float(timeout)
        deadline = self._clock() + timeout
        if self.on_wait is not None and not self._fits(
                weight, tenant, quota):
            # unlocked peek: purely a wake hint for the shedding worker --
            # a racy false positive or negative only costs one notify.
            # Carries the blocked weight so the shedder can free exactly
            # enough low-priority slots for this submitter to pass.
            self.on_wait(weight)
        with self._cond:
            while not self._fits(weight, tenant, quota):
                remaining = deadline - self._clock()
                if remaining <= 0 or not self._cond.wait(remaining):
                    tenant_full = (self._tenants.get(tenant, 0) + weight
                                   > quota)
                    self._c_rejected.inc()
                    if tenant_full:
                        self._c_tenant_rejected.inc(tenant=tenant)
                        raise TenantOverQuota(
                            f"tenant {tenant!r} at quota "
                            f"{self._tenants.get(tenant, 0)}/{quota} "
                            f"for {timeout:.3f}s")
                    raise ServerOverloaded(
                        f"{self._inflight} weighted slots in flight >= "
                        f"max_pending={self.max_pending} for {timeout:.3f}s")
            self._inflight += weight
            self._tenants[tenant] = self._tenants.get(tenant, 0) + weight
            with self.metrics.hold():
                self._g_inflight.add(weight)
                self._g_tenant.add(weight, tenant=tenant)

    def release(self, weight: int = 1, tenant: str = "default") -> None:
        """Free `weight` slots of `tenant` (its request was fulfilled)."""
        weight = max(1, int(weight))
        with self._cond:
            self._inflight -= weight
            held = self._tenants.get(tenant, 0) - weight
            assert self._inflight >= 0 and held >= 0, \
                "admission gate over-released"
            if held:
                self._tenants[tenant] = held
            else:
                self._tenants.pop(tenant, None)
            with self.metrics.hold():
                self._g_inflight.add(-weight)
                self._g_tenant.add(-weight, tenant=tenant)
            self._cond.notify_all()


__all__ = ["AdmissionGate", "ServerClosed", "ServerDegraded",
           "ServerOverloaded", "TenantOverQuota"]
