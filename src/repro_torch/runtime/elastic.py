"""Elastic serving: find the devices that are still alive (DESIGN.md §13).

Counterpart of the serving half of `repro.runtime.elastic`. The elastic
executor pool (`repro_torch.serve.pool`) needs discovery only:
`probe_device` runs a trivial one-device sharded dispatch on a single id,
and `surviving_devices` filters a member's id set down to the ids that
still complete one. Serving state is per request, so a pool member's
"restore" is a fresh `BatchExecutor` over the surviving ids; every output
stays bit-identical because the sharded path is bit-identical on any mesh
(DESIGN.md §9).

Ids name devices of one type: the CUDA devices of this process, or, with
`device='cpu'`, the logical CPU shards of `repro_torch.distribute.mesh`.

The probes run under the §12 chaos harness: the sharded dispatch path
probes `SITE_SHARD` with a `dev<id>`-suffixed key per participating
device, so an injector rule `on_key(SITE_SHARD, "dev3")` models device 3
dying, to the filter traffic and to these probes alike.

The training half (`remesh_restore`, `state_shardings`) waits for the
port's checkpoint and sharding modules (ROADMAP Queue 1 item 2, training).
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.platform import resolve_device


def probe_device(device_id: int, device: str | torch.device | None = None) -> bool:
    """True iff `device_id` (of `device`'s type, the card for None)
    completes one trivial sharded dispatch.

    The probe is a (1, 1) mesh over exactly this id running an identity
    pass, so it goes through the same `SITE_SHARD` chaos hook (key suffix
    `dev<id>`) as the real filter traffic. An id that is not visible also
    reports False. The result is copied to host memory, which waits for
    the device: an asynchronous CUDA error surfaces here, not in the next
    dispatch."""
    from repro_torch.distribute.sharded import sharded_call

    dev = resolve_device(device)            # no card at all raises here
    try:
        x = torch.zeros((1, 4, 4), dtype=torch.int32, device=dev)
        out = sharded_call(lambda t: t, ("probe",), x, 0,
                           devices=[int(device_id)], mesh_shape=(1, 1))
        out.cpu()
        return True
    except Exception:                                      # noqa: BLE001
        return False


def surviving_devices(device_ids: Sequence[int],
                      device: str | torch.device | None = None) -> tuple[int, ...]:
    """The subset of `device_ids` that still complete a probe dispatch,
    the id set a drained pool member's mesh is rebuilt from (§13)."""
    return tuple(int(i) for i in device_ids if probe_device(i, device))


__all__ = ["probe_device", "surviving_devices"]
