"""Elastic scaling: rebuild on the devices that are still alive (DESIGN.md
§13).

Counterpart of `repro.runtime.elastic`. Two consumers share the idea:

  * training -- restore a checkpoint taken on mesh A onto mesh B.
    Checkpoints hold whole arrays (`repro_torch.checkpoint`), so
    elasticity is "derive the shardings on the new mesh, keep each rank's
    block": `remesh_restore(ckpt_dir, abstract_state, cfg, new_mesh)`, with
    `state_shardings` for a `TrainState`. Data order stays deterministic
    because batches are pure functions of the step;
  * serving -- the elastic executor pool (`repro_torch.serve.pool`)
    needs discovery only: `probe_device` runs a trivial one-device sharded
    dispatch on a single id, and `surviving_devices` filters a member's id
    set down to the ids that still complete one. Serving state is per
    request, so a pool member's "restore" is a fresh `BatchExecutor` over
    the surviving ids; every output stays bit-identical because the
    sharded path is bit-identical on any mesh (DESIGN.md §9).

Ids name devices of one type: the CUDA devices of this process, or, with
`device='cpu'`, the logical CPU shards of `repro_torch.distribute.mesh`.

The probes run under the §12 chaos harness: the sharded dispatch path
probes `SITE_SHARD` with a `dev<id>`-suffixed key per participating
device, so an injector rule `on_key(SITE_SHARD, "dev3")` models device 3
dying, to the filter traffic and to these probes alike.
"""
from __future__ import annotations

from typing import Any, Sequence

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


def abstract_train_state(cfg):
    """The `TrainState` of `cfg` with shapes and dtypes and no storage
    (tensors of a `FakeTensorMode`): what `remesh_restore` fills."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.model import build_model
    from repro_torch.runtime.train_lib import make_train_state
    with FakeTensorMode():
        return make_train_state(build_model(cfg, "cpu"), torch.Generator("cpu"))


def state_shardings(abstract_state, cfg, mesh, *, multi_pod: bool):
    """A `TrainState` of `Sharding`s for a `TrainState` (params, optimizer
    state, residual; the step whole), by `repro_torch.runtime.sharding`."""
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.train_lib import TrainState
    return TrainState(
        shd.scalar_sharding(mesh),
        shd.param_shardings(abstract_state.params, cfg, mesh, multi_pod=multi_pod),
        shd.opt_shardings(abstract_state.opt, cfg, mesh, multi_pod=multi_pod),
        shd.ef_shardings(abstract_state.ef, cfg, mesh, multi_pod=multi_pod))


def remesh_restore(ckpt_dir: str, abstract_state, cfg, new_mesh,
                   *, multi_pod: bool) -> tuple[int, Any]:
    """(step, the newest checkpoint's state with each rank's blocks on
    `new_mesh`); every rank of `new_mesh` calls it. Raises
    FileNotFoundError without a checkpoint."""
    from repro_torch.checkpoint import latest_step, restore
    from repro_torch.runtime import sharding as shd
    step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    shardings = state_shardings(abstract_state, cfg, new_mesh, multi_pod=multi_pod)
    return step, restore(ckpt_dir, step, abstract_state, device=shd.mesh_device(new_mesh),
                         shardings=shardings)


__all__ = ["abstract_train_state", "probe_device", "remesh_restore", "state_shardings",
           "surviving_devices"]
