"""Meshes: the production meshes (shape only) and the host mesh over the
process group's ranks.

Counterpart of `repro.launch.mesh`. Functions, not module constants:
importing this module touches no device and no process group.

  * `make_production_mesh(multi_pod)` is (16, 16) ("data", "model") or (2,
    16, 16) ("pod", "data", "model"): the axis sizes the sharding rules
    resolve against (`repro_torch.runtime.sharding`), with no ranks behind
    them, so a 256- or 512-card layout is planned from one process;
  * `make_host_mesh(data, model)` is a `DeviceMesh` ("data", "model") over
    the initialized process group: "cuda" under NCCL, "cpu" under gloo.
    `data` defaults to world_size // model. Without a process group, or
    with a shape that does not cover the world, it raises;
  * `fake_production_mesh(multi_pod)` is a context manager: PyTorch's
    "fake" process group at the production mesh's world (256 or 512
    ranks, this process rank 0, every collective a no-op) and rank 0's
    `DeviceMesh` over it, the group destroyed on exit. Under
    `FakeTensorMode` one step of the port's program then runs as one
    rank of the production mesh runs it, with nothing allocated: what
    `repro_torch.launch.dryrun` counts.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple


class ShapeMesh(NamedTuple):
    """A mesh's axis names and sizes, with no devices: `.shape` maps each
    name to its size, as a JAX `Mesh`'s does."""
    mesh_dim_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.mesh_dim_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    if multi_pod:
        return ShapeMesh(("pod", "data", "model"), (2, 16, 16))
    return ShapeMesh(("data", "model"), (16, 16))


def make_host_mesh(*, data: int | None = None, model: int = 1):
    """A (data, model) `DeviceMesh` over every rank of the process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_host_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    data = data if data is not None else world // model
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh does not cover the world of {world} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def fake_production_mesh(multi_pod: bool = False):
    """Rank 0's `DeviceMesh` of the production mesh over a "fake" process
    group of its world (256 or 512 ranks), a "cuda" mesh where a card is
    present, else "cpu"; the group is destroyed on exit. Raises if a
    process group is already initialized."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = make_production_mesh(multi_pod=multi_pod)
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    world = 1
    for n in shape.sizes:
        world *= n
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield init_device_mesh(device_type, shape.sizes, mesh_dim_names=shape.mesh_dim_names)
    finally:
        dist.destroy_process_group()


__all__ = ["ShapeMesh", "fake_production_mesh", "make_host_mesh", "make_production_mesh"]
