"""The device grid of the sharded filter datapath, and shard-shape planning.

Counterpart of `repro.distribute.mesh`. A sharded run splits a batch over a
2-D `(batch, rows)` grid of devices: whole images ride the `batch` axis
(no halo traffic) and row bands of one image ride the `rows` axis (each
band carries a kh//2-row halo). The port runs it in one process, as the
reference does (one controller over its local devices): a `FilterMesh` is
a grid of torch devices.

  * On the card the devices are the CUDA devices of this process
    (`torch.cuda.device_count()`); a one-card machine has a 1x1 mesh.
  * With `device="cpu"` the grid is of logical CPU shards: every shard runs
    on the CPU, in turn. `CPU_LOGICAL_DEVICES` of them are visible, the
    counterpart of the `--xla_force_host_platform_device_count=8` the
    reference's tests set, so multi-shard halos are held on the CPU.

`shard_dims` / `shard_local_shape` are the pure planning functions, copied
from the reference: they pad the global (N, H) to the grid with zero
images and zero rows (cropped from the output; the pad rows are the zero
halo the local pass reads anyway) and name the shard-local shape the conv
passes -- and so the tuning cache -- see.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.platform import resolve_device
from repro_torch.tuning.blocks import round_up

#: mesh axis names: whole images x row bands.
BATCH_AXIS = "batch"
ROWS_AXIS = "rows"

#: logical CPU shards visible to a CPU mesh.
CPU_LOGICAL_DEVICES = 8


@dataclasses.dataclass(frozen=True)
class FilterMesh:
    """A (batch, rows) grid of devices: `devices[b, r]` runs the shard of
    batch slice b and row band r; `ids[b, r]` is its device id (the CUDA
    index, or the logical CPU shard's)."""

    devices: np.ndarray          # (nb, nr) object array of torch.device
    ids: np.ndarray              # (nb, nr) int array

    @property
    def shape(self) -> tuple[int, int]:
        nb, nr = self.devices.shape
        return int(nb), int(nr)


def _backend_device(device) -> torch.device:
    """The device type a mesh is built on: `device`'s (the card for None)."""
    dev = resolve_device(device)
    return torch.device(dev.type)


def device_count(device: str | torch.device | None = None) -> int:
    """Devices a mesh of `device`'s type may use: the CUDA devices of this
    process, or CPU_LOGICAL_DEVICES logical CPU shards."""
    dev = _backend_device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else CPU_LOGICAL_DEVICES


def devices_by_id(ids: Sequence[int], device: str | torch.device | None = None
                  ) -> list[torch.device]:
    """The devices named by `ids`, in the given order."""
    dev = _backend_device(device)
    count = device_count(dev)
    missing = [i for i in ids if not 0 <= int(i) < count]
    if missing:
        raise ValueError(f"unknown device ids {missing}; visible ids are "
                         f"{list(range(count))}")
    if dev.type == "cuda":
        return [torch.device("cuda", int(i)) for i in ids]
    return [torch.device("cpu") for _ in ids]


def auto_mesh_shape(ndev: int, n: int) -> tuple[int, int]:
    """Default (batch_shards, row_shards) factorization of `ndev` devices:
    the largest divisor of `ndev` not above the batch size shards the
    batch, the rest shards rows (a single image gets a pure rows mesh)."""
    nb = 1
    for d in range(1, ndev + 1):
        if ndev % d == 0 and d <= max(int(n), 1):
            nb = d
    return nb, ndev // nb


def filter_mesh(devices: int | Sequence[int] | None = None,
                mesh_shape: tuple[int, int] | None = None, *, n: int = 1,
                device: str | torch.device | None = None) -> FilterMesh:
    """Build the (batch, rows) mesh for a sharded filter run on `device`'s
    type (the card for None).

    `devices` -- how many of the visible devices to use (None = all), or an
    explicit sequence of device ids; `mesh_shape` -- explicit
    (batch_shards, row_shards), which must multiply to the device count
    used; None picks `auto_mesh_shape` for a batch of `n`."""
    dev = _backend_device(device)
    visible = device_count(dev)
    if isinstance(devices, (list, tuple)):
        ids = [int(i) for i in devices]
        devices_by_id(ids, dev)                 # validates the ids
        count = len(ids)
    else:
        count = int(devices) if devices is not None else visible
    if mesh_shape is not None:
        nb, nr = int(mesh_shape[0]), int(mesh_shape[1])
        need = nb * nr
        if need != count and devices is not None:
            raise ValueError(f"mesh_shape {mesh_shape} needs {need} devices, "
                             f"but devices={devices} was requested")
    else:
        need = count
        nb, nr = auto_mesh_shape(need, n)
    if need < 1:
        raise ValueError(f"a mesh needs at least one device, got {need}")
    if not isinstance(devices, (list, tuple)):
        if need > visible:
            raise ValueError(
                f"mesh needs {need} devices but only {visible} {dev.type} "
                "devices are visible")
        ids = list(range(need))
    elif need > len(ids):
        raise ValueError(f"mesh needs {need} devices but devices={devices} "
                         f"names {len(ids)}")
    ids = ids[:need]
    grid = np.empty(need, dtype=object)
    grid[:] = devices_by_id(ids, dev)
    return FilterMesh(grid.reshape(nb, nr), np.asarray(ids).reshape(nb, nr))


def shard_dims(n: int, h: int, nb: int, nr: int, ph: int) -> tuple[int, int, int]:
    """-> (padded batch, padded rows, rows per shard) for a (nb, nr) mesh.
    The batch pads to a multiple of `nb` with zero images and the rows to
    `nr` equal bands of at least max(ceil(h/nr), ph) rows (a band shallower
    than the halo could not source its neighbour's halo from one hop)."""
    n2 = round_up(max(int(n), 1), nb)
    hl = max(-(-int(h) // nr), ph, 1)
    return n2, hl * nr, hl


def shard_local_shape(n: int, h: int, w: int, nb: int, nr: int,
                      ph: int) -> tuple[int, int, int]:
    """The (N, H, W) one shard's conv pass sees -- the shape the tuning
    cache is keyed on under sharded execution: the shard-local band plus
    its 2*ph halo rows whenever rows are actually sharded. Never the global
    image shape."""
    n2, _, hl = shard_dims(n, h, nb, nr, ph)
    ext = hl + 2 * ph if (nr > 1 and ph > 0) else hl
    return n2 // nb, ext, int(w)


__all__ = ["BATCH_AXIS", "CPU_LOGICAL_DEVICES", "ROWS_AXIS", "FilterMesh",
           "auto_mesh_shape", "device_count", "devices_by_id", "filter_mesh",
           "shard_dims", "shard_local_shape"]
