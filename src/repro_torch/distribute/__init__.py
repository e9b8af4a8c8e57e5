"""`repro_torch.distribute` -- scale-out execution of the filter datapath:
sharded (a (batch, rows) grid of devices with halo'd row bands) and
streamed (out-of-core overlapping tiles), both bit-identical to the
single-device path.

Counterpart of `repro.distribute`. Layers:
  mesh.py     -- the (batch, rows) device grid and shard-shape planning
                 (`filter_mesh`, `shard_dims`, `shard_local_shape`);
  sharded.py  -- the passes and `apply_filter` over the grid, in one
                 process, halos by exchange between shards or embedded
                 overlapping windows;
  streamed.py -- the tile planner and the out-of-core executor with its
                 crash-resume journal (`plan_tiles`, `stream_filter`).

The one-call entry point mirrors the local pipeline:

    from repro_torch import distribute
    distribute.apply_filter(imgs, "gaussian5", exec="sharded")   # grid
    distribute.apply_filter(big, "gaussian5", exec="streamed")   # tiles

which is `repro_torch.filters.apply_filter(..., exec=...)`, the routing
the serving layer rides for a bucket of a scale-out mode.
"""
from __future__ import annotations

from repro_torch.distribute.mesh import (
    BATCH_AXIS,
    CPU_LOGICAL_DEVICES,
    ROWS_AXIS,
    FilterMesh,
    auto_mesh_shape,
    device_count,
    devices_by_id,
    filter_mesh,
    shard_dims,
    shard_local_shape,
)
from repro_torch.distribute.sharded import (
    HALO_MODES,
    sharded_apply_filter,
    sharded_call,
    sharded_conv2d_pass,
    sharded_fused_separable_pass,
)
from repro_torch.distribute.streamed import (
    JOURNAL_MAGIC,
    Tile,
    journal_fingerprint,
    load_journal,
    plan_tiles,
    stream_filter,
)
from repro_torch.filters.pipeline import EXEC_MODES


def apply_filter(imgs, filt, *, exec: str = "sharded", **kw):
    """Thin mirror of `repro_torch.filters.apply_filter` defaulting to
    scale-out execution; `exec` is 'local' | 'sharded' | 'streamed'."""
    from repro_torch.filters.pipeline import apply_filter as _apply_filter
    return _apply_filter(imgs, filt, exec=exec, **kw)


__all__ = [
    "BATCH_AXIS",
    "CPU_LOGICAL_DEVICES",
    "EXEC_MODES",
    "HALO_MODES",
    "JOURNAL_MAGIC",
    "ROWS_AXIS",
    "FilterMesh",
    "Tile",
    "apply_filter",
    "auto_mesh_shape",
    "device_count",
    "devices_by_id",
    "filter_mesh",
    "journal_fingerprint",
    "load_journal",
    "plan_tiles",
    "shard_dims",
    "shard_local_shape",
    "sharded_apply_filter",
    "sharded_call",
    "sharded_conv2d_pass",
    "sharded_fused_separable_pass",
    "stream_filter",
]
