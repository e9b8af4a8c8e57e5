"""Fault-tolerant checkpointing: async, atomic, device-agnostic.

Counterpart of `repro.checkpoint.checkpoint`, on the reference's layout:

    <dir>/step_<N:08d>/
        arrays.npz      every leaf, key = its '/'-joined tree path
        manifest.json   {step, num_leaves, mesh_shape, "complete": true}

  * atomic: written to step_<N>.tmp-<pid>, then `os.rename`d, so a crash
    mid-write never leaves a half checkpoint that `latest_step` would pick;
  * async: `save(..., blocking=False)` snapshots every leaf into host
    memory before it returns, then writes on a daemon thread while training
    goes on. The snapshot is a copy (`Tensor.to("cpu", copy=True)`): on
    the CPU `.cpu()` returns the same storage, and the next step's in-place
    update would race the writer;
  * device-agnostic: `restore` puts the leaves on the device asked for;
  * mesh-agnostic: a sharded state (DTensor leaves, `repro_torch.runtime.
    sharding`) is saved whole, under the same keys, so a checkpoint's bytes
    do not depend on the mesh that wrote it; every rank gathers, rank 0
    writes, and `manifest.json` records the mesh's shape. `restore(...,
    shardings=...)` gives each rank its block on the mesh asked for
    (`repro_torch.runtime.elastic.remesh_restore`).

A tree is nested dicts, lists, tuples and NamedTuples (a `TrainState`)
with tensor leaves; None is an empty subtree. Keys follow the reference's
naming (dict key, list index, NamedTuple field name), so the paths are its
own where the trees agree.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.core.tree import tree_map_with_path, tree_paths


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _snapshot(tree: Any, keep: bool = True) -> dict[str, np.ndarray]:
    """Every leaf of `tree` as a NumPy copy in host memory, by path; a
    sharded leaf gathered whole first, which every rank takes part in.
    With `keep` False the gathers run and nothing is copied."""
    from repro_torch.runtime.sharding import gather
    out = {}
    for k, v in tree_paths(tree):
        if isinstance(v, torch.Tensor):
            full = gather(v)
            if keep:
                out[k] = full.detach().to("cpu", copy=True).numpy()
        elif keep:
            out[k] = np.array(v, copy=True)
    return out


def save(ckpt_dir: str, step: int, tree: Any, *, mesh_shape=None,
         blocking: bool = True) -> threading.Thread | None:
    """Checkpoint `tree` at `step`. Returns the writer thread if async.
    Under a process group every rank calls it: a sharded leaf is gathered
    whole, and rank 0 alone snapshots and writes."""
    host = _snapshot(tree, keep=_rank() == 0)
    if _rank() != 0:
        return None
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = f"{final}.tmp-{os.getpid()}"

    def write():
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        manifest = {"step": step, "num_leaves": len(host),
                    "mesh_shape": list(mesh_shape) if mesh_shape else None,
                    "complete": True}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if blocking:
        write()
        return None
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> int | None:
    """Newest COMPLETE checkpoint step (half-written ones are skipped)."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if not m:
            continue
        try:
            with open(os.path.join(ckpt_dir, name, "manifest.json")) as f:
                if json.load(f).get("complete"):
                    best = max(best or -1, int(m.group(1)))
        except (OSError, json.JSONDecodeError):
            continue                       # torn write -> not a candidate
    return best


def restore(ckpt_dir: str, step: int, like: Any,
            device: str | torch.device | None = None, shardings: Any = None) -> Any:
    """A new tree shaped as `like` from the checkpoint at `step`: each leaf
    in its `like` leaf's dtype, on `device` (else that leaf's device), with
    its `requires_grad`. A leaf with a `Sharding` in `shardings` (a tree
    shaped as `like`), or a sharded `like` leaf without one, comes back as
    a DTensor holding this rank's block of the saved array, on its mesh's
    device. Raises ValueError on a missing leaf or a shape that differs."""
    from repro_torch.runtime import sharding as shd
    data = np.load(os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz"))
    specs = dict(tree_paths(shardings)) if shardings is not None else {}

    def leaf(key: str, t: torch.Tensor) -> torch.Tensor:
        if key not in data:
            raise ValueError(f"checkpoint step {step} has no leaf {key!r}")
        arr = data[key]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs {tuple(t.shape)}")
        full = torch.from_numpy(arr)
        sharding = specs.get(key)
        if sharding is None and shd.is_sharded(t):
            sharding = shd.Sharding(t.device_mesh, shd.spec_of(t))
        if sharding is not None:
            return shd.distribute(full.to(shd.mesh_device(sharding.mesh), t.dtype), sharding)
        out = full.to(device if device is not None else t.device, t.dtype)
        return out.requires_grad_(t.requires_grad)

    return tree_map_with_path(leaf, like)


class CheckpointManager:
    """Every-N-steps async checkpointing with retention + restart helper."""

    def __init__(self, ckpt_dir: str, *, interval: int = 50, keep: int = 3):
        self.dir = ckpt_dir
        self.interval = interval
        self.keep = keep
        self._pending: threading.Thread | None = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def maybe_save(self, step: int, tree: Any, mesh_shape=None) -> bool:
        if step % self.interval:
            return False
        self.wait()
        self._pending = save(self.dir, step, tree, mesh_shape=mesh_shape, blocking=False)
        self._gc()
        return True

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self):
        if _rank() != 0:
            return
        steps = sorted(int(m.group(1)) for m in
                       (re.fullmatch(r"step_(\d+)", n) for n in os.listdir(self.dir)) if m)
        # one save is in flight: keep-1 on disk now -> keep once it lands
        cut = -(self.keep - 1) or None
        for s in steps[:cut]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    def restore_latest(self, like: Any, device=None) -> tuple[int | None, Any]:
        """(the newest complete step, `like` restored from it) or (None,
        None). Under a process group every rank waits here until rank 0's
        writer has finished, so that all of them read the same step."""
        import torch.distributed as dist
        self.wait()
        if dist.is_available() and dist.is_initialized():
            dist.barrier()
        step = latest_step(self.dir)
        if step is None:
            return None, None
        return step, restore(self.dir, step, like, device)


__all__ = ["CheckpointManager", "latest_step", "restore", "save"]
