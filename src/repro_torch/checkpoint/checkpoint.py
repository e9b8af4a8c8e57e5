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
  * device-agnostic: `restore` puts the leaves on the device asked for.

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

from repro_torch.core.tree import tree_paths


def _rebuild(tree: Any, leaf_fn, prefix: str = "") -> Any:
    """`tree` with each leaf replaced by leaf_fn(path, leaf)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaf_fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), leaf_fn,
                                     f"{prefix}/{f}" if prefix else f) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaf_fn, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return leaf_fn(prefix, tree)


def _snapshot(tree: Any) -> dict[str, np.ndarray]:
    """Every leaf of `tree` as a NumPy copy in host memory, by path."""
    return {k: (v.detach().to("cpu", copy=True).numpy() if isinstance(v, torch.Tensor)
                else np.array(v, copy=True)) for k, v in tree_paths(tree)}


def save(ckpt_dir: str, step: int, tree: Any, *, mesh_shape=None,
         blocking: bool = True) -> threading.Thread | None:
    """Checkpoint `tree` at `step`. Returns the writer thread if async."""
    host = _snapshot(tree)
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
            device: str | torch.device | None = None) -> Any:
    """A new tree shaped as `like` from the checkpoint at `step`: each leaf
    in its `like` leaf's dtype, on `device` (else that leaf's device), with
    its `requires_grad`. Raises ValueError on a missing leaf or a shape
    that differs."""
    data = np.load(os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz"))

    def leaf(key: str, t: torch.Tensor) -> torch.Tensor:
        if key not in data:
            raise ValueError(f"checkpoint step {step} has no leaf {key!r}")
        arr = data[key]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs {tuple(t.shape)}")
        out = torch.from_numpy(arr).to(device if device is not None else t.device, t.dtype)
        return out.requires_grad_(t.requires_grad)

    return _rebuild(like, leaf)


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
        steps = sorted(int(m.group(1)) for m in
                       (re.fullmatch(r"step_(\d+)", n) for n in os.listdir(self.dir)) if m)
        # one save is in flight: keep-1 on disk now -> keep once it lands
        cut = -(self.keep - 1) or None
        for s in steps[:cut]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    def restore_latest(self, like: Any, device=None) -> tuple[int | None, Any]:
        self.wait()
        step = latest_step(self.dir)
        if step is None:
            return None, None
        return step, restore(self.dir, step, like, device)


__all__ = ["CheckpointManager", "latest_step", "restore", "save"]
