"""Runnable training entry point: --arch <id> [--steps N], on the CUDA card
unless `--device cpu` is given.

Counterpart of `repro.launch.train`, with its flags and defaults:

    python -m repro_torch.launch.train [--arch qwen2-0.5b] [--steps 200]
        [--batch 8] [--seq 128] [--ckpt-dir DIR] [--ckpt-every 50] [--full]
        [--inject-fault-at STEP] [--d-model D] [--device cpu]

The reduced config by default (`--full` for the published one, `--d-model`
to widen the reduced one); the crash-safe loop (`runtime.fault.
run_training`: restart from the latest checkpoint, straggler monitoring)
over deterministic data (`data.tokens.lm_batch`). Weights are random,
drawn from a generator seeded with 0. Checkpoints go to `--ckpt-dir`, by
default `repro_torch_ckpt` in the temporary directory.

Launched plainly it trains in one process on one device, and the
checkpoints record a (1, 1) mesh. Under `torchrun` (`WORLD_SIZE` and
`RANK` in the environment) it is the reference's multi-device trainer:
it initializes the process group (NCCL on the cards, one a rank by
`LOCAL_RANK`; gloo with `--device cpu`), builds `launch.mesh.
make_host_mesh()` over the world and trains the sharded state
(`make_train_state` / `make_train_step` with the mesh) through the same
loop; rank 0 prints and writes the checkpoints. A process group that does
not come up raises.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train [flags]
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.platform import resolve_device
from repro_torch.data.tokens import lm_batch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import build_model
from repro_torch.runtime.fault import FaultInjector, StragglerMonitor, run_training
from repro_torch.runtime.train_lib import make_train_state, make_train_step

#: the mesh a one-process run records in its checkpoints
MESH_SHAPE = (1, 1)


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--full", action="store_true",
                    help="full config instead of reduced()")
    ap.add_argument("--inject-fault-at", type=int, default=-1)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override reduced d_model (e.g. 512 for ~100M)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
        if args.d_model:
            cfg = dataclasses.replace(
                cfg, d_model=args.d_model, head_dim=args.d_model // cfg.num_heads,
                d_ff=2 * args.d_model if cfg.d_ff else 0)
    mesh = None
    device = resolve_device(args.device)
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        import torch.distributed as dist
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        mesh = make_host_mesh()
    rank0 = mesh is None or mesh.get_rank() == 0
    model = build_model(cfg, device)
    train_step = make_train_step(model, total_steps=args.steps, mesh=mesh)

    def init_state():
        return make_train_state(model, torch.Generator(device).manual_seed(0), mesh)

    def batch_fn(step):
        return lm_batch(cfg, batch=args.batch, seq=args.seq, step=step)

    ckpt = CheckpointManager(args.ckpt_dir, interval=args.ckpt_every)
    injector = FaultInjector([args.inject_fault_at] if args.inject_fault_at >= 0 else [])
    monitor = StragglerMonitor()
    losses = []

    def on_metrics(step, m):
        losses.append(float(m["loss"]))
        if step % 10 == 0:
            print(f"step {step:5d} loss {float(m['loss']):.4f} "
                  f"lr {float(m['lr']):.2e} |g| {float(m['grad_norm']):.3f}")

    try:
        state = run_training(
            train_step=train_step, init_state=init_state, batch_fn=batch_fn,
            num_steps=args.steps, ckpt=ckpt,
            mesh_shape=MESH_SHAPE if mesh is None else tuple(mesh.shape),
            injector=injector, straggler=monitor, on_metrics=on_metrics)
        if rank0:
            n_params = model.count_params(state.params)
            print(f"done: {args.steps} steps, {n_params:,} params, "
                  f"loss {losses[0]:.4f} -> {np.mean(losses[-10:]):.4f}, "
                  f"stragglers flagged: {len(monitor.flagged)}, final loss {losses[-1]!r}")
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()
    return state, losses


if __name__ == "__main__":
    main()
