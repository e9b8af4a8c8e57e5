#!/usr/bin/env python3
"""Time `mitchell_matmul` of several copies of the port on one card, in turns.

    python3 scripts/time_mitchell_trees.py TREE [TREE ...]

Each TREE is a directory that holds a copy of this repository's `src/`:
for example a parent commit, `git archive <commit> src | tar -x -C
build/parent`, beside a copy of the working tree (a directory that
.gitignore lists). The script builds the kernel of every tree at once, then
times it in one process per tree, in the order given and then reversed
(A B B A), so that two versions are compared on one card in one run.

Times, for `mitchell_matmul` (num_ecc 0, case split: Mitchell's algorithm)
on seeded 8-bit operands: device ms of one call (10 calls queued while the
card is held, median of 7) at the Qwen2-0.5B dense shapes of a batch-4
decode step (M = 4) and of a 4 x 32 prefill (M = 128), and at 2048 x 896 x
4864; the decode step's sum (device ms x launches a step); then Qwen2-0.5B
at full width (24 layers, bf16, random weights from a seeded generator)
with matmul_method 'mitchell': one decode step after a 4 x 32 prefill under
torch.profiler, the device ms of the mitchell_matmul kernels in it, and the
decode step's wall ms (median of 5, each ended by a sync). One JSON line per
tree and turn, and the card's name and power limit first. Needs a CUDA card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

# (K, N) of Qwen2-0.5B's dense calls and their launches a decode step
LM_DENSE = (((896, 896), 48), ((896, 128), 48), ((896, 4864), 48), ((4864, 896), 24))
DECODE_M, PREFILL_M = 4, 128
LARGE = (2048, 896, 4864)
SM_CLOCK_HZ = 1.98e9


def device_ms(fn, calls: int = 10, runs: int = 7) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(0.005 * SM_CLOCK_HZ))
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def lm_decode(device) -> dict[str, float]:
    """mitchell_matmul's device ms in one Qwen2-0.5B decode step (batch 4,
    after a 32-token prefill) under torch.profiler, and the step's wall ms."""
    import dataclasses
    import time

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("qwen2-0.5b"), matmul_method="mitchell")
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0))
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32))).to(device)
    caches = model.init_cache(4, 64)
    logits, caches, clen = model.prefill(params, {"tokens": prompt}, caches)
    walls = []
    for _ in range(5):
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches, clen = model.decode_step(params, tok, caches, clen)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.decode_step(params, tok, caches, clen)
        torch.cuda.synchronize()
    mitchell = busy = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            busy += ms
            mitchell += ms if "mitchell_matmul" in e.name else 0.0
    return {"lm_decode_step_mitchell_device_ms": mitchell, "lm_decode_step_device_ms": busy,
            "lm_decode_step_wall_ms": statistics.median(walls)}


def worker(tree: Path, mode: str) -> None:
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import build
    build.LIBRARIES = {"mitchell_matmul": build.LIBRARIES["mitchell_matmul"]}
    if mode == "build":
        build.build()
        return
    import numpy as np
    import torch

    from repro_torch.kernels.mitchell_matmul import mitchell_matmul_kernel
    dev = torch.device("cuda")
    rng = np.random.default_rng(90)
    out = {"tree": str(tree)}
    step = 0.0
    shapes = [((DECODE_M, k, n), per_step) for (k, n), per_step in LM_DENSE]
    shapes += [((PREFILL_M, k, n), 0) for (k, n), _ in LM_DENSE] + [(LARGE, 0)]
    for (m, k, n), per_step in shapes:
        a, b = (torch.from_numpy(rng.integers(-255, 256, s).astype(np.int32)).to(dev)
                for s in ((m, k), (k, n)))
        ms = device_ms(lambda: mitchell_matmul_kernel(a, b))
        out[f"{m}x{k}x{n}"] = ms
        step += ms * per_step
    out["decode_step_ms"] = step
    out.update(lm_decode(dev))
    print(json.dumps(out), flush=True)


def main(trees: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("time_mitchell_trees: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    me = [sys.executable, __file__, "--worker"]
    builds = [subprocess.Popen(me + [t, "build"]) for t in trees]
    if any(p.wait() for p in builds):
        return 1
    for tree in trees + trees[::-1]:
        subprocess.run(me + [tree, "time"], check=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        worker(Path(sys.argv[2]).resolve(), sys.argv[3])
        sys.exit(0)
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
