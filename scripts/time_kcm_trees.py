#!/usr/bin/env python3
"""Time the kcm conv kernels of several copies of the port on one card, in turns.

    python3 scripts/time_kcm_trees.py TREE [TREE ...]

Each TREE is a directory that holds a copy of this repository's `src/`:
for example a parent commit, `git archive <commit> src | tar -x -C
build/parent`, beside a copy of the working tree (a directory that
.gitignore lists). The script builds the conv kernels of every tree at
once, then times them in one process per tree, in the order given and
then reversed (A B B A), so that two versions are compared on one card in
one run. Times: `conv_pass_kcm` (the Fig. 9 table) and
`fused_separable_kcm` (gaussian3 and gaussian5), refmlm ROMs, on
chip_smoke.py's scale-phase frames at 16x2048x2048 and at 8x480x640; device
ms of one call: 10 calls queued while the card is held, median of 7. One
JSON line per tree and turn, and the card's name and power limit first.
Needs a CUDA card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

SHAPES = ((16, 2048, 2048), (8, 480, 640))
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


def worker(tree: Path, mode: str) -> None:
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import build
    build.SOURCES = ("conv_pass", "fused_separable")
    if mode == "build":
        build.build()
        return
    import numpy as np
    import torch

    from repro_torch.data.images import fingerprint
    from repro_torch.filters import conv
    from repro_torch.filters.bank import get_filter
    from repro_torch.kernels.gaussian_conv import gaussian_kernel_3x3
    dev = torch.device("cuda")
    out = {"tree": str(tree)}
    for shape in SHAPES:
        n, h, w = shape
        g = torch.Generator(device=dev).manual_seed(5)
        base = torch.from_numpy(fingerprint((h, w), seed=5).astype(np.int32)).to(dev)
        noise = torch.rand(shape, generator=g, device=dev)
        salt = torch.rand(shape, generator=g, device=dev) < 0.5
        x = torch.where(noise < 0.2, torch.where(salt, 255, 0), base).to(torch.int32)
        rom9 = conv.rom_stack("refmlm", gaussian_kernel_3x3(1.0, 256), 8, dev)
        out[f"conv_pass_kcm fig9 {h}x{w}"] = device_ms(
            lambda: conv.conv_pass_kcm(x, rom9, 3, 3, shift=8, post="clip"))
        for name in ("gaussian3", "gaussian5"):
            spec = get_filter(name)
            row = conv.rom_stack("refmlm", spec.sep_row, 8, dev)
            col = conv.rom_stack("refmlm", spec.sep_col, 16, dev)
            out[f"fused_separable_kcm {name} {h}x{w}"] = device_ms(
                lambda: conv.fused_separable_kcm(x, row, col, shift=spec.shift,
                                                 post=spec.post))
    print(json.dumps(out), flush=True)


def main(trees: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("time_kcm_trees: no CUDA device", file=sys.stderr)
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
