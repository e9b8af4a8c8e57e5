#!/usr/bin/env python3
"""Time the wide limb kernel (`karatsuba_matmul_wide`) of several copies of
the port on one card, in turns.

    python3 scripts/time_karatsuba_trees.py TREE [TREE ...]

Each TREE is a directory that holds a copy of this repository's `src/`:
for example a parent commit, `git archive <commit> src | tar -x -C
build/parent`, beside a copy of the working tree (a directory that
.gitignore lists). The script builds the limb kernels of every tree at
once, then times them in one process per tree, in the order given and
then reversed (A B B A), so that two versions are compared on one card in
one run.

Cases, both limb modes (Karatsuba w = 7, schoolbook w = 8): the five limb
calls of the inference path at 64x64 x 256 images (cnn conv1, conv2,
dense; mlp dense1, dense2) on balanced limbs of seeded q in +-(2**14 - 1),
as nbits = 14 calibrates them; and 2048 x 896 x 4864 on the same limbs
(past int8: 2 int8 digits) and on full-range int32 limbs with the extremes
placed in (4 digits). Device ms of one call of the wide kernel (10 calls
queued while the card is held, median of 7): `karatsuba_matmul_wide` in a
tree without a launch plan (the first, CUDA-core wide kernel), else
`run_plan` with the plan `launch_plan` names for the limbs' digit count,
so no call reads it back; and of the int8 route's pack step
(`pack_async`) on the same limbs; then the int8 route's pack on int8 limbs
(the LM path's) at the Qwen2-0.5B train step's four shapes (M = 1024) and
at 2048 x 896 x 4864. One JSON line per tree and turn, and the card's name
and power limit first. Needs a CUDA card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

# (name, (M, K, N)) of the inference path's limb calls at 64x64 x 256
WIDE_SHAPES = (("cnn_conv1", (1048576, 9, 4)), ("cnn_conv2", (262144, 36, 8)),
               ("cnn_dense", (256, 2048, 4)), ("mlp_dense1", (256, 4096, 32)),
               ("mlp_dense2", (256, 32, 4)))
LARGE = (2048, 896, 4864)
# (K, N) of a Qwen2-0.5B train step's quantized dense calls, at M = 1024
TRAIN_SHAPES = ((1024, 896, 896), (1024, 896, 128), (1024, 896, 4864), (1024, 4864, 896))
QMAX = (1 << 14) - 1
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


def limbs(shape, karatsuba: bool, full_range: bool, seed: int, device):
    """(a_hi, a_lo, b_hi, b_lo) on the card: balanced limbs of q in
    +-QMAX, or full-range int32 limbs with INT_MIN / INT_MAX placed in."""
    import numpy as np
    import torch
    m, k, n = shape
    rng = np.random.default_rng(seed)
    if full_range:
        out = [rng.integers(-(1 << 31), 1 << 31, s, dtype=np.int64) for s in
               ((m, k), (m, k), (k, n), (k, n))]
        out[0][0, :2] = (-(1 << 31), (1 << 31) - 1)
        out[2][:2, 0] = ((1 << 31) - 1, -(1 << 31))
    else:
        w = 7 if karatsuba else 8
        half = 1 << (w - 1)
        out = []
        for s in ((m, k), (k, n)):
            q = rng.integers(-QMAX, QMAX + 1, s, dtype=np.int64)
            lo = ((q + half) & ((1 << w) - 1)) - half
            out += [(q - lo) >> w, lo]
    return [torch.from_numpy(v.astype(np.int32)).to(device) for v in out]


def worker(tree: Path, mode: str) -> None:
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import build
    build.LIBRARIES = {name: build.LIBRARIES[name]
                       for name in ("karatsuba_matmul", "karatsuba_matmul_i8")}
    if mode == "build":
        build.build()
        return
    import torch

    from repro_torch.kernels import karatsuba_matmul as km
    from repro_torch.kernels import karatsuba_matmul_i8 as i8
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {"tree": str(tree)}
    cases = [(name, shape, False) for name, shape in WIDE_SHAPES]
    cases += [("large_q14", LARGE, False), ("large_full", LARGE, True)]
    for kar in (True, False):
        for i, (name, shape, full) in enumerate(cases):
            args = limbs(shape, kar, full, 60 + i, dev)
            if hasattr(km, "launch_plan"):
                plan = km.launch_plan(*shape, km.limb_digits(*args, karatsuba=kar), sms)
                call = lambda: km.run_plan(*args, plan, karatsuba=kar)  # noqa: E731
            else:
                call = lambda: km.karatsuba_matmul_wide(*args, karatsuba=kar)  # noqa: E731
            key = f"{name}_{'karatsuba' if kar else 'schoolbook'}"
            out[key] = device_ms(call)
            out[f"{key}_pack"] = device_ms(lambda: i8.pack_async(*args, karatsuba=kar))
            del args
            torch.cuda.empty_cache()
    for i, shape in enumerate(TRAIN_SHAPES + (LARGE,)):
        args = [t.clamp(-64, 63) for t in limbs(shape, True, False, 90 + i, dev)]
        out["int8_pack_{}x{}x{}".format(*shape)] = device_ms(
            lambda: i8.pack_async(*args, karatsuba=True))
    print(json.dumps(out), flush=True)


def main(trees: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("time_karatsuba_trees: no CUDA device", file=sys.stderr)
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
