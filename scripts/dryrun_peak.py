"""What a rank holds at a dry-run count's peak: the live storages at the
counted peak by size, and the Python stack that reached it.

    PYTHONPATH=src python scripts/dryrun_peak.py --arch deepseek-v3-671b \
        --shape train_4k [--layers 5] [--multi-pod]

It counts one cell as `python -m repro_torch.launch.dryrun` does (rank 0
of the fake production mesh, fake CPU tensors, `launch.dryrun.count_cell`),
with `roofline.analysis.StepCounter._track` wrapped to keep a snapshot at
each new peak (in steps of 256 MiB). `--layers` cuts the depth, as the
counts' layer extrapolation does, to keep a MoE config's count to minutes.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
import traceback
from collections import Counter

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import count_cell
from repro_torch.launch.mesh import fake_production_mesh
from repro_torch.roofline import analysis

GIB = 2**30


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args()
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)

    snap: dict = {"peak": 0}
    track = analysis.StepCounter._track

    def tracked(self, t):
        key = track(self, t)
        if self.peak_bytes > snap["peak"] + 2**28:
            snap.update(peak=self.peak_bytes, sizes=Counter(self._live.values()),
                        stack="".join(traceback.format_stack(limit=16)[:-2]))
        return key

    analysis.StepCounter._track = tracked
    t0 = time.perf_counter()
    with fake_production_mesh(args.multi_pod) as mesh:
        counts, _ = count_cell(cfg, SHAPES[args.shape], mesh, device="cpu")
    print(f"{args.arch} {args.shape} layers {cfg.num_layers}: peak {counts.peak_bytes / GIB:.3f} "
          f"GiB, arguments {counts.argument_bytes / GIB:.3f} GiB "
          f"({time.perf_counter() - t0:.1f} s)")
    sizes = snap["sizes"]
    print(f"at the last snapshot ({snap['peak'] / GIB:.3f} GiB): {sum(sizes.values())} live "
          f"storages; the largest shares (GiB each x count = GiB):")
    for size, n in sorted(sizes.items(), key=lambda kv: -kv[0] * kv[1])[:12]:
        print(f"  {size / GIB:.4f} x {n} = {size * n / GIB:.3f}")
    print(snap["stack"])


if __name__ == "__main__":
    main()
