"""Warm-start for the serving datapath (DESIGN.md §10).

    PYTHONPATH=src python -m repro_torch.serve.warmup \\
        --shapes 480x640 --filters gaussian3,gaussian5 \\
        --methods refmlm --mult-impls kcm,recurse --batches 1,8

Counterpart of `repro.serve.warmup`. Each point of the cross product is
one warm `serve_key` -- shape bucket x filter x mult_impl x exec x traced
batch size. Warming runs a zero dummy batch through the exact dispatch the
server will issue, so the first request pays none of the one-time work:
the nvcc build of the kernels (`repro_torch.kernels.build`, once a
process; tens of seconds on the card), the KCM ROM stacks and recurse
plans (cached per coefficient table), and the executor's plan memo.

A running server exposes the same sweep as `ImageFilterServer.warmup()`;
this CLI warms a fresh executor on the card (`--device cpu` for the plain
versions).
"""
from __future__ import annotations

import argparse
import itertools
import time

from repro_torch.filters.bank import FILTER_NAMES
from repro_torch.serve.executor import BatchExecutor


def parse_shapes(text: str) -> list[tuple[int, int]]:
    shapes = []
    for part in text.split(","):
        h, _, w = part.strip().partition("x")
        shapes.append((int(h), int(w)))
    return shapes


def sweep(executor: BatchExecutor, shapes, filters, methods, mult_impls,
          execs, batches, *, nbits: int = 8, priorities=("normal",),
          workload: str = "filter", verbose: bool = False) -> list[str]:
    """Warm the cross product of serve points on `executor`; returns the
    warmed keys. The one sweep definition shared by this CLI and
    `ImageFilterServer.warmup()`. `priorities` widens the warmed-ledger
    cross product (§13 buckets are per-class); the kernels and caches
    underneath are priority-blind, so extra classes cost bookkeeping.
    `workload` selects the §14 class being warmed ('filter' by default;
    `filters` then names that workload's targets)."""
    keys = []
    for (h, w), filt, method, impl, em, n, pri in itertools.product(
            shapes, filters, methods, mult_impls, execs, batches,
            priorities):
        t0 = time.perf_counter()
        key = executor.warm((int(h), int(w)), filt, method=method,
                            mult_impl=impl, exec_mode=em, nbits=nbits,
                            n=int(n), priority=pri, workload=workload)
        keys.append(key)
        if verbose:
            dt = (time.perf_counter() - t0) * 1e3
            print(f"warmed {key}  ({dt:.0f} ms)")
    return keys


def warm(shapes, filters, methods, mult_impls, execs, batches, *,
         device: str | None = None, verbose: bool = True) -> list[str]:
    """Run the warmup sweep on a fresh executor; returns the warmed keys."""
    return sweep(BatchExecutor(device=device), shapes, filters,
                 methods, mult_impls, execs, batches, verbose=verbose)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--shapes", default="128x128",
                    help="comma-separated HxW shape buckets")
    ap.add_argument("--filters", default=",".join(FILTER_NAMES))
    ap.add_argument("--methods", default="refmlm")
    ap.add_argument("--mult-impls", default="auto")
    ap.add_argument("--execs", default="local",
                    help="comma-separated exec modes (only 'local' is ported)")
    ap.add_argument("--batches", default="1,8",
                    help="comma-separated traced batch sizes")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    keys = warm(parse_shapes(args.shapes),
                args.filters.split(","), args.methods.split(","),
                args.mult_impls.split(","), args.execs.split(","),
                [int(b) for b in args.batches.split(",")],
                device=args.device)
    print(f"warmed {len(keys)} serve keys")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
