#!/usr/bin/env python3
"""Time the port's plain LNS matmul route on the CPU with and without its
product table.

    PYTHONPATH=src python3 scripts/time_lns_table.py [--nbits 8] [--repeats 5]

At nbits <= `TABLE_NBITS` the plain route (`repro_torch.core.approx_matmul.
_lns_matmul`, which the CPU tests run for every LNS method) looks each
product of two magnitudes up in a table of all 2**(2 * nbits) pairs; with
`TABLE_NBITS` set to 0 it calls the method's element function on every
(row, K, N) triple instead. For each LNS method, at the reduced Qwen2-0.5B
train shapes (256 rows, batch 8 x seq 32, against (128, 128) and (128,
256)), the script checks that both give the same bytes and prints the
median ms of each (the table built before timing) and their ratio.
"""
import argparse
import statistics
import time

import torch

import repro_torch.core.approx_matmul as am

METHODS = ("mitchell", "mitchell_ecc1", "mitchell_ecc2", "mitchell_ecc3", "odma",
           "refmlm", "refmlm_kom3")
SHAPES = ((256, 128, 128), (256, 128, 256))


def median_ms(fn, repeats: int) -> float:
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nbits", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    gen = torch.Generator().manual_seed(0)
    table_nbits = am.TABLE_NBITS
    print(f"torch {torch.__version__}, {torch.get_num_threads()} threads, nbits {args.nbits}")
    for m, k, n in SHAPES:
        a = torch.randn((m, k), generator=gen)
        b = torch.randn((k, n), generator=gen)
        for method in METHODS:
            am.TABLE_NBITS = table_nbits
            table = am._lns_matmul(a, b, method, args.nbits)
            t_table = median_ms(lambda: am._lns_matmul(a, b, method, args.nbits), args.repeats)
            am.TABLE_NBITS = 0
            element = am._lns_matmul(a, b, method, args.nbits)
            t_elem = median_ms(lambda: am._lns_matmul(a, b, method, args.nbits), args.repeats)
            am.TABLE_NBITS = table_nbits
            assert torch.equal(table, element), method
            print(f"({m}, {k}, {n}) {method:14s} table {t_table:9.3f} ms  element function "
                  f"{t_elem:9.3f} ms  x{t_elem / t_table:.1f}")


if __name__ == "__main__":
    main()
