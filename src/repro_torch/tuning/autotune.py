"""Autotuner for the conv datapath: block (tile) sweeps, plan sweeps with
roofline pruning, and the recurse kernels' chunk sweep.

    python -m repro_torch.tuning.autotune            # the card's shapes
    python -m repro_torch.tuning.autotune --quick    # the main-path shape
    python -m repro_torch.tuning.autotune --dist     # tile/shard-local shapes

Counterpart of `repro.tuning.autotune`. It runs on the card (the default
device; it raises without one) and writes `blocks_cuda.json` beside this
module, or in `$REPRO_TORCH_TUNE_CACHE`; `--device cpu` tunes the CPU
backend's plain versions instead. Three tuned units:

  * **blocks** -- every tile of the kernels' menu (`candidate_blocks`) per
    (dataflow kind, shape, mult_impl), by its device time on the card
    (`_time_us`); the pass-level fallback of every conv call.
  * **plans** -- full `PlanConfig`s (dataflow x mult_impl x tile) per
    (filter, shape), the choice `apply_filter` resolves on default
    arguments. Candidates sort by their roofline lower bound
    (`repro_torch.roofline.conv_model`, calibrated online by the smallest
    measured/bound ratio) and a candidate whose calibrated bound exceeds
    the incumbent by `PRUNE_MARGIN` is skipped untimed; each entry records
    its candidates / swept / pruned counts.
  * **chunks** -- the recurse kernels' rows-a-thread-at-once (`conv.CHUNKS`,
    the tap policy's kChunk) at every tile, for REFMLM's 8-bit policy at
    the Fig. 9 table's 3x3 and the fused kernel's 16-bit column policy at
    gaussian3 and gaussian5; recorded in the file's `meta` (`chunks`) with
    the card's name and power limit. The kernels keep their policies' own
    chunks: the sweep is the measurement that choice rests on.

The sweeps use the card's shapes: chip_smoke's 8x480x640 (the FVC2004 DB1
frame) and 16x2048x2048; `--dist` the tile-local batches of the streamed
mode at its default (256, 256) x 8 and at (2048, 2048) x 4 tiles, (8, 260,
260) and (4, 2052, 2052) for a 5x5 filter, and the one-card shard-local
shape (the cache keys on what the pass sees, never the global image).
Stores merge into the existing file (`--no-merge` rewrites it); the
`generated` stamps honour BENCH_TIMESTAMP and the candidate order and
tie-breaks are deterministic, so two runs over identical timings write
identical bytes.
"""
from __future__ import annotations

import argparse
import functools
import statistics
import subprocess
import time
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from repro_torch.core.platform import resolve_device
from repro_torch.roofline.conv_model import plan_cost
from repro_torch.tuning.blocks import (
    MAX_BLOCK_ROWS,
    TILE_MENU,
    BlockConfig,
    choose_block_rows,
    default_blocks,
    round_up,
    route_of,
)
from repro_torch.tuning.cache import (
    backend_key,
    cache_timestamp,
    config_key,
    load_cache,
    load_meta,
    load_plans,
    store_cache,
)
from repro_torch.tuning.plans import PLAN_MULT_IMPLS, PlanConfig, plan_key

MAIN_SHAPE = (8, 480, 640)
SCALE_SHAPE = (16, 2048, 2048)

#: (kind, n, h, w, kh, kw, mult_impl) rows of the default block sweep.
DEFAULT_SWEEP: tuple[tuple, ...] = tuple(
    (kind, n, h, w, k, k, impl)
    for kind in ("direct", "fused")
    for (n, h, w) in (MAIN_SHAPE, SCALE_SHAPE)
    for k in (3, 5)
    for impl in ("kcm", "recurse")
)
QUICK_SWEEP: tuple[tuple, ...] = tuple(
    (kind, *MAIN_SHAPE, 3, 3, "kcm") for kind in ("direct", "fused"))
#: tile-local batches of the streamed mode ((256, 256) x 8 and (2048, 2048)
#: x 4 tiles of a 5x5 filter) and the one-card shard-local shape
#: (`repro_torch.distribute.shard_local_shape(16, 2048, 2048, 1, 1, 2)`).
DIST_SWEEP: tuple[tuple, ...] = tuple(
    (kind, n, h, w, 5, 5, "kcm")
    for kind in ("direct", "fused")
    for (n, h, w) in ((8, 260, 260), (4, 2052, 2052), SCALE_SHAPE)
)

#: (filter, n, h, w) rows of the default plan sweep.
PLAN_SWEEP: tuple[tuple[str, int, int, int], ...] = (
    ("gaussian3", *MAIN_SHAPE),
    ("gaussian5", *MAIN_SHAPE),
    ("sobel_x", *MAIN_SHAPE),
    ("gaussian3", *SCALE_SHAPE),
    ("gaussian5", *SCALE_SHAPE),
)
PLAN_QUICK: tuple[tuple[str, int, int, int], ...] = (("gaussian5", *MAIN_SHAPE),)

#: (kernel, filter, n, h, w) rows of the chunk sweep ('fig9': the paper's
#: Fig. 9 3x3 Gaussian table, `kernels.gaussian_conv.gaussian_kernel_3x3`).
CHUNK_SWEEP: tuple[tuple[str, str, int, int, int], ...] = tuple(
    (kernel, filt, *shape)
    for shape in (MAIN_SHAPE, SCALE_SHAPE)
    for kernel, filt in (("conv_pass_recurse", "fig9"),
                         ("fused_separable_recurse", "gaussian3"),
                         ("fused_separable_recurse", "gaussian5"))
)
CHUNK_QUICK = tuple(row for row in CHUNK_SWEEP if tuple(row[2:]) == MAIN_SHAPE)

#: pruning safety factor: a candidate is skipped only when its calibrated
#: roofline lower bound exceeds the incumbent's measured time by this much.
PRUNE_MARGIN = 2.0

#: back-to-back calls between the CUDA events of one timed run, the
#: shortest spin that holds the card while they are enqueued, and the
#: H100's highest SM clock (which converts the spin to cycles).
CALLS_PER_RUN = 10
HOLD_MIN_S = 0.002
SM_CLOCK_HZ = 1.98e9


def candidate_blocks(kind: str, n: int, h: int, w: int, kh: int, kw: int, *,
                     backend: str = "cuda") -> Iterator[BlockConfig]:
    """Valid candidate grid organizations for one shape, deduplicated, in
    a deterministic order. 'cuda': every tile of the pass's route's menu,
    unfolded. 'cpu': the reference's candidates (its divisor and fold
    bands and column halvings), which the plain versions run alike."""
    if backend == "cuda":
        for rows, cols in TILE_MENU[route_of(kind, kh, kw)]:
            yield BlockConfig(rows, cols, False)
        return
    ph, pw = kh // 2, kw // 2
    folds = (False,) if n == 1 else (False, True)
    seen = set()
    for fold in folds:
        tall = n * (h + 2 * ph) if fold else h
        rows = {choose_block_rows(h), 32, 64, 128}
        if fold:
            for steps in (1, 2, 4):
                if -(-tall // steps) <= MAX_BLOCK_ROWS * 2:
                    rows.add(round_up(-(-tall // steps), 8))
        cols: set[int | None] = {None}
        bc = w
        while w > 256 and bc // 2 >= max(2 * pw, 128):
            bc //= 2
            cols.add(bc)
        for br in sorted(rows):
            if br < max(2 * ph, 8) or br > 2 * MAX_BLOCK_ROWS:
                continue
            for col in sorted(cols, key=lambda c: -1 if c is None else c):
                cfg = BlockConfig(br, col, fold)
                if cfg not in seen:
                    seen.add(cfg)
                    yield cfg


def _time_us(fn, device: torch.device, *, iters: int = 3) -> float:
    """Median us of one call of `fn`. On the card: its device time -- each
    run queues CALLS_PER_RUN back-to-back calls between two CUDA events
    behind a spin of the card (`torch.cuda._sleep`) at least twice as long
    as enqueueing them took, so no host gap falls between the events (a
    small call is otherwise timed by its launch, not by its tile). On the
    CPU, the host clock."""
    fn()                                          # warm-up: build, caches
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(CALLS_PER_RUN):
            fn()
        hold_s = max(HOLD_MIN_S, 2 * (time.perf_counter() - t0))
        torch.cuda.synchronize(device)
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(hold_s * SM_CLOCK_HZ))
            start.record()
            for _ in range(CALLS_PER_RUN):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3 / CALLS_PER_RUN)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(times)


@functools.lru_cache(maxsize=2)
def _frames(n: int, h: int, w: int, device: torch.device) -> torch.Tensor:
    """Seeded (n, h, w) int32 frames on `device`, kept for the next
    measurements of the same shape."""
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, 256, (n, h, w)).astype(np.int32)).to(device)


def _sep_taps(kh: int) -> np.ndarray:
    return np.array([1, 4, 6, 4, 1] if kh == 5 else [4, 8, 4], np.int64)


def measure(kind: str, cfg: BlockConfig, n: int, h: int, w: int, kh: int,
            kw: int, mult_impl: str, *, iters: int = 3,
            device: str | torch.device | None = None) -> float:
    """Median us/call of one pass kind under one grid organization on
    `device` (the card for None; raises without one)."""
    from repro_torch.filters.conv import conv2d_pass, fused_separable_pass

    dev = resolve_device(device)
    x = _frames(n, h, w, dev)
    taps1d = _sep_taps(kh)
    kw_common = dict(method="refmlm", mult_impl=mult_impl,
                     block_rows=cfg.block_rows,
                     block_cols=w if cfg.block_cols is None else cfg.block_cols,
                     batch_fold=cfg.batch_fold)
    if kind == "fused":
        fn = lambda: fused_separable_pass(x, taps1d, taps1d, nbits=8, nbits2=16,
                                          shift=8, post="clip", **kw_common)
    else:
        taps = np.outer(taps1d, taps1d)
        fn = lambda: conv2d_pass(x, taps, nbits=8, shift=8, post="clip", **kw_common)
    return _time_us(fn, dev, iters=iters)


def tune(sweep: Iterable[tuple] = DEFAULT_SWEEP, *, iters: int = 3,
         verbose: bool = True, backend: str = "cuda",
         device: str | torch.device | None = None) -> dict:
    """Sweep every (shape, kind, impl) block row and return the winning
    configs as a `store_cache`-ready blocks mapping."""
    configs: dict[str, dict] = {}
    for kind, n, h, w, kh, kw, impl in sweep:
        best: tuple[float, BlockConfig] | None = None
        for cfg in candidate_blocks(kind, n, h, w, kh, kw, backend=backend):
            us = measure(kind, cfg, n, h, w, kh, kw, impl, iters=iters, device=device)
            if verbose:
                print(f"# tune {kind} n{n}x{h}x{w} k{kh}x{kw} {impl} "
                      f"br={cfg.block_rows} bc={cfg.block_cols} "
                      f"fold={cfg.batch_fold}: {us:.1f}us", flush=True)
            if best is None or us < best[0]:
                best = (us, cfg)
        assert best is not None
        us, cfg = best
        key = config_key(kind, n, h, w, kh, kw, impl)
        configs[key] = {**cfg.as_dict(), "us_per_call": round(us, 1)}
        if verbose:
            d = default_blocks(kind, n, h, w, kh, kw, backend=backend)
            print(f"# tune {key}: winner br={cfg.block_rows} "
                  f"bc={cfg.block_cols} fold={cfg.batch_fold} ({us:.1f}us; "
                  f"cache miss gives br={d.block_rows} bc={d.block_cols} "
                  f"fold={d.batch_fold})", flush=True)
    return configs


def plan_candidates(name: str, n: int, h: int, w: int, *,
                    backend: str = "cuda") -> list[PlanConfig]:
    """Deterministic, fully concrete plan candidates for one (filter,
    shape): every dataflow the spec admits x both tap-product
    implementations x the block candidates of the matching pass kind
    (a full-width CPU tile spelled `block_cols=w`)."""
    from repro_torch.filters.bank import get_filter

    spec = get_filter(name)
    kh, kw = spec.ksize
    dataflows = (("fused", "two_pass", "direct") if spec.separable
                 else ("direct",))
    out: list[PlanConfig] = []
    for df in dataflows:
        kind = "fused" if df == "fused" else "direct"
        for impl in PLAN_MULT_IMPLS:
            for cfg in candidate_blocks(kind, n, h, w, kh, kw, backend=backend):
                out.append(PlanConfig(
                    df, impl, cfg.block_rows,
                    w if cfg.block_cols is None else cfg.block_cols,
                    cfg.batch_fold))
    return out


def plan_bound_us(plan: PlanConfig, name: str, n: int, h: int, w: int,
                  backend: str | None = None) -> float:
    """Roofline lower bound of one concrete plan, in us."""
    from repro_torch.filters.bank import get_filter

    kh, kw = get_filter(name).ksize
    cost = plan_cost(plan.dataflow, plan.mult_impl, n, h, w, kh, kw,
                     block_rows=plan.block_rows, block_cols=plan.block_cols,
                     batch_fold=bool(plan.batch_fold),
                     backend=backend or backend_key())
    return cost.lower_bound_s * 1e6


def measure_plan(name: str, plan: PlanConfig, n: int, h: int, w: int, *,
                 iters: int = 3, device: str | torch.device | None = None) -> float:
    """Median us/call of one fully explicit plan through `apply_filter` on
    `device`: every field pinned, so the cache does not enter."""
    from repro_torch.filters import apply_filter

    dev = resolve_device(device)
    x = _frames(n, h, w, dev)
    kw_plan = dict(method="refmlm", mult_impl=plan.mult_impl,
                   block_rows=plan.block_rows, block_cols=plan.block_cols,
                   batch_fold=bool(plan.batch_fold), device=dev)
    if plan.dataflow == "direct":
        fn = lambda: apply_filter(x, name, separable=False, **kw_plan)
    elif plan.dataflow == "two_pass":
        fn = lambda: apply_filter(x, name, separable=True, fused=False, **kw_plan)
    else:
        fn = lambda: apply_filter(x, name, fused=True, **kw_plan)
    return _time_us(fn, dev, iters=iters)


def sweep_plan(
    name: str,
    n: int,
    h: int,
    w: int,
    *,
    iters: int = 3,
    prune: bool = True,
    margin: float = PRUNE_MARGIN,
    measure_fn: Callable[[PlanConfig], float] | None = None,
    backend: str = "cuda",
    device: str | torch.device | None = None,
    verbose: bool = True,
) -> tuple[dict, list[tuple[PlanConfig, float]]]:
    """One (filter, shape) plan sweep -> (cache entry, measured records).

    Candidates sort by roofline lower bound (ties on the plan tuple); the
    bound is calibrated online by `scale = min(measured / bound)`, and a
    candidate is pruned untimed when `bound * scale > incumbent * margin`.
    `measure_fn` injects the timer (tests replay recorded timings through
    the same loop)."""
    cands = plan_candidates(name, n, h, w, backend=backend)
    bounds = [plan_bound_us(p, name, n, h, w, backend) for p in cands]
    order = sorted(range(len(cands)), key=lambda i: (bounds[i], cands[i]))
    mfn = measure_fn or (
        lambda p: measure_plan(name, p, n, h, w, iters=iters, device=device))
    best: tuple[float, PlanConfig] | None = None
    scale: float | None = None
    swept = pruned = 0
    records: list[tuple[PlanConfig, float]] = []
    for i in order:
        plan, bound = cands[i], bounds[i]
        if (prune and best is not None and scale is not None
                and bound * scale > best[0] * margin):
            pruned += 1
            continue
        us = mfn(plan)
        swept += 1
        records.append((plan, us))
        if bound > 0:
            scale = us / bound if scale is None else min(scale, us / bound)
        if verbose:
            print(f"# plan {name} n{n}x{h}x{w} {plan.dataflow}/"
                  f"{plan.mult_impl} br={plan.block_rows} "
                  f"bc={plan.block_cols} fold={plan.batch_fold}: "
                  f"{us:.1f}us (bound {bound:.1f}us)", flush=True)
        if best is None or us < best[0]:
            best = (us, plan)
    assert best is not None
    us, plan = best
    entry = {**plan.as_dict(), "us_per_call": round(us, 1),
             "generated": cache_timestamp(), "candidates": len(cands),
             "swept": swept, "pruned": pruned}
    if verbose:
        print(f"# plan {plan_key(name, n, h, w)}: winner {plan.dataflow}/"
              f"{plan.mult_impl} br={plan.block_rows} bc={plan.block_cols} "
              f"fold={plan.batch_fold} ({us:.1f}us; swept {swept}/"
              f"{len(cands)}, pruned {pruned})", flush=True)
    return entry, records


def tune_plans(sweep: Iterable[tuple] = PLAN_SWEEP, *, iters: int = 3,
               prune: bool = True, margin: float = PRUNE_MARGIN,
               verbose: bool = True, backend: str = "cuda",
               device: str | torch.device | None = None) -> dict:
    """Sweep every (filter, shape) plan row -> `store_cache`-ready plans."""
    plans: dict[str, dict] = {}
    for name, n, h, w in sweep:
        entry, _ = sweep_plan(name, n, h, w, iters=iters, prune=prune,
                              margin=margin, verbose=verbose, backend=backend,
                              device=device)
        plans[plan_key(name, n, h, w)] = entry
    return plans


def measure_chunk(kernel: str, filt: str, n: int, h: int, w: int,
                  tile: tuple[int, int], chunk: int | None, *, iters: int = 3,
                  device: str | torch.device | None = None) -> float:
    """Median us/call of a recurse kernel (REFMLM) at one tile and chunk
    (None: the policy's own) on `device`."""
    from repro_torch.filters import conv
    from repro_torch.filters.bank import get_filter, max_intermediate
    from repro_torch.kernels.gaussian_conv import gaussian_kernel_3x3

    dev = resolve_device(device)
    x = _frames(n, h, w, dev)
    if kernel == "conv_pass_recurse":
        taps = np.asarray(gaussian_kernel_3x3(1.0, 256), np.int64)
        fn = lambda: conv.conv_pass_recurse(x, taps, method="refmlm", nbits=8, shift=8,
                                            post="clip", tile=tile, chunk=chunk)
    else:
        spec = get_filter(filt)
        row, col = spec.sep_row.astype(np.int64), spec.sep_col.astype(np.int64)
        nb2 = conv.second_pass_nbits(max_intermediate(spec), int(np.abs(col).max()))
        fn = lambda: conv.fused_separable_recurse(
            x, row, col, method="refmlm", nbits=8, nbits2=nb2, shift=spec.shift,
            post=spec.post, tile=tile, chunk=chunk)
    return _time_us(fn, dev, iters=iters)


def tune_chunks(sweep: Iterable[tuple] = CHUNK_SWEEP, *, iters: int = 3,
                verbose: bool = True,
                device: str | torch.device | None = None) -> dict:
    """{"<kernel>/<filter>/n<N>x<H>x<W>": {"<rows>x<cols>": {"own": us,
    "<chunk>": us, ...}, "winner": {"tile": "<rows>x<cols>", "chunk":
    "<chunk>" | "own", "us_per_call": us}}} over the chunk menu of each
    row at every persistent tile."""
    from repro_torch.filters import conv

    out: dict[str, dict] = {}
    for kernel, filt, n, h, w in sweep:
        kh, kw = (3, 3) if filt == "fig9" else (5, 5) if filt.endswith("5") else (3, 3)
        menu = conv.chunk_menu(kernel, "refmlm", 8, kh, kw,
                               None if kernel == "conv_pass_recurse" else 16)
        key = f"{kernel}/{filt}/n{n}x{h}x{w}"
        row: dict[str, dict] = {}
        best = None
        for tile in TILE_MENU["persistent"]:
            times = {}
            for chunk in (None, *menu):
                us = measure_chunk(kernel, filt, n, h, w, tile, chunk, iters=iters,
                                   device=device)
                label = "own" if chunk is None else str(chunk)
                times[label] = round(us, 1)
                if best is None or us < best[0]:
                    best = (us, f"{tile[0]}x{tile[1]}", label)
                if verbose:
                    print(f"# chunk {key} tile {tile[0]}x{tile[1]} chunk {label}: "
                          f"{us:.1f}us", flush=True)
            row[f"{tile[0]}x{tile[1]}"] = times
        assert best is not None
        row["winner"] = {"tile": best[1], "chunk": best[2], "us_per_call": round(best[0], 1)}
        out[key] = row
    return out


def card_meta(device: torch.device) -> dict:
    """What the measurements were taken on: the card's name and, from
    nvidia-smi, its name and power limit (empty off the card)."""
    if device.type != "cuda":
        return {}
    meta = {"device_name": torch.cuda.get_device_name(device)}
    try:
        meta["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        meta["nvidia_smi"] = "not read"
    return meta


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true",
                    help="reduced sweep (the main-path shape only)")
    ap.add_argument("--dist", action="store_true",
                    help="sweep the tile/shard-local shapes of distributed "
                         "execution instead of the defaults (blocks only)")
    ap.add_argument("--no-merge", action="store_true",
                    help="rewrite the cache from this sweep alone instead of "
                         "merging into the existing per-backend file")
    ap.add_argument("--no-prune", action="store_true",
                    help="exhaustive plan sweep (time every candidate)")
    ap.add_argument("--prune-margin", type=float, default=PRUNE_MARGIN,
                    help="pruning safety factor over the incumbent's "
                         "measured time (default %(default)s)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="device to tune (default: the CUDA card; 'cpu' "
                         "tunes the CPU backend's plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    backend = backend_key(device)
    sweep = (DIST_SWEEP if args.dist
             else QUICK_SWEEP if args.quick else DEFAULT_SWEEP)
    configs = tune(sweep, iters=args.iters, backend=backend, device=device)
    plans: dict[str, dict] = {}
    chunks: dict[str, dict] = {}
    if not args.dist:
        plans = tune_plans(PLAN_QUICK if args.quick else PLAN_SWEEP,
                           iters=args.iters, prune=not args.no_prune,
                           margin=args.prune_margin, backend=backend,
                           device=device)
        if backend == "cuda":
            chunks = tune_chunks(CHUNK_QUICK if args.quick else CHUNK_SWEEP,
                                 iters=args.iters, device=device)
    meta = {"chunks": chunks, **card_meta(device)} if chunks or backend == "cuda" else {}
    if not args.no_merge:
        configs = {**load_cache(backend), **configs}
        plans = {**load_plans(backend), **plans}
        old = load_meta(backend)
        meta = {**{k: v for k, v in old.items()
                   if k not in ("backend", "generated", "version")}, **meta,
                "chunks": {**old.get("chunks", {}), **meta.get("chunks", {})}}
        if not meta["chunks"]:
            del meta["chunks"]
    path = store_cache(configs, plans, backend, meta=meta)
    print(f"# wrote {path} ({len(configs)} configs, {len(plans)} plans, "
          f"{len(meta.get('chunks', {}))} chunk rows, backend={backend})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
