"""Analytic conv roofline: compute/memory lower bounds for one execution
plan of the filter datapath (DESIGN.md §11).

Counterpart of `repro.roofline.conv_model`, with the same accounting:

  * **ops** -- 2 (multiply, add) per tap product over the padded output
    grid: kh*kw taps a pixel for the direct dataflow, kh+kw for the
    separable ones, plus the fused kernel's row-pass recompute on each
    band's 2*(kh//2) halo rows. A 'recurse' plan multiplies the count by
    the backend's `RECURSE_OP_FACTOR`.
  * **bytes** -- int32 reads of the padded input with every band's and
    tile's halo re-reads, plus the int32 output write; 'two_pass' pays its
    intermediate's round trip, 'fused' never materializes it.

`lower_bound_s = max(compute_s, memory_s) + overhead_s`, the roofline plus
a per-launch floor. The presets are per backend and an unknown backend
raises (the reference falls back to its TPU terms):

  * 'cuda' -- one H100: INT32 at 1.6727e13 ops/s and HBM at 3.35e12 B/s,
    the rates PERF.md's bounds use; the launch floor is the smallest gap
    between a call and its device time that `chip_smoke.py` measured at
    8x480x640 (PERF.md's kernel table, an NVIDIA H100 80GB HBM3 at 700.00 W:
    `fused_separable_kcm` 0.0441 ms a call against 0.0243 ms device, so
    ~0.0198 ms); a recurse product counts as one product (its plan's work
    is method-dependent, and exact products cost no more than that), so
    the bound stays below every method;
  * 'cpu' -- the plain PyTorch versions the port runs on the CPU: rough
    element-op and byte rates and a per-pass floor for its Python and op
    dispatch, deliberately low, so the drift table
    (`repro_torch.obs.profile`) reads how far a dispatch runs over them.

The tile is the plan's route tile (`repro_torch.filters.pipeline.
plan_tile`): 32x64 persistent or 16x32 tiled blocks, never a folded batch.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HW:
    """Rates of one device (the reference's `roofline.analysis.HW`)."""

    peak_flops: float                   # ops/s for the datapath's integer type
    hbm_bw: float                       # bytes/s of device memory
    ici_bw: float = 0.0                 # bytes/s a link (unused: one device)


#: per-backend roofline constants (see the module docstring).
HW_PRESETS: dict[str, HW] = {
    "cuda": HW(peak_flops=1.6727e13, hbm_bw=3.35e12),
    "cpu": HW(peak_flops=1e9, hbm_bw=1e10),
}

#: per-backend fixed cost of one kernel launch, by kernel flavor, seconds.
LAUNCH_OVERHEAD_S: dict[str, dict[str, float]] = {
    "cuda": {"pass_1d": 1.98e-5, "pass_2d": 1.98e-5, "fused": 1.98e-5},
    "cpu": {"pass_1d": 5e-5, "pass_2d": 5e-5, "fused": 1e-4},
}

#: ops of one 'recurse' product relative to one 'kcm' gather, per backend:
#: the plain CPU pass evaluates the multiplier's datapath element-wise
#: (the reference's conservative 32); the card's recurse kernels take the
#: coefficient side from a host plan (1: a lower bound for every method).
RECURSE_OP_FACTOR: dict[str, float] = {"cuda": 1.0, "cpu": 32.0}


def _preset(table: dict, backend: str | None):
    if backend not in table:
        raise ValueError(f"no roofline preset for backend {backend!r}; "
                         f"known: {tuple(table)}")
    return table[backend]


def hw_for(backend: str | None) -> HW:
    return _preset(HW_PRESETS, backend)


def launch_overhead_for(backend: str | None) -> dict[str, float]:
    return _preset(LAUNCH_OVERHEAD_S, backend)


@dataclasses.dataclass(frozen=True)
class ConvCost:
    """Roofline terms of one plan on one shape (seconds are lower bounds)."""

    flops: float
    hbm_bytes: float
    compute_s: float
    memory_s: float
    overhead_s: float           # fixed per-launch dispatch floor
    lower_bound_s: float        # max(compute, memory) + overhead
    bottleneck: str             # 'compute' | 'memory' | 'dispatch'


def _round_up(x: int, mult: int) -> int:
    return -(-int(x) // mult) * mult


def _pass_terms(n_img: int, rows: int, w: int, kh: int, kw: int, br: int,
                bc: int, *, elem: int = 4) -> tuple[float, float, dict]:
    """(flops, bytes, grid facts) of one conv pass over an (n_img, rows, w)
    input: taps x 2 ops per padded-grid pixel; input read once per tile
    plus the per-band/per-tile halo re-reads; int32 output written once."""
    ph, pw = kh // 2, kw // 2
    br = max(1, min(int(br), _round_up(rows, 8)))
    bc = max(1, min(int(bc), w))
    rows2, w2 = _round_up(rows, br), _round_up(w, bc)
    nbands, ntiles = rows2 // br, w2 // bc
    grid_pix = float(n_img) * rows2 * w2
    flops = 2.0 * kh * kw * grid_pix
    read_rows = rows2 + 2 * ph * nbands
    read_cols = w2 + 2 * pw * ntiles
    bytes_ = elem * float(n_img) * (read_rows * read_cols + rows2 * w2)
    return flops, bytes_, {"nbands": nbands, "ntiles": ntiles,
                           "rows2": rows2, "w2": w2}


def plan_cost(
    dataflow: str,
    mult_impl: str,
    n: int,
    h: int,
    w: int,
    kh: int,
    kw: int,
    *,
    block_rows: int,
    block_cols: int | None,
    batch_fold: bool,
    hw: HW | None = None,
    backend: str | None = None,
) -> ConvCost:
    """Roofline lower bound of one plan on one (n, h, w) batch with a
    (kh, kw) filter, tiled in `block_rows` x `block_cols` blocks
    (`block_cols=None`: a full-width tile). A folded batch would be one
    (1, N*(H+2*ph), W) image; the port's kernels run N independent (H, W)
    grids (`batch_fold=False`)."""
    if hw is None:
        hw = hw_for(backend)
    launch = launch_overhead_for(backend)
    ph = kh // 2
    bc = w if block_cols is None else int(block_cols)
    fold = bool(batch_fold) and n > 1

    def img_rows(pass_ph: int) -> tuple[int, int]:
        """(n_img, rows) one pass of `pass_ph` row halo traces with."""
        if fold:
            return 1, n * (h + 2 * pass_ph)
        return n, h

    if dataflow == "direct":
        n_img, rows = img_rows(ph)
        flops, bytes_, _ = _pass_terms(n_img, rows, w, kh, kw,
                                       block_rows, bc)
        overhead_s = launch["pass_2d"]
    elif dataflow == "two_pass":
        n_img, rows = img_rows(0)
        f1, b1, _ = _pass_terms(n_img, rows, w, 1, kw, block_rows, bc)
        n_img, rows = img_rows(ph)
        f2, b2, _ = _pass_terms(n_img, rows, w, kh, 1, block_rows, bc)
        flops, bytes_ = f1 + f2, b1 + b2
        overhead_s = 2 * launch["pass_1d"]
    elif dataflow == "fused":
        n_img, rows = img_rows(ph)
        fv, bytes_, grid = _pass_terms(n_img, rows, w, kh, 1,
                                       block_rows, bc)
        # horizontal pass runs over every band's rows *plus* its 2*ph halo
        # rows (the in-shared-memory recompute the fused kernel pays) and over
        # the tile's 2*(kw//2) halo columns.
        h_rows = grid["rows2"] + 2 * ph * grid["nbands"]
        h_cols = grid["w2"] + 2 * (kw // 2) * grid["ntiles"]
        flops = fv + 2.0 * kw * float(n_img) * h_rows * h_cols
        overhead_s = launch["fused"]
    else:
        raise ValueError(f"unknown dataflow {dataflow!r}")

    if mult_impl == "recurse":
        flops *= _preset(RECURSE_OP_FACTOR, backend)
    elif mult_impl != "kcm":
        raise ValueError(f"unknown mult_impl {mult_impl!r}")

    compute_s = flops / hw.peak_flops
    memory_s = bytes_ / hw.hbm_bw
    roofline_s = max(compute_s, memory_s)
    bottleneck = ("dispatch" if overhead_s > roofline_s
                  else "compute" if compute_s >= memory_s else "memory")
    return ConvCost(flops=flops, hbm_bytes=bytes_, compute_s=compute_s,
                    memory_s=memory_s, overhead_s=overhead_s,
                    lower_bound_s=roofline_s + overhead_s,
                    bottleneck=bottleneck)


__all__ = ["HW", "HW_PRESETS", "LAUNCH_OVERHEAD_S", "RECURSE_OP_FACTOR",
           "ConvCost", "hw_for", "launch_overhead_for", "plan_cost"]
