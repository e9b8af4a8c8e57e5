"""LNS (Mitchell-family) approximate matmul: a hand-written CUDA kernel for
Hopper (`csrc/mitchell_matmul.cu`) and its plain PyTorch version.

Counterpart of `repro.kernels.mitchell_matmul`. On pre-quantized signed
int32 operands a (M, K) and b (K, N):

    out[m, n] = sum_k sgn(a) sgn(b) P(|a|, |b|)      (int32, wrapping)

where P is Mitchell's algorithm with its case split (num_ecc=0,
case_split=True) or the Babic basic block plus `num_ecc` error-correction
stages (case_split=False). The multiplier datapath is shifts and adds; no
multiply is used.

Both versions follow XLA's int32 semantics for every int32 input, as the
reference kernel does: |INT_MIN| stays INT_MIN, sums wrap, Mitchell's
m < lead compares as int32, and a left shift by 32 bits or more gives 0 (the
kernel mirrors it; no operand is refused). Operands of the quantized
datapath are below 2**16, where no shift reaches 32 bits.

`mitchell_matmul_kernel` launches the kernel for CUDA tensors and raises if
the launch fails; it runs `mitchell_matmul_plain` only for CPU tensors. A
fake tensor (`FakeTensorMode`, the dry-run's) launches nothing: the wrapper
returns an empty output of the kernel's shape and records the kernel's
work, `ops_per_product` int32 operations a product and its int32 bytes,
in `repro_torch.roofline.analysis`'s counters. Each
launch adds one to `LAUNCHES['mitchell_matmul']` and one to its route's
count in `ROUTE_LAUNCHES`. The reference's TPU grid arguments (block_m,
block_n, block_k, accum) have no counterpart: `launch_plan` picks the
route, the tile and the K splits from the shape alone (the thin route for
M <= 1024, the LM decode and prefill shapes among them; the tiled route
above), and the kernel masks the ragged edges itself, so operands need no
padding. With more than one split the blocks add their partial sums into
a zeroed output; int32 addition modulo 2**32 is associative and
commutative, so the result is the same bits in any order.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.core.approx_matmul import row_slices
from repro_torch.core.bitops import leading_one_position, shift_left_int32, wrap32
from repro_torch.kernels.build import launch

KERNEL = "mitchell_matmul"
#: kernel name -> number of launches since the last `reset_launches()`.
LAUNCHES: dict[str, int] = {KERNEL: 0}
#: launches by route of the launch plan, since the last `reset_launches()`.
ROUTE_LAUNCHES: dict[str, int] = {"tiled": 0, "thin": 0}
_ROUTE_IDS = {"tiled": 0, "thin": 1}          # the C entry's route argument
TILED_TILE = (64, 64)                         # kTileM x kTileN of the tiled kernel
TILED_K_STEP = 32                             # kTileK: the tiled kernel's K tile
THIN_ROWS = (1, 2, 4, 8, 16)                  # the thin kernel's compiled row tiles
THIN_TILE_N = 128                             # kThinTileN: 4 warps' lanes x 4 columns
#: M up to which the thin route runs (16-row tiles past 16). On the H100 the
#: thin route timed faster than the tiled one at every M from 4 to 1024 on
#: the Qwen2-0.5B MLP shapes (chip_smoke.py's [route] lines, PERF.md); the
#: tiled route keeps the larger calls (2048 x 896 x 4864, the infer path)
THIN_MAX_M = 1024
#: the shortest K range a split is given: one group of kUnroll K steps for
#: each of the thin kernel's 4 warps; one K tile of the tiled kernel
K_CHUNK = {"thin": 16, "tiled": TILED_K_STEP}
FILL = 6                                      # blocks an SM that the splits aim for
GRID_YZ_MAX = 65535                           # CUDA's gridDim.y / .z limit
_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 9


def reset_launches() -> None:
    LAUNCHES[KERNEL] = 0
    for route in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[route] = 0


@dataclass(frozen=True)
class LaunchPlan:
    """How one (M, K) x (K, N) call runs: `route` 'thin' or 'tiled', a
    (tile_m, tile_n) output tile a block, and `splits` K ranges cut in
    steps of `k_step` (1 thin; the tiled kernel's K tile): of T =
    ceil(K / k_step) steps, split i covers steps [i T // splits,
    (i + 1) T // splits), the last one ending at K."""
    route: str
    tile_m: int
    tile_n: int
    splits: int
    k_step: int = 1

    def grid(self, m: int, n: int) -> tuple[int, int, int]:
        """The CUDA grid (x, y, z) of the route's kernel."""
        rows, cols = -(-m // self.tile_m), -(-n // self.tile_n)
        return (rows, cols, self.splits) if self.route == "tiled" else (cols, rows, self.splits)

    def k_ranges(self, k: int) -> list[tuple[int, int]]:
        """The [begin, end) K range of each split, as the kernel cuts them."""
        steps = -(-k // self.k_step)
        return [(min(k, i * steps // self.splits * self.k_step),
                 min(k, (i + 1) * steps // self.splits * self.k_step))
                for i in range(self.splits)]


def launch_plan(m: int, k: int, n: int, sms: int) -> LaunchPlan:
    """The route, tile and K splits of an (m, k) x (k, n) call on a card
    with `sms` SMs, a pure function of the shape. M <= THIN_MAX_M takes the
    thin route with the smallest row tile that covers M (16-row tiles past
    16); larger M the 64 x 64 tiled route. K is split into as many ranges
    as keep tiles x splits within FILL x sms blocks, but no more than
    K // K_CHUNK[route]. Raises ValueError for a shape past the kernels'
    index or grid limits."""
    if min(m, n) < 1 or k < 0 or sms < 1:
        raise ValueError(f"launch_plan needs m, n, sms >= 1 and k >= 0, got "
                         f"{m}x{k}x{n} on {sms} SMs")
    if max(m, k, n) >= 1 << 31:
        raise ValueError(f"shape {m}x{k}x{n} exceeds the kernel's grid")
    return route_plan("thin" if m <= THIN_MAX_M else "tiled", m, k, n, sms)


def route_plan(route: str, m: int, k: int, n: int, sms: int) -> LaunchPlan:
    """`launch_plan`'s tile and split rule for a given route, at any M:
    what chip_smoke.py times on both routes to set THIN_MAX_M."""
    if route == "thin":
        (tile_m, tile_n), k_step = (next((r for r in THIN_ROWS if r >= m), THIN_ROWS[-1]),
                                    THIN_TILE_N), 1
    else:
        (tile_m, tile_n), k_step = TILED_TILE, TILED_K_STEP
    tiles = -(-m // tile_m) * -(-n // tile_n)
    splits = max(1, min(FILL * sms // tiles, k // K_CHUNK[route]))
    plan = LaunchPlan(route, tile_m, tile_n, splits, k_step)
    if max(plan.grid(m, n)[1:]) > GRID_YZ_MAX:
        raise ValueError(f"shape {m}x{k}x{n} exceeds the kernel's grid")
    return plan


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def ops_per_product(num_ecc: int, case_split: bool) -> int:
    """Integer operations of one product as the kernel forms it: per stage
    the exponent add, three shifts and two adds; the case split's compare,
    select and shift; the sign and the accumulate (11 for Mitchell)."""
    return 6 * (num_ecc + 1) + (3 if case_split else 0) + 2


def count_fake(a: torch.Tensor, b: torch.Tensor, num_ecc: int,
               case_split: bool) -> torch.Tensor:
    """A fake call: the (M, N) int32 output, empty, and the kernel's work
    recorded (`roofline.analysis.record_kernel`); no launch, no count in
    LAUNCHES."""
    from repro_torch.roofline.analysis import record_kernel
    if num_ecc < 0:
        raise ValueError(f"num_ecc must be >= 0, got {num_ecc}")
    m, k = a.shape
    n = b.shape[1]
    record_kernel(KERNEL, ops=ops_per_product(num_ecc, case_split) * m * k * n,
                  dtype="int32", nbytes=4 * (m * k + k * n + m * n))
    return torch.empty((m, n), dtype=torch.int32, device=a.device)


def _check_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    for name, t in (("a", a), ("b", b)):
        if not isinstance(t, torch.Tensor) or t.dim() != 2 or t.dtype != torch.int32:
            raise ValueError(f"{name} must be a 2-D int32 tensor, got "
                             f"{getattr(t, 'dtype', type(t))} "
                             f"{tuple(getattr(t, 'shape', ()))}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dimensions differ: {tuple(a.shape)} x {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device}, {b.device}")


def _block_product(a: torch.Tensor, b: torch.Tensor, num_ecc: int,
                   case_split: bool) -> torch.Tensor:
    """(r, K) x (K, N) int64 (int32 values) -> (r, N) int32: the kernel's
    arithmetic, one stage at a time, on int32 values carried in int64."""
    ra = wrap32(a.abs())[:, :, None]          # jnp.abs: |INT_MIN| == INT_MIN
    rb = wrap32(b.abs())[None, :, :]
    sgn = torch.sign(a)[:, :, None] * torch.sign(b)[None, :, :]
    total = torch.zeros((), dtype=torch.int64, device=a.device)
    for stage in range(num_ecc + 1):
        k1, k2 = leading_one_position(ra), leading_one_position(rb)
        x1 = ra - torch.where(ra > 0, torch.ones_like(k1) << k1, 0)
        x2 = rb - torch.where(rb > 0, torch.ones_like(k2) << k2, 0)
        m = wrap32((x1 << k2) + (x2 << k1))   # shifts < 31: k <= 30 on int32
        lead = shift_left_int32(torch.ones_like(k1), k1 + k2)
        if case_split and stage == num_ecc:
            p = torch.where(m < lead, lead + m, 2 * m)
        else:
            p = lead + m
        total = total + torch.where((ra == 0) | (rb == 0), 0, p)
        ra, rb = x1, x2
    return wrap32((wrap32(total) * sgn).sum(dim=1)).to(torch.int32)


def mitchell_matmul_plain(a: torch.Tensor, b: torch.Tensor, *, num_ecc: int = 0,
                          case_split: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: the element
    products of a block of rows at a time, summed over K."""
    _check_operands(a, b)
    if num_ecc < 0:
        raise ValueError(f"num_ecc must be >= 0, got {num_ecc}")
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    b64 = b.to(torch.int64)
    for rows in row_slices(m, k, n):
        out[rows] = _block_product(a[rows].to(torch.int64), b64, num_ecc, case_split)
    return out


def mitchell_matmul_kernel(a: torch.Tensor, b: torch.Tensor, *, num_ecc: int = 0,
                           case_split: bool = True) -> torch.Tensor:
    """Raw kernel entry: a (M, K), b (K, N) signed int32 on one device ->
    (M, N) int32 on that device."""
    _check_operands(a, b)
    if is_fake(a):
        return count_fake(a, b, num_ecc, case_split)
    if a.device.type == "cpu":
        return mitchell_matmul_plain(a, b, num_ecc=num_ecc, case_split=case_split)
    if a.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA or CPU tensors, got {a.device}")
    if num_ecc < 0:
        raise ValueError(f"num_ecc must be >= 0, got {num_ecc}")
    m, k = a.shape
    n = b.shape[1]
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=torch.int32, device=a.device)
    index = a.device.index if a.device.index is not None else torch.cuda.current_device()
    return run_plan(a, b, launch_plan(m, k, n, _sm_count(index)), num_ecc=num_ecc,
                    case_split=case_split)


def run_plan(a: torch.Tensor, b: torch.Tensor, plan: LaunchPlan, *, num_ecc: int,
             case_split: bool) -> torch.Tensor:
    """Launch the kernel on CUDA operands with a given plan (the wrapper's
    `launch_plan`, or `route_plan`'s for chip_smoke.py's route timings)."""
    m, k = a.shape
    n = b.shape[1]
    a, b = a.contiguous(), b.contiguous()
    # with K splits the blocks add into the output, so it starts at zero
    out = (torch.zeros if plan.splits > 1 else torch.empty)(
        (m, n), dtype=torch.int32, device=a.device)
    launch(KERNEL, KERNEL, _ARGTYPES, a.device, a.data_ptr(), b.data_ptr(),
           out.data_ptr(), m, k, n, num_ecc, int(case_split), _ROUTE_IDS[plan.route],
           plan.tile_m, plan.tile_n, plan.splits)
    LAUNCHES[KERNEL] += 1
    ROUTE_LAUNCHES[plan.route] += 1
    return out


__all__ = ["KERNEL", "LAUNCHES", "LaunchPlan", "ROUTE_LAUNCHES", "count_fake", "launch_plan",
           "mitchell_matmul_kernel", "mitchell_matmul_plain", "ops_per_product",
           "reset_launches", "route_plan", "run_plan"]
