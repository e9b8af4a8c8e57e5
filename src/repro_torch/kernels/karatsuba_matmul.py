"""Limb-decomposed wide-integer matmul: hand-written CUDA kernels for Hopper
(`csrc/karatsuba_matmul_i8.cu` for int8 limbs, `csrc/karatsuba_matmul.cu`
for wider ones) and their plain PyTorch versions.

Counterpart of `repro.kernels.karatsuba_matmul`. Over balanced limbs
(`repro_torch.core.quant`) a = a_hi * 2^w + a_lo, b = b_hi * 2^w + b_lo it
returns the three int32 partial matmuls (hh, mid, ll):

  karatsuba=True   3 products: mid = (a_hi + a_lo)(b_hi + b_lo) - hh - ll
  karatsuba=False  4 products: mid = a_hi b_lo + a_lo b_hi

so a caller reconstructs a @ b = hh 2^(2w) + mid 2^w + ll. The limbs are
int32 tensors (int8 values on the quantized datapath) and every sum wraps
like int32, so every version is bit-identical to the reference for any
int32 limbs.

`karatsuba_matmul_kernel` runs `karatsuba_matmul_plain` only for CPU
tensors. For CUDA tensors it first runs the int8 route's pack step, whose
flag is read with one host sync: limbs that fit int8 go to
`karatsuba_matmul_i8` (`repro_torch.kernels.karatsuba_matmul_i8`, which
holds the rule and its own launch count); wider ones to the wide kernel,
with the digit count the flag carries (`limb_digits` is its plain mirror).
The wide kernel has two routes, which `launch_plan` picks from the shape
and that digit count:

  thin    N <= THIN_MAX_N (every limb call of the inference path): the
          CUDA cores, any int32 limbs; A streamed once through a cp.async
          ring, B's K range in shared memory, K split over the grid when
          row tiles are few (the splits add into a zeroed output with
          atomics: int32 addition modulo 2**32 gives the same bits in any
          order);
  digits  wider N: every int32 operand split into `digits` balanced int8
          digits, the pairs whose shift stays below 32 bits multiplied on
          the int8 tensor cores (`digit_product_plain` is the plain
          version of that arithmetic).

Each launch of the wide kernel adds one to `LAUNCHES['karatsuba_matmul']`
and one to its route's count in `ROUTE_LAUNCHES`; a failed launch raises.
Fake tensors (`FakeTensorMode`, on any device) take the int8 route's pack
and product, which launch nothing and record the product's work
(`karatsuba_matmul_i8`). The reference's TPU grid arguments (block_m,
block_n, block_k, accum) have no counterpart: the plan names the tiles and
K splits, and the kernels mask the ragged edges themselves, so operands
need no padding.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.core.bitops import wrap32
from repro_torch.kernels.build import launch

KERNEL = "karatsuba_matmul"
#: kernel name -> number of launches since the last `reset_launches()`.
LAUNCHES: dict[str, int] = {KERNEL: 0}
#: launches of the wide kernel by route, since the last `reset_launches()`.
ROUTE_LAUNCHES: dict[str, int] = {"thin": 0, "digits": 0}
#: N up to which the thin route runs. On the H100 it timed 3-22x faster
#: than the digit route at all five limb calls of the inference path (N =
#: 4, 8, 32; chip_smoke.py's [wide-time] lines, PERF.md): the digit route
#: pads N to 64-column tiles and K to 128.
THIN_MAX_N = 32
THIN_THREADS = 256                     # kThinThreads: a thread a row x 4 columns
THIN_TILE_N = (4, 8, 16, 32)           # the thin kernel's column tiles
THIN_B_ELEMS = 6144                    # a split's K range x tile_n, per B limb
THIN_A_ELEMS = 8192                    # rows x K chunk of a ring stage, per A limb
THIN_FILL = 2                          # blocks an SM that K splits aim for
THIN_SPLIT_MIN_K = 32                  # the shortest K range a split is given
THIN_BLOCKS_PER_SM = 4                 # the persistent grid's blocks an SM, at most
K_STEP = 4                             # splits and chunks cut K in steps of 4
SMEM_PER_SM = 233472                   # an H100 SM's shared memory, bytes
SMEM_PER_BLOCK = 232448                # kSmemMax: a block's, bytes
DIGIT_TILE = (64, 64)                  # kBM x kBN of the digit product
DIGIT_K_ALIGN = 128                    # kKAlign: the digit planes' K padding
#: digit products a limb product forms: pairs (i, j) of digits with i + j <= 3
DIGIT_PAIRS = {2: 4, 3: 8, 4: 10}
GRID_YZ_MAX = 65535                    # CUDA's gridDim.y / .z limit
#: the largest |value| (as [lo, hi]) that 2 and 3 balanced int8 digits hold
DIGIT_RANGE = {2: (-128 * 257, 127 * 257), 3: (-128 * 65793, 127 * 65793)}
_THIN_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 10
_DIGIT_ARGTYPES = (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 6


def reset_launches() -> None:
    LAUNCHES[KERNEL] = 0
    for route in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[route] = 0


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) x (K, N) integer matmul -> int32, wrapping like an int32 dot.

    On the CPU, torch.matmul in int32. PyTorch has no integer matmul on CUDA,
    so there it is a float64 matmul, exact while every partial sum stays
    below 2**53 (checked here: K * max|a| * max|b| < 2**53, which holds for
    K < 2**37 at 8-bit operands); beyond that it raises."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    amax = int(a.to(torch.int64).abs().max()) if a.numel() else 0
    bmax = int(b.to(torch.int64).abs().max()) if b.numel() else 0
    if a.shape[-1] * amax * bmax >= 1 << 53:
        raise ValueError(f"K={a.shape[-1]}, max|a|={amax}, max|b|={bmax}: the "
                         "float64 matmul would not be exact")
    exact = torch.matmul(a.to(torch.float64), b.to(torch.float64))
    return wrap32(exact.to(torch.int64)).to(torch.int32)


def _check_limbs(a_hi, a_lo, b_hi, b_lo) -> None:
    for name, t in (("a_hi", a_hi), ("a_lo", a_lo), ("b_hi", b_hi), ("b_lo", b_lo)):
        if not isinstance(t, torch.Tensor) or t.dim() != 2 or t.dtype != torch.int32:
            raise ValueError(f"{name} must be a 2-D int32 tensor, got "
                             f"{getattr(t, 'dtype', type(t))} "
                             f"{tuple(getattr(t, 'shape', ()))}")
        if t.device != a_hi.device:
            raise ValueError(f"limbs on different devices: {a_hi.device}, {t.device}")
    if a_lo.shape != a_hi.shape or b_lo.shape != b_hi.shape:
        raise ValueError("hi and lo limbs must have the same shape")
    if a_hi.shape[1] != b_hi.shape[0]:
        raise ValueError(f"inner dimensions differ: {tuple(a_hi.shape)} x "
                         f"{tuple(b_hi.shape)}")


def karatsuba_matmul_plain(a_hi: torch.Tensor, a_lo: torch.Tensor,
                           b_hi: torch.Tensor, b_lo: torch.Tensor, *,
                           karatsuba: bool = True):
    """Plain PyTorch version of the kernel, on any device; -> (hh, mid, ll)."""
    _check_limbs(a_hi, a_lo, b_hi, b_lo)
    hh = int_matmul(a_hi, b_hi)
    ll = int_matmul(a_lo, b_lo)
    if karatsuba:
        cross = int_matmul(a_hi + a_lo, b_hi + b_lo).to(torch.int64) - hh - ll
    else:
        cross = int_matmul(a_hi, b_lo).to(torch.int64) + int_matmul(a_lo, b_hi)
    return hh, wrap32(cross).to(torch.int32), ll


# ----------------------------------------------------------------- digits

def _operands(a_hi, a_lo, b_hi, b_lo, karatsuba: bool):
    """The operands of the limb products: A's and B's hi, lo and, for
    Karatsuba, the int32-wrapped hi + lo."""
    a_ops, b_ops = [a_hi, a_lo], [b_hi, b_lo]
    if karatsuba:
        a_ops.append(wrap32(a_hi.to(torch.int64) + a_lo).to(torch.int32))
        b_ops.append(wrap32(b_hi.to(torch.int64) + b_lo).to(torch.int32))
    return a_ops, b_ops


def limb_digits(a_hi: torch.Tensor, a_lo: torch.Tensor, b_hi: torch.Tensor,
                b_lo: torch.Tensor, *, karatsuba: bool) -> int:
    """The digit count of the pack step's flag, on any device: 1 when the
    limbs fit the int8 kernel (`karatsuba_matmul_i8.limbs_fit_int8`), else
    the balanced int8 digits the widest operand of the limb products needs
    (2, 3 or 4; for Karatsuba the wrapped sums count)."""
    from repro_torch.kernels.karatsuba_matmul_i8 import limbs_fit_int8

    if limbs_fit_int8(a_hi, a_lo, b_hi, b_lo, karatsuba=karatsuba):
        return 1
    a_ops, b_ops = _operands(a_hi, a_lo, b_hi, b_lo, karatsuba)
    ops = [t for t in a_ops + b_ops if t.numel()]
    lo = min(int(t.min()) for t in ops)
    hi = max(int(t.max()) for t in ops)
    for digits, (low, high) in DIGIT_RANGE.items():
        if low <= lo and hi <= high:
            return digits
    return 4


def split_digits(x: torch.Tensor, digits: int) -> list[torch.Tensor]:
    """x (int32) as `digits` balanced int8 digits, low first, each an int32
    tensor in [-128, 127]: x == sum_i d_i 2^(8i) modulo 2**32, and exactly
    when x fits them (the top digit is taken modulo 256)."""
    r = x.to(torch.int64)
    out = []
    for _ in range(digits):
        d = ((r + 128) & 255) - 128
        out.append(d.to(torch.int32))
        r = (r - d) >> 8
    return out


def _digit_product(x: list[torch.Tensor], y: list[torch.Tensor]) -> torch.Tensor:
    """X @ Y modulo 2**32 from the digits of X (M, K) and Y (K, N): the sum
    over i + j <= 3 of (x_i @ y_j) << 8(i + j), int64."""
    total = torch.zeros((), dtype=torch.int64)
    for i, xi in enumerate(x):
        for j, yj in enumerate(y):
            if i + j <= 3:
                total = total + (int_matmul(xi, yj).to(torch.int64) << (8 * (i + j)))
    return wrap32(total)


def digit_product_plain(a_hi: torch.Tensor, a_lo: torch.Tensor, b_hi: torch.Tensor,
                        b_lo: torch.Tensor, *, karatsuba: bool = True,
                        digits: int | None = None):
    """Plain PyTorch version of the digit route's arithmetic, on any device;
    -> (hh, mid, ll). Each operand of the limb products split into `digits`
    balanced int8 digits (default: the count `limb_digits` names, at least
    2); each limb product the sum of its digit pair products (int32
    matmuls on the CPU, exact float64 on CUDA), shifted and wrapped;
    mid = S - hh - ll (Karatsuba) or the sum of the two cross products.
    Raises if the limbs need more digits than given."""
    _check_limbs(a_hi, a_lo, b_hi, b_lo)
    need = max(2, limb_digits(a_hi, a_lo, b_hi, b_lo, karatsuba=karatsuba))
    digits = need if digits is None else digits
    if not need <= digits <= 4:
        raise ValueError(f"the limbs need {need} int8 digits, got digits={digits}")
    a_ops, b_ops = _operands(a_hi, a_lo, b_hi, b_lo, karatsuba)
    ad = [split_digits(t, digits) for t in a_ops]
    bd = [split_digits(t, digits) for t in b_ops]
    hh, ll = _digit_product(ad[0], bd[0]), _digit_product(ad[1], bd[1])
    if karatsuba:
        mid = _digit_product(ad[2], bd[2]) - hh - ll
    else:
        mid = _digit_product(ad[0], bd[1]) + _digit_product(ad[1], bd[0])
    return tuple(wrap32(t).to(torch.int32) for t in (hh, mid, ll))


# ------------------------------------------------------------------- plan

@dataclass(frozen=True)
class LaunchPlan:
    """How one wide (M, K) x (K, N) call runs.

    route 'thin': (tile_m, tile_n) an output tile a block (a thread a row
    and 4 columns), `blocks` persistent blocks over the row tiles, `splits`
    K ranges cut in steps of `k_step` (of T = ceil(K / k_step) steps, split
    i covers [i T // splits, (i + 1) T // splits), the last ending at K),
    each streamed in chunks of `kc` through the ring at row stride `stride`
    (`span`: whole rows, one contiguous copy).

    route 'digits': 64 x 64 output tiles, `digits` int8 digits an operand,
    K padded to DIGIT_K_ALIGN."""
    route: str
    tile_m: int
    tile_n: int
    splits: int = 1
    k_step: int = K_STEP
    kc: int = 0
    stride: int = 0
    span: bool = False
    blocks: int = 0
    digits: int = 0

    def grid(self, m: int, n: int) -> tuple[int, int, int]:
        """The CUDA grid (x, y, z) of the route's kernel (the digit route's
        product launches)."""
        if self.route == "thin":
            return self.blocks, self.splits, 1
        return -(-m // self.tile_m), -(-n // self.tile_n), 1

    def k_ranges(self, k: int) -> list[tuple[int, int]]:
        """The [begin, end) K range of each split, as the kernel cuts them."""
        steps = -(-k // self.k_step)
        return [(min(k, i * steps // self.splits * self.k_step),
                 min(k, (i + 1) * steps // self.splits * self.k_step))
                for i in range(self.splits)]

    def b_rows(self, k: int) -> int:
        """The longest split's K range: B rows a thin block stages."""
        steps = -(-k // self.k_step)
        return min(k, -(-steps // self.splits) * self.k_step)

    def smem_bytes(self, k: int) -> int:
        """Dynamic shared memory of a thin block: B's two limbs over its K
        range, and two ring stages of A's two limbs."""
        return 4 * (2 * self.b_rows(k) * self.tile_n + 4 * self.tile_m * self.stride)

    def kp(self, k: int) -> int:
        """K of the digit planes, padded to DIGIT_K_ALIGN."""
        return -(-k // DIGIT_K_ALIGN) * DIGIT_K_ALIGN

    def pairs(self) -> int:
        """Digit products a limb product forms (digit route)."""
        return DIGIT_PAIRS[self.digits]


def launch_plan(m: int, k: int, n: int, digits: int, sms: int) -> LaunchPlan:
    """The route, tiles and K splits of a wide (m, k) x (k, n) call whose
    limbs need `digits` balanced int8 digits (1-4, `limb_digits`; the digit
    route takes at least 2) on a card with `sms` SMs: a pure function of
    the shape and the digit count. N <= THIN_MAX_N takes the thin route,
    wider N the digit route. Raises ValueError for a shape past the
    kernels' index or grid limits."""
    if min(m, n) < 1 or k < 0 or sms < 1 or not 1 <= digits <= 4:
        raise ValueError(f"launch_plan needs m, n, sms >= 1, k >= 0 and digits in 1..4, "
                         f"got {m}x{k}x{n}, digits={digits}, on {sms} SMs")
    if max(m, k, n) >= 1 << 31:
        raise ValueError(f"shape {m}x{k}x{n} exceeds the kernel's grid")
    return route_plan("thin" if n <= THIN_MAX_N else "digits", m, k, n, digits, sms)


def route_plan(route: str, m: int, k: int, n: int, digits: int, sms: int) -> LaunchPlan:
    """`launch_plan`'s tile and split rule for a given route, at any N the
    route takes (the thin route N <= THIN_MAX_N): what chip_smoke.py times
    on both routes to set THIN_MAX_N."""
    if route == "thin":
        return _thin_plan(m, k, n, sms)
    if route != "digits":
        raise ValueError(f"unknown route {route!r}")
    kp = -(-k // DIGIT_K_ALIGN) * DIGIT_K_ALIGN
    plan = LaunchPlan("digits", *DIGIT_TILE, digits=max(2, digits))
    if plan.grid(m, n)[1] > GRID_YZ_MAX or kp // 32 > GRID_YZ_MAX or m * (kp // 4) >= 1 << 39:
        raise ValueError(f"shape {m}x{k}x{n} exceeds the kernel's grid")
    return plan


def _thin_plan(m: int, k: int, n: int, sms: int) -> LaunchPlan:
    if n > THIN_MAX_N:
        raise ValueError(f"the thin route takes N <= {THIN_MAX_N}, got {n}")
    tile_n = next(t for t in THIN_TILE_N if t >= n)
    tile_m = THIN_THREADS // (tile_n // 4)
    row_tiles = -(-m // tile_m)
    steps = -(-k // K_STEP)
    # enough splits that a split's B range fits; more when row tiles are few
    need = -(-steps // (THIN_B_ELEMS // tile_n // K_STEP))
    fill = min(THIN_FILL * sms // row_tiles, k // THIN_SPLIT_MIN_K)
    splits = max(1, min(max(need, fill), steps))
    if splits > GRID_YZ_MAX:
        raise ValueError(f"shape {m}x{k}x{n} exceeds the kernel's grid")
    b_rows = min(k, -(-steps // splits) * K_STEP)
    room = THIN_A_ELEMS // tile_m                  # elements of a row in a stage
    span = k % 4 != 0 and splits == 1 and k <= room
    if span:
        kc = stride = k
    elif k % 4 == 0:      # 16-byte copies and reads; stride = 4 (mod 8): conflict-free
        kc = max(4, min(b_rows, room) // 4 * 4)
        stride = kc + 4 if kc % 8 == 0 else kc
    else:                 # 4-byte copies; an odd stride: conflict-free reads
        kc = max(1, min(b_rows, room - 1))
        stride = kc | 1
    plan = LaunchPlan("thin", tile_m, tile_n, splits, K_STEP, kc, stride, span)
    per_sm = max(1, min(THIN_BLOCKS_PER_SM, SMEM_PER_SM // (plan.smem_bytes(k) + 1024)))
    blocks = max(1, min(row_tiles, per_sm * sms // splits))
    return LaunchPlan("thin", tile_m, tile_n, splits, K_STEP, kc, stride, span, blocks)


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def run_plan(a_hi: torch.Tensor, a_lo: torch.Tensor, b_hi: torch.Tensor,
             b_lo: torch.Tensor, plan: LaunchPlan, *, karatsuba: bool):
    """Launch the wide kernel's route on contiguous CUDA limbs with a given
    plan (the wrapper's `launch_plan`, or `route_plan`'s for chip_smoke.py's
    route timings); -> (hh, mid, ll)."""
    m, k = a_hi.shape
    n = b_hi.shape[1]
    dev = a_hi.device
    # with K splits the blocks add into the outputs, so they start at zero
    # (one buffer for the three: one fill launch)
    alloc = torch.zeros if plan.route == "thin" and plan.splits > 1 else torch.empty
    outs = tuple(alloc((3, m, n), dtype=torch.int32, device=dev).unbind(0))
    ptrs = [t.data_ptr() for t in (a_hi, a_lo, b_hi, b_lo)]
    if plan.route == "thin":
        launch(KERNEL, "karatsuba_thin", _THIN_ARGTYPES, dev, *ptrs,
               *(t.data_ptr() for t in outs), m, k, n, int(karatsuba), plan.tile_n,
               plan.splits, plan.kc, plan.stride, int(plan.span), plan.blocks)
    else:
        kp, nops = plan.kp(k), 3 if karatsuba else 2
        a_dig = torch.empty((nops, plan.digits, m, kp), dtype=torch.int8, device=dev)
        b_dig = torch.empty((nops, plan.digits, n, kp), dtype=torch.int8, device=dev)
        launch(KERNEL, "karatsuba_digits", _DIGIT_ARGTYPES, dev, *ptrs, a_dig.data_ptr(),
               b_dig.data_ptr(), *(t.data_ptr() for t in outs), m, k, n, kp,
               plan.digits, int(karatsuba))
    LAUNCHES[KERNEL] += 1
    ROUTE_LAUNCHES[plan.route] += 1
    return outs


def karatsuba_matmul_wide(a_hi: torch.Tensor, a_lo: torch.Tensor,
                          b_hi: torch.Tensor, b_lo: torch.Tensor, *,
                          karatsuba: bool = True):
    """The wide kernel for any int32 limbs (M, K), (K, N) on one device,
    without the int8 route's pack (the digit count read with `limb_digits`,
    which syncs); -> (hh, mid, ll), each (M, N) int32 on that device."""
    _check_limbs(a_hi, a_lo, b_hi, b_lo)
    if a_hi.device.type == "cpu":
        return karatsuba_matmul_plain(a_hi, a_lo, b_hi, b_lo, karatsuba=karatsuba)
    limbs = _cuda_limbs(a_hi, a_lo, b_hi, b_lo)
    if a_hi.shape[0] == 0 or b_hi.shape[1] == 0:
        return _outputs(a_hi, b_hi)
    digits = limb_digits(*limbs, karatsuba=karatsuba)
    return run_plan(*limbs, _plan(*limbs, digits), karatsuba=karatsuba)


def _plan(a_hi: torch.Tensor, a_lo: torch.Tensor, b_hi: torch.Tensor,
          b_lo: torch.Tensor, digits: int) -> LaunchPlan:
    index = a_hi.device.index if a_hi.device.index is not None else torch.cuda.current_device()
    return launch_plan(a_hi.shape[0], a_hi.shape[1], b_hi.shape[1], digits, _sm_count(index))


def _cuda_limbs(a_hi, a_lo, b_hi, b_lo) -> list[torch.Tensor]:
    """The limbs, contiguous; raises for a device other than CUDA (fake
    tensors on any device pass) or a shape past the kernels' indices."""
    if a_hi.device.type != "cuda" and not is_fake(a_hi):
        raise ValueError(f"the kernel runs on CUDA or CPU tensors, got {a_hi.device}")
    m, k = a_hi.shape
    n = b_hi.shape[1]
    if max(m, k, n) >= 1 << 31:
        raise ValueError(f"shape {m}x{k}x{n} exceeds the kernel's grid")
    return [t.contiguous() for t in (a_hi, a_lo, b_hi, b_lo)]


def _outputs(a_hi, b_hi) -> tuple[torch.Tensor, ...]:
    """Three empty (M, N) int32 tensors for hh, mid, ll."""
    shape = (a_hi.shape[0], b_hi.shape[1])
    return tuple(torch.empty(shape, dtype=torch.int32, device=a_hi.device)
                 for _ in range(3))


def karatsuba_matmul_kernel(a_hi: torch.Tensor, a_lo: torch.Tensor,
                            b_hi: torch.Tensor, b_lo: torch.Tensor, *,
                            karatsuba: bool = True):
    """Raw kernel entry over pre-decomposed int32 limbs (M, K), (K, N) on one
    device; -> (hh, mid, ll), each (M, N) int32 on that device. On CUDA the
    int8 tensor-core kernel when the limbs fit int8, else the wide kernel's
    route for the shape and the flag's digit count."""
    from repro_torch.kernels import karatsuba_matmul_i8 as i8

    _check_limbs(a_hi, a_lo, b_hi, b_lo)
    if a_hi.device.type == "cpu" and not is_fake(a_hi):
        return karatsuba_matmul_plain(a_hi, a_lo, b_hi, b_lo, karatsuba=karatsuba)
    limbs = _cuda_limbs(a_hi, a_lo, b_hi, b_lo)
    if a_hi.shape[0] == 0 or b_hi.shape[1] == 0:
        return _outputs(a_hi, b_hi)
    packed, digits = i8.pack_route(*limbs, karatsuba=karatsuba)
    if packed is not None:
        return i8.product(packed)
    return run_plan(*limbs, _plan(*limbs, digits), karatsuba=karatsuba)


__all__ = ["DIGIT_PAIRS", "KERNEL", "LAUNCHES", "LaunchPlan", "ROUTE_LAUNCHES", "THIN_MAX_N",
           "digit_product_plain", "int_matmul", "karatsuba_matmul_kernel",
           "karatsuba_matmul_plain", "karatsuba_matmul_wide", "launch_plan", "limb_digits",
           "reset_launches", "route_plan", "run_plan", "split_digits"]
