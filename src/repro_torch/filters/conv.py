"""Batched multiplier-selectable 2-D convolution passes of the integer
filter datapath.

Counterpart of `repro.filters.conv`. Two passes, each a hand-written CUDA
kernel for Hopper in two tap-product variants, with a plain PyTorch version
of the same pass beside it:

  * `conv2d_pass` -- one direct pass over a (kh, kw) tap table
    (`csrc/conv_pass.cu`: `conv_pass_kcm`, `conv_pass_recurse`);
  * `fused_separable_pass` -- the (1, kw) row pass at `nbits` and the
    (kh, 1) column pass at `nbits2` in one kernel, the row-pass band held in
    shared memory (`csrc/fused_separable.cu`: `fused_separable_kcm`,
    `fused_separable_recurse`).

Per pixel: sum over taps of sgn(t) * sgn(c) * mult(|t|, |c|), zero padding,
a wrapping int32 sum, then `apply_post` (a rounding shift, then clip to
0..255, abs, or the raw sum). `mult_impl` picks how products are formed:
'kcm' gathers from per-tap product ROMs computed by the selected
multiplier (`repro_torch.core.kcm`, sign baked in), 'recurse' evaluates
the multiplier per tap, 'auto' is 'kcm' (coefficients are always concrete
host values here). Both give the same bytes for operands below 2**nbits.
The recurse kernels take the coefficient side of every product from a
host plan (`recurse_plan`), and the fused kcm kernel stages a prefix of
its column ROMs (`column_prefix`), on the tap shapes their persistent
kernels are compiled for (`kernel_route`); other shapes run their tiled
kernels.

The kcm passes give the reference's bytes for operands at or past the ROM
too (|t| >= 2**nbits). The reference gathers with `jnp.take`, whose fill
for such an index is the minimum of the narrow host stack's dtype (-2**15
for an int16 stack, -2**31 for int32), and sums in the carry its bound
analysis picks: int16 when `tables_acc_bound < 2**15`, where the sum
wraps at 16 bits, else int32. A `RomStack` carries both facts with the
device table; the fused pass keeps an int32 carry for both of its passes,
as the reference's fused kernel does.

A kernel wrapper launches its kernel for a CUDA tensor, and raises if the
launch fails; it runs the plain version only for a CPU tensor. Each launch
adds one to `LAUNCHES[<kernel name>]`. The reference's TPU grid arguments
(block_rows, block_cols, batch_fold) have no counterpart: each kernel's
tile shape is a constant of its source.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.kcm import (
    METHODS,
    filter_tables,
    parse_method,
    tables_acc_bound,
    tap_multiplier,
)
from repro_torch.core.mitchell import MAX_NBITS, wrap_int32
from repro_torch.core.refmlm import SUPPORTED_WIDTHS
from repro_torch.filters.recurse_plan import plan_words, recurse_plan
from repro_torch.kernels.build import launch

MULT_IMPLS = ("recurse", "kcm", "auto")
POSTS = ("none", "clip", "abs")              # index = the kernels' post code
KERNELS = ("conv_pass_kcm", "conv_pass_recurse", "fused_separable_kcm",
           "fused_separable_recurse")
MAX_K = 15                                   # kMaxK in csrc/multipliers.cuh
_TILE_H = 16                                 # kTileH of both kernels
_METHOD_CODES = {"exact": 0, "refmlm": 1, "refmlm_nc": 2, "mitchell": 3,
                 "mitchell_ecc": 4, "odma": 5}
# Pixels per chunk of the plain recurse pass: bounds its digit-plane
# temporaries (64 int64 planes per pixel for 16-bit REFMLM).
_PLAIN_CHUNK_PIXELS = 1 << 22

# Tap shapes the persistent kernels are compiled for (the bank's); any other
# shape runs the tiled kernels (`conv_pass_kcm`'s C entry makes the same
# choice itself). The recurse and fused kcm C entries run the persistent
# kernel when they are given a plan (a column prefix) and the tiled one when
# they are not, so for them this rule (`kernel_route`) is the only copy.
PERSISTENT_SHAPES = ((3, 3), (5, 5), (1, 3), (3, 1), (1, 5), (5, 1))
FUSED_PERSISTENT_SHAPES = ((3, 3), (5, 5))
# Output tile (rows, cols) of one block of each route: the persistent
# kernels' kKcmTileH x kKcmTileW (csrc/staging.cuh), the tiled kernels'
# kTileH x kTileW (conv_pass.cu, fused_separable.cu).
ROUTE_TILES = {"persistent": (32, 64), "tiled": (_TILE_H, 32)}

# The fused kcm kernel's column-ROM prefix (`column_prefix`): its length is
# rounded up to PREFIX_GRANULE entries, so the launcher's occupancy cache
# sees few shared-memory sizes, and held to PREFIX_MAX_BYTES a block; an
# operand past the prefix is gathered from global memory.
PREFIX_GRANULE = 256
PREFIX_MAX_BYTES = 96 * 1024
# Kernels whose route (`kernel_route`) the wrappers pick.
ROUTED = ("conv_pass_recurse", "fused_separable_recurse", "fused_separable_kcm")

#: kernel name -> number of launches since the last `reset_launches()`.
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)
#: (kernel name, 'persistent' | 'tiled') -> launches of that route, for ROUTED.
ROUTE_LAUNCHES: dict[tuple[str, str], int] = {
    (name, route): 0 for name in ROUTED for route in ("persistent", "tiled")}


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
    for key in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[key] = 0


class RomStack(NamedTuple):
    """A KCM ROM stack as the kcm passes read it, with the facts of the
    reference's narrow host stack (`filter_tables`) that decide operands
    at or past the ROM."""
    table: torch.Tensor       # (taps, 2**nbits) int32, signs baked in
    fill: int                 # a gather past the ROM: the host dtype's minimum
    acc_bound: int            # `tables_acc_bound` of the host stack
    int16_prefix: int         # entries [0, int16_prefix) of every tap fit int16

    @property
    def carry_bits(self) -> int:
        """The reference's carry width for a direct pass from this stack."""
        return 16 if self.acc_bound < (1 << 15) else 32


# ------------------------------------------------------------ plain versions

def apply_post(acc: torch.Tensor, *, post: str, shift: int) -> torch.Tensor:
    """Fixed-point epilogue on the int32 sum: rounding shift, then clip /
    abs / raw. The add wraps like int32 and the shift is arithmetic."""
    _check_post(post)
    if post == "none":
        return acc
    if post == "abs":
        acc = wrap_int32(acc.to(torch.int64).abs())
    if shift > 0:
        acc = wrap_int32(acc.to(torch.int64) + (1 << (shift - 1))) >> shift
    return acc.clamp(0, 255)


def _tap_views(x: torch.Tensor, kh: int, kw: int):
    """(tap index, (N, H, W) int64 view) for each tap of the zero-padded
    batch, taps in row-major order."""
    n, h, w = x.shape
    ph, pw = kh // 2, kw // 2
    padded = F.pad(x, (pw, kw - 1 - pw, ph, kh - 1 - ph)).to(torch.int64)
    for t, (di, dj) in enumerate(itertools.product(range(kh), range(kw))):
        yield t, padded[:, di:di + h, dj:dj + w]


def _kcm_sum(x: torch.Tensor, roms: RomStack, kh: int, kw: int,
             carry_bits: int) -> torch.Tensor:
    """Per pixel, sum over taps of sgn(t) * table[tap][|t|], `roms.fill`
    for |t| past the ROM, wrapped to the carry (16 bits: the low half,
    sign-extended) -> int32."""
    table = roms.table
    rom_len = table.shape[1]
    acc = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    for t, tap in _tap_views(x, kh, kw):
        mag = tap.abs()
        prod = table[t].to(torch.int64)[mag.clamp(max=rom_len - 1)]
        acc += torch.sign(tap) * torch.where(mag < rom_len, prod, roms.fill)
    if carry_bits == 16:
        acc = ((acc + (1 << 15)) & 0xFFFF) - (1 << 15)
    return wrap_int32(acc)


def conv_pass_kcm_plain(x: torch.Tensor, roms: RomStack, kh: int, kw: int, *,
                        shift: int, post: str) -> torch.Tensor:
    """Plain PyTorch version of `conv_pass_kcm`: per tap, sgn(t) *
    rom[tap][|t|], the fill past the ROM, in the stack's carry."""
    return apply_post(_kcm_sum(x, roms, kh, kw, roms.carry_bits), post=post,
                      shift=shift)


def conv_pass_recurse_plain(x: torch.Tensor, taps: np.ndarray, *, method: str,
                            nbits: int, shift: int, post: str) -> torch.Tensor:
    """Plain PyTorch version of `conv_pass_recurse`: the selected multiplier
    on every tap, sgn(c) * sgn(t) * mult(|t|, |c|)."""
    kh, kw = taps.shape
    mult = tap_multiplier(method)
    n, h, w = x.shape
    out = torch.empty_like(x)
    step = max(1, _PLAIN_CHUNK_PIXELS // max(1, h * w))
    for lo in range(0, n, step):
        part = x[lo:lo + step]
        acc = torch.zeros(part.shape, dtype=torch.int64, device=x.device)
        for t, tap in _tap_views(part, kh, kw):
            c = int(taps.flat[t])
            if c == 0:                       # sgn(c) == 0: the term is 0
                continue
            prod = mult(tap.abs(), torch.tensor(abs(c), device=x.device), nbits)
            acc += (int(np.sign(c)) * torch.sign(tap)) * prod.to(torch.int64)
        out[lo:lo + step] = apply_post(wrap_int32(acc), post=post, shift=shift)
    return out


def fused_separable_kcm_plain(x: torch.Tensor, row: RomStack, col: RomStack,
                              *, shift: int, post: str) -> torch.Tensor:
    """Plain PyTorch version of `fused_separable_kcm`: the row pass, then
    the column pass, each with its own ROM's fill and both in an int32
    carry whatever the stacks' bounds."""
    rows = _kcm_sum(x, row, 1, row.table.shape[0], 32)
    return apply_post(_kcm_sum(rows, col, col.table.shape[0], 1, 32), post=post,
                      shift=shift)


def column_prefix(row: RomStack, col: RomStack) -> tuple[int, bool]:
    """-> (length, int16) of the column-ROM prefix the persistent fused kcm
    kernel stages in shared memory: every |row sum| that in-range operands
    give (at most the row stack's bound) indexes it, rounded up to
    PREFIX_GRANULE, within the column ROM and PREFIX_MAX_BYTES; int16 iff
    every entry in it fits int16. Any operand past it is gathered from
    global memory (or is past the ROM), so the bytes do not depend on it."""
    kh, col_len = col.table.shape
    need = -(-(1 + row.acc_bound) // PREFIX_GRANULE) * PREFIX_GRANULE

    def cap(entry_bytes: int) -> int:
        return PREFIX_MAX_BYTES // (entry_bytes * kh) // PREFIX_GRANULE * PREFIX_GRANULE

    length = min(col_len, need, cap(2))
    if length > col.int16_prefix:
        length = min(length, cap(4))
    return length, length <= col.int16_prefix


def fused_separable_recurse_plain(x: torch.Tensor, row: np.ndarray,
                                  col: np.ndarray, *, method: str, nbits: int,
                                  nbits2: int, shift: int,
                                  post: str) -> torch.Tensor:
    """Plain PyTorch version of `fused_separable_recurse`."""
    rows = conv_pass_recurse_plain(x, row.reshape(1, -1), method=method,
                                   nbits=nbits, shift=0, post="none")
    return conv_pass_recurse_plain(rows, col.reshape(-1, 1), method=method,
                                   nbits=nbits2, shift=shift, post=post)


# ----------------------------------------------------------- kernel wrappers

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {    # the entry points' argument types, the stream aside
    "conv_pass_kcm": ("conv_pass", (_P, _P, _I, _I, _I, _P) + (_I,) * 7),
    "conv_pass_recurse": ("conv_pass", (_P, _P, _P, _I, _I, _I, _P) + (_I,) * 7),
    "fused_separable_kcm": ("fused_separable",
                            (_P, _P, _I, _I, _P, _I, _I, _I, _I, _P) + (_I,) * 7),
    "fused_separable_recurse": ("fused_separable",
                                (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P) + (_I,) * 7),
}


def _launch(name: str, x: torch.Tensor, args_for,
            route: str | None = None) -> torch.Tensor:
    """Launch kernel `name` on the current stream of x's device with the C
    arguments (x, *args_for(out), stream), `out` allocated here; raise if
    the launch failed. An empty batch launches nothing. `route`: the
    kernel_route the wrapper picked, for the ROUTED kernels."""
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    library, argtypes = _SIGNATURES[name]
    launch(library, name, argtypes, x.device, x.data_ptr(), *args_for(out))
    LAUNCHES[name] += 1
    if route is not None:
        ROUTE_LAUNCHES[(name, route)] += 1
    return out


def _host_ints(values: np.ndarray) -> ctypes.Array:
    flat = np.asarray(values, np.int64).reshape(-1)
    if flat.size and (flat.min() < -(1 << 31) or flat.max() >= (1 << 31)):
        raise ValueError("coefficients must fit int32")
    return (ctypes.c_int32 * flat.size)(*flat.tolist())


def _check_x(x: torch.Tensor) -> None:
    if not isinstance(x, torch.Tensor) or x.dim() != 3 or x.dtype != torch.int32:
        raise ValueError("expected an (N, H, W) int32 tensor, got "
                         f"{getattr(x, 'dtype', type(x))} "
                         f"{tuple(getattr(x, 'shape', ()))}")


def _check_cuda(x: torch.Tensor, kh: int, kw: int, *roms: RomStack) -> None:
    """What the kernels take: contiguous int32 on one CUDA device, taps up
    to MAX_K, a grid within CUDA's limits."""
    if x.device.type != "cuda":
        raise ValueError(f"kernels run on CUDA or CPU tensors, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("input must be contiguous")
    if not (1 <= kh <= MAX_K and 1 <= kw <= MAX_K):
        raise ValueError(f"taps up to {MAX_K}x{MAX_K}, got {kh}x{kw}")
    n, h, _ = x.shape
    if n > 65535 or -(-h // _TILE_H) > 65535:
        raise ValueError(f"batch {n} or height {h} exceeds the kernel grid")
    for rom in roms:
        table = rom.table
        if (table.device != x.device or table.dtype != torch.int32
                or table.dim() != 2 or not table.is_contiguous()):
            raise ValueError("ROMs must be contiguous 2-D int32 tensors on "
                             "the input's device")


def _check_post(post: str) -> None:
    if post not in POSTS:
        raise ValueError(f"unknown post {post!r}; expected one of {POSTS}")


def _check_method_width(method: str, nbits: int) -> tuple[int, int]:
    """-> (kernel method code, num_ecc); raises where the reference's
    multiplier would reject the width."""
    family, num_ecc = parse_method(method)
    if family in ("refmlm", "refmlm_nc") and nbits not in SUPPORTED_WIDTHS:
        raise ValueError(f"nbits must be one of {SUPPORTED_WIDTHS}, got {nbits}")
    if family != "exact" and not 2 <= nbits <= MAX_NBITS:
        raise ValueError(f"nbits must be in [2, {MAX_NBITS}], got {nbits}")
    return _METHOD_CODES[family], num_ecc


def conv_pass_kcm(x: torch.Tensor, rom: RomStack, kh: int, kw: int, *,
                  shift: int, post: str) -> torch.Tensor:
    """Direct pass from a (kh*kw, 2**nbits) ROM stack (`rom_stack`)."""
    _check_x(x)
    _check_post(post)
    if rom.table.shape[0] != kh * kw:
        raise ValueError(f"ROM stack has {rom.table.shape[0]} rows for {kh}x{kw} taps")
    if x.device.type == "cpu":
        return conv_pass_kcm_plain(x, rom, kh, kw, shift=shift, post=post)
    _check_cuda(x, kh, kw, rom)
    n, h, w = x.shape
    return _launch("conv_pass_kcm", x, lambda out: (
        rom.table.data_ptr(), rom.table.shape[1], rom.fill, rom.carry_bits,
        out.data_ptr(), n, h, w, kh, kw, shift, POSTS.index(post)))


def kernel_route(kh: int, kw: int, *, fused: bool = False) -> str:
    """Which kernel runs a (kh, kw) tap shape of a recurse pass or of the
    fused kcm pass: 'persistent' for the shapes it is compiled for
    (PERSISTENT_SHAPES for the direct pass, FUSED_PERSISTENT_SHAPES for the
    fused ones), 'tiled' for any other."""
    shapes = FUSED_PERSISTENT_SHAPES if fused else PERSISTENT_SHAPES
    return "persistent" if (kh, kw) in shapes else "tiled"


def _plan_ptr(method: str, taps, nbits: int, route: str) -> int | None:
    """Host address of the cached plan words for a persistent launch
    (None, a null pointer, for the tiled kernels, which take no plan)."""
    if route != "persistent":
        return None
    return plan_words(recurse_plan(method, taps, nbits)).ctypes.data


def conv_pass_recurse(x: torch.Tensor, taps: np.ndarray, *, method: str,
                      nbits: int, shift: int, post: str) -> torch.Tensor:
    """Direct pass with the multiplier evaluated per tap, from the host plan
    of `taps` (`recurse_plan`) on the persistent kernel's shapes."""
    _check_x(x)
    _check_post(post)
    code, num_ecc = _check_method_width(method, nbits)
    if x.device.type == "cpu":
        return conv_pass_recurse_plain(x, taps, method=method, nbits=nbits,
                                       shift=shift, post=post)
    kh, kw = taps.shape
    _check_cuda(x, kh, kw)
    n, h, w = x.shape
    coeffs = _host_ints(taps)
    route = kernel_route(kh, kw)
    plan = _plan_ptr(method, taps, nbits, route)
    return _launch("conv_pass_recurse", x, lambda out: (
        ctypes.cast(coeffs, ctypes.c_void_p), plan, code, num_ecc, nbits,
        out.data_ptr(), n, h, w, kh, kw, shift, POSTS.index(post)), route)


def fused_separable_kcm(x: torch.Tensor, row: RomStack, col: RomStack, *,
                        shift: int, post: str) -> torch.Tensor:
    """Fused separable pass from a (kw, 2**nbits) row ROM stack and a
    (kh, 2**nbits2) column ROM stack (`rom_stack`); the persistent kernel
    stages the column ROMs' `column_prefix` on the shapes it is compiled
    for."""
    _check_x(x)
    _check_post(post)
    if x.device.type == "cpu":
        return fused_separable_kcm_plain(x, row, col, shift=shift, post=post)
    kh, kw = col.table.shape[0], row.table.shape[0]
    _check_cuda(x, kh, kw, row, col)
    n, h, w = x.shape
    route = kernel_route(kh, kw, fused=True)
    prefix, int16 = column_prefix(row, col) if route == "persistent" else (0, False)
    return _launch("fused_separable_kcm", x, lambda out: (
        row.table.data_ptr(), row.table.shape[1], row.fill, col.table.data_ptr(),
        col.table.shape[1], col.fill, prefix, int(int16), out.data_ptr(), n, h, w,
        kh, kw, shift, POSTS.index(post)), route)


def fused_separable_recurse(x: torch.Tensor, row: np.ndarray, col: np.ndarray,
                            *, method: str, nbits: int, nbits2: int,
                            shift: int, post: str) -> torch.Tensor:
    """Fused separable pass with the multiplier evaluated per tap, from the
    host plans of `row` and `col` on the persistent kernel's shapes."""
    _check_x(x)
    _check_post(post)
    code, num_ecc = _check_method_width(method, nbits)
    _check_method_width(method, nbits2)
    if x.device.type == "cpu":
        return fused_separable_recurse_plain(
            x, row, col, method=method, nbits=nbits, nbits2=nbits2,
            shift=shift, post=post)
    kh, kw = col.size, row.size
    _check_cuda(x, kh, kw)
    n, h, w = x.shape
    row_c, col_c = _host_ints(row), _host_ints(col)
    route = kernel_route(kh, kw, fused=True)
    row_plan = _plan_ptr(method, row, nbits, route)
    col_plan = _plan_ptr(method, col, nbits2, route)
    return _launch("fused_separable_recurse", x, lambda out: (
        ctypes.cast(row_c, ctypes.c_void_p), ctypes.cast(col_c, ctypes.c_void_p),
        row_plan, col_plan, code, num_ecc, nbits, nbits2, out.data_ptr(), n, h,
        w, kh, kw, shift, POSTS.index(post)), route)


# ------------------------------------------------------------- public passes

@functools.lru_cache(maxsize=None)
def _host_tables(method: str, taps_key: tuple, nbits: int):
    """Stacked KCM ROMs (narrow dtype) + their exact accumulator bound."""
    stack = filter_tables(method, np.asarray(taps_key, np.int64), nbits)
    return stack, tables_acc_bound(stack)


@functools.lru_cache(maxsize=None)
def _device_tables(method: str, taps_key: tuple, nbits: int,
                   device: torch.device) -> RomStack:
    """The ROM stack as a contiguous int32 tensor on `device` (the kernels
    read int32 ROMs) with its host stack's facts, cached per coefficient
    table."""
    stack, bound = _host_tables(method, taps_key, nbits)
    fits = ((stack >= -(1 << 15)) & (stack < (1 << 15))).all(axis=0)
    int16_prefix = int(fits.size if fits.all() else fits.argmin())
    return RomStack(torch.from_numpy(stack.astype(np.int32)).to(device),
                    int(np.iinfo(stack.dtype).min), bound, int16_prefix)


def rom_stack(method: str, taps, nbits: int, device: torch.device) -> RomStack:
    """(taps.size, 2**nbits) KCM ROM stack on `device` for the coefficients
    `taps` (row-major), as the kcm kernels read it; raises when the
    accumulator bound exceeds int32, like the reference."""
    key = (method, tuple(_host_taps(taps).reshape(-1).tolist()), nbits)
    if _host_tables(*key)[1] >= (1 << 31):
        raise ValueError(f"accumulator bound {_host_tables(*key)[1]} exceeds "
                         "the int32 datapath; narrow the taps or nbits")
    return _device_tables(*key, device)


def _resolve_mult_impl(mult_impl: str) -> str:
    if mult_impl not in MULT_IMPLS:
        raise ValueError(f"mult_impl must be one of {MULT_IMPLS}, got {mult_impl!r}")
    return "kcm" if mult_impl == "auto" else mult_impl


def _as_batch(imgs: torch.Tensor) -> torch.Tensor:
    if not isinstance(imgs, torch.Tensor) or imgs.dim() != 3:
        raise ValueError("expected an (N, H, W) integer tensor, got "
                         f"{type(imgs).__name__} {tuple(getattr(imgs, 'shape', ()))}")
    return imgs.to(torch.int32).contiguous()


def _host_taps(taps) -> np.ndarray:
    if isinstance(taps, torch.Tensor):
        taps = taps.cpu().numpy()
    return np.asarray(taps, np.int64)


def conv2d_pass(imgs: torch.Tensor, taps, *, method: str = "refmlm",
                nbits: int = 8, shift: int = 8, post: str = "clip",
                mult_impl: str = "auto") -> torch.Tensor:
    """One batched convolution pass: (N, H, W) int32 -> (N, H, W) int32 on
    the input's device. Input may be signed (the separable intermediate);
    `nbits` must cover the widest |operand| of each tap product."""
    x = _as_batch(imgs)
    taps = _host_taps(taps)
    if taps.ndim != 2:
        raise ValueError(f"taps must be (kh, kw), got shape {taps.shape}")
    kh, kw = taps.shape
    if _resolve_mult_impl(mult_impl) == "kcm":
        rom = rom_stack(method, taps, nbits, x.device)
        return conv_pass_kcm(x, rom, kh, kw, shift=shift, post=post)
    return conv_pass_recurse(x, taps, method=method, nbits=nbits, shift=shift,
                             post=post)


def fused_separable_pass(imgs: torch.Tensor, row, col, *,
                         method: str = "refmlm", nbits: int = 8,
                         nbits2: int = 16, shift: int = 8, post: str = "clip",
                         mult_impl: str = "auto") -> torch.Tensor:
    """Both separable passes in one kernel: `row` is the (kw,) horizontal
    filter at width `nbits`, `col` the (kh,) vertical filter at `nbits2`
    (see `second_pass_nbits`). Bit-identical to `conv2d_pass(row,
    post='none')` followed by `conv2d_pass(col)`."""
    x = _as_batch(imgs)
    row, col = _host_taps(row).reshape(-1), _host_taps(col).reshape(-1)
    if _resolve_mult_impl(mult_impl) == "kcm":
        return fused_separable_kcm(
            x, rom_stack(method, row, nbits, x.device),
            rom_stack(method, col, nbits2, x.device), shift=shift, post=post)
    return fused_separable_recurse(x, row, col, method=method, nbits=nbits,
                                   nbits2=nbits2, shift=shift, post=post)


def second_pass_nbits(intermediate_max: int, coeff_max: int) -> int:
    """Multiplier width for the separable column pass: the narrowest
    supported width covering both the row-pass accumulator magnitude and the
    column coefficients (8 for narrow filters, 16 in general)."""
    need = max(int(intermediate_max), int(coeff_max))
    for nb in (2, 4, 8, 16):
        if need < (1 << nb):
            return nb
    raise ValueError(
        f"separable intermediate {need} exceeds the 16-bit REFMLM datapath")


__all__ = [
    "FUSED_PERSISTENT_SHAPES", "KERNELS", "LAUNCHES", "METHODS", "MULT_IMPLS",
    "PERSISTENT_SHAPES", "POSTS", "PREFIX_GRANULE", "PREFIX_MAX_BYTES", "ROUTED",
    "ROUTE_LAUNCHES", "ROUTE_TILES", "RomStack", "apply_post", "column_prefix",
    "conv2d_pass", "conv_pass_kcm", "conv_pass_kcm_plain", "conv_pass_recurse",
    "conv_pass_recurse_plain", "fused_separable_kcm",
    "fused_separable_kcm_plain", "fused_separable_pass",
    "fused_separable_recurse", "fused_separable_recurse_plain",
    "kernel_route", "reset_launches", "rom_stack", "second_pass_nbits", "tap_multiplier",
]
