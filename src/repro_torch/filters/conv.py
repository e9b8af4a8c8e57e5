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
adds one to `LAUNCHES[<kernel name>]` and to `ROUTE_LAUNCHES[(name, route,
tile)]`.

The grid arguments of the reference's passes (block_rows, block_cols,
batch_fold) choose the tile on the card: the persistent kernels are
compiled for every tile of a menu (`repro_torch.tuning.blocks.TILE_MENU`,
one library a tile), and `conv2d_pass` / `fused_separable_pass` resolve
unset fields through the tuning cache (`resolve_blocks`: explicit, then
cached, then the route's first tile). An explicit tile off the menu raises
ValueError on the card. `batch_fold=True` folds the batch on the host, as
the reference does around its pass (`_fold_batch`): each image padded
with its kh//2 zero rows, the same pass run on the tall (1, N*(H+2ph), W)
image, its halo rows cropped; the embedded zero rows are the halo each
image's own pass reads, so the bytes are the unfolded pass's. On the CPU
the tile fields are the reference's vocabulary, checked as the reference
checks an explicit `block_cols`; the plain versions ignore them, since
the bytes never depend on the tile, and an explicit fold folds there too.
The recurse wrappers also take `chunk`, the rows a thread of the
persistent kernel holds at once, which the tuner sweeps (`chunk_menu`).
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
from repro_torch.kernels.build import launch, library_name
from repro_torch.tuning.blocks import (
    FUSED_PERSISTENT_SHAPES,
    PERSISTENT_SHAPES,
    TILE_MENU,
    kernel_route,
    menu_tile,
    min_block_cols,
    route_of,
)
from repro_torch.tuning.cache import resolve_blocks

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

# Tap shapes the persistent kernels are compiled for (the bank's,
# PERSISTENT_SHAPES and FUSED_PERSISTENT_SHAPES); any other shape runs the
# tiled kernels. `kernel_route` is the rule: the recurse and fused kcm C
# entries run the persistent kernel when they are given a plan (a column
# prefix) and the tiled one when they are not, and every C entry refuses a
# tile that is not its route's.
# Output tiles (rows, cols) of one block of each route, the menu the wrappers
# choose from: the persistent kernels' TileShapes (csrc/staging.cuh), the
# tiled kernels' kTileH x kTileW (conv_pass.cu, fused_separable.cu).
ROUTE_TILES = TILE_MENU
# Rows a thread of a persistent recurse kernel holds at once (its tap
# policy's kChunk), the menu the tuner sweeps: compiled for REFMLM's 8-bit
# policy at 3x3 direct taps and for its 8-bit rows with 16-bit columns in the
# fused kernel (`chunk_menu`); elsewhere each policy's own.
CHUNKS = (0, 4, 8, 16)

# The fused kcm kernel's column-ROM prefix (`column_prefix`): its length is
# rounded up to PREFIX_GRANULE entries, so the launcher's occupancy cache
# sees few shared-memory sizes, and held to PREFIX_MAX_BYTES a block; an
# operand past the prefix is gathered from global memory.
PREFIX_GRANULE = 256
PREFIX_MAX_BYTES = 96 * 1024
# Kernels whose route (`kernel_route`) and tile the wrappers pick: all four.
ROUTED = KERNELS

#: kernel name -> number of launches since the last `reset_launches()`.
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)
#: (kernel name, route, (rows, cols)) -> launches of that route and tile.
ROUTE_LAUNCHES: dict[tuple[str, str, tuple[int, int]], int] = {
    (name, route, tile): 0 for name in ROUTED
    for route, tiles in TILE_MENU.items() for tile in tiles}


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
    "conv_pass_kcm": ("conv_pass", (_P, _P, _I, _I, _I, _P) + (_I,) * 9),
    "conv_pass_recurse": ("conv_pass", (_P, _P, _P, _I, _I, _I, _P) + (_I,) * 10),
    "fused_separable_kcm": ("fused_separable",
                            (_P, _P, _I, _I, _P, _I, _I, _I, _I, _P) + (_I,) * 9),
    "fused_separable_recurse": ("fused_separable",
                                (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P) + (_I,) * 10),
}


def _launch(name: str, x: torch.Tensor, args_for, route: str,
            tile: tuple[int, int]) -> torch.Tensor:
    """Launch kernel `name` on the current stream of x's device with the C
    arguments (x, *args_for(out), *tile, stream), `out` allocated here, from
    the library of `tile` (`build.library_name`); raise if the launch
    failed. An empty batch launches nothing. `route`, `tile`: the
    kernel_route and menu tile the wrapper picked."""
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    source, argtypes = _SIGNATURES[name]
    library = library_name(source, tile if route == "persistent" else None)
    launch(library, name, argtypes, x.device, x.data_ptr(), *args_for(out), *tile)
    LAUNCHES[name] += 1
    ROUTE_LAUNCHES[(name, route, tile)] += 1
    return out


def _tile(route: str, tile: tuple[int, int] | None) -> tuple[int, int]:
    """The menu tile a kernel wrapper launches: `tile`, checked against the
    route's menu, or the route's first."""
    if tile is None:
        return TILE_MENU[route][0]
    return menu_tile(route, int(tile[0]), int(tile[1]), False)


def chunk_menu(kernel: str, method: str, nbits: int, kh: int, kw: int,
               nbits2: int | None = None) -> tuple[int, ...]:
    """The chunks a recurse kernel is compiled for at these arguments on
    the persistent route: CHUNKS for REFMLM's 8-bit policy (nbits 3-8)
    at 3x3 direct taps, and in the fused kernel for 8-bit rows with columns
    past 8 bits; () elsewhere, where only the policy's own runs."""
    family, _ = parse_method(method)
    table8 = family in ("refmlm", "refmlm_nc") and 2 < nbits <= 8
    if kernel == "conv_pass_recurse":
        swept = table8 and (kh, kw) == (3, 3)
    else:
        swept = table8 and nbits2 is not None and nbits2 > 8 \
            and kernel_route(kh, kw, fused=True) == "persistent"
    return CHUNKS if swept else ()


def _chunk(chunk: int | None, menu: tuple[int, ...]) -> int:
    """The C entry's chunk argument: -1 (the policy's own) for None."""
    if chunk is None:
        return -1
    if int(chunk) not in menu:
        raise ValueError(f"chunk={chunk} is not compiled for these arguments; "
                         f"the menu is {menu or '(the policy default only)'}")
    return int(chunk)


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
                  shift: int, post: str,
                  tile: tuple[int, int] | None = None) -> torch.Tensor:
    """Direct pass from a (kh*kw, 2**nbits) ROM stack (`rom_stack`), on
    `tile` of its route's menu (None: the first)."""
    _check_x(x)
    _check_post(post)
    if rom.table.shape[0] != kh * kw:
        raise ValueError(f"ROM stack has {rom.table.shape[0]} rows for {kh}x{kw} taps")
    route = kernel_route(kh, kw)
    tile = _tile(route, tile)
    if x.device.type == "cpu":
        return conv_pass_kcm_plain(x, rom, kh, kw, shift=shift, post=post)
    _check_cuda(x, kh, kw, rom)
    n, h, w = x.shape
    return _launch("conv_pass_kcm", x, lambda out: (
        rom.table.data_ptr(), rom.table.shape[1], rom.fill, rom.carry_bits,
        out.data_ptr(), n, h, w, kh, kw, shift, POSTS.index(post)), route, tile)


def _plan_ptr(method: str, taps, nbits: int, route: str) -> int | None:
    """Host address of the cached plan words for a persistent launch
    (None, a null pointer, for the tiled kernels, which take no plan)."""
    if route != "persistent":
        return None
    return plan_words(recurse_plan(method, taps, nbits)).ctypes.data


def conv_pass_recurse(x: torch.Tensor, taps: np.ndarray, *, method: str,
                      nbits: int, shift: int, post: str,
                      tile: tuple[int, int] | None = None,
                      chunk: int | None = None) -> torch.Tensor:
    """Direct pass with the multiplier evaluated per tap, from the host plan
    of `taps` (`recurse_plan`) on the persistent kernel's shapes, on `tile`
    of the route's menu, with `chunk` of `chunk_menu` (None: the policy's)."""
    _check_x(x)
    _check_post(post)
    code, num_ecc = _check_method_width(method, nbits)
    kh, kw = taps.shape
    route = kernel_route(kh, kw)
    tile = _tile(route, tile)
    menu = chunk_menu("conv_pass_recurse", method, nbits, kh, kw) \
        if route == "persistent" else ()
    chunk = _chunk(chunk, menu)
    if x.device.type == "cpu":
        return conv_pass_recurse_plain(x, taps, method=method, nbits=nbits,
                                       shift=shift, post=post)
    _check_cuda(x, kh, kw)
    n, h, w = x.shape
    coeffs = _host_ints(taps)
    plan = _plan_ptr(method, taps, nbits, route)
    return _launch("conv_pass_recurse", x, lambda out: (
        ctypes.cast(coeffs, ctypes.c_void_p), plan, code, num_ecc, nbits,
        out.data_ptr(), n, h, w, kh, kw, shift, POSTS.index(post), chunk), route, tile)


def fused_separable_kcm(x: torch.Tensor, row: RomStack, col: RomStack, *,
                        shift: int, post: str,
                        tile: tuple[int, int] | None = None) -> torch.Tensor:
    """Fused separable pass from a (kw, 2**nbits) row ROM stack and a
    (kh, 2**nbits2) column ROM stack (`rom_stack`), on `tile` of its
    route's menu; the persistent kernel stages the column ROMs'
    `column_prefix` on the shapes it is compiled for."""
    _check_x(x)
    _check_post(post)
    kh, kw = col.table.shape[0], row.table.shape[0]
    route = kernel_route(kh, kw, fused=True)
    tile = _tile(route, tile)
    if x.device.type == "cpu":
        return fused_separable_kcm_plain(x, row, col, shift=shift, post=post)
    _check_cuda(x, kh, kw, row, col)
    n, h, w = x.shape
    prefix, int16 = column_prefix(row, col) if route == "persistent" else (0, False)
    return _launch("fused_separable_kcm", x, lambda out: (
        row.table.data_ptr(), row.table.shape[1], row.fill, col.table.data_ptr(),
        col.table.shape[1], col.fill, prefix, int(int16), out.data_ptr(), n, h, w,
        kh, kw, shift, POSTS.index(post)), route, tile)


def fused_separable_recurse(x: torch.Tensor, row: np.ndarray, col: np.ndarray,
                            *, method: str, nbits: int, nbits2: int,
                            shift: int, post: str,
                            tile: tuple[int, int] | None = None,
                            chunk: int | None = None) -> torch.Tensor:
    """Fused separable pass with the multiplier evaluated per tap, from the
    host plans of `row` and `col` on the persistent kernel's shapes, on
    `tile` of the route's menu, with the column policy's `chunk` of
    `chunk_menu` (None: the policy's own)."""
    _check_x(x)
    _check_post(post)
    code, num_ecc = _check_method_width(method, nbits)
    _check_method_width(method, nbits2)
    kh, kw = col.size, row.size
    route = kernel_route(kh, kw, fused=True)
    tile = _tile(route, tile)
    chunk = _chunk(chunk, chunk_menu("fused_separable_recurse", method, nbits, kh, kw,
                                     nbits2))
    if x.device.type == "cpu":
        return fused_separable_recurse_plain(
            x, row, col, method=method, nbits=nbits, nbits2=nbits2,
            shift=shift, post=post)
    _check_cuda(x, kh, kw)
    n, h, w = x.shape
    row_c, col_c = _host_ints(row), _host_ints(col)
    row_plan = _plan_ptr(method, row, nbits, route)
    col_plan = _plan_ptr(method, col, nbits2, route)
    return _launch("fused_separable_recurse", x, lambda out: (
        ctypes.cast(row_c, ctypes.c_void_p), ctypes.cast(col_c, ctypes.c_void_p),
        row_plan, col_plan, code, num_ecc, nbits, nbits2, out.data_ptr(), n, h,
        w, kh, kw, shift, POSTS.index(post), chunk), route, tile)


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


def pass_tile(x: torch.Tensor, kind: str, kh: int, kw: int, impl: str,
              block_rows: int | None, block_cols: int | None,
              batch_fold: bool | None) -> tuple[tuple[int, int] | None, bool]:
    """(the menu tile a pass of `kind` ('direct' | 'fused') launches on x's
    card, whether it folds the batch): the explicit grid fields, the rest
    through the 'cuda' cache and the route's first tile (`resolve_blocks`);
    raises for a tile off the menu. On the CPU (tile None) only the
    reference's check of an explicit `block_cols` applies: the plain
    versions ignore the grid, and only an explicit fold folds."""
    n, h, w = x.shape
    if x.device.type != "cuda":
        bc = w if block_cols is None else min(int(block_cols), w)
        if bc < w and bc < min_block_cols(kw):
            raise ValueError(f"block_cols={bc} too narrow for a {kw // 2}-column halo")
        return None, bool(batch_fold) and n > 1
    cfg = resolve_blocks(kind, n, h, w, kh, kw, impl, block_rows=block_rows,
                         block_cols=block_cols, batch_fold=batch_fold,
                         backend="cuda")
    return (menu_tile(route_of(kind, kh, kw), cfg.block_rows, cfg.block_cols,
                      cfg.batch_fold), bool(cfg.batch_fold) and n > 1)


def _fold_batch(x: torch.Tensor, ph: int) -> torch.Tensor:
    """(N, H, W) -> (1, N*(H+2ph), W): the images stacked into one tall
    image, each with its own ph-row zero halo (the reference's
    `_fold_batch`)."""
    return F.pad(x, (0, 0, ph, ph)).reshape(1, -1, x.shape[-1])


def _unfold_batch(out: torch.Tensor, n: int, h: int, ph: int) -> torch.Tensor:
    """The inverse on the pass's output: each image's rows, its halo rows
    (computed from zeros) dropped."""
    return out.reshape(n, h + 2 * ph, out.shape[-1])[:, ph:ph + h].contiguous()


def conv2d_pass(imgs: torch.Tensor, taps, *, method: str = "refmlm",
                nbits: int = 8, shift: int = 8, post: str = "clip",
                mult_impl: str = "auto", block_rows: int | None = None,
                block_cols: int | None = None,
                batch_fold: bool | None = None) -> torch.Tensor:
    """One batched convolution pass: (N, H, W) int32 -> (N, H, W) int32 on
    the input's device. Input may be signed (the separable intermediate);
    `nbits` must cover the widest |operand| of each tap product. The grid
    fields pick the card's tile (`pass_tile`); the bytes never depend on
    them."""
    x = _as_batch(imgs)
    taps = _host_taps(taps)
    if taps.ndim != 2:
        raise ValueError(f"taps must be (kh, kw), got shape {taps.shape}")
    kh, kw = taps.shape
    impl = _resolve_mult_impl(mult_impl)
    tile, fold = pass_tile(x, "direct", kh, kw, impl, block_rows, block_cols, batch_fold)
    if fold:
        n, h, _ = x.shape
        return _unfold_batch(conv2d_pass(_fold_batch(x, kh // 2), taps, method=method,
                                         nbits=nbits, shift=shift, post=post,
                                         mult_impl=impl, block_rows=tile and tile[0],
                                         block_cols=tile and tile[1], batch_fold=False),
                             n, h, kh // 2)
    if impl == "kcm":
        rom = rom_stack(method, taps, nbits, x.device)
        return conv_pass_kcm(x, rom, kh, kw, shift=shift, post=post, tile=tile)
    return conv_pass_recurse(x, taps, method=method, nbits=nbits, shift=shift,
                             post=post, tile=tile)


def fused_separable_pass(imgs: torch.Tensor, row, col, *,
                         method: str = "refmlm", nbits: int = 8,
                         nbits2: int = 16, shift: int = 8, post: str = "clip",
                         mult_impl: str = "auto", block_rows: int | None = None,
                         block_cols: int | None = None,
                         batch_fold: bool | None = None) -> torch.Tensor:
    """Both separable passes in one kernel: `row` is the (kw,) horizontal
    filter at width `nbits`, `col` the (kh,) vertical filter at `nbits2`
    (see `second_pass_nbits`). Bit-identical to `conv2d_pass(row,
    post='none')` followed by `conv2d_pass(col)`. The grid fields pick the
    card's tile (`pass_tile`)."""
    x = _as_batch(imgs)
    row, col = _host_taps(row).reshape(-1), _host_taps(col).reshape(-1)
    impl = _resolve_mult_impl(mult_impl)
    tile, fold = pass_tile(x, "fused", col.size, row.size, impl, block_rows, block_cols,
                           batch_fold)
    if fold:
        n, h, _ = x.shape
        return _unfold_batch(fused_separable_pass(
            _fold_batch(x, col.size // 2), row, col, method=method, nbits=nbits,
            nbits2=nbits2, shift=shift, post=post, mult_impl=impl,
            block_rows=tile and tile[0], block_cols=tile and tile[1], batch_fold=False),
            n, h, col.size // 2)
    if impl == "kcm":
        return fused_separable_kcm(
            x, rom_stack(method, row, nbits, x.device),
            rom_stack(method, col, nbits2, x.device), shift=shift, post=post,
            tile=tile)
    return fused_separable_recurse(x, row, col, method=method, nbits=nbits,
                                   nbits2=nbits2, shift=shift, post=post, tile=tile)


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
    "CHUNKS", "FUSED_PERSISTENT_SHAPES", "KERNELS", "LAUNCHES", "METHODS",
    "MULT_IMPLS", "PERSISTENT_SHAPES", "POSTS", "PREFIX_GRANULE",
    "PREFIX_MAX_BYTES", "ROUTED", "ROUTE_LAUNCHES", "ROUTE_TILES", "RomStack",
    "apply_post", "chunk_menu", "column_prefix", "pass_tile",
    "conv2d_pass", "conv_pass_kcm", "conv_pass_kcm_plain", "conv_pass_recurse",
    "conv_pass_recurse_plain", "fused_separable_kcm",
    "fused_separable_kcm_plain", "fused_separable_pass",
    "fused_separable_recurse", "fused_separable_recurse_plain",
    "kernel_route", "reset_launches", "rom_stack", "second_pass_nbits", "tap_multiplier",
]
