"""Unified matmul API over the multiplier family.

    matmul(a, b, method=...)   a: (..., M, K) float   b: (K, N) float

Counterpart of `repro.core.approx_matmul`. Methods:
  exact            -- float32 torch.matmul.
  int8             -- symmetric int8 quantized matmul, int32 accumulation.
  schoolbook_int16 -- exact ~int16 matmul from 4 int8-limb products.
  karatsuba_int16  -- ~int13 matmul from 3 int8-limb products.
  mitchell / mitchell_ecc{k} / odma -- LNS approximate matmuls: every scalar
                      multiply is the paper's multiplier on `nbits`-quantized
                      magnitudes, sign-tracked.
  refmlm / refmlm_kom3 -- the paper's recursive multiplier, bit-exact.

Implementations (`impl=`):
  reference -- plain PyTorch with the reference's semantics (element
               products, then the sum), on any device. The default.
  kernel    -- the CUDA kernels (`mitchell_matmul` for the LNS family,
               `karatsuba_matmul` for the limb family); on a CPU tensor a
               kernel wrapper runs its plain version. Methods with no kernel
               (exact, int8, odma, refmlm, refmlm_kom3) keep the reference
               semantics. This takes the place of the reference's 'pallas'.
  auto      -- the kernel for a CUDA tensor, the reference semantics for a
               CPU tensor (the reference picks its kernel on a compiled TPU
               backend and its reference on the CPU interpreter).

The reference sums LNS products in float32, which is exact while K <=
2**(24 - 2*nbits) (256 at 8 bits); the kernel route rescales an exact int32
sum, so the two agree within that range and the kernel route is exact
beyond it. The reference's `row_chunk` and `precision` arguments have no
counterpart: chunking does not change the result, and float32 matmuls run
in full float32 (TF32 is off for matmuls by default in PyTorch).

The activation operand `a` is quantized inside `core.collectives.
batch_rows()`: its rows are batch rows, so in a meshed step, which splits
them over the row axes, its abs-max spans every rank's rows (`core.quant`).
The weight `b` inside `core.collectives.weight_block()`.

`split` is the product's tensor-parallel split over "model"
(`core.collectives.model_axis`, None outside a meshed step): "col", `b`
is a block of the weight's columns (N), and the result the same columns;
"row", `b` is a block of its rows (K) and `a` the same block of its
columns. Either way the abs-max of a split operand spans "model", so each
rank quantizes to the integers of the unsplit product; under "row" the
accumulator (the int32 sums, or the plain LNS route's float32 sums of
integers) is summed over "model" before the float32 rescale, so the result
is the unsplit product's, to the byte (the int32 sum wraps as the kernel's
own does).

The kernel modules are imported inside the functions that call them, as in
the reference: they import `repro_torch.core`, which imports this module.
"""
from __future__ import annotations

import re
from functools import lru_cache, partial
from typing import Callable

import torch

from repro_torch.core.collectives import all_reduce, batch_rows, model_axis, weight_block
from repro_torch.core.mitchell import babic_ecc, mitchell
from repro_torch.core.odma import odma
from repro_torch.core.platform import resolve_device
from repro_torch.core.quant import quantize_limbs, quantize_magnitude
from repro_torch.core.refmlm import refmlm

METHODS = (
    "exact",
    "int8",
    "schoolbook_int16",
    "karatsuba_int16",
    "mitchell",
    "mitchell_ecc1",
    "mitchell_ecc2",
    "mitchell_ecc3",
    "odma",
    "refmlm",
    "refmlm_kom3",
)

IMPLS = ("reference", "kernel", "auto")

#: methods with a kernel: LNS family -> mitchell_matmul, limb family ->
#: karatsuba_matmul. Everything else keeps the reference semantics.
KERNEL_LNS_METHODS = ("mitchell", "mitchell_ecc1", "mitchell_ecc2",
                      "mitchell_ecc3")
KERNEL_LIMB_METHODS = ("schoolbook_int16", "karatsuba_int16")

# Elements of the (rows, K, N) product block the plain LNS routes form at once.
PLAIN_CHUNK_ELEMENTS = 1 << 22


def scalar_multiplier(method: str, nbits: int) -> Callable:
    """The method's element-wise integer product on non-negative operands
    (< 2**nbits), the unit the matmuls and `repro_torch.infer` reduce over."""
    if method == "mitchell":
        return partial(mitchell, nbits=nbits)
    if m := re.fullmatch(r"mitchell_ecc(\d+)", method):
        return partial(babic_ecc, nbits=nbits, num_ecc=int(m.group(1)))
    if method == "odma":
        return partial(odma, nbits=nbits)
    if method == "refmlm":
        return partial(refmlm, nbits=nbits, variant="kom4", base="efmlm")
    if method == "refmlm_kom3":
        return partial(refmlm, nbits=nbits, variant="kom3", base="efmlm")
    raise ValueError(f"unknown LNS method {method!r}")


def lns_kernel_args(method: str) -> tuple[int, bool]:
    """(num_ecc, case_split) of the `mitchell_matmul` kernel for a method of
    KERNEL_LNS_METHODS."""
    if method == "mitchell":
        return 0, True
    return int(re.fullmatch(r"mitchell_ecc(\d+)", method).group(1)), False


def row_slices(m: int, k: int, n: int) -> list[slice]:
    """Row blocks of an (M, K) x (K, N) plain element-product route, each at
    most PLAIN_CHUNK_ELEMENTS (rows, K, N) products (the reference's
    row_chunk, which does not change the result, sized for the card)."""
    rows = max(1, PLAIN_CHUNK_ELEMENTS // max(1, k * n))
    return [slice(lo, lo + rows) for lo in range(0, m, rows)]


#: widths whose plain LNS route looks its products up in a table of all
#: 2**(2 * nbits) magnitude pairs (65536 at 8 bits), built by the same
#: multiplier, so the bytes are the element function's
TABLE_NBITS = 8


@lru_cache(maxsize=None)
def _product_table(method: str, nbits: int, device: torch.device) -> torch.Tensor:
    v = torch.arange(1 << nbits, dtype=torch.int32, device=device)
    return scalar_multiplier(method, nbits)(v[:, None], v[None, :]).reshape(-1)


def _reduce_acc(acc: torch.Tensor, split: str | None) -> torch.Tensor:
    """A row-parallel product's accumulator summed over "model" (module
    docstring); `acc` itself otherwise. It carries no grad."""
    m = model_axis() if split == "row" else None
    return acc if m is None else all_reduce(acc.contiguous(), "sum", m)


def _lns_matmul(a: torch.Tensor, b: torch.Tensor, method: str,
                nbits: int, split: str | None = None) -> torch.Tensor:
    """Sign-magnitude LNS matmul: out[m,n] = sum_k mult(|a|,|b|) * sign,
    the products summed in float32 like the reference's."""
    mult = scalar_multiplier(method, nbits)
    with batch_rows(split):
        qa = quantize_magnitude(a, nbits)
    with weight_block(split):
        qb = quantize_magnitude(b, nbits)
    sa = (qa.magnitude * qa.sign).reshape(-1, a.shape[-1])
    sb = qb.magnitude * qb.sign
    mag_b, sgn_b = sb.abs()[None], torch.sign(sb)[None]
    if nbits <= TABLE_NBITS:       # every product of two magnitudes, looked up
        table = _product_table(method, nbits, a.device)
        mult = lambda x, y: table[x * (1 << nbits) + y]     # noqa: E731
    out = torch.empty((sa.shape[0], sb.shape[1]), dtype=torch.float32,
                      device=a.device)
    for rows in row_slices(*sa.shape, sb.shape[1]):
        blk = sa[rows]
        mag = mult(blk.abs()[:, :, None], mag_b).to(torch.float32)
        sgn = (torch.sign(blk)[:, :, None] * sgn_b).to(torch.float32)
        out[rows] = (mag * sgn).sum(dim=1)
    acc = _reduce_acc(out, split) * (qa.scale * qb.scale)
    return acc.reshape(*a.shape[:-1], b.shape[-1])


def limb_matmul(a: torch.Tensor, b: torch.Tensor, *, karatsuba: bool,
                kernel: bool, split: str | None = None) -> torch.Tensor:
    """Exact wide-int matmul from int8-valued limb products (3 or 4): the
    int32 partial sums come from the `karatsuba_matmul` kernel when
    `kernel`, else from its plain version (the reference's integer
    matmuls), and are rescaled in float32 (shifting hh by 2w bits could
    overflow int32), summed in the reference's order."""
    from repro_torch.kernels.karatsuba_matmul import (
        karatsuba_matmul_kernel,
        karatsuba_matmul_plain,
    )
    with batch_rows(split):
        da, sa = quantize_limbs(a.reshape(-1, a.shape[-1]), karatsuba=karatsuba)
    with weight_block(split):
        db, sb = quantize_limbs(b, karatsuba=karatsuba)
    partials = karatsuba_matmul_kernel if kernel else karatsuba_matmul_plain
    hh, mid, ll = partials(da.hi, da.lo, db.hi, db.lo, karatsuba=karatsuba)
    if split == "row" and model_axis() is not None:
        hh, mid, ll = _reduce_acc(torch.stack([hh, mid, ll]), split).unbind(0)
    w = da.limb_bits
    acc = (hh.to(torch.float32) * float(1 << (2 * w))
           + mid.to(torch.float32) * float(1 << w) + ll.to(torch.float32))
    return (acc * (sa * sb)).reshape(*a.shape[:-1], b.shape[-1])


def kernel_lns_matmul(a: torch.Tensor, b: torch.Tensor, *, nbits: int,
                      num_ecc: int, case_split: bool, split: str | None = None) -> torch.Tensor:
    """LNS matmul on the `mitchell_matmul` kernel: an exact int32 sum,
    rescaled in float32. Like the reference's kernel route it takes any
    `nbits`; the reference route's multipliers stop at 16."""
    from repro_torch.kernels.mitchell_matmul import mitchell_matmul_kernel
    with batch_rows(split):
        qa = quantize_magnitude(a, nbits)
    with weight_block(split):
        qb = quantize_magnitude(b, nbits)
    sa = (qa.magnitude * qa.sign).reshape(-1, a.shape[-1])
    acc = _reduce_acc(mitchell_matmul_kernel(sa, qb.magnitude * qb.sign, num_ecc=num_ecc,
                                             case_split=case_split), split)
    out = acc.to(torch.float32) * (qa.scale * qb.scale)
    return out.reshape(*a.shape[:-1], b.shape[-1])


def _int8_matmul(a: torch.Tensor, b: torch.Tensor, split: str | None = None) -> torch.Tensor:
    from repro_torch.kernels.karatsuba_matmul import int_matmul
    with batch_rows(split):
        qa = quantize_magnitude(a, 7)      # int8 symmetric: magnitudes < 128
    with weight_block(split):
        qb = quantize_magnitude(b, 7)
    acc = _reduce_acc(int_matmul((qa.magnitude * qa.sign).reshape(-1, a.shape[-1]),
                                 qb.magnitude * qb.sign), split)
    out = acc.to(torch.float32) * (qa.scale * qb.scale)
    return out.reshape(*a.shape[:-1], b.shape[-1])


def resolve_impl(impl: str, method: str, device: torch.device) -> str:
    """'reference' or 'kernel' for a method on a device (module docstring)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        impl = "kernel" if device.type == "cuda" else "reference"
    if method not in (*KERNEL_LNS_METHODS, *KERNEL_LIMB_METHODS):
        return "reference"
    return impl


def matmul(a, b, method: str = "exact", *, nbits: int = 8,
           impl: str = "reference",
           device: str | torch.device | None = None,
           split: str | None = None) -> torch.Tensor:
    """Unified (..., M, K) x (K, N) matmul over the multiplier family, on
    `device` (the CUDA card by default); -> float32 (..., M, N).

    `impl` selects the implementation ('reference' | 'kernel' | 'auto',
    module docstring); `split` the tensor-parallel split (None, "col",
    "row"; module docstring)."""
    from repro_torch.core.collectives import reduce_from_model
    dev = resolve_device(device)
    a = torch.as_tensor(a).to(dev)
    b = torch.as_tensor(b).to(dev)
    if method == "exact":
        y = torch.matmul(a, b)
        return reduce_from_model(y, model_axis()) if split == "row" else y
    if method == "int8":
        return _int8_matmul(a, b, split)
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; valid: {METHODS}")
    kernel = resolve_impl(impl, method, dev) == "kernel"
    if method in KERNEL_LIMB_METHODS:
        return limb_matmul(a, b, karatsuba=method == "karatsuba_int16", kernel=kernel,
                           split=split)
    if kernel:
        num_ecc, case_split = lns_kernel_args(method)
        return kernel_lns_matmul(a, b, nbits=nbits, num_ecc=num_ecc,
                                 case_split=case_split, split=split)
    return _lns_matmul(a, b, method, nbits, split)


__all__ = ["IMPLS", "KERNEL_LIMB_METHODS", "KERNEL_LNS_METHODS", "METHODS",
           "PLAIN_CHUNK_ELEMENTS", "kernel_lns_matmul", "limb_matmul",
           "lns_kernel_args", "matmul", "resolve_impl", "row_slices",
           "scalar_multiplier"]
