"""The limb kernel on Hopper's int8 tensor cores (`csrc/karatsuba_matmul_i8.cu`)
and the rule that picks it.

`karatsuba_matmul_kernel` (`repro_torch.kernels.karatsuba_matmul`) takes any
int32 limbs. On CUDA tensors it first runs this module's pack step, which
casts the limbs to int8 in the layouts `mma.sync` wants and checks that
they fit (`select_route`'s rule); one host sync reads the check. Limbs that
fit go to `karatsuba_matmul_i8`; wider ones to the wide kernel
`karatsuba_matmul` (its thin or digit route), which reads the digit count
it needs from the same flag (`flag_digits`; the plain mirror is
`karatsuba_matmul.limb_digits`). Both give the same bytes as
`karatsuba_matmul_plain`.

The rule: every limb in [-128, 127], and for Karatsuba every hi + lo in
[-128, 127] too (its middle product multiplies the sums). `quantize_limbs`
guarantees it (w=7 limbs in [-64, 63], w=8 limbs in [-128, 127]), and so do
`balanced_limbs` of the 8-bit operands `infer.forward` quantizes.

Each launch of the product kernel adds one to
`LAUNCHES['karatsuba_matmul_i8']`; the pack step is its first half and is
not counted apart.

Fake tensors (`FakeTensorMode`, the dry-run's) launch nothing: `pack`
returns empty int8 copies and takes the limbs as fitting (the range check
cannot be read; `quantize_limbs` guarantees it), and `product` returns
empty outputs and records the product's work in `repro_torch.roofline.
analysis`'s counters: 2 int8 operations a multiply-add of each of its 3
(Karatsuba) or 4 products, and the bytes of its bound, 4 (2MK + 2KN + 3MN).
`LAUNCHES` does not move.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.kernels.build import launch

KERNEL = "karatsuba_matmul_i8"
WIDE_KERNEL = "karatsuba_matmul"
#: kernel name -> number of launches since the last `reset_launches()`.
LAUNCHES: dict[str, int] = {KERNEL: 0}
_K_ALIGN = 128                                # kBK of the kernel
_TILE_N = 64                                  # kBN of the kernel
_PACK_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 5
_PRODUCT_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4


def reset_launches() -> None:
    LAUNCHES[KERNEL] = 0


def limbs_fit_int8(a_hi: torch.Tensor, a_lo: torch.Tensor, b_hi: torch.Tensor,
                   b_lo: torch.Tensor, *, karatsuba: bool) -> bool:
    """The int8 kernel's rule, on any device: every limb in [-128, 127] and,
    for Karatsuba, every hi + lo as well."""
    def fits(t: torch.Tensor) -> bool:
        if t.numel() == 0:
            return True
        lo, hi = torch.aminmax(t)
        return -128 <= int(lo) and int(hi) <= 127

    limbs = [a_hi, a_lo, b_hi, b_lo]
    if karatsuba:
        limbs += [a_hi.to(torch.int64) + a_lo, b_hi.to(torch.int64) + b_lo]
    return all(fits(t) for t in limbs)


def select_route(a_hi: torch.Tensor, a_lo: torch.Tensor, b_hi: torch.Tensor,
                 b_lo: torch.Tensor, *, karatsuba: bool) -> str:
    """Name of the kernel `karatsuba_matmul_kernel` launches for these limbs
    on the card: KERNEL when they fit int8, else WIDE_KERNEL."""
    fit = limbs_fit_int8(a_hi, a_lo, b_hi, b_lo, karatsuba=karatsuba)
    return KERNEL if fit else WIDE_KERNEL


class PackedLimbs(NamedTuple):
    a8: torch.Tensor           # (2, M, Kp) int8: a_hi, a_lo, K contiguous
    b8: torch.Tensor           # (2, N, Kp) int8: b_hi, b_lo transposed
    m: int
    n: int
    karatsuba: bool


def pack_async(a_hi: torch.Tensor, a_lo: torch.Tensor, b_hi: torch.Tensor,
               b_lo: torch.Tensor, *,
               karatsuba: bool) -> tuple[PackedLimbs, torch.Tensor]:
    """Launch the pack step on contiguous (M, K), (K, N) int32 CUDA limbs:
    int8 copies with K padded to a multiple of 128, and a one-element device
    flag that turns nonzero if a limb does not fit (`flag_digits` reads
    it). Nothing waits for it."""
    m, k = a_hi.shape
    n = b_hi.shape[1]
    kp = -(-k // _K_ALIGN) * _K_ALIGN
    if -(-n // _TILE_N) > 65535 or kp // 32 > 65535 or m * kp >= 1 << 40:
        raise ValueError(f"shape {m}x{k}x{n} exceeds the int8 kernel's grid")
    dev = a_hi.device
    a8 = torch.empty((2, m, kp), dtype=torch.int8, device=dev)
    b8 = torch.empty((2, n, kp), dtype=torch.int8, device=dev)
    flag = torch.empty(1, dtype=torch.int32, device=dev)
    if is_fake(a_hi):
        return PackedLimbs(a8, b8, m, n, karatsuba), flag
    launch(KERNEL, "karatsuba_i8_pack", _PACK_ARGTYPES, dev,
           *(t.data_ptr() for t in (a_hi, a_lo, b_hi, b_lo, a8, b8, flag)),
           m, k, n, kp, int(karatsuba))
    return PackedLimbs(a8, b8, m, n, karatsuba), flag


def flag_digits(flag: int) -> int:
    """The digit count the pack step's flag names: 1 when the limbs fit
    int8 (flag 0), else the balanced int8 digits the widest operand of the
    wide route's products needs: 2, 3 (bit 1) or 4 (bit 2)."""
    return 1 if flag == 0 else 4 if flag & 4 else 3 if flag & 2 else 2


def pack_route(a_hi: torch.Tensor, a_lo: torch.Tensor, b_hi: torch.Tensor,
               b_lo: torch.Tensor, *, karatsuba: bool) -> tuple[PackedLimbs | None, int]:
    """`pack_async`, then its flag read with one host sync: (the packed
    limbs, 1) when they fit int8, else (None, the digit count of
    `flag_digits`)."""
    packed, flag = pack_async(a_hi, a_lo, b_hi, b_lo, karatsuba=karatsuba)
    if is_fake(flag):
        return packed, 1
    digits = flag_digits(int(flag.item()))
    return (packed if digits == 1 else None), digits


def pack(a_hi: torch.Tensor, a_lo: torch.Tensor, b_hi: torch.Tensor,
         b_lo: torch.Tensor, *, karatsuba: bool) -> PackedLimbs | None:
    """`pack_route`'s packed limbs; None if the limbs do not fit int8."""
    return pack_route(a_hi, a_lo, b_hi, b_lo, karatsuba=karatsuba)[0]


def product(packed: PackedLimbs) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(hh, mid, ll), each (M, N) int32, from limbs that `pack` accepted."""
    a8, b8, m, n, karatsuba = packed
    outs = [torch.empty((m, n), dtype=torch.int32, device=a8.device) for _ in range(3)]
    if is_fake(a8):
        from repro_torch.roofline.analysis import record_kernel
        k = a8.shape[2]
        record_kernel(KERNEL, ops=(3 if karatsuba else 4) * 2 * m * k * n, dtype="int8",
                      nbytes=4 * (2 * m * k + 2 * k * n + 3 * m * n))
        return tuple(outs)
    launch(KERNEL, KERNEL, _PRODUCT_ARGTYPES, a8.device, a8.data_ptr(), b8.data_ptr(),
           *(t.data_ptr() for t in outs), m, a8.shape[2], n, int(karatsuba))
    LAUNCHES[KERNEL] += 1
    return tuple(outs)


__all__ = ["KERNEL", "LAUNCHES", "PackedLimbs", "WIDE_KERNEL", "flag_digits",
           "limbs_fit_int8", "pack", "pack_async", "pack_route", "product",
           "reset_launches", "select_route"]
