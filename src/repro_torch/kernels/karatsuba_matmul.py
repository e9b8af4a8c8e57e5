"""Limb-decomposed wide-integer matmul: two hand-written CUDA kernels for
Hopper (`csrc/karatsuba_matmul_i8.cu` on the int8 tensor cores,
`csrc/karatsuba_matmul.cu` on the CUDA cores) and their plain PyTorch version.

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
tensors. For CUDA tensors it launches one of two kernels and raises if a
launch fails: `karatsuba_matmul_i8` on the int8 tensor cores when the limbs
fit int8 (`repro_torch.kernels.karatsuba_matmul_i8`, which holds the rule and
its own launch count), else `karatsuba_matmul_wide`, the CUDA-core kernel
for any int32 limbs; each launch of the latter adds one to
`LAUNCHES['karatsuba_matmul']`. Fake tensors (`FakeTensorMode`, on any
device) take the int8 route's pack and product, which launch nothing and
record the product's work (`karatsuba_matmul_i8`). The reference's TPU
grid arguments (block_m, block_n, block_k, accum) have no counterpart:
each kernel's tile is a constant of its source, it reduces over K in a
loop, and it masks the ragged edges itself, so operands need no padding.
"""
from __future__ import annotations

import ctypes

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.core.bitops import wrap32
from repro_torch.kernels.build import launch

KERNEL = "karatsuba_matmul"
#: kernel name -> number of launches since the last `reset_launches()`.
LAUNCHES: dict[str, int] = {KERNEL: 0}
_TILE_N = 64                                  # kTileN of the kernel
_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 4


def reset_launches() -> None:
    LAUNCHES[KERNEL] = 0


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


def karatsuba_matmul_wide(a_hi: torch.Tensor, a_lo: torch.Tensor,
                          b_hi: torch.Tensor, b_lo: torch.Tensor, *,
                          karatsuba: bool = True):
    """The CUDA-core kernel for any int32 limbs (M, K), (K, N) on one
    device; -> (hh, mid, ll), each (M, N) int32 on that device."""
    _check_limbs(a_hi, a_lo, b_hi, b_lo)
    if a_hi.device.type == "cpu":
        return karatsuba_matmul_plain(a_hi, a_lo, b_hi, b_lo, karatsuba=karatsuba)
    limbs, outs = _cuda_limbs(a_hi, a_lo, b_hi, b_lo), _outputs(a_hi, b_hi)
    if outs[0].numel() == 0:
        return outs
    m, k = a_hi.shape
    launch(KERNEL, KERNEL, _ARGTYPES, a_hi.device, *(t.data_ptr() for t in limbs),
           *(t.data_ptr() for t in outs), m, k, b_hi.shape[1], int(karatsuba))
    LAUNCHES[KERNEL] += 1
    return outs


def _cuda_limbs(a_hi, a_lo, b_hi, b_lo) -> list[torch.Tensor]:
    """The limbs, contiguous; raises for a device other than CUDA (fake
    tensors on any device pass) or a shape past the kernels' grids."""
    if a_hi.device.type != "cuda" and not is_fake(a_hi):
        raise ValueError(f"the kernel runs on CUDA or CPU tensors, got {a_hi.device}")
    m, k = a_hi.shape
    n = b_hi.shape[1]
    if max(m, k, n) >= 1 << 31 or -(-n // _TILE_N) > 65535:
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
    int8 tensor-core kernel when the limbs fit int8, else the wide one."""
    from repro_torch.kernels import karatsuba_matmul_i8 as i8

    _check_limbs(a_hi, a_lo, b_hi, b_lo)
    if a_hi.device.type == "cpu" and not is_fake(a_hi):
        return karatsuba_matmul_plain(a_hi, a_lo, b_hi, b_lo, karatsuba=karatsuba)
    limbs = _cuda_limbs(a_hi, a_lo, b_hi, b_lo)
    if a_hi.shape[0] == 0 or b_hi.shape[1] == 0:
        return _outputs(a_hi, b_hi)
    packed = i8.pack(*limbs, karatsuba=karatsuba)
    if packed is not None:
        return i8.product(packed)
    return karatsuba_matmul_wide(*limbs, karatsuba=karatsuba)


__all__ = ["KERNEL", "LAUNCHES", "int_matmul", "karatsuba_matmul_kernel",
           "karatsuba_matmul_plain", "karatsuba_matmul_wide", "reset_launches"]
