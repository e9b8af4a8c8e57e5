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
the launch fails; it runs `mitchell_matmul_plain` only for CPU tensors. Each
launch adds one to `LAUNCHES['mitchell_matmul']`. The reference's TPU grid
arguments (block_m, block_n, block_k, accum) have no counterpart: the
kernel's tile is a constant of its source, it reduces over K in a loop, and
it masks the ragged edges itself, so operands need no padding.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.approx_matmul import row_slices
from repro_torch.core.bitops import leading_one_position, shift_left_int32, wrap32
from repro_torch.kernels.build import launch

KERNEL = "mitchell_matmul"
#: kernel name -> number of launches since the last `reset_launches()`.
LAUNCHES: dict[str, int] = {KERNEL: 0}
_TILE_N = 64                                  # kTileN of the kernel
_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 5


def reset_launches() -> None:
    LAUNCHES[KERNEL] = 0


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
    if a.device.type == "cpu":
        return mitchell_matmul_plain(a, b, num_ecc=num_ecc, case_split=case_split)
    if a.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA or CPU tensors, got {a.device}")
    if num_ecc < 0:
        raise ValueError(f"num_ecc must be >= 0, got {num_ecc}")
    m, k = a.shape
    n = b.shape[1]
    if max(m, k, n) >= 1 << 31 or -(-n // _TILE_N) > 65535:
        raise ValueError(f"shape {m}x{k}x{n} exceeds the kernel's grid")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if out.numel() == 0:
        return out
    launch(KERNEL, KERNEL, _ARGTYPES, a.device, a.data_ptr(), b.data_ptr(),
           out.data_ptr(), m, k, n, num_ecc, int(case_split))
    LAUNCHES[KERNEL] += 1
    return out


__all__ = ["KERNEL", "LAUNCHES", "mitchell_matmul_kernel", "mitchell_matmul_plain",
           "reset_launches"]
