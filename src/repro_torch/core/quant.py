"""Quantization helpers bridging real-valued tensors and the integer
multiplier family.

Counterpart of `repro.core.quant`. Two regimes:
  * unsigned magnitude + sign (for the LNS / Mitchell family, defined on
    non-negative operands like the paper's datapath), and
  * balanced signed limbs (for the Karatsuba int8-limb decomposition):
    A = A_hi * 2^w + A_lo with A_lo in [-2^(w-1), 2^(w-1) - 1].
    schoolbook (4 passes): w = 8, range +-32639; karatsuba (3 passes): w = 7,
    both limbs in [-64, 63] so that A_hi + A_lo fits int8, range +-8127.

Scales are float32 and rounding is half to even (`torch.round`), as in the
reference. Every division by a scale divides by a float32 tensor on the
operand's device, never by a Python float: on CUDA, PyTorch turns division
by a host scalar into a multiply by its reciprocal, which can differ from
the quotient in the last bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.collectives import operand_max


class QuantizedMagnitude(NamedTuple):
    magnitude: torch.Tensor    # int32, in [0, 2^nbits)
    sign: torch.Tensor         # int32, in {-1, 0, +1}
    scale: torch.Tensor        # float32 scalar or per-axis tensor


def f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """`value` as a 0-dim float32 tensor on `like`'s device."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _absmax_scale(x: torch.Tensor, qlim: float, axis: int | None) -> torch.Tensor:
    """max(|x|, 1e-30) / qlim in float32, over all of x or along `axis`.
    An operand split over ranks takes the max over all of them, as the
    reference's does over its global operand (`collectives.operand_max`): an
    operand of batch rows (`collectives.batch_rows`) over the row axes,
    and a weight block or an activation split over "model"
    (`collectives.weight_block`, `batch_rows("row")`) over "model" too;
    anything else, x's own."""
    absx = x.abs().to(torch.float32)
    amax = operand_max(absx) if axis is None else absx.amax(dim=axis, keepdim=True)
    return torch.maximum(amax, f32(1e-30, x)) / f32(qlim, x)


def quantize_magnitude(x: torch.Tensor, nbits: int,
                       axis: int | None = None) -> QuantizedMagnitude:
    """Symmetric magnitude quantization to unsigned `nbits` integers."""
    qmax = float(2**nbits - 1)
    scale = _absmax_scale(x, qmax, axis)
    mag = torch.round(x.abs().to(torch.float32) / scale).clamp(0, qmax)
    return QuantizedMagnitude(mag.to(torch.int32), torch.sign(x).to(torch.int32),
                              scale)


def dequantize_product(acc: torch.Tensor, qa: QuantizedMagnitude,
                       qb: QuantizedMagnitude) -> torch.Tensor:
    return acc.to(torch.float32) * (qa.scale * qb.scale)


def fake_quant(x: torch.Tensor, nbits: int, axis: int | None = None) -> torch.Tensor:
    """Fake quantization: x + (dequantized - x), the straight-through form
    (detach the difference for an identity gradient)."""
    q = quantize_magnitude(x, nbits, axis)
    deq = (q.magnitude.to(torch.float32) * q.sign.to(torch.float32)) * q.scale
    return x + (deq - x).to(x.dtype)


class LimbDecomposition(NamedTuple):
    hi: torch.Tensor           # int8-representable limb, carried as int32
    lo: torch.Tensor
    limb_bits: int


def balanced_limbs(q: torch.Tensor, w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """q = hi * 2^w + lo with lo in [-2^(w-1), 2^(w-1) - 1], on int32
    (wrapping) integers. Used by `repro_torch.infer` on already-quantized
    activations."""
    half = 1 << (w - 1)
    lo = ((q + half) & ((1 << w) - 1)) - half
    hi = (q - lo) >> w
    return hi, lo


def quantize_limbs(x: torch.Tensor, *, karatsuba: bool,
                   axis: int | None = None) -> tuple[LimbDecomposition, torch.Tensor]:
    """Quantize a float tensor into balanced int8-valued limbs + scale.

    karatsuba=True  -> w=7 limbs confined to [-64, 63] (range +-8127).
    karatsuba=False -> w=8 limbs, hi in [-128, 127], lo in [-128, 127]
                       (range +-32639).
    """
    if karatsuba:
        w, qlim = 7, 63 * 128 + 63
    else:
        w, qlim = 8, 127 * 256 + 127
    scale = _absmax_scale(x, float(qlim), axis)
    q = torch.round(x.to(torch.float32) / scale).clamp(-qlim, qlim)
    hi, lo = balanced_limbs(q.to(torch.int32), w)
    return LimbDecomposition(hi, lo, w), scale


def limbs_to_int(d: LimbDecomposition) -> torch.Tensor:
    return (d.hi << d.limb_bits) + d.lo


__all__ = ["LimbDecomposition", "QuantizedMagnitude", "balanced_limbs",
           "dequantize_product", "f32", "fake_quant", "limbs_to_int",
           "quantize_limbs", "quantize_magnitude"]
