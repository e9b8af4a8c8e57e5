"""Quantized forward runner with per-layer multiplier routing.

Counterpart of `repro.infer.runner`. Every matmul/conv of the calibrated
network runs on integer operands and takes each scalar product from the
selected paper multiplier:

  int8               -- integer matmul with int32 accumulation: the exact-
                        quantized oracle every other method is judged against.
  refmlm/refmlm_kom3 -- the paper's recursive multiplier; error-free, so the
                        int32 accumulators (and the logits) equal the oracle's.
  schoolbook_int16 / karatsuba_int16 -- balanced-limb decomposition of the
                        quantized operands, exact reconstruction, also equal
                        to the oracle.
  mitchell / mitchell_ecc{k} / odma -- approximate LNS products; the error
                        report measures their drift.
  exact              -- the float32 forward (no quantization).

Routing: mitchell / mitchell_ecc{k} run on the `mitchell_matmul` kernel and
the two limb methods on the `karatsuba_matmul` kernel. Each kernel computes
exactly that method's int32 accumulators (for Mitchell-family operands below
2**16, which every nbits the scalar multipliers accept gives), so the bytes
are the reference's. On a CPU tensor the kernel wrappers run their plain
versions. int8, odma and refmlm run plain PyTorch on any device: int8 as an
integer matmul (`int_matmul`), odma and refmlm as element products summed
over K in row blocks sized by an element budget.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.approx_matmul import (
    KERNEL_LIMB_METHODS,
    KERNEL_LNS_METHODS,
    METHODS,
    lns_kernel_args,
    row_slices,
    scalar_multiplier,
)
from repro_torch.core.bitops import wrap32
from repro_torch.core.mitchell import _check_width
from repro_torch.core.quant import balanced_limbs, f32
from repro_torch.infer.calibrate import (
    CalibratedModel,
    _im2col,
    _maxpool,
    float_forward,
)
from repro_torch.infer.graph import Conv, Dense, Flatten
from repro_torch.kernels.karatsuba_matmul import int_matmul, karatsuba_matmul_kernel
from repro_torch.kernels.mitchell_matmul import mitchell_matmul_kernel

#: methods the routed integer forward accepts ('exact' bypasses quantization).
INFER_METHODS = METHODS


def _routed_int_matmul(qa: torch.Tensor, qw: torch.Tensor, method: str,
                       nbits: int) -> torch.Tensor:
    """(M,K) x (K,N) on signed int32 operands -> int32 accumulators, with
    every scalar product produced by `method`'s multiplier."""
    if method == "int8":
        return int_matmul(qa, qw)
    if method in KERNEL_LIMB_METHODS:
        w = 7 if method == "karatsuba_int16" else 8
        ahi, alo = balanced_limbs(qa, w)
        bhi, blo = balanced_limbs(qw, w)
        hh, mid, ll = karatsuba_matmul_kernel(
            ahi, alo, bhi, blo, karatsuba=method == "karatsuba_int16")
        acc = (hh.to(torch.int64) << (2 * w)) + (mid.to(torch.int64) << w) + ll
        return wrap32(acc).to(torch.int32)
    if method in KERNEL_LNS_METHODS:
        _check_width(nbits)
        num_ecc, case_split = lns_kernel_args(method)
        return mitchell_matmul_kernel(qa, qw, num_ecc=num_ecc, case_split=case_split)

    mult = scalar_multiplier(method, nbits)
    mag_w, sgn_w = qw.abs()[None], torch.sign(qw)[None]
    out = torch.empty((qa.shape[0], qw.shape[1]), dtype=torch.int32, device=qa.device)
    for rows in row_slices(*qa.shape, qw.shape[1]):
        blk = qa[rows]
        mag = mult(blk.abs()[:, :, None], mag_w).to(torch.int64)
        sgn = torch.sign(blk)[:, :, None] * sgn_w
        out[rows] = wrap32((mag * sgn).sum(dim=1)).to(torch.int32)
    return out


def forward(cal: CalibratedModel, x, method: str = "int8", *,
            per_layer: dict[int, str] | None = None, collect: bool = False):
    """Run the calibrated network on its device. x: (B, H, W) float32 in
    [0, 1] (numpy or tensor).

    `method` is the default multiplier for every multiplying layer;
    `per_layer` pins a (quantized) method per layer index on top of it.
    Returns logits (B, num_classes) float32; with collect=True returns
    (logits, [per-multiplying-layer int32 accumulators]). The reference's
    `row_chunk` has no counterpart (chunking does not change the result).
    """
    if method == "exact":
        if per_layer:
            raise ValueError("per_layer pinning needs a quantized method; "
                             "use 'int8' for exact-quantized layers")
        logits = float_forward(cal.graph, cal.params, x, device=cal.device)
        return (logits, []) if collect else logits
    if method not in INFER_METHODS:
        raise ValueError(f"unknown method {method!r}; valid: {INFER_METHODS}")
    per_layer = per_layer or {}
    qmax = cal.qmax
    accs = []
    a = torch.as_tensor(np.asarray(x, np.float32)).to(cal.device)[..., None]
    for i, (layer, q) in enumerate(zip(cal.graph.layers, cal.lq)):
        if isinstance(layer, Flatten):
            a = a.reshape(a.shape[0], -1)
            continue
        m = per_layer.get(i, method)
        if m not in INFER_METHODS or m == "exact":
            raise ValueError(f"layer {i}: invalid pinned method {m!r}")
        qa = torch.round(a / f32(q.a_scale, a)).clamp(-qmax, qmax).to(torch.int32)
        if isinstance(layer, Dense):
            acc = _routed_int_matmul(qa, q.qweight, m, cal.nbits)
        else:
            patches = _im2col(qa, layer.ksize)
            b_, h_, w_, k_ = patches.shape
            acc = _routed_int_matmul(patches.reshape(-1, k_), q.qweight, m,
                                     cal.nbits).reshape(b_, h_, w_, -1)
        acc = acc + q.qbias
        if collect:
            accs.append(acc)
        a = acc.to(torch.float32) * (q.a_scale * q.w_scale)
        if layer.relu:
            a = torch.clamp_min(a, 0.0)
        if isinstance(layer, Conv) and layer.pool > 1:
            a = _maxpool(a, layer.pool)
    return (a, accs) if collect else a


__all__ = ["INFER_METHODS", "forward"]
