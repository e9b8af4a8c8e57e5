"""Static-scale calibration for the quantized inference path.

Counterpart of `repro.infer.calibrate`. Post-training symmetric
quantization, one scale pair per multiplying layer:

  * weights:     s_w = max|W| / qmax, qW = round(W / s_w)         (offline)
  * activations: s_a = max|a| over a calibration batch / qmax     (offline)
  * bias:        qb  = round(b / (s_a * s_w))  -- accumulator LSBs

Scales are static: frozen by `calibrate()` or imported with `with_scales()`
from the reference's `export_scales()`, never recomputed from live data.
Weights and biases are quantized on the host in numpy float32, as the
reference does, so both packages hold the same integers for the same
scales. The calibration pass itself is a float32 forward on `device`; its
matmuls may sum in another order than XLA's, so its scales agree with the
reference's to float32 rounding, not bit for bit.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.platform import resolve_device
from repro_torch.infer.graph import Conv, Dense, Flatten, LayerGraph


class LayerQuant(NamedTuple):
    """Frozen quantization of one multiplying layer."""
    qweight: torch.Tensor      # int32 (K, c_out): Dense (d_in, d_out) or im2col conv
    qbias: torch.Tensor        # int32, accumulator-domain bias
    w_scale: float
    a_scale: float


class CalibratedModel(NamedTuple):
    graph: LayerGraph
    params: list               # float params (numpy), kept for the float path
    lq: tuple                  # per-layer LayerQuant | None (non-multiplying)
    nbits: int

    @property
    def qmax(self) -> int:
        return (1 << self.nbits) - 1

    @property
    def device(self) -> torch.device:
        """The device the quantized weights live on."""
        return next(q.qweight.device for q in self.lq if q is not None)


def _im2col(a: torch.Tensor, ksize: int) -> torch.Tensor:
    """(B,H,W,C) -> (B,H,W,ksize*ksize*C), zero 'same' halo, index order
    (ki, kj, c) to match `w.reshape(k*k*c_in, c_out)`. Zero pads commute
    with symmetric quantization (round(0/s) == 0)."""
    pad = ksize // 2
    _, h, w, _ = a.shape
    ap = F.pad(a, (0, 0, pad, pad, pad, pad))
    cols = [ap[:, i:i + h, j:j + w, :] for i in range(ksize) for j in range(ksize)]
    return torch.cat(cols, dim=-1)


def _maxpool(a: torch.Tensor, stride: int) -> torch.Tensor:
    b, h, w, c = a.shape
    return a.reshape(b, h // stride, stride, w // stride, stride, c).amax(dim=(2, 4))


def _weight_matrix(layer, p) -> tuple[np.ndarray, np.ndarray]:
    w, b = p["w"], p["b"]
    if isinstance(layer, Conv):
        w = w.reshape(layer.ksize * layer.ksize * layer.c_in, layer.c_out)
    return w, b


def _float_layer(layer, p, a: torch.Tensor) -> torch.Tensor:
    """One multiplying layer's float32 affine map and ReLU (no pooling)."""
    w, b = (torch.from_numpy(np.asarray(v, np.float32)).to(a.device)
            for v in _weight_matrix(layer, p))
    a = (a if isinstance(layer, Dense) else _im2col(a, layer.ksize)) @ w + b
    return torch.clamp_min(a, 0.0) if layer.relu else a


def float_forward(graph: LayerGraph, params: list, x,
                  device: str | torch.device | None = None) -> torch.Tensor:
    """Float32 forward (the 'exact' method and the calibration pass):
    x (B, H, W) in [0, 1] -> logits (B, num_classes) on `device`."""
    a = torch.as_tensor(np.asarray(x, np.float32)).to(resolve_device(device))[..., None]
    for layer, p in zip(graph.layers, params):
        if isinstance(layer, Flatten):
            a = a.reshape(a.shape[0], -1)
        elif isinstance(layer, (Dense, Conv)):
            a = _float_layer(layer, p, a)
            if isinstance(layer, Conv) and layer.pool > 1:
                a = _maxpool(a, layer.pool)
        else:
            raise TypeError(f"unknown layer {layer!r}")
    return a


def calibrate(graph: LayerGraph, params: list, x_cal, nbits: int = 8,
              device: str | torch.device | None = None) -> CalibratedModel:
    """One float pass over a calibration batch on `device`, recording each
    multiplying layer's input abs-max; freezes weight and activation scales
    (module docstring). Raises on non-finite statistics."""
    dev = resolve_device(device)
    qmax = (1 << nbits) - 1
    a = torch.as_tensor(np.asarray(x_cal, np.float32)).to(dev)[..., None]
    scales: list[float | None] = []
    for layer, p in zip(graph.layers, params):
        if isinstance(layer, Flatten):
            a = a.reshape(a.shape[0], -1)
            scales.append(None)
            continue
        amax = float(a.abs().max())
        if not math.isfinite(amax):
            raise ValueError(
                f"calibration overflow at layer {layer!r}: non-finite "
                f"activation abs-max {amax!r}")
        scales.append(max(amax, 1e-30) / qmax)
        a = _float_layer(layer, p, a)
        if isinstance(layer, Conv) and layer.pool > 1:
            a = _maxpool(a, layer.pool)
    return _freeze(graph, params, scales, nbits, dev)


def _freeze(graph: LayerGraph, params: list, a_scales: list, nbits: int,
            device: torch.device) -> CalibratedModel:
    """Quantize weights and biases in numpy float32 with the reference's
    arithmetic (a float32 quotient by the float32-rounded scale, rounded
    half to even)."""
    qmax = (1 << nbits) - 1
    lq: list[LayerQuant | None] = []
    for layer, p, s_a in zip(graph.layers, params, a_scales):
        if not isinstance(layer, (Dense, Conv)):
            lq.append(None)
            continue
        w, b = (np.asarray(v, np.float32) for v in _weight_matrix(layer, p))
        wmax = float(np.max(np.abs(w)))
        if not math.isfinite(wmax):
            raise ValueError(f"non-finite weights at layer {layer!r}")
        s_w = max(wmax, 1e-30) / qmax
        qw = np.clip(np.round(w / np.float32(s_w)), -qmax, qmax).astype(np.int32)
        qb = np.round(b / np.float32(s_a * s_w)).astype(np.int32)
        lq.append(LayerQuant(torch.from_numpy(qw).to(device),
                             torch.from_numpy(qb).to(device), s_w, float(s_a)))
    return CalibratedModel(graph, params, tuple(lq), nbits)


def export_scales(cal: CalibratedModel) -> dict:
    """JSON-able static-scale bundle (deploy-time artifact), in the
    reference's format."""
    return {
        "nbits": cal.nbits,
        "layers": [None if q is None
                   else {"a_scale": q.a_scale, "w_scale": q.w_scale}
                   for q in cal.lq],
    }


def with_scales(graph: LayerGraph, params: list, scales: dict,
                device: str | torch.device | None = None) -> CalibratedModel:
    """Rebuild a CalibratedModel on `device` from an `export_scales()`
    bundle of either package (no calibration data needed)."""
    if len(scales["layers"]) != len(graph.layers):
        raise ValueError("scale bundle does not match graph arity")
    a_scales = [None if s is None else float(s["a_scale"])
                for s in scales["layers"]]
    return _freeze(graph, params, a_scales, int(scales["nbits"]),
                   resolve_device(device))


__all__ = ["CalibratedModel", "LayerQuant", "calibrate", "export_scales",
           "float_forward", "with_scales"]
