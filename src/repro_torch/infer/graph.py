"""Layer-graph definition for the quantized inference datapath.

A copy of `repro.infer.graph` (numpy only): the same layer specs, model zoo
and He-scaled weights from the same `default_rng` seed, so both packages
compute from the same float32 bytes.

A `LayerGraph` is a flat tuple of layer specs, enough to express the two
evaluation networks (an MLP head and a small CNN classifier over
`data/images.py` inputs). Parameters live outside the graph (a plain numpy
dict per layer), so graph + params + calibration scales fully determine the
quantized forward pass.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Dense:
    d_in: int
    d_out: int
    relu: bool = True


@dataclass(frozen=True)
class Conv:
    """3x3 'same' conv (im2col) with optional 2x2 max-pool after activation."""
    c_in: int
    c_out: int
    ksize: int = 3
    relu: bool = True
    pool: int = 1          # max-pool window/stride after activation (1 = none)


@dataclass(frozen=True)
class Flatten:
    pass


@dataclass(frozen=True)
class LayerGraph:
    name: str
    input_hw: tuple[int, int]
    layers: tuple
    num_classes: int


def mlp_head(hw: tuple[int, int] = (8, 8), num_classes: int = 4,
             hidden: int = 32) -> LayerGraph:
    h, w = hw
    return LayerGraph("mlp", (h, w), (
        Flatten(),
        Dense(h * w, hidden, relu=True),
        Dense(hidden, num_classes, relu=False),
    ), num_classes)


def cnn_classifier(hw: tuple[int, int] = (8, 8), num_classes: int = 4) -> LayerGraph:
    h, w = hw
    if h % 4 or w % 4:
        raise ValueError(f"cnn_classifier pools twice; hw must be /4, got {hw}")
    return LayerGraph("cnn", (h, w), (
        Conv(1, 4, 3, relu=True, pool=2),
        Conv(4, 8, 3, relu=True, pool=2),
        Flatten(),
        Dense((h // 4) * (w // 4) * 8, num_classes, relu=False),
    ), num_classes)


#: model-zoo entry points.
MODELS = {"mlp": mlp_head, "cnn": cnn_classifier}


def init_params(graph: LayerGraph, seed: int = 0) -> list[dict | None]:
    """He-scaled random weights. The evaluation compares multiplier
    datapaths on a *fixed* network (the paper's Table-10 framing: same
    workload, different multiplier), so training is out of scope."""
    rng = np.random.default_rng(seed)
    params: list[dict | None] = []
    for layer in graph.layers:
        if isinstance(layer, Dense):
            w = rng.standard_normal((layer.d_in, layer.d_out))
            w *= (2.0 / layer.d_in) ** 0.5
            b = rng.standard_normal((layer.d_out,)) * 0.1
        elif isinstance(layer, Conv):
            fan_in = layer.c_in * layer.ksize**2
            w = rng.standard_normal(
                (layer.ksize, layer.ksize, layer.c_in, layer.c_out))
            w *= (2.0 / fan_in) ** 0.5
            b = rng.standard_normal((layer.c_out,)) * 0.1
        else:
            params.append(None)
            continue
        params.append({"w": w.astype(np.float32), "b": b.astype(np.float32)})
    return params


__all__ = ["MODELS", "Conv", "Dense", "Flatten", "LayerGraph", "cnn_classifier",
           "init_params", "mlp_head"]
