"""Carry the reference's parameters across to the port, as plain values.

  * `from_reference_spec` takes the fields of a JAX-package `FilterSpec`
    (numpy arrays and plain values) and returns the port's `FilterSpec`, so
    any reference spec -- a `get_filter(name, sigma=...)` re-sampling
    included -- runs through both packages;
  * `from_reference_model` takes a reference `LayerGraph`'s fields, its
    numpy params and its `export_scales()` bundle and returns the port's
    `CalibratedModel`, so both packages compute from the same integers;
  * `from_reference_lm_params` takes a reference LM's parameter pytree (as
    numpy arrays, each segment's layers stacked on a leading axis) and
    returns the port's parameters, one dict per layer, so both packages
    run an LM from the same weights.

Nothing here imports the reference package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.platform import resolve_device
from repro_torch.filters.bank import FilterSpec
from repro_torch.infer.calibrate import CalibratedModel, with_scales
from repro_torch.infer.graph import Conv, Dense, Flatten, LayerGraph

_LAYERS = {"Dense": Dense, "Conv": Conv, "Flatten": Flatten}


def _vector(v) -> np.ndarray | None:
    return None if v is None else np.asarray(v, np.int32).reshape(-1)


def from_reference_spec(name, taps, shift, post, sep_row, sep_col) -> FilterSpec:
    """The port's `FilterSpec` with the reference spec's values."""
    taps = np.asarray(taps, np.int32)
    if taps.ndim != 2:
        raise ValueError(f"taps must be a (kh, kw) table, got shape {taps.shape}")
    if (sep_row is None) != (sep_col is None):
        raise ValueError("sep_row and sep_col must both be given or both None")
    return FilterSpec(str(name), taps, int(shift), str(post),
                      _vector(sep_row), _vector(sep_col))


def from_reference_model(name: str, input_hw, layers, num_classes: int,
                         params: list, scales: dict,
                         device: str | torch.device | None = None) -> CalibratedModel:
    """The port's `CalibratedModel` on `device` for a reference model.

    `layers` lists each layer of the reference graph as (class name, field
    dict), e.g. `(type(l).__name__, dataclasses.asdict(l))`; `params` are
    the reference's numpy params and `scales` its `export_scales()` dict."""
    specs = []
    for kind, fields in layers:
        if kind not in _LAYERS:
            raise ValueError(f"unknown layer kind {kind!r}; have {sorted(_LAYERS)}")
        specs.append(_LAYERS[kind](**dict(fields)))
    graph = LayerGraph(str(name), tuple(int(v) for v in input_hw), tuple(specs),
                       int(num_classes))
    params = [None if p is None else {k: np.asarray(v, np.float32)
                                      for k, v in p.items()} for p in params]
    return with_scales(graph, params, scales, device=device)


def _to_tensors(tree, index: int | None, device: torch.device):
    """The float32 tensors of a dict tree of numpy arrays (entry `index` of
    each leaf's leading axis when given)."""
    if isinstance(tree, dict):
        return {k: _to_tensors(v, index, device) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    return torch.from_numpy(np.array(a if index is None else a[index])).to(device)


def from_reference_lm_params(params_np: dict, cfg,
                             device: str | torch.device | None = None) -> dict:
    """The port's LM parameters on `device` for a reference LM's params.

    `params_np` is the reference's `Model.init` pytree with numpy leaves:
    the embedding dicts, and `backbone` = {"segments": one tuple per
    `segment_kinds` segment, holding a block dict per pattern position
    whose leaves stack that position's layers on axis 0 (the reference's
    `jax.vmap` init); "final_ln"}. The port keeps one dict per layer, in
    layer order."""
    from repro_torch.models.transformer import check_supported, segment_kinds
    check_supported(cfg)
    dev = resolve_device(device)
    bb = params_np["backbone"]
    segments = segment_kinds(cfg.block_kinds())
    if len(bb["segments"]) != len(segments):
        raise ValueError(f"{len(bb['segments'])} segments, the config has "
                         f"{len(segments)}")
    layers = [_to_tensors(seg[pi], i, dev)
              for (pattern, reps), seg in zip(segments, bb["segments"])
              for i in range(reps) for pi in range(len(pattern))]
    out = {k: _to_tensors(v, None, dev) for k, v in params_np.items() if k != "backbone"}
    out["backbone"] = {"layers": layers,
                       "final_ln": _to_tensors(bb["final_ln"], None, dev)}
    return out


__all__ = ["from_reference_lm_params", "from_reference_model", "from_reference_spec"]
