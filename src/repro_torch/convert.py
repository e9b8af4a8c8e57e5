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
    run an LM from the same weights;
  * `from_reference_train_state` takes a reference `TrainState` (as numpy
    arrays) and returns the port's: the params as above, the optimizer
    state and error-feedback residual in the reference's stacked shapes
    keyed by its tree paths (`repro_torch.optim.optimizers.param_groups`).

Nothing here imports the reference package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.platform import resolve_device
from repro_torch.core.tree import tree_paths
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


def _to_tensors(tree, index: int | None, device: torch.device, reps: int = 0):
    """The float32 tensors of a dict tree of numpy arrays (entry `index` of
    each leaf's leading axis of `reps` layers when given)."""
    if isinstance(tree, dict):
        return {k: _to_tensors(v, index, device, reps) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    if index is None:
        return torch.from_numpy(np.array(a)).to(device)
    if a.ndim == 0 or a.shape[0] != reps:
        raise ValueError(f"a stacked leaf of shape {a.shape}: the config gives {reps} layers")
    return torch.from_numpy(np.array(a[index])).to(device)


def from_reference_lm_params(params_np: dict, cfg,
                             device: str | torch.device | None = None) -> dict:
    """The port's LM parameters on `device` for a reference LM's params.

    `params_np` is the reference's `Model.init` pytree with numpy leaves:
    the embedding dicts, and `backbone` = {"segments": one tuple per
    `segment_kinds` segment, holding a block dict per pattern position
    whose leaves stack that position's layers on axis 0 (the reference's
    `jax.vmap` init); "final_ln"; and, for zamba2, "shared_block"}. The
    port keeps one dict per layer, in layer order, whatever the rank of a
    leaf (the mLSTM's (H, Dh, Dh) maps, the sLSTM's recurrent weights, the
    conv taps, the MoE experts' (E, D, F) stacks, the VLM's 0-d `xgate`),
    and carries `shared_block` as it is (it is not stacked). Raises
    ValueError when a leaf is missing, extra or of another shape than the
    port's own init gives for `cfg`."""
    from repro_torch.models.transformer import segment_kinds
    dev = resolve_device(device)
    bb = params_np["backbone"]
    segments = segment_kinds(cfg.block_kinds())
    if len(bb["segments"]) != len(segments):
        raise ValueError(f"{len(bb['segments'])} segments, the config has "
                         f"{len(segments)}")
    layers = [_to_tensors(seg[pi], i, dev, reps)
              for (pattern, reps), seg in zip(segments, bb["segments"])
              for i in range(reps) for pi in range(len(pattern))]
    out = {k: _to_tensors(v, None, dev) for k, v in params_np.items() if k != "backbone"}
    out["backbone"] = {"layers": layers,
                       "final_ln": _to_tensors(bb["final_ln"], None, dev)}
    if "shared_block" in bb:
        out["backbone"]["shared_block"] = _to_tensors(bb["shared_block"], None, dev)
    _check_shapes(out, _shapes(_param_shapes(cfg)), "params")
    return out


def _stacked_tensor(flat: dict, key: str, shape: tuple, dev: torch.device) -> torch.Tensor:
    if key not in flat:
        raise ValueError(f"{key}: missing from the reference's state")
    a = np.asarray(flat.pop(key), np.float32)
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{key}: shape {a.shape}, the config gives {tuple(shape)}")
    return torch.from_numpy(np.array(a)).to(dev)


def from_reference_train_state(state_np, cfg, device: str | torch.device | None = None):
    """The port's `TrainState` on `device` for a reference `TrainState`
    with numpy leaves (`jax.tree.map(np.asarray, state)`): `step`; the
    params (`from_reference_lm_params`, leaves that require grad); the
    optimizer state {"count", "state": {path: {"m", "v"} or {"vr", "vc"}
    or {"v"}}} and the residual `ef` ({path: array} or None), whose leaves
    keep the reference's stacked shapes. Raises ValueError on a missing,
    extra or misshapen leaf."""
    from repro_torch.optim import get_optimizer, param_groups
    from repro_torch.runtime.train_lib import TrainState
    dev = resolve_device(device)
    params = from_reference_lm_params(state_np.params, cfg, dev)
    groups = param_groups(params, cfg)
    for group in groups:
        for t in group.params:
            t.requires_grad_(True)
    want = get_optimizer(cfg.optimizer).init(groups)
    flat = dict(tree_paths(state_np.opt["state"]))
    opt_state = {g.key: {kind: _stacked_tensor(flat, f"{g.key}/{kind}", t.shape, dev)
                         for kind, t in want["state"][g.key].items()} for g in groups}
    if flat:
        raise ValueError(f"optimizer leaves the config does not give: {sorted(flat)[:4]}")
    opt = {"count": torch.tensor(int(state_np.opt["count"]), dtype=torch.int32, device=dev),
           "state": opt_state}
    ef = None
    if state_np.ef is not None:
        flat = dict(tree_paths(state_np.ef))
        ef = {g.key: _stacked_tensor(flat, g.key, g.shape, dev) for g in groups}
        if flat:
            raise ValueError(f"residual leaves the config does not give: {sorted(flat)[:4]}")
    step = torch.tensor(int(state_np.step), dtype=torch.int32, device=dev)
    return TrainState(step, params, opt, ef)


def _param_shapes(cfg) -> dict:
    """The port's parameter tree for `cfg` with shapes and no storage
    (tensors of a `FakeTensorMode`): the full-size configs too."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.model import build_model
    with FakeTensorMode():
        return build_model(cfg, "cpu").init(torch.Generator("cpu"))


def _shapes(tree):
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape)
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return [_shapes(v) for v in tree]


def _check_shapes(tree, want, path: str) -> None:
    if isinstance(want, tuple):
        if not isinstance(tree, torch.Tensor) or tuple(tree.shape) != want:
            got = tuple(tree.shape) if isinstance(tree, torch.Tensor) else type(tree).__name__
            raise ValueError(f"{path}: shape {got}, the config gives {want}")
        return
    keys = range(len(want)) if isinstance(want, list) else want.keys()
    have = range(len(tree)) if isinstance(tree, list) else tree.keys()
    if set(have) != set(keys):
        raise ValueError(f"{path}: leaves {sorted(map(str, have))}, the config gives "
                         f"{sorted(map(str, keys))}")
    for k in keys:
        _check_shapes(tree[k], want[k], f"{path}/{k}")


__all__ = ["from_reference_lm_params", "from_reference_model", "from_reference_spec",
           "from_reference_train_state"]
