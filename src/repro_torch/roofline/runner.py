"""Roofline table: per-cell terms of the port's own step.

Counterpart of `repro.roofline.runner`. XLA's cost analysis counts a
while/scan body once, so the reference lowers 2-3 unrolled tiny-layer
variants of each cell and extrapolates over layers (and over the global
batch). The port's layers are a Python loop: `StepCounter` sees every
layer's ops, so a cell's count is whole (`launch.dryrun.lower_cell` at the
true config) wherever it takes a few minutes of host time.

Two kinds of layer take longer on a CPU, and `layer_extrapolated` picks
their configs by structure: MoE layers (`cfg.moe`: deepseek-v3 and kimi-k2
stack 58, each a Python loop over its token chunks and expert groups,
forward, remat recompute and backward) and sLSTM layers
(`cfg.slstm_period`: xlstm-1.3b's six each loop over the sequence's
tokens; its train_4k count whole took 1893.5 s on one core). For them the
reference's affine layer extrapolation is kept (xlstm's counts hold one
and two sLSTM layers, not six): the terms are exactly affine in the
per-kind layer counts (a Python loop adds the same ops a layer;
tests/test_torch_dryrun.py holds f(8) = f(1) + 7 (f(2) - f(1)) for the
dense, MoE and xLSTM families' real counts), so 2-3 counts at tiny depth
give the true depth's:

  dense/audio   f(L) = base + L*m                      (2 counts)
  vlm/zamba2/   f = base + n_periods*m_period [+ tail  (2-3 counts)
  xlstm                  layers * m_layer]
  moe           f = base + n_dense*m_attn + n_moe*m_moe (3 counts)

No batch extrapolation: a count at the true batch costs no memory.

The step counted is the sharded one (`launch.dryrun`): each layer gathers
its FSDP blocks just before its forward and computes on its "model" shard
where it splits, so a layer's gathers, like its ops, are the same at
every depth and the terms stay affine in the layers.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

from repro_torch.configs import SHAPES, get_config
from repro_torch.roofline.analysis import HW, analyze_step, model_flops


def layer_extrapolated(cfg) -> bool:
    """Whether `cfg`'s cells are counted at 2-3 tiny depths and
    extrapolated over layers (MoE or sLSTM layers: module docstring),
    rather than counted whole."""
    return bool(cfg.moe or cfg.slstm_period)


def _terms(counts, hw: HW = HW()) -> dict[str, float]:
    r = analyze_step(counts, hw=hw)
    return {"flops": r.flops, "hbm_bytes": r.hbm_bytes, "coll_bytes": r.coll_bytes,
            "compute_s": r.compute_s}


def _lower_terms(arch: str, shape_name: str, overrides: dict,
                 multi_pod: bool = False,
                 shape_overrides: dict | None = None) -> dict[str, float]:
    from repro_torch.launch.dryrun import lower_cell
    counts, _, _ = lower_cell(arch, shape_name, multi_pod=multi_pod, overrides=overrides,
                              shape_overrides=shape_overrides)
    return _terms(counts)


def _affine(f1, f2, n1: float, n2: float, n_true: float):
    """f is affine in n: f(n) = f(n1) + (f(n2)-f(n1)) * (n-n1)/(n2-n1)."""
    return {k: f1[k] + (f2[k] - f1[k]) * (n_true - n1) / (n2 - n1) for k in f1}


def _layer_extrapolated(arch: str, shape_name: str, ov: dict, multi_pod: bool = False,
                        shape_ov: dict | None = None) -> dict[str, float]:
    """Extrapolate terms over LAYERS (2-3 counts at tiny depth)."""
    cfg = dataclasses.replace(get_config(arch), **ov)
    L = cfg.num_layers

    def lower(**layers):
        return _lower_terms(arch, shape_name, {**ov, **layers}, multi_pod, shape_ov)

    if cfg.moe:
        fd = cfg.first_dense_layers
        f1 = lower(num_layers=2, first_dense_layers=1)
        f3 = lower(num_layers=3, first_dense_layers=1)
        m_moe = {k: f3[k] - f1[k] for k in f1}
        if fd > 1:
            # one more dense layer, the same moe layer: the reference
            # subtracts m_moe here too, which undercounts by (fd - 1) m_moe
            f2 = lower(num_layers=3, first_dense_layers=2)
            m_attn = {k: f2[k] - f1[k] for k in f1}
        else:
            m_attn = {k: 0.0 for k in f1}
        return {k: f1[k] + (fd - 1) * m_attn[k] + (L - fd - 1) * m_moe[k]
                for k in f1}

    # periodic families: period p derived from the structural knobs
    if cfg.family == "vlm" and cfg.cross_attn_period:
        p = cfg.cross_attn_period
    elif cfg.family == "hybrid" and cfg.shared_attn_period:
        p = cfg.shared_attn_period
    elif cfg.family == "ssm" and cfg.slstm_period:
        p = cfg.slstm_period
    else:
        p = 1

    if p == 1:
        return _affine(lower(num_layers=1), lower(num_layers=2), 1, 2, L)

    n_periods, tail = divmod(L, p)
    f1 = lower(num_layers=p)
    out = _affine(f1, lower(num_layers=2 * p), 1, 2, n_periods)
    if tail:
        # tail layers are plain (non-special) blocks: marginal from +1 layer
        f3 = lower(num_layers=p + 1)
        out = {k: out[k] + tail * (f3[k] - f1[k]) for k in out}
    return out


def extrapolated_terms(arch: str, shape_name: str,
                       multi_pod: bool = False,
                       overrides: dict | None = None) -> dict[str, float]:
    """True-config per-device roofline raw terms for one cell: the whole
    cell counted, or where `layer_extrapolated`, extrapolated over layers
    (module docstring)."""
    ov = dict(overrides or {})
    if layer_extrapolated(dataclasses.replace(get_config(arch), **ov)):
        return _layer_extrapolated(arch, shape_name, ov, multi_pod)
    return _lower_terms(arch, shape_name, ov, multi_pod)


def roofline_cell(arch: str, shape_name: str, *, chips: int = 256,
                  hw: HW = HW(), overrides: dict | None = None) -> dict[str, Any]:
    """Full roofline record for one (arch x shape) cell on the 256-card
    (16, 16) mesh, or the 512-card (2, 16, 16) one for `chips` 512."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.model import build_model
    if chips not in (256, 512):
        raise ValueError(f"the production meshes hold 256 or 512 cards, not {chips}")
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    with FakeTensorMode():
        model = build_model(cfg, "cpu")
        n_params = model.count_params(model.init(torch.Generator("cpu")))
    mf = model_flops(cfg, n_params, shape)

    t = extrapolated_terms(arch, shape_name, multi_pod=chips == 512, overrides=overrides)
    compute_s = t["compute_s"]
    memory_s = t["hbm_bytes"] / hw.hbm_bw
    coll_s = t["coll_bytes"] / hw.ici_bw
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    bottleneck = max(terms, key=terms.get)
    step_s = max(terms.values())
    ideal_s = mf / (chips * hw.peak_flops)
    return {
        "arch": arch, "shape": shape_name, "chips": chips,
        "n_params": n_params, "model_flops": mf,
        "flops_per_dev": t["flops"], "hbm_bytes_per_dev": t["hbm_bytes"],
        "coll_bytes_per_dev": t["coll_bytes"],
        "compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s,
        "bottleneck": bottleneck,
        "useful_ratio": mf / (t["flops"] * chips) if t["flops"] else 0.0,
        "roofline_fraction": ideal_s / step_s if step_s else 0.0,
        "counted": "layers" if layer_extrapolated(cfg) else "whole",
    }


def main():
    import argparse

    from repro_torch.configs import list_archs, supported_shapes
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default="artifacts/torch_roofline")
    args = ap.parse_args()
    archs = list_archs() if args.arch == "all" else [args.arch]
    os.makedirs(args.out, exist_ok=True)
    for arch in archs:
        support = supported_shapes(get_config(arch))
        shapes = list(SHAPES) if args.shape == "all" else [args.shape]
        for shape_name in shapes:
            if support[shape_name] != "ok":
                continue
            try:
                rec = roofline_cell(arch, shape_name)
                rec["status"] = "ok"
            except Exception as e:                     # noqa: BLE001
                import traceback
                rec = {"arch": arch, "shape": shape_name, "status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-1500:]}
            with open(os.path.join(args.out, f"{arch}__{shape_name}.json"), "w") as f:
                json.dump(rec, f, indent=1)
            if rec["status"] == "ok":
                print(f"{arch:22s} {shape_name:12s} bottleneck={rec['bottleneck']:10s} "
                      f"compute={rec['compute_s']:.3f}s memory={rec['memory_s']:.3f}s "
                      f"coll={rec['collective_s']:.3f}s roofline={rec['roofline_fraction']:.2%} "
                      f"useful={rec['useful_ratio']:.2%}")
            else:
                print(f"{arch:22s} {shape_name:12s} ERROR {rec['error']}")


if __name__ == "__main__":
    main()
