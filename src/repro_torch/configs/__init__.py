"""Config registry: get_config(name) / list_archs() / supported_shapes(cfg).

Counterpart of `repro.configs`, copied (the reference's `refmlm_filter`
application config is not an architecture and is not carried).

Arch ids match the assignment table; `--arch <id>` in the launchers resolves
through here. Shape-cell applicability (the long_500k / decode skips) is
centralized in supported_shapes so the dry-run, tests and EXPERIMENTS.md all
agree on the 31 runnable cells.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig

_MODULES = {
    "zamba2-1.2b": "zamba2_1_2b",
    "hubert-xlarge": "hubert_xlarge",
    "qwen2.5-3b": "qwen2_5_3b",
    "nemotron-4-340b": "nemotron_4_340b",
    "granite-3-2b": "granite_3_2b",
    "qwen2-0.5b": "qwen2_0_5b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "xlstm-1.3b": "xlstm_1_3b",
}


def list_archs() -> list[str]:
    return list(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def supported_shapes(cfg: ArchConfig) -> dict[str, str]:
    """shape name -> "ok" or the skip reason. 31 "ok" cells in total."""
    out: dict[str, str] = {}
    sub_quadratic = cfg.family in ("hybrid", "ssm")
    for name, shape in SHAPES.items():
        if shape.kind == "decode" and not cfg.causal:
            out[name] = "skip: encoder-only arch has no decode step"
        elif name == "long_500k" and not sub_quadratic:
            out[name] = "skip: pure full attention is O(S^2) at 512k (per spec)"
        else:
            out[name] = "ok"
    return out


__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "get_config", "list_archs",
           "supported_shapes"]
