"""`repro_torch.models` -- the LM backbones the serving path runs.

Counterpart of `repro.models` for the dense and audio families (`attn`
blocks with GQA attention): `layers` (dense, norms, RoPE, attention,
MLPs), `transformer` (the block stack) and `model` (`build_model`). The
MoE, VLM, hybrid and xLSTM families raise `NotImplementedError` at
`build_model` (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
