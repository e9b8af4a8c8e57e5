"""`repro_torch.models` -- the LM backbones the serving path runs.

Counterpart of `repro.models` for the dense and audio families (`attn`
blocks with GQA attention), the hybrid family (zamba2: Mamba2 blocks) and
the xLSTM family (mLSTM / sLSTM blocks): `layers` (dense, norms, RoPE,
attention, MLPs), `ssm` (the Mamba2 mixer), `xlstm` (the mLSTM and sLSTM
blocks), `transformer` (the block stack) and `model` (`build_model`). The
MoE and VLM families raise `NotImplementedError` at `build_model` (ROADMAP
Queue 1 item 1).
"""
from __future__ import annotations

from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
