"""`repro_torch.models` -- the LM backbones the serving path runs.

Counterpart of `repro.models` for every family of the configs: dense and
audio (`attn` blocks), MoE (`moe` blocks, MLA or GQA attention), hybrid
(zamba2: Mamba2 blocks), xLSTM (mLSTM / sLSTM blocks) and the VLM
(`attn_cross` blocks): `layers` (dense, norms, RoPE, GQA / MLA / cross
attention, MLPs), `moe` (the routed and shared experts), `ssm` (the Mamba2
mixer), `xlstm` (the mLSTM and sLSTM blocks), `transformer` (the block
stack) and `model` (`build_model`).
"""
from __future__ import annotations

from repro_torch.models.model import Model, build_model, input_specs

__all__ = ["Model", "build_model", "input_specs"]
