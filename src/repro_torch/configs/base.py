"""Architecture + run configuration dataclasses.

Counterpart of `repro.configs.base`, copied: these are data. One
`ArchConfig` per architecture lives in `repro_torch/configs/<id>.py`;
`repro_torch.configs.get_config(name)` is the registry entry point.
`reduced()` returns the family-preserving small config used by CPU smoke
tests. Fields that steer the reference's XLA compilation and sharding
(remat, scan_unroll, fsdp, ...) are kept for parity and read by nothing
in the port yet.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

AttnKind = Literal["gqa", "mla", "none"]
MlpKind = Literal["swiglu", "squared_relu", "gelu", "none"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- attention ---
    attention: AttnKind = "gqa"
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    causal: bool = True              # False => encoder-only (no decode path)
    attn_logit_softcap: float = 0.0
    # cross attention (vlm): insert one cross-attn layer every N self-attn layers
    cross_attn_period: int = 0
    image_tokens: int = 0            # stub patch-embedding count for vlm

    # --- MLA (deepseek/kimi family) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    # --- MLP ---
    mlp: MlpKind = "swiglu"
    mlp_bias: bool = False

    # --- MoE ---
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0      # leading dense layers (deepseek=3)
    capacity_factor: float = 1.25
    moe_seq_chunk: int = 512

    # --- SSM / hybrid (zamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    shared_attn_period: int = 0      # zamba2: shared attn block every N ssm layers

    # --- xlstm ---
    slstm_period: int = 0            # xlstm: 1 sLSTM per N blocks (rest mLSTM)
    mlstm_proj_factor: float = 2.0

    # --- frontend stubs ---
    input_kind: str = "tokens"       # tokens | frames | tokens+image
    frame_dim: int = 0               # audio: precomputed frame-embedding dim

    # --- numerics / systems ---
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    tie_embeddings: bool = False
    sliding_window: int = 0          # 0 = full attention; >0 applies at decode
    matmul_method: str = "exact"     # repro.core.approx_matmul method
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"       # full | dots (save matmul outputs,
                                     # recompute elementwise only)
    optimizer: str = "adamw"         # adamw | adafactor (large models)
    fsdp: bool = True                # shard params/opt-state over 'data' too
    fsdp_pod: bool = False           # extend FSDP over the 'pod' axis (monsters)
    microbatches: int = 1            # grad-accumulation microbatches per step
    grad_compress: bool = False      # int8 + error-feedback DP all-reduce
    attn_chunk_q: int = 1024         # q-chunk for long prefill attention
    scan_unroll: bool = False        # python-unroll layer scan (roofline:
                                     # XLA cost_analysis counts scan bodies
                                     # once; unrolled small-L lowers give the
                                     # exact per-layer marginal)
    # --- §Perf hillclimb levers (defaults = paper-faithful baseline) ---
    prefer_dp: bool = False          # small-TP archs: fold 'model' axis into
                                     # DP/FSDP instead of TP (xlstm fix)
    attn_scores_dtype: str = "float32"   # bfloat16 halves score traffic
    fused_lse_loss: bool = False     # single-LSE CE+z-loss (no log_softmax
                                     # materialization)
    emb_vocab_sharded: bool = True   # shard embedding table on vocab (the
                                     # naive default). False = replicate
                                     # vocab, FSDP the d_model dim -- avoids
                                     # GSPMD's involuntary full remat of the
                                     # (B,S,D) gather (14 GB/dev for d=7168;
                                     # OOMs the SPMD *compiler* on the MoE
                                     # monsters)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def inactive_expert_params(self) -> int:
        """Parameters NOT active per token (MoE routed experts beyond top-k).

        The true total comes from the real parameter tree (models.model
        .count_params); MODEL_FLOPS uses total - inactive (6*N_active*D).
        """
        if not self.moe:
            return 0
        per_expert = 3 * self.d_model * self.moe_d_ff   # swiglu expert
        moe_layers = sum(1 for k in self.block_kinds() if k == "moe")
        return (self.num_experts - self.top_k) * per_expert * moe_layers

    def block_kinds(self) -> list[str]:
        """Per-layer block kind sequence (drives assembly + param counting)."""
        kinds: list[str] = []
        for i in range(self.num_layers):
            if self.family == "moe":
                kinds.append("attn" if i < self.first_dense_layers else "moe")
            elif self.family == "hybrid":
                kinds.append("mamba2")
            elif self.family == "ssm":
                if self.slstm_period and (i + 1) % self.slstm_period == 0:
                    kinds.append("slstm")
                else:
                    kinds.append("mlstm")
            elif self.family == "vlm":
                if self.cross_attn_period and (i + 1) % self.cross_attn_period == 0:
                    kinds.append("attn_cross")
                else:
                    kinds.append("attn")
            else:
                kinds.append("attn")
        return kinds

    def reduced(self) -> "ArchConfig":
        """Family-preserving tiny config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            num_layers=max(2, min(4, self.num_layers)),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(4, max(1, self.num_kv_heads)),
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            q_lora_rank=32 if self.q_lora_rank else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            qk_rope_dim=16 if self.attention == "mla" else self.qk_rope_dim,
            qk_nope_dim=16 if self.attention == "mla" else self.qk_nope_dim,
            v_head_dim=32 if self.attention == "mla" else self.v_head_dim,
            num_experts=8 if self.moe else 0,
            top_k=2 if self.moe else 0,
            moe_d_ff=64 if self.moe else 0,
            first_dense_layers=min(1, self.first_dense_layers),
            moe_seq_chunk=16,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=16,
            shared_attn_period=3 if self.shared_attn_period else 0,
            slstm_period=2 if self.slstm_period else 0,
            cross_attn_period=2 if self.cross_attn_period else 0,
            image_tokens=8 if self.image_tokens else 0,
            frame_dim=64 if self.frame_dim else 0,
            capacity_factor=2.0 if self.moe else self.capacity_factor,
            dtype="float32",
            remat=False,
            microbatches=1,
            grad_compress=False,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
