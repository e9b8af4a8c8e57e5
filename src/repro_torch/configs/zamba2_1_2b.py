"""zamba2-1.2b [hybrid] -- 38L d_model=2048 32H (kv=32) d_ff=8192
vocab=32000, ssm_state=64; Mamba2 blocks + one weight-SHARED attention+MLP
block applied every 6th layer [arXiv:2411.15242; hf].

long_500k RUNS for this family (O(1) SSM decode state); the shared attention
block uses a 4k sliding-window KV at 512k context (documented deviation)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    attention="gqa",
    mlp="swiglu",
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv_width=4,
    ssm_chunk=256, shared_attn_period=6,
    sliding_window=4096,
)
