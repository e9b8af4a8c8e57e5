"""qwen2.5-3b [dense] -- 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936; GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B family; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b", family="dense",
    num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
    d_ff=11008, vocab_size=151936, head_dim=128,
    attention="gqa", qkv_bias=True, rope_theta=1e6,
    mlp="swiglu",
)
