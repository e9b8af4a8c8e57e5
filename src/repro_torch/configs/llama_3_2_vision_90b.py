"""llama-3.2-vision-90b [vlm] -- 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256; gated cross-attention image layers every 5th layer (20 of 100)
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

Vision frontend stub: input_specs supplies precomputed patch embeddings
(B, image_tokens, d_model); cross-attn K/V come from them."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128256, head_dim=128,
    attention="gqa", rope_theta=500000.0,
    mlp="swiglu",
    cross_attn_period=5, image_tokens=1600, input_kind="tokens+image",
    optimizer="adafactor", fsdp_pod=True, microbatches=8,
)
