"""kimi-k2-1t-a32b [moe] -- 61L d_model=7168 64H (GQA kv=8) d_ff=2048(expert)
vocab=163840; MoE 1 shared + 384 routed top-8 -- trillion-param MoE
[arXiv:2501.kimi2; unverified, paper-table].

Assignment specifies GQA kv=8 (vs deepseek's MLA), so this config exercises
the GQA + giant-EP path. Memory note: 1T params exceeds a single 256-chip
v5e pod for training (see EXPERIMENTS.md dry-run table); adafactor +
fsdp_pod keeps the multi-pod cell within budget."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=18432, vocab_size=163840, head_dim=128,
    attention="gqa", rope_theta=50000.0,
    mlp="swiglu",
    moe=True, num_experts=384, top_k=8, num_shared_experts=1,
    moe_d_ff=2048, first_dense_layers=1,
    optimizer="adafactor", fsdp_pod=True, microbatches=16,
    # vocab-sharded embedding OOMs the SPMD *compiler* on this host
    # (involuntary full remat of the gather); see base.py + DESIGN.md.
    emb_vocab_sharded=False,
    # dispatch-einsum overhead is linear in the chunk: ~10-12% of expert
    # flops at 512 (the GShard default); see EXPERIMENTS.md roofline note.
    moe_seq_chunk=512,
)
