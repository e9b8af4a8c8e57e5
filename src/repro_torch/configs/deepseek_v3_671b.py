"""deepseek-v3-671b [moe] -- 61L d_model=7168 128H d_ff=2048(expert)
vocab=129280; MLA attention, MoE 1 shared + 256 routed top-8, first 3 layers
dense (d_ff=18432) [arXiv:2412.19437; hf].

MTP head is noted in DESIGN.md as out of scope (orthogonal to the paper's
technique). Memory note: 671B => adafactor + fsdp over pod."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    d_ff=18432, vocab_size=129280, head_dim=128,
    attention="mla",
    q_lora_rank=1536, kv_lora_rank=512,
    qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
    mlp="swiglu",
    moe=True, num_experts=256, top_k=8, num_shared_experts=1,
    moe_d_ff=2048, first_dense_layers=3,
    optimizer="adafactor", fsdp_pod=True, microbatches=16,
    # vocab-sharded embedding OOMs the SPMD *compiler* on this host
    # (involuntary full remat of the gather); see base.py + DESIGN.md.
    emb_vocab_sharded=False,
    # dispatch-einsum overhead is linear in the chunk: ~10-12% of expert
    # flops at 512 (the GShard default); see EXPERIMENTS.md roofline note.
    moe_seq_chunk=512,
)
