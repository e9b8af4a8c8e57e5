"""nemotron-4-340b [dense] -- 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000; squared-ReLU MLP [arXiv:2402.16819; unverified].

Memory note: 340B params => adafactor (factored 2nd moment) + bf16 master;
FSDP extends over the pod axis on the multi-pod mesh (fsdp_pod)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
    d_ff=73728, vocab_size=256000, head_dim=192,
    attention="gqa", rope_theta=10000.0,
    mlp="squared_relu", norm="layernorm",
    optimizer="adafactor", fsdp_pod=True, microbatches=16,
)
