"""hubert-xlarge [audio] -- 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504;
encoder-only (same backbone as wav2vec2) [arXiv:2106.07447; unverified].

Frontend stub: the CNN feature extractor is replaced by precomputed frame
embeddings (input_specs supplies (B, S, frame_dim)); the vocab is the HuBERT
masked-prediction cluster codebook. No causal mask, no decode path."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504, head_dim=80,
    attention="gqa", causal=False, norm="layernorm",
    mlp="gelu", input_kind="frames", frame_dim=512,
)
