"""xlstm-1.3b [ssm] -- 48L d_model=2048 4H (kv=4) d_ff=0 vocab=50304;
mLSTM blocks (matrix memory, proj factor 2) with 1 sLSTM block every 8
(the paper's xLSTM[7:1] ratio) [arXiv:2405.04517; unverified].

d_ff=0 => no separate FFN; the mLSTM block carries its own up/down
projection. long_500k RUNS (O(1) matrix-memory decode state)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    mlp="none",
    slstm_period=8, mlstm_proj_factor=2.0, ssm_conv_width=4,
    # H=4 heads cannot use a 16-way model axis: TP thrashes GSPMD with
    # gather/replicate cycles (collective term 18.8s/step). prefer_dp folds
    # the model axis into DP+FSDP: 0.36s (EXPERIMENTS.md #Perf cell A).
    prefer_dp=True,
)
