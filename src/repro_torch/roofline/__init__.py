"""Cost models of the port's datapaths: the analytic conv model
(`conv_model`) and the roofline of one counted step of the port's program
(`analysis`, with `runner`'s per-cell records)."""
from repro_torch.roofline.analysis import (HW, RooflineReport, analyze_step,
                                           collective_bytes, model_flops)

__all__ = ["HW", "RooflineReport", "analyze_step", "collective_bytes", "model_flops"]
