"""Error-propagation report for the routed inference path.

Counterpart of `repro.infer.report`. Per multiplier method, versus the
exact-quantized int8 oracle:

  * per-layer max/mean ulp drift -- |difference| of the int32 accumulators,
    in accumulator LSBs (the quantized network's 'ulp'),
  * top-1 agreement (vs the oracle and vs the float forward),
  * logits PSNR (paper eq. 30/31, peak = the oracle's largest |logit|),

formatted as the paper's Table-10-style table lifted from filters to
networks.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.images import psnr
from repro_torch.infer.calibrate import CalibratedModel
from repro_torch.infer.runner import forward


def _ulp_stats(acc: torch.Tensor, oracle: torch.Tensor) -> dict:
    """max and mean of |acc - oracle| in int32, the mean taken as the
    reference's jnp.mean gives it: the float32 sum times the float32
    reciprocal of the count (XLA turns the division into that product)."""
    d = (acc - oracle).abs()
    total = np.float32(int(d.to(torch.int64).sum()))
    return {"max_ulp": int(d.max()),
            "mean_ulp": float(total * (np.float32(1) / np.float32(d.numel())))}


def error_report(cal: CalibratedModel, x, methods: tuple[str, ...],
                 oracle: str = "int8") -> dict:
    """Run every method over x and score it against the oracle forward."""
    o_logits, o_accs = forward(cal, x, oracle, collect=True)
    o_logits = o_logits.cpu().numpy()
    o_top1 = o_logits.argmax(axis=-1)
    f_top1 = forward(cal, x, "exact").cpu().numpy().argmax(axis=-1)
    peak = float(np.max(np.abs(o_logits))) or 1.0
    out = {}
    for method in methods:
        logits, accs = forward(cal, x, method, collect=True)
        logits = logits.cpu().numpy()
        layers = [_ulp_stats(am, ao) for am, ao in zip(accs, o_accs)]
        top1 = logits.argmax(axis=-1)
        out[method] = {
            "top1_vs_oracle": float((top1 == o_top1).mean()),
            "top1_vs_float": float((top1 == f_top1).mean()),
            "psnr_db": psnr(o_logits, logits, peak=peak),
            "layers": layers,
        }
    return out


def format_report(report: dict, title: str = "") -> str:
    """Table-10-style text table (one row per multiplier method)."""
    lines = []
    if title:
        lines.append(title)
    head = (f"{'method':<18} {'top1 vs oracle':>14} {'top1 vs float':>14} "
            f"{'PSNR dB':>9}  per-layer max ulp")
    lines += [head, "-" * len(head)]
    for method, r in report.items():
        ulps = " ".join(str(layer["max_ulp"]) for layer in r["layers"]) or "-"
        p = r["psnr_db"]
        ptxt = "   inf" if p > 200 else f"{p:6.1f}"
        lines.append(f"{method:<18} {r['top1_vs_oracle']:>14.3f} "
                     f"{r['top1_vs_float']:>14.3f} {ptxt:>9}  {ulps}")
    return "\n".join(lines)


__all__ = ["error_report", "format_report"]
