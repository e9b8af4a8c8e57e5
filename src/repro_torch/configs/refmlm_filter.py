"""The paper's own application config: 3x3 Gaussian smoothing of fingerprint
images with the REFMLM multiplier family (paper §3.3, Tables 7-10).

Counterpart of `repro.configs.refmlm_filter`, copied. Not an LM
architecture; its consumers (the reference's `examples/
gaussian_filter_fingerprint.py` and `benchmarks/table10_psnr.py`) stay with
the JAX package.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    image_hw: tuple[int, int] = (256, 256)
    batch: int = 4                   # images per pipeline invocation (N axis)
    sigma: float = 1.0
    kernel_scale: int = 256          # paper Fig. 9
    nbits: int = 8                   # pixel width; the paper's 8x8 REFMLM
    multiplier: str = "refmlm"       # exact|refmlm|refmlm_nc|mitchell|mitchell_ecc{k}|odma
    #: filter-bank members swept by the benchmarks (repro_torch.filters, DESIGN.md §5)
    filters: tuple[str, ...] = ("gaussian3", "gaussian5", "box3", "sharpen3",
                                "sobel_x", "sobel_y", "laplacian")
    noise_levels: tuple[int, ...] = (10, 20, 30, 40)   # % salt&pepper, Table 10
    block_rows: int | None = None    # the reference's Pallas row-band tile; None = auto


CONFIG = FilterConfig()
