"""Batched multi-filter image pipeline on the REFMLM datapath.

  bank.py     -- the filter definitions (integer taps, fixed-point epilogue,
                 separable decompositions);
  conv.py     -- the conv passes: CUDA kernels and their plain versions;
  pipeline.py -- apply_filter / filter_bank_apply / apply_filter_batch;
  ref.py      -- an independently written plain oracle for tests.
"""
from repro_torch.filters.bank import (
    FILTER_BANK,
    FILTER_NAMES,
    FilterSpec,
    gaussian_kernel_1d,
    get_filter,
)
from repro_torch.filters.conv import (
    METHODS,
    MULT_IMPLS,
    conv2d_pass,
    fused_separable_pass,
    tap_multiplier,
)
from repro_torch.filters.pipeline import (
    EXEC_MODES,
    apply_filter,
    apply_filter_batch,
    filter_bank_apply,
    resolve_filter_blocks,
    resolve_filter_plan,
)

__all__ = [
    "EXEC_MODES", "FILTER_BANK", "FILTER_NAMES", "METHODS", "MULT_IMPLS",
    "FilterSpec", "apply_filter", "apply_filter_batch", "conv2d_pass",
    "filter_bank_apply", "fused_separable_pass", "gaussian_kernel_1d",
    "get_filter", "resolve_filter_blocks", "resolve_filter_plan", "tap_multiplier",
]
