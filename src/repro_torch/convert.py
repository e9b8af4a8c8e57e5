"""Carry the reference's filter parameters across to the port.

In this datapath the parameters are filter coefficients, not weights:
`from_reference_spec` takes the fields of a JAX-package `FilterSpec` (as
numpy arrays and plain values) and returns the port's `FilterSpec`, so any
reference spec -- a `get_filter(name, sigma=...)` re-sampling included --
runs through both packages.
"""
from __future__ import annotations

import numpy as np

from repro_torch.filters.bank import FilterSpec


def _vector(v) -> np.ndarray | None:
    return None if v is None else np.asarray(v, np.int32).reshape(-1)


def from_reference_spec(name, taps, shift, post, sep_row, sep_col) -> FilterSpec:
    """The port's `FilterSpec` with the reference spec's values."""
    taps = np.asarray(taps, np.int32)
    if taps.ndim != 2:
        raise ValueError(f"taps must be a (kh, kw) table, got shape {taps.shape}")
    if (sep_row is None) != (sep_col is None):
        raise ValueError("sep_row and sep_col must both be given or both None")
    return FilterSpec(str(name), taps, int(shift), str(post),
                      _vector(sep_row), _vector(sep_col))


__all__ = ["from_reference_spec"]
