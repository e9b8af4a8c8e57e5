"""KCM -- constant-coefficient multiplier tables (product ROMs).

Counterpart of `repro.core.kcm`. Filter coefficients are constants, so each
tap becomes a ROM indexed by the pixel value: for a `(method, coeff,
nbits)` every operand x in [0, 2**nbits) is enumerated once through the
selected multiplier, and the conv passes gather from the table. The table
is computed *by* the multiplier, so approximation error is preserved bit
for bit: table[x] == sign(coeff) * mult(x, |coeff|).

`tap_multiplier` casts every product to int32 like the reference's
`.astype(jnp.int32)`, which wraps 16-bit products >= 2**31; the port keeps
the wrap.
"""
from __future__ import annotations

import re
from functools import lru_cache

import numpy as np
import torch

from repro_torch.core.mitchell import babic_ecc, mitchell, wrap_int32
from repro_torch.core.odma import odma
from repro_torch.core.refmlm import refmlm

METHODS = ("exact", "refmlm", "refmlm_nc", "mitchell", "odma")  # + mitchell_ecc{k}


def parse_method(method: str) -> tuple[str, int]:
    """method -> (family, num_ecc); 'mitchell_ecc3' -> ('mitchell_ecc', 3)."""
    if method in METHODS:
        return method, 0
    if m := re.fullmatch(r"mitchell_ecc(\d+)", method):
        return "mitchell_ecc", int(m.group(1))
    raise ValueError(f"unknown multiplier method {method!r}")


def tap_multiplier(method: str):
    """method -> f(a, b, nbits): int32 element-wise product of non-negative
    integer tensors, wrapped to int32 as the reference casts it."""
    family, num_ecc = parse_method(method)
    i64 = torch.int64
    products = {
        "exact": lambda a, b, nbits: a.to(i64) * b.to(i64),
        "refmlm": lambda a, b, nbits: refmlm(a, b, nbits, variant="kom4",
                                             base="efmlm"),
        "refmlm_nc": lambda a, b, nbits: refmlm(a, b, nbits, variant="kom4",
                                                base="mlm"),
        "mitchell": mitchell,
        "mitchell_ecc": lambda a, b, nbits: babic_ecc(a, b, nbits,
                                                      num_ecc=num_ecc),
        "odma": odma,
    }
    product = products[family]
    return lambda a, b, nbits: wrap_int32(product(a, b, nbits))


@lru_cache(maxsize=None)
def product_table(method: str, coeff: int, nbits: int) -> np.ndarray:
    """(2**nbits,) int32 ROM: table[x] = sign(coeff) * mult(x, |coeff|)."""
    xs = torch.arange(1 << nbits, dtype=torch.int64)
    tab = tap_multiplier(method)(xs, torch.tensor(abs(int(coeff))), nbits)
    signed = int(np.sign(coeff)) * tab.numpy().astype(np.int64)
    return signed.astype(np.int32)


def filter_tables(method: str, taps, nbits: int, *,
                  narrow: bool = True) -> np.ndarray:
    """(taps.size, 2**nbits) stack of per-tap ROMs in row-major tap order,
    int16 when every |product| < 2**15 and `narrow`, else int32."""
    flat = np.asarray(taps, dtype=np.int64).reshape(-1)
    stack = np.stack([product_table(method, int(c), nbits) for c in flat])
    if narrow and np.abs(stack).max(initial=0) < (1 << 15):
        return stack.astype(np.int16)
    return stack


def tables_acc_bound(tables: np.ndarray) -> int:
    """Worst-case |accumulator| fed by these ROMs: the sum of each tap's
    largest |product|."""
    return int(np.abs(np.asarray(tables, np.int64)).max(axis=-1).sum())


__all__ = ["METHODS", "filter_tables", "parse_method", "product_table",
           "tables_acc_bound", "tap_multiplier"]
