"""REFMLM -- Recursive Error-Free Mitchell Log Multiplier (paper §3).

Counterpart of `repro.core.refmlm`:

  * 2x2 EFMLM base (§3.1): Mitchell on 2-bit operands plus the single
    correction term a1&a0&b1&b0 (eq. 23), exact; `mlm2` is the uncorrected
    base ('Proposed Without Error Correction').
  * KOM recursion (§3.2): 'kom4' is the paper's 4-sub-product split
    (Table 2), 'kom3' the 3-product Karatsuba form of eq. 19 with a
    sign-tracked cross term.
  * flatten=True evaluates every 2x2 leaf of the recursion as one stacked
    base call over a digit-plane axis and sums the weighted leaves;
    flatten=False is the paper-literal unrolled recursion.

Products are int64; at 16 bits they are reduced modulo 2**32 like the
reference's uint32 lane (`wrap_product`).
"""
from __future__ import annotations

import torch

from repro_torch.core.bitops import split_halves
from repro_torch.core.mitchell import _check_width

SUPPORTED_WIDTHS = (2, 4, 8, 16)


def wrap_product(x: torch.Tensor, nbits: int) -> torch.Tensor:
    """The reference's REFMLM product lane: int32 below 16 bits, uint32
    (values modulo 2**32) at 16 bits."""
    return x & ((1 << 32) - 1) if 2 * nbits > 31 else x


def mlm2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Uncorrected 2x2 Mitchell product: exact except 3*3 -> 8."""
    a, b = a.to(torch.int64), b.to(torch.int64)
    k1 = (a >> 1) & 1
    k2 = (b >> 1) & 1
    x1 = a - torch.where(a > 0, 1 << k1, 0)
    x2 = b - torch.where(b > 0, 1 << k2, 0)
    m = (x1 << k2) + (x2 << k1)
    lead = 1 << (k1 + k2)
    p = torch.where(m < lead, lead + m, 2 * m)
    return torch.where((a == 0) | (b == 0), 0, p)


def efmlm2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Error-free 2x2 Mitchell multiplier: mlm2 + a1*a0*b1*b0 (eq. 23)."""
    a, b = a.to(torch.int64), b.to(torch.int64)
    return mlm2(a, b) + ((a >> 1) & a & (b >> 1) & b & 1)


def _recurse(a, b, nbits: int, base_fn, variant: str) -> torch.Tensor:
    """Paper-literal KOM recursion; returns the 2*nbits-bit product."""
    if nbits == 2:
        return base_fn(a, b)
    half = nbits // 2
    a_h, a_l = split_halves(a.to(torch.int64), nbits)
    b_h, b_l = split_halves(b.to(torch.int64), nbits)
    low = _recurse(a_l, b_l, half, base_fn, variant)
    high = _recurse(a_h, b_h, half, base_fn, variant)
    if variant == "kom4":
        mid = (_recurse(a_h, b_l, half, base_fn, variant)
               + _recurse(a_l, b_h, half, base_fn, variant))
    elif variant == "kom3":
        dl = a_l - a_h
        dr = b_h - b_l
        t = _recurse(dl.abs(), dr.abs(), half, base_fn, variant)
        mid = low + high + torch.sign(dl) * torch.sign(dr) * t
    else:
        raise ValueError(f"unknown variant {variant!r}")
    return wrap_product(low + (mid << half) + (high << nbits), nbits)


def _leaves(a, b, nbits: int, variant: str, weight: int, sign, out: list) -> None:
    """Collect the (a2, b2, weight, sign) digit-plane leaves of the
    recursion: each contributes weight * sign * base(a2, b2). `sign` is
    None (+1) or a {-1, 0, 1} tensor from nested kom3 cross terms."""
    if nbits == 2:
        out.append((a, b, weight, sign))
        return
    half = nbits // 2
    a_h, a_l = split_halves(a, nbits)
    b_h, b_l = split_halves(b, nbits)
    if variant == "kom4":
        _leaves(a_l, b_l, half, variant, weight, sign, out)
        _leaves(a_h, b_l, half, variant, weight << half, sign, out)
        _leaves(a_l, b_h, half, variant, weight << half, sign, out)
        _leaves(a_h, b_h, half, variant, weight << nbits, sign, out)
    elif variant == "kom3":
        _leaves(a_l, b_l, half, variant, weight * (1 + (1 << half)), sign, out)
        _leaves(a_h, b_h, half, variant,
                weight * ((1 << half) + (1 << nbits)), sign, out)
        dl = a_l - a_h
        dr = b_h - b_l
        s = torch.sign(dl) * torch.sign(dr)
        _leaves(dl.abs(), dr.abs(), half, variant, weight << half,
                s if sign is None else sign * s, out)
    else:
        raise ValueError(f"unknown variant {variant!r}")


def _recurse_flat(a, b, nbits: int, base_fn, variant: str) -> torch.Tensor:
    """Digit-plane-flattened KOM: one stacked base call, then the weighted
    sum of the leaves (modular at 16 bits, like the reference)."""
    if nbits == 2:
        return base_fn(a, b)
    a, b = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
    leaves: list = []
    _leaves(a, b, nbits, variant, 1, None, leaves)
    prods = base_fn(torch.stack([la for la, _, _, _ in leaves]),
                    torch.stack([lb for _, lb, _, _ in leaves]))
    acc = torch.zeros_like(a)
    for prod, (_, _, weight, sign) in zip(prods, leaves):
        acc = acc + weight * (prod if sign is None else sign * prod)
    return wrap_product(acc, nbits)


def refmlm(a: torch.Tensor, b: torch.Tensor, nbits: int = 16, *,
           variant: str = "kom4", base: str = "efmlm",
           flatten: bool = True) -> torch.Tensor:
    """The paper's recursive multiplier on non-negative operands < 2**nbits.

    variant 'kom4' | 'kom3'; base 'efmlm' (exact) | 'mlm' (uncorrected);
    flatten picks the stacked digit-plane evaluation or the unrolled
    recursion (bit-identical)."""
    _check_width(nbits)
    if nbits not in SUPPORTED_WIDTHS:
        raise ValueError(f"nbits must be one of {SUPPORTED_WIDTHS}, got {nbits}")
    base_fn = {"efmlm": efmlm2, "mlm": mlm2}[base]
    impl = _recurse_flat if flatten else _recurse
    return impl(a, b, nbits, base_fn, variant)


def op_counts(nbits: int, variant: str = "kom4") -> dict[str, int]:
    """Analytic operation counts of an n x n product (the paper's LUT
    table, Table 9): base 2x2 multiplies and word adds."""
    if nbits == 2:
        return {"base_mults": 1, "adds": 0}
    sub = op_counts(nbits // 2, variant)
    if variant == "kom4":               # 4 sub-products, 3 combining adds
        return {"base_mults": 4 * sub["base_mults"], "adds": 4 * sub["adds"] + 3}
    # kom3: 3 sub-products; 2 operand subs + 2 adds for mid + 2 combining adds
    return {"base_mults": 3 * sub["base_mults"], "adds": 3 * sub["adds"] + 6}


__all__ = ["SUPPORTED_WIDTHS", "efmlm2", "mlm2", "op_counts", "refmlm"]
