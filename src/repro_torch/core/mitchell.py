"""Mitchell logarithmic multipliers (paper §2.1/§2.2) and the Babic
basic-block family BB + k ECC (paper baseline [18]) on integer tensors.

Counterpart of `repro.core.mitchell`, same integer formulation:
  a = 2^k1 + x1,  b = 2^k2 + x2,  m = (x1 << k2) + (x2 << k1)
  Mitchell: P = 2^(k1+k2) + m  if m < 2^(k1+k2)  else  2m
  BB:       P = 2^(k1+k2) + m  (no case split), ECC stages re-apply BB to
            the mantissa residues.

The lane is the reference's: int32 at every width, carried here in int64
and wrapped after every step. The reference declares a uint32 lane for
16-bit products (`_prod_dtype`), but JAX promotes uint32 shifted by the
int32 characteristic to int32, so its Mitchell-family products wrap at
2**31 (e.g. mitchell(65535, 65535, 16) == -131072). Operands of magnitude
2**30 and more follow the same lane: the characteristic of a non-positive
int32 (|-2**31| is -2**31) is 0, a shift by 32 or more gives 0, and
Mitchell's case split compares the wrapped m and 2**(k1+k2) as signed
int32 (for a = 2**30, b = 2: lead = 2**31 wraps to -2**31, so P = 2m = 0).
"""
from __future__ import annotations

import torch

from repro_torch.core.bitops import leading_one_position, shift_left_int32, wrap32

MAX_NBITS = 16
_U32 = (1 << 32) - 1


def _check_width(nbits: int) -> None:
    if not (2 <= nbits <= MAX_NBITS):
        raise ValueError(f"nbits must be in [2, {MAX_NBITS}], got {nbits}")


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> int32 with two's-complement wrap (the reference's
    `.astype(jnp.int32)` of a uint32 product, or an int32 sum that
    overflowed)."""
    x = x.to(torch.int64) & _U32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def characteristic_and_mantissa(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(k, mantissa) with x = 2^k + mantissa of the int32 value of x;
    (0, x) for x <= 0, as the reference's int32 lane gives."""
    x = wrap32(x.to(torch.int64))
    k = leading_one_position(x)
    return k, x - torch.where(x > 0, torch.ones_like(k) << k, 0)


def _lead_and_m(a: torch.Tensor, b: torch.Tensor):
    """-> (2**(k1+k2), (x1 << k2) + (x2 << k1), zero operand), int32 values."""
    k1, x1 = characteristic_and_mantissa(a)
    k2, x2 = characteristic_and_mantissa(b)
    m = wrap32(shift_left_int32(x1, k2) + shift_left_int32(x2, k1))
    lead = shift_left_int32(torch.ones_like(k1), k1 + k2)
    return lead, m, (wrap32(a) == 0) | (wrap32(b) == 0)


def mitchell(a: torch.Tensor, b: torch.Tensor, nbits: int = 16) -> torch.Tensor:
    """Mitchell's algorithm (MA) product approximation, eq. 8."""
    _check_width(nbits)
    lead, m, zero = _lead_and_m(a.to(torch.int64), b.to(torch.int64))
    p = torch.where(m < lead, lead + m, 2 * m)
    return wrap_int32(torch.where(zero, 0, p))


def babic_bb(a: torch.Tensor, b: torch.Tensor, nbits: int = 16) -> torch.Tensor:
    """Babic/Bulic basic block (no case split): 2^(k1+k2) + m."""
    _check_width(nbits)
    lead, m, zero = _lead_and_m(a.to(torch.int64), b.to(torch.int64))
    return wrap_int32(torch.where(zero, 0, lead + m))


def babic_ecc(a: torch.Tensor, b: torch.Tensor, nbits: int = 16,
              num_ecc: int = 1) -> torch.Tensor:
    """Iterative logarithmic multiplier: BB + `num_ecc` correction stages,
    each applying BB to the previous stage's mantissa residues."""
    _check_width(nbits)
    ra, rb = torch.broadcast_tensors(wrap32(a.to(torch.int64)),
                                     wrap32(b.to(torch.int64)))
    total = torch.zeros_like(ra)
    for _ in range(num_ecc + 1):
        total = total + babic_bb(ra, rb, nbits).to(torch.int64)
        ra = characteristic_and_mantissa(ra)[1]
        rb = characteristic_and_mantissa(rb)[1]
    return wrap_int32(total)


def mitchell_residual_operands(a: torch.Tensor,
                               b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Operands whose exact product is Mitchell's error (eqs. 11 / 13):
    (x1, x2) while the mantissas' sum has no carry, else (2^k1 - x1, 2^k2
    - x2); (0, 0) for a zero operand. int32, wrapped as the reference's."""
    a, b = wrap32(a.to(torch.int64)), wrap32(b.to(torch.int64))
    k1, x1 = characteristic_and_mantissa(a)
    k2, x2 = characteristic_and_mantissa(b)
    m = wrap32(shift_left_int32(x1, k2) + shift_left_int32(x2, k1))
    carry = m >= shift_left_int32(torch.ones_like(k1), k1 + k2)
    ra = torch.where(carry, wrap32(shift_left_int32(torch.ones_like(k1), k1) - x1), x1)
    rb = torch.where(carry, wrap32(shift_left_int32(torch.ones_like(k2), k2) - x2), x2)
    zero = (a == 0) | (b == 0)
    return (torch.where(zero, 0, ra).to(torch.int32), torch.where(zero, 0, rb).to(torch.int32))


def mitchell_corrected(a: torch.Tensor, b: torch.Tensor, nbits: int = 16) -> torch.Tensor:
    """Mitchell's own analytic correction (eq. 14): MA plus the exact
    product of the residual operands; exact by construction, and an
    oracle (it needs the second multiplier REFMLM removes). int32, the
    sum wrapped as the reference's."""
    _check_width(nbits)
    ra, rb = mitchell_residual_operands(a, b)
    return wrap_int32(mitchell(a, b, nbits).to(torch.int64)
                      + wrap_int32(ra.to(torch.int64) * rb.to(torch.int64)))


def mitchell_truncated_float(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mitchell on real values (the LNS research path): log2|x| ~ k + f,
    piecewise linear; the product carries sign(a) * sign(b). Exact at
    powers of two, error <= 11.1%."""
    sa, sb = torch.sign(a), torch.sign(b)
    aa, ab = a.abs(), b.abs()
    ea = torch.floor(torch.log2(torch.where(aa > 0, aa, torch.ones_like(aa))))
    eb = torch.floor(torch.log2(torch.where(ab > 0, ab, torch.ones_like(ab))))
    fa = aa / torch.exp2(ea) - 1.0          # mantissa fraction in [0, 1)
    fb = ab / torch.exp2(eb) - 1.0
    s = fa + fb
    p = torch.where(s < 1.0, torch.exp2(ea + eb) * (1.0 + s), torch.exp2(ea + eb + 1.0) * s)
    return sa * sb * torch.where((aa == 0) | (ab == 0), torch.zeros_like(p), p)


__all__ = ["MAX_NBITS", "babic_bb", "babic_ecc", "characteristic_and_mantissa",
           "mitchell", "mitchell_corrected", "mitchell_residual_operands",
           "mitchell_truncated_float", "wrap_int32"]
