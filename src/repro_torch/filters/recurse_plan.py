"""Per-tap plans of the `recurse` conv kernels.

The recurse kernels evaluate the selected multiplier's datapath for every
tap product sgn(t) * sgn(c) * mult(|t|, |c|). Everything in that datapath
that depends on the coefficient alone is a launch constant, so the host
works it out once per (method, taps, nbits) -- `num_ecc` is part of the
method name -- and caches it, as `conv.rom_stack` caches ROMs:

  * every method: the signed coefficient (its sign and |c|);
  * refmlm / refmlm_nc (nbits >= 4): the non-zero 2-bit digits c_j of |c|,
    each with its weight shift 2j and its packed 16-bit row: nibble v of
    the row is base(v, c_j) for v in 0..3, base = efmlm2 or mlm2. A zero
    digit contributes nothing (base(a, 0) == 0), so it is left out;
  * refmlm / refmlm_nc at nbits == 2: the reference applies the base to
    the unmasked operands, so the plan holds the base's coefficient side
    of the whole |c|: (k2, x2) = ((|c| >> 1) & 1, |c| - 2**k2) and the
    correction bit (|c| >> 1) & |c| & 1 (0 for mlm);
  * mitchell: the leading-one position k2 of |c| and its mantissa x2;
  * mitchell_ecc{k}: (k2, x2) of each Babic stage, ending where the
    coefficient's residue reaches 0 (babic_bb(a, 0) == 0) or after k + 1
    stages;
  * odma: b = |c| & mask and ~b & mask, mask = 2**nbits - 1 (its products
    pair pixel and coefficient bits, so only the masks are hoisted).

`plan_words` lays a plan out as the kernels read it; `plan_products`
evaluates the products the kernels' way from a plan and is used by the
tests, which hold it against the reference's `tap_multiplier`.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.bitops import leading_one_position, shift_left_int32, wrap32
from repro_torch.core.kcm import parse_method
from repro_torch.core.mitchell import mitchell, wrap_int32
from repro_torch.core.refmlm import efmlm2, mlm2

SLOTS = 16                  # kPlanSlots in csrc/multipliers.cuh
WORDS = 2 + 2 * SLOTS       # int32 words a tap: coeff, count, a[SLOTS], b[SLOTS]


class Leaf(NamedTuple):
    """One non-zero coefficient digit c_j of a REFMLM tap."""
    shift: int              # 2j, the weight of the digit
    row: int                # packed 16-bit row: nibble v = base(v, c_j)
    digit: int              # c_j


class Stage(NamedTuple):
    """The coefficient side of one Mitchell-family stage."""
    k2: int                 # leading-one position
    x2: int                 # mantissa, the next stage's residue


class TapPlan(NamedTuple):
    coeff: int                              # the signed coefficient
    leaves: tuple[Leaf, ...] = ()           # refmlm family, nbits >= 4
    stages: tuple[Stage, ...] = ()          # mitchell family; base at nbits 2
    corr: int = 0                           # base correction bit, nbits 2
    masks: tuple[int, int] = (0, 0)         # odma: (b, ~b & mask)


class RecursePlan(NamedTuple):
    method: str
    family: str
    num_ecc: int
    nbits: int
    taps: tuple[TapPlan, ...]               # row-major tap order


def _base_row(digit: int, corrected: bool) -> int:
    """Packed truth table of base(., digit): nibble v = base(v, digit)."""
    v = torch.arange(4)
    fn = efmlm2 if corrected else mlm2
    vals = fn(v, torch.full_like(v, digit)).tolist()
    return sum(int(p) << (4 * i) for i, p in enumerate(vals))


def _mitchell_stage(b: int) -> Stage:
    k2 = b.bit_length() - 1
    return Stage(k2, b - (1 << k2))


def _tap_plan(family: str, num_ecc: int, nbits: int, coeff: int) -> TapPlan:
    mag = abs(coeff)
    if family in ("refmlm", "refmlm_nc"):
        corrected = family == "refmlm"
        if nbits == 2:
            if mag == 0:
                return TapPlan(coeff)
            k2 = (mag >> 1) & 1
            corr = (mag >> 1) & mag & 1 if corrected else 0
            return TapPlan(coeff, stages=(Stage(k2, mag - (1 << k2)),), corr=corr)
        digits = [(mag >> (2 * j)) & 3 for j in range(nbits // 2)]
        return TapPlan(coeff, leaves=tuple(
            Leaf(2 * j, _base_row(d, corrected), d)
            for j, d in enumerate(digits) if d))
    if family in ("mitchell", "mitchell_ecc"):
        stages, b = [], mag
        limit = 1 if family == "mitchell" else num_ecc + 1
        while b and len(stages) < limit:
            stages.append(_mitchell_stage(b))
            b = stages[-1].x2
        return TapPlan(coeff, stages=tuple(stages))
    if family == "odma":
        mask = (1 << nbits) - 1
        b = mag & mask
        return TapPlan(coeff, masks=(b, ~b & mask))
    return TapPlan(coeff)                                        # exact


@functools.lru_cache(maxsize=None)
def _cached_plan(method: str, taps: tuple, nbits: int) -> RecursePlan:
    family, num_ecc = parse_method(method)
    return RecursePlan(method, family, num_ecc, nbits, tuple(
        _tap_plan(family, num_ecc, nbits, c) for c in taps))


def recurse_plan(method: str, taps, nbits: int) -> RecursePlan:
    """The plan of `taps` (any shape, row-major) for `method` at `nbits`;
    the same object for equal arguments."""
    flat = tuple(int(c) for c in np.asarray(taps, np.int64).reshape(-1))
    return _cached_plan(method, flat, int(nbits))


def _spread_bytes(row: int) -> int:
    """16-bit row of four nibbles -> 32-bit word of four bytes (the
    kernels extract a leaf with one byte permute)."""
    return sum(((row >> (4 * v)) & 15) << (8 * v) for v in range(4))


def _tap_words(plan: RecursePlan, tap: TapPlan) -> list[int]:
    a, b = [0] * SLOTS, [0] * SLOTS
    if tap.leaves:
        count = len(tap.leaves)
        for k, lf in enumerate(tap.leaves):
            a[k] = _spread_bytes(lf.row)
            b[k] = lf.shift
    elif plan.family == "odma":
        count = int(tap.masks[0] != 0)
        a[0], b[0] = tap.masks
    elif plan.family == "exact":
        count = int(tap.coeff != 0)
    else:
        count = len(tap.stages)
        if count > SLOTS:
            raise ValueError(f"coefficient {tap.coeff} needs {count} Babic "
                             f"stages; the kernels hold {SLOTS}")
        for s, st in enumerate(tap.stages):
            a[s], b[s] = st.k2, st.x2
        if plan.family in ("refmlm", "refmlm_nc"):         # nbits == 2
            a[1] = tap.corr
    return [tap.coeff, count, *a, *b]


@functools.lru_cache(maxsize=None)
def plan_words(plan: RecursePlan) -> np.ndarray:
    """(taps, WORDS) int32 layout of `plan` as the kernels read it, per
    tap: the signed coefficient, the count of live entries, then SLOTS
    words a and SLOTS words b. REFMLM (nbits >= 4): entry k = (the row as
    four bytes, 2j). nbits 2 base: (k2, x2), a[1] = the correction bit.
    Mitchell family: stage s = (k2, x2). odma: (b, ~b & mask). The array
    is cached and read-only."""
    words = np.array([_tap_words(plan, t) for t in plan.taps],
                     np.int64).reshape(-1, WORDS)
    out = words.astype(np.int32)
    out.flags.writeable = False
    return out


# ------------------------------------------------ the products, the kernels' way

def _mitchell_from(k1, x1, nz, st: Stage, case_split: bool):
    """One stage with the coefficient side from the plan: int32 values in
    int64 lanes, shifts and the signed case split as the reference's."""
    m = wrap32(shift_left_int32(x1, torch.tensor(st.k2)) + (st.x2 << k1))
    lead = shift_left_int32(torch.ones_like(k1), k1 + st.k2)
    p = torch.where(m < lead, lead + m, 2 * m) if case_split else lead + m
    return torch.where(nz, wrap32(p), 0)


def plan_products(plan: RecursePlan, a: torch.Tensor) -> torch.Tensor:
    """(taps, *a.shape) int32: mult(a, |c|) for each tap of `plan` and each
    non-negative operand in `a`, evaluated as the kernels do -- the pixel
    side split once, then only the plan's live entries: REFMLM leaves read
    from their packed rows and shifted into place, Mitchell stages from
    (k2, x2). Wrapped to int32 like the reference's `tap_multiplier`."""
    a = a.to(torch.int64)
    out = []
    for tap in plan.taps:
        mag = abs(tap.coeff)
        if plan.family == "exact":
            p = a * mag
        elif plan.family in ("refmlm", "refmlm_nc") and plan.nbits > 2:
            p = torch.zeros_like(a)
            for lf in tap.leaves:
                for i in range(plan.nbits // 2):
                    ai = (a >> (2 * i)) & 3
                    p = p + (((lf.row >> (4 * ai)) & 15) << (2 * i + lf.shift))
            p = p & 0xFFFFFFFF
        elif plan.family in ("refmlm", "refmlm_nc"):               # nbits 2
            p = torch.zeros_like(a)
            for st in tap.stages:
                k1 = (a >> 1) & 1
                x1 = a - torch.where(a > 0, 1 << k1, 0)
                corr = (a >> 1) & a & tap.corr & 1
                p = _mitchell_from(k1, x1, a != 0, st, True) + corr
        elif plan.family == "odma":
            mask = (1 << plan.nbits) - 1
            am = a & mask
            b, nb = (torch.tensor(v) for v in tap.masks)
            p = (mitchell(am & b, am | b).to(torch.int64)
                 + mitchell(am & nb, (~am & mask) & b))
        else:                                                  # mitchell family
            p, r = torch.zeros_like(a), wrap32(a)
            for st in tap.stages:
                k1 = leading_one_position(r)
                x1 = r - torch.where(r > 0, torch.ones_like(k1) << k1, 0)
                p = p + _mitchell_from(k1, x1, r != 0, st,
                                       plan.family == "mitchell")
                r = x1
        out.append(wrap_int32(p))
    return torch.stack(out) if out else torch.empty((0, *a.shape), dtype=torch.int32)


__all__ = ["Leaf", "RecursePlan", "SLOTS", "Stage", "TapPlan",
           "WORDS", "plan_products", "plan_words", "recurse_plan"]
