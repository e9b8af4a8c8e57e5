"""Parity of the port's multipliers and KCM ROMs (`repro_torch.core`) with
the JAX package (`repro.core`), byte for byte.

The same operands, made with numpy, go through both packages; the datapath
is all integers, so the tolerance is zero. 16-bit products compare as the
reference's uint32 values, and `tap_multiplier` as the int32 it casts them
to (which wraps at >= 2**31).
"""
import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.filters.bank as jbank

# The suite runs in several worker processes; one torch thread each keeps
# them from oversubscribing the cores.
torch.set_num_threads(1)

# `repro.core` and `repro_torch.core` re-export functions named like their
# modules (`mitchell`, `odma`, `refmlm`), so the modules are fetched by name.
jbitops, jkcm, jmitchell, jodma, jrefmlm = (
    importlib.import_module(f"repro.core.{m}")
    for m in ("bitops", "kcm", "mitchell", "odma", "refmlm"))
tbitops, tkcm, tmitchell, todma, trefmlm = (
    importlib.import_module(f"repro_torch.core.{m}")
    for m in ("bitops", "kcm", "mitchell", "odma", "refmlm"))


def _pairs(nbits: int) -> tuple[np.ndarray, np.ndarray]:
    """Every (a, b) operand pair of the width."""
    xs = np.arange(1 << nbits, dtype=np.int32)
    return np.repeat(xs, xs.size), np.tile(xs, xs.size)


def _samples16(seed: int = 11, n: int = 4096) -> tuple[np.ndarray, np.ndarray]:
    """Seeded 16-bit operands: uniform, plus pairs both >= 46,341 whose
    product reaches 2**31 (the int32 cast wraps there), plus the corners."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 16, n)
    b = rng.integers(0, 1 << 16, n)
    ha = rng.integers(46341, 1 << 16, n)
    hb = rng.integers(46341, 1 << 16, n)
    corners = np.array([0, 1, 2, 3, 255, 256, 46340, 46341, 65534, 65535])
    ca, cb = np.meshgrid(corners, corners)
    a = np.concatenate([a, ha, ca.ravel()]).astype(np.int32)
    b = np.concatenate([b, hb, cb.ravel()]).astype(np.int32)
    return a, b


# (name, reference f(a, b, nbits), port f(a, b, nbits)) for each multiplier
MULTIPLIERS = [
    ("exact", lambda a, b, n: a.astype(jnp.uint32) * b.astype(jnp.uint32),
     lambda a, b, n: (a.long() * b.long()) & 0xFFFFFFFF),
    ("mitchell", jmitchell.mitchell, tmitchell.mitchell),
    ("babic_bb", jmitchell.babic_bb, tmitchell.babic_bb),
    *[(f"mitchell_ecc{k}",
       lambda a, b, n, k=k: jmitchell.babic_ecc(a, b, n, num_ecc=k),
       lambda a, b, n, k=k: tmitchell.babic_ecc(a, b, n, num_ecc=k))
      for k in (1, 2, 3)],
    ("odma", jodma.odma, todma.odma),
    *[(f"refmlm_{variant}_{base}_{'flat' if flat else 'tree'}",
       lambda a, b, n, v=variant, s=base, f=flat: jrefmlm.refmlm(
           a, b, n, variant=v, base=s, flatten=f),
       lambda a, b, n, v=variant, s=base, f=flat: trefmlm.refmlm(
           a, b, n, variant=v, base=s, flatten=f))
      for variant in ("kom4", "kom3") for base in ("efmlm", "mlm")
      for flat in (True, False)],
]
TAP_METHODS = [*tkcm.METHODS, "mitchell_ecc1", "mitchell_ecc2", "mitchell_ecc3"]


def _compare(ref_fn, port_fn, a, b, nbits):
    want = np.asarray(ref_fn(jnp.asarray(a), jnp.asarray(b), nbits)).astype(np.int64)
    got = port_fn(torch.from_numpy(a), torch.from_numpy(b), nbits)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


@pytest.mark.parametrize("name,ref_fn,port_fn", MULTIPLIERS,
                         ids=[m[0] for m in MULTIPLIERS])
@pytest.mark.parametrize("nbits", [2, 8])
def test_multiplier_exhaustive(name, ref_fn, port_fn, nbits):
    """All operand pairs of the width (65,536 at 8 bits)."""
    _compare(ref_fn, port_fn, *_pairs(nbits), nbits)


@pytest.mark.parametrize("name,ref_fn,port_fn", MULTIPLIERS,
                         ids=[m[0] for m in MULTIPLIERS])
def test_multiplier_16bit_samples(name, ref_fn, port_fn):
    """Seeded 16-bit operands, products past 2**31 included: the port's
    int64 values reduced modulo 2**32 equal the reference's uint32 lane."""
    _compare(ref_fn, port_fn, *_samples16(), 16)


@pytest.mark.parametrize("method", TAP_METHODS)
@pytest.mark.parametrize("nbits", [8, 16])
def test_tap_multiplier_wraps_like_reference(method, nbits):
    """The int32 cast of tap_multiplier, wrap included, at both widths."""
    a, b = _pairs(8) if nbits == 8 else _samples16(seed=3)
    want = np.asarray(jkcm.tap_multiplier(method)(
        jnp.asarray(a), jnp.asarray(b), nbits))
    got = tkcm.tap_multiplier(method)(torch.from_numpy(a), torch.from_numpy(b),
                                      nbits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if nbits == 16:
        assert (want < 0).any(), "sample must reach the int32 wrap"


@pytest.mark.parametrize("base", ["mlm2", "efmlm2"])
def test_base_2x2(base):
    a, b = _pairs(2)
    want = np.asarray(getattr(jrefmlm, base)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(trefmlm, base)(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)


def test_bitops():
    x = np.concatenate([np.arange(1 << 16), [1 << 20, (1 << 31) - 1]]).astype(np.int32)
    np.testing.assert_array_equal(
        tbitops.leading_one_position(torch.from_numpy(x)).numpy(),
        np.asarray(jbitops.leading_one_position(jnp.asarray(x))))
    for nbits in (2, 4, 8, 16):
        for got, want in zip(tbitops.split_halves(torch.from_numpy(x).long(), nbits),
                             jbitops.split_halves(jnp.asarray(x), nbits)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_width_checks_raise_like_reference():
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="nbits"):
        tmitchell.mitchell(one, one, 17)
    with pytest.raises(ValueError, match="nbits"):
        trefmlm.refmlm(one, one, 6)
    with pytest.raises(ValueError, match="unknown multiplier"):
        tkcm.tap_multiplier("booth")


def _bank_coefficients() -> list[int]:
    coeffs = set()
    for spec in jbank.FILTER_BANK.values():
        coeffs.update(int(c) for c in np.asarray(spec.taps).ravel())
        if spec.separable:
            coeffs.update(int(c) for c in spec.sep_row)
            coeffs.update(int(c) for c in spec.sep_col)
    return sorted(coeffs)


@functools.lru_cache(maxsize=None)
def _reference_rows(method: str, nbits: int) -> dict[int, np.ndarray]:
    """coeff -> the reference's ROM, sign(c) * tap_multiplier(x, |c|), for
    every bank coefficient in ONE vectorized call (the reference's
    per-coefficient `product_table` costs seconds each at 16 bits)."""
    coeffs = np.array(_bank_coefficients())
    xs = jnp.arange(1 << nbits, dtype=jnp.int32)[None, :]
    cs = jnp.asarray(np.abs(coeffs), jnp.int32)[:, None]
    prods = np.asarray(jkcm.tap_multiplier(method)(
        jnp.broadcast_to(xs, (cs.shape[0], xs.shape[1])),
        jnp.broadcast_to(cs, (cs.shape[0], xs.shape[1])), nbits), np.int64)
    rows = (np.sign(coeffs)[:, None] * prods).astype(np.int32)
    return dict(zip(coeffs.tolist(), rows))


def test_reference_rows_are_product_table():
    """The vectorized reference rows are the reference's `product_table`."""
    for method in ("refmlm", "mitchell"):
        for coeff in (-32, 7, 160):
            np.testing.assert_array_equal(
                _reference_rows(method, 8)[coeff],
                jkcm.product_table(method, coeff, 8))


@pytest.mark.parametrize("method", [*tkcm.METHODS, "mitchell_ecc2"])
@pytest.mark.parametrize("nbits", [8, 16])
def test_product_tables_every_bank_coefficient(method, nbits):
    for coeff, want in _reference_rows(method, nbits).items():
        got = tkcm.product_table(method, coeff, nbits)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"coeff={coeff}")


@pytest.mark.parametrize("method", [*tkcm.METHODS, "mitchell_ecc2"])
@pytest.mark.parametrize("nbits", [8, 16])
def test_filter_tables_and_bound_every_bank_filter(method, nbits):
    """Stacks, narrowing and accumulator bounds. At 8 bits against the
    reference's `filter_tables`; at 16 bits against the stacked reference
    rows, where every ROM with a nonzero coefficient holds 65535*|c| >=
    2**15 and so stays int32 in the reference."""
    rows = _reference_rows(method, nbits)
    for name, spec in jbank.FILTER_BANK.items():
        tap_sets = [spec.taps]
        if spec.separable:
            tap_sets += [spec.sep_row, spec.sep_col]
        for taps in tap_sets:
            got = tkcm.filter_tables(method, np.asarray(taps), nbits)
            if nbits == 8:
                want = jkcm.filter_tables(method, np.asarray(taps), nbits)
            else:
                want = np.stack([rows[int(c)] for c in np.ravel(taps)])
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
            assert tkcm.tables_acc_bound(got) == jkcm.tables_acc_bound(want)


# ------------------------------------------------ the oracle functions ------
def _bytes_equal(got: torch.Tensor, want) -> None:
    """Same dtype, same values: byte-equal."""
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


ORACLES = [
    ("mitchell_corrected", jmitchell.mitchell_corrected, tmitchell.mitchell_corrected),
    ("odma_exact_identity", jodma.odma_exact_identity, todma.odma_exact_identity),
]


@pytest.mark.parametrize("name,ref_fn,port_fn", ORACLES, ids=[o[0] for o in ORACLES])
@pytest.mark.parametrize("nbits", [2, 8, 16])
def test_oracle_products_are_byte_equal(name, ref_fn, port_fn, nbits):
    """Every pair at 2 and 8 bits, the seeded 16-bit samples (products past
    2**31): the same dtype (int32, odma's identity uint32 at 16 bits) and
    values as the reference's."""
    a, b = _pairs(nbits) if nbits < 16 else _samples16()
    _bytes_equal(port_fn(torch.from_numpy(a), torch.from_numpy(b), nbits),
                 ref_fn(jnp.asarray(a), jnp.asarray(b), nbits))


def test_mitchell_corrected_is_the_exact_product():
    a, b = _pairs(8)
    got = tmitchell.mitchell_corrected(torch.from_numpy(a), torch.from_numpy(b), 8)
    np.testing.assert_array_equal(got.numpy(), a * b)


@pytest.mark.parametrize("nbits", [8, 16])
def test_mitchell_residual_operands_are_byte_equal(nbits):
    a, b = _pairs(nbits) if nbits < 16 else _samples16()
    a = np.concatenate([a, [-5, 1 << 30, -(1 << 31)]]).astype(np.int32)
    b = np.concatenate([b, [3, 3, 7]]).astype(np.int32)
    got = tmitchell.mitchell_residual_operands(torch.from_numpy(a), torch.from_numpy(b))
    for g, w in zip(got, jmitchell.mitchell_residual_operands(jnp.asarray(a), jnp.asarray(b))):
        _bytes_equal(g, w)


def test_mitchell_truncated_float_within_its_tolerance():
    """R6: the float path against the reference's, elementwise within a few
    float32 ulps (log2 / exp2 are the libraries' own), and within its
    documented 11.1% of the exact product; exact at powers of two."""
    rng = np.random.default_rng(5)
    a = (rng.standard_normal(4096) * 10).astype(np.float32)
    b = (rng.standard_normal(4096) * 10).astype(np.float32)
    a[:4], b[:4] = [0.0, 2.0, -4.0, 0.5], [3.0, 8.0, 0.25, -16.0]
    got = tmitchell.mitchell_truncated_float(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jmitchell.mitchell_truncated_float(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=4 * np.finfo(np.float32).eps, atol=0)
    exact = a.astype(np.float64) * b
    assert (np.abs(got - exact) <= 0.1112 * np.abs(exact) + 1e-30).all()
    np.testing.assert_array_equal(got[:4], exact[:4].astype(np.float32))


def test_bitops_oracles_are_byte_equal():
    x = np.concatenate([np.arange(1 << 16), [1 << 20, (1 << 31) - 1, -5, -(1 << 31)]]
                       ).astype(np.int32)
    k = np.array(jbitops.leading_one_position(jnp.asarray(x)))
    _bytes_equal(tbitops.mantissa(torch.from_numpy(x), torch.from_numpy(k)),
                 jbitops.mantissa(jnp.asarray(x), jnp.asarray(k)))
    ks = np.arange(0, 32, dtype=np.int32)
    _bytes_equal(tbitops.decode_power(torch.from_numpy(ks)), jbitops.decode_power(jnp.asarray(ks)))
    for nbits in (8, 16, 32):
        _bytes_equal(tbitops.popcount(torch.from_numpy(x), nbits),
                     jbitops.popcount(jnp.asarray(x), nbits))


@pytest.mark.parametrize("variant", ["kom4", "kom3"])
def test_op_counts_equal_the_reference(variant):
    for nbits in (2, 4, 8, 16):
        assert trefmlm.op_counts(nbits, variant) == jrefmlm.op_counts(nbits, variant)
