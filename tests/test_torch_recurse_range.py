"""The recurse path on operands of magnitude 2**30 and more, byte for byte
against the JAX package (ROADMAP fault F2, fixed).

The reference's Mitchell family runs in an int32 lane at every width: the
characteristic of a non-positive int32 is 0 (|-2**31| is -2**31), a shift
by 32 or more gives 0, and Mitchell's case split compares the wrapped
m and 2**(k1+k2) as signed int32. The port follows that lane in its plain
multipliers (`repro_torch.core.mitchell`), in the plans' products
(`recurse_plan.plan_products`) and in the recurse kernels
(`csrc/multipliers.cuh`, held against the plain versions on the card by
`chip_smoke.py`'s `with_out_of_range`).

Covered: ROADMAP's F2 input -- a (1, 3, 5) zero image with x[0, 1, 2] one
of 2**30, -2**30, 2**31 - 1, -2**31, taps [[1, -3, 2]] -- through the
direct recurse pass for every multiplier at nbits 8 and 16; the fused
recurse pass on the same operands; and the plans' products on operands up
to 2**31 - 1 and -2**31. The tolerance is zero: the datapath is all
integers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.kcm as jkcm
import repro.filters.conv as jconv
from repro_torch.filters import conv as tconv
from repro_torch.filters import recurse_plan as rp

# The suite runs in several worker processes; one torch thread each keeps
# them from oversubscribing the cores.
torch.set_num_threads(1)

METHODS = ["exact", "refmlm", "refmlm_nc", "mitchell", "mitchell_ecc1",
           "mitchell_ecc2", "mitchell_ecc3", "odma"]
MITCHELL_FAMILY = ["mitchell", "mitchell_ecc1", "mitchell_ecc2", "mitchell_ecc3"]
LARGE = (1 << 30, -(1 << 30), (1 << 31) - 1, -(1 << 31))
F2_TAPS = np.array([[1, -3, 2]])


def _f2_image(operand: int) -> np.ndarray:
    x = np.zeros((1, 3, 5), np.int64)
    x[0, 1, 2] = operand
    return x.astype(np.int32)


@pytest.mark.parametrize("operand", LARGE)
@pytest.mark.parametrize("nbits", (8, 16))
@pytest.mark.parametrize("method", METHODS)
def test_f2_input_gives_the_reference_bytes(method, nbits, operand):
    x = _f2_image(operand)
    want = np.asarray(jconv.conv2d_pass(
        jnp.asarray(x), F2_TAPS, method=method, nbits=nbits, shift=0,
        post="none", mult_impl="recurse", interpret=True))
    got = tconv.conv2d_pass(torch.from_numpy(x), F2_TAPS, method=method,
                            nbits=nbits, shift=0, post="none",
                            mult_impl="recurse")
    np.testing.assert_array_equal(got.numpy(), want)


def test_f2_first_difference_is_the_reference_zero():
    """The F2 report: mitchell at 2**30 gives 0 at out[0, 1, 1] (tap 2:
    lead = 2**31 wraps negative, so the case split takes 2m = 0); the
    int64 lane gave -2**31."""
    got = tconv.conv2d_pass(torch.from_numpy(_f2_image(1 << 30)), F2_TAPS,
                            method="mitchell", nbits=8, shift=0, post="none",
                            mult_impl="recurse")
    assert int(got[0, 1, 1]) == 0


@pytest.mark.parametrize("operand", LARGE)
@pytest.mark.parametrize("method", MITCHELL_FAMILY)
def test_fused_recurse_pass_on_large_operands(method, operand):
    """Row [1, -3, 2] at nbits 8, column [1, 2, 1] at nbits 16: the large
    operand reaches the row pass, its wrapped sums the column pass."""
    x = np.zeros((1, 4, 5), np.int64)
    x[0, 1, 2], x[0, 2, 3] = operand, 7
    x = x.astype(np.int32)
    row, col = np.array([1, -3, 2]), np.array([1, 2, 1])
    want = np.asarray(jconv.fused_separable_pass(
        jnp.asarray(x), row, col, method=method, nbits=8, nbits2=16, shift=0,
        post="none", mult_impl="recurse", interpret=True))
    got = tconv.fused_separable_pass(torch.from_numpy(x), row, col,
                                     method=method, nbits=8, nbits2=16,
                                     shift=0, post="none", mult_impl="recurse")
    np.testing.assert_array_equal(got.numpy(), want)


OPERANDS = np.array([0, 1, 3, 255, 256, 65535, 65536, 70000, 1 << 29,
                     (1 << 30) - 1, 1 << 30, (1 << 30) + 1, (1 << 30) + 777777,
                     (1 << 31) - 2, (1 << 31) - 1, -(1 << 31), -(1 << 31) + 1])


@pytest.mark.parametrize("nbits", (8, 16))
@pytest.mark.parametrize("method", METHODS)
def test_plan_products_on_large_operands(method, nbits):
    """mult(|x|, |c|) with |x| taken in int32 (|-2**31| = -2**31), from the
    plan the kernels read, against the reference's tap_multiplier."""
    coeffs = np.array([1, 2, 3, 5, 7, 100, 255] + ([12345, 65535] if nbits == 16 else []))
    mags = np.abs(OPERANDS.astype(np.int32))
    plan = rp.recurse_plan(method, coeffs, nbits)
    got = rp.plan_products(plan, torch.from_numpy(mags.astype(np.int64)))
    aa = jnp.broadcast_to(jnp.asarray(mags)[None, :], (coeffs.size, mags.size))
    cc = jnp.broadcast_to(jnp.asarray(coeffs, jnp.int32)[:, None], aa.shape)
    want = np.asarray(jkcm.tap_multiplier(method)(aa, cc, nbits))
    np.testing.assert_array_equal(got.numpy(), want)
