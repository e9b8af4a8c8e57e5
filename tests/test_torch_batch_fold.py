"""`batch_fold=True` (`repro_torch.filters.conv`): the batch folded on the
host into one tall image, each image with its own kh//2 zero rows, the
same pass run on it, then cropped, as the reference folds around its
pass. On the CPU the folded call is byte-equal to the unfolded one (the
plain versions; `chip_smoke.py` holds the same on the card), and both to
the reference's folded pass in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.filters.conv as jconv
import repro_torch.filters.conv as tconv

torch.set_num_threads(1)

TAPS = {"3x3": np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]]),
        "5x5": np.arange(25).reshape(5, 5) % 7 - 3,
        "1x3": np.array([[-1, 0, 1]]),
        "3x1": np.array([[1], [2], [1]])}


def images(n: int, h: int, w: int, seed: int = 0) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (n, h, w),
                                                                 dtype=np.int32))


@pytest.mark.parametrize("impl", ["kcm", "recurse"])
@pytest.mark.parametrize("taps", TAPS, ids=list(TAPS))
def test_folded_direct_pass_equals_the_unfolded(impl, taps):
    x = images(3, 37, 53)
    kw = dict(method="refmlm", nbits=8, shift=4, mult_impl=impl)
    got = tconv.conv2d_pass(x, TAPS[taps], batch_fold=True, **kw)
    want = tconv.conv2d_pass(x, TAPS[taps], batch_fold=False, **kw)
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("impl", ["kcm", "recurse"])
@pytest.mark.parametrize("size", [3, 5])
def test_folded_fused_pass_equals_the_unfolded(impl, size):
    row = np.arange(size) - size // 2 + 2
    col = np.ones(size, dtype=np.int64)
    x = images(4, 29, 31, seed=1)
    kw = dict(method="mitchell", nbits=8, nbits2=16, shift=4, mult_impl=impl)
    got = tconv.fused_separable_pass(x, row, col, batch_fold=True, **kw)
    want = tconv.fused_separable_pass(x, row, col, batch_fold=False, **kw)
    assert torch.equal(got, want)


def test_folded_pass_equals_the_references_fold():
    x = images(2, 16, 16, seed=2)
    taps = TAPS["3x3"]
    got = tconv.conv2d_pass(x, taps, batch_fold=True, mult_impl="kcm", shift=4)
    want = np.asarray(jconv.conv2d_pass(jnp.asarray(x.numpy()), taps, batch_fold=True,
                                        mult_impl="kcm", shift=4, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
