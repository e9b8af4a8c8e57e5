"""Parity of the port's entry points (`repro_torch.filters.pipeline`,
`repro_torch.kernels.ops`) with the JAX package, byte for byte, and the
port's package boundary.

The JAX side runs its Pallas passes in interpret mode on the CPU, as the
JAX package's own tests do; the port runs its plain versions, asked for
with `device="cpu"`. Tolerance zero throughout.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.images as jimages
import repro.filters as jfilters
import repro.filters.bank as jbank
import repro.kernels.ops as jops
import repro.tuning.plans as jplans
import repro_torch.data.images as timages
import repro_torch.filters as tfilters
import repro_torch.filters.bank as tbank
import repro_torch.kernels.ops as tops
import repro_torch.tuning.plans as tplans
from repro.filters.ref import apply_filter_ref
from repro_torch.convert import from_reference_spec

# The suite runs in several worker processes; one torch thread each keeps
# them from oversubscribing the cores.
torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
NAMES = jbank.FILTER_NAMES


def _frames(n=2, hw=(13, 21), noise=20):
    return np.stack([jimages.add_salt_pepper(jimages.fingerprint(hw, seed=5 + i),
                                             noise, seed=9 + i)
                     for i in range(n)]).astype(np.int32)


@pytest.mark.parametrize("name", NAMES)
def test_apply_filter_matches_reference_every_layout(name):
    """(H, W), (N, H, W) and (N, H, W, 1) through the default plan."""
    batch = _frames()
    for x in (batch[0], batch, batch[..., None]):
        want = np.asarray(jfilters.apply_filter(jnp.asarray(x), name,
                                                method="refmlm"))
        got = tfilters.apply_filter(x, name, method="refmlm", device="cpu")
        assert got.dtype == torch.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(x.shape))


def test_filter_bank_apply_matches_reference():
    batch = _frames()
    want = jfilters.filter_bank_apply(jnp.asarray(batch), method="refmlm")
    got = tfilters.filter_bank_apply(batch, method="refmlm", device="cpu")
    assert tuple(got) == tuple(want) == NAMES
    for name in NAMES:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))


@pytest.mark.parametrize("name", NAMES)
def test_apply_filter_batch_with_padding_matches_reference(name):
    imgs = list(_frames(n=3))
    want = jfilters.apply_filter_batch(imgs, name, pad_to=4, method="refmlm")
    got = tfilters.apply_filter_batch(imgs, name, pad_to=4, method="refmlm",
                                      device="cpu")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_gaussian_filter_matches_reference_table10_multipliers():
    """The legacy Fig. 9 entry point, each multiplier of Table 10."""
    kern = jops.gaussian_kernel_3x3(sigma=1.0, scale=256)
    np.testing.assert_array_equal(tops.gaussian_kernel_3x3(sigma=1.0,
                                                           scale=256), kern)
    noisy = _frames(n=1, hw=(17, 19), noise=30)[0]
    for method in ("exact", "refmlm", "mitchell", "odma", "mitchell_ecc3"):
        want = np.asarray(jops.gaussian_filter(jnp.asarray(noisy),
                                               jnp.asarray(kern), method=method))
        got = tops.gaussian_filter(noisy, kern, method=method, device="cpu")
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want, err_msg=method)


@pytest.mark.parametrize("name", NAMES)
def test_refmlm_bytes_equal_exact_bytes(name):
    """The paper's claim, on every dataflow and both tap-product paths."""
    batch = _frames(hw=(16, 24))
    spec = tbank.get_filter(name)
    plans = [dict()] + ([dict(separable=False), dict(fused=False)]
                        if spec.separable else [])
    for plan in plans:
        for impl in ("kcm", "recurse"):
            kw = dict(mult_impl=impl, device="cpu", **plan)
            exact = tfilters.apply_filter(batch, name, method="exact", **kw)
            ref = tfilters.apply_filter(batch, name, method="refmlm", **kw)
            assert torch.equal(ref, exact), (plan, impl)


def test_filter_bank_matches_reference():
    assert tbank.FILTER_NAMES == jbank.FILTER_NAMES
    for name in NAMES:
        t, j = tbank.FILTER_BANK[name], jbank.FILTER_BANK[name]
        assert (t.name, t.shift, t.post, t.ksize, t.separable) == (
            j.name, j.shift, j.post, j.ksize, j.separable)
        np.testing.assert_array_equal(t.taps, j.taps)
        if j.separable:
            np.testing.assert_array_equal(t.sep_row, j.sep_row)
            np.testing.assert_array_equal(t.sep_col, j.sep_col)
        assert tbank.max_intermediate(t) == jbank.max_intermediate(j)
    for ktaps, sigma in ((3, 1.0), (5, 1.0), (5, 1.4), (7, 2.0)):
        np.testing.assert_array_equal(
            tbank.gaussian_kernel_1d(ktaps, sigma, 16),
            jbank.gaussian_kernel_1d(ktaps, sigma, 16))


@pytest.mark.parametrize("method", ["refmlm", "mitchell"])
def test_from_reference_spec_runs_reference_specs(method):
    """Every bank spec and sigma=1.4 re-samplings, carried across with
    `from_reference_spec`, give the reference oracle's bytes."""
    batch = _frames(hw=(12, 14))
    specs = [*jbank.FILTER_BANK.values(),
             jbank.get_filter("gaussian3", sigma=1.4),
             jbank.get_filter("gaussian5", sigma=1.4)]
    for spec in specs:
        port_spec = from_reference_spec(*spec)
        assert port_spec.separable == spec.separable
        want = np.asarray(apply_filter_ref(jnp.asarray(batch), spec,
                                           method=method))
        got = tfilters.apply_filter(batch, port_spec, method=method,
                                    device="cpu").numpy()
        np.testing.assert_array_equal(got, want, err_msg=spec.name)
    np.testing.assert_array_equal(
        from_reference_spec(*jbank.get_filter("gaussian5", sigma=1.4)).taps,
        tbank.get_filter("gaussian5", sigma=1.4).taps)


def test_images_match_reference():
    for hw, seed in (((13, 21), 0), ((32, 17), 7)):
        base = jimages.fingerprint(hw, seed=seed)
        np.testing.assert_array_equal(timages.fingerprint(hw, seed=seed), base)
        for pct in (10, 40):
            np.testing.assert_array_equal(
                timages.add_salt_pepper(base, pct, seed=11),
                jimages.add_salt_pepper(base, pct, seed=11))
        noisy = jimages.add_salt_pepper(base, 20, seed=3)
        assert timages.psnr(base, noisy) == jimages.psnr(base, noisy)


def test_plan_resolution_matches_reference_defaults():
    for sep_ok in (True, False):
        for separable in (None, True, False):
            for fused in (None, True, False):
                assert (tplans.allowed_dataflows(sep_ok, separable, fused)
                        == jplans.allowed_dataflows(sep_ok, separable, fused))
    # with no shape only the dataflow and mult_impl resolve (the grid is
    # keyed on the shape); with one, the CPU backend's plan is the
    # reference's cache-miss plan, grid included
    assert tfilters.resolve_filter_plan("gaussian5") == tplans.PlanConfig("fused", "kcm")
    assert tfilters.resolve_filter_plan("sharpen3") == tplans.PlanConfig("direct", "kcm")
    assert tfilters.resolve_filter_plan(
        "sobel_x", fused=False, mult_impl="recurse") == tplans.PlanConfig("two_pass", "recurse")
    for name, shape in (("gaussian5", (2, 40, 48)), ("sobel_x", (1, 300, 600))):
        got = tfilters.resolve_filter_plan(name, *shape, device="cpu")
        want = jfilters.resolve_filter_plan(name, *shape)
        assert tuple(got) == tuple(want), name


def test_port_imports_neither_jax_nor_repro():
    code = ("import sys\n"
            "import repro_torch, repro_torch.convert, repro_torch.data.images\n"
            "import repro_torch.filters, repro_torch.filters.ref\n"
            "import repro_torch.kernels.ops, repro_torch.tuning\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_entry_points_raise_without_a_card(monkeypatch):
    """No card and no explicit device: raise, never a quiet CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = _frames(n=1)[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfilters.apply_filter(img, "gaussian3")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.gaussian_filter(img, tops.gaussian_kernel_3x3())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfilters.apply_filter(img, "gaussian3", device="cuda")


def test_unported_exec_modes_raise():
    """The scale-out modes run and give the local bytes (`exec='streamed'`
    as a NumPy array); a bad mode, or a mode's arguments under another,
    raise."""
    img = _frames(n=1)[0]
    want = tfilters.apply_filter(img, "gaussian3", device="cpu")
    got = tfilters.apply_filter(img, "gaussian3", exec="sharded", devices=2, device="cpu")
    assert torch.equal(got, want)
    got = tfilters.apply_filter(img, "gaussian3", exec="streamed", tile=(8, 8), device="cpu")
    np.testing.assert_array_equal(got, want.numpy())
    with pytest.raises(ValueError, match="streamed-mode"):
        tfilters.apply_filter(img, "gaussian3", exec="sharded", tile=(8, 8), device="cpu")
    with pytest.raises(ValueError, match="sharded-mode"):
        tfilters.apply_filter(img, "gaussian3", exec="streamed", devices=2, device="cpu")
    with pytest.raises(ValueError, match="exec"):
        tfilters.apply_filter(img, "gaussian3", exec="remote", device="cpu")
    with pytest.raises(ValueError, match="separable"):
        tfilters.apply_filter(img, "sharpen3", separable=True, device="cpu")
