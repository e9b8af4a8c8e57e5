"""Parity of the port's conv passes (`repro_torch.filters.conv`) with the
JAX package, byte for byte.

  * `conv2d_pass` / `fused_separable_pass` on the CPU against the Pallas
    passes (interpret mode, as the JAX package's own tests run them), kcm
    and recurse, on odd shapes smaller than any tile;
  * a broad sweep of every bank filter x multiplier x dataflow x mult_impl
    against the reference's plain jnp oracle `apply_filter_ref`;
  * the plain versions beside each kernel against the port's own oracle.

The datapath is all integers: the tolerance is zero. The CUDA kernels
themselves run only on the card, where `chip_smoke.py` holds each against
its plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.filters.conv as jconv
import repro.filters.ref as jref
import repro_torch.filters.conv as tconv
import repro_torch.filters.ref as tref
from repro.data.images import fingerprint
from repro.filters.bank import FILTER_BANK, FILTER_NAMES, get_filter
from repro_torch.filters.pipeline import apply_filter
from repro_torch.kernels import build

# The suite runs in several worker processes; one torch thread each keeps
# them from oversubscribing the cores.
torch.set_num_threads(1)

SWEEP_METHODS = ["exact", "refmlm", "refmlm_nc", "mitchell", "mitchell_ecc3",
                 "odma"]
SEPARABLE = [n for n in FILTER_NAMES if FILTER_BANK[n].separable]


def _batch(shape, seed=0, lo=0, hi=256):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(np.int32)


def _fingerprints(n=2, hw=(15, 17)):
    return np.stack([fingerprint(hw, seed=3 + i) for i in range(n)]).astype(np.int32)


def _port(fn, x, *args, **kw):
    return fn(torch.from_numpy(x), *args, **kw).numpy()


# ------------------------------------------- the passes against Pallas (CPU)

# (mult_impl, method, shape): each impl sees both shapes, several methods
PASS_CASES = [
    ("kcm", "refmlm", (2, 13, 21)), ("kcm", "odma", (1, 7, 5)),
    ("recurse", "refmlm", (1, 7, 5)), ("recurse", "mitchell", (2, 13, 21)),
]
FUSED_CASES = [
    ("kcm", "refmlm", (2, 13, 21)), ("kcm", "mitchell", (1, 7, 5)),
    ("recurse", "refmlm", (1, 7, 5)), ("recurse", "mitchell", (2, 13, 21)),
]


@pytest.mark.parametrize("impl,method,shape", PASS_CASES)
def test_conv2d_pass_matches_pallas(impl, method, shape):
    """Direct pass on sharpen3 (negative and zero taps)."""
    x = _batch(shape, seed=1)
    kw = dict(method=method, nbits=8, shift=5, post="clip", mult_impl=impl)
    taps = get_filter("sharpen3").taps
    want = np.asarray(jconv.conv2d_pass(jnp.asarray(x), taps, **kw))
    np.testing.assert_array_equal(_port(tconv.conv2d_pass, x, taps, **kw), want)


@pytest.mark.parametrize("impl,method", [("kcm", "mitchell"),
                                         ("recurse", "refmlm")])
def test_conv2d_pass_16bit_signed_matches_pallas(impl, method):
    """The two_pass second pass: signed inputs up to +-4080 at nbits=16."""
    x = _batch((1, 7, 5), seed=2, lo=-4080, hi=4081)
    kw = dict(method=method, nbits=16, shift=8, post="clip", mult_impl=impl)
    col = np.array([[4], [8], [4]])
    want = np.asarray(jconv.conv2d_pass(jnp.asarray(x), col, **kw))
    np.testing.assert_array_equal(_port(tconv.conv2d_pass, x, col, **kw), want)


@pytest.mark.parametrize("impl,method,shape", FUSED_CASES)
def test_fused_separable_pass_matches_pallas(impl, method, shape):
    """Fused pass on gaussian5: 8-bit row pass, 16-bit column pass."""
    x = _batch(shape, seed=4)
    spec = get_filter("gaussian5")
    kw = dict(method=method, nbits=8, nbits2=16, shift=8, post="clip",
              mult_impl=impl)
    want = np.asarray(jconv.fused_separable_pass(
        jnp.asarray(x), spec.sep_row, spec.sep_col, **kw))
    got = _port(tconv.fused_separable_pass, x, spec.sep_row, spec.sep_col, **kw)
    np.testing.assert_array_equal(got, want)


def test_apply_post_matches_reference_at_int32_edges():
    acc = np.array([[-(1 << 31), -(1 << 31) + 1, -300, -1, 0, 1, 127, 128,
                     255, 256, 70000, (1 << 31) - 200, (1 << 31) - 1]],
                   np.int32)
    for post in ("none", "clip", "abs"):
        for shift in (0, 1, 5, 8):
            want = np.asarray(jconv.apply_post(jnp.asarray(acc), post=post,
                                               shift=shift))
            got = tconv.apply_post(torch.from_numpy(acc), post=post,
                                   shift=shift).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{post} {shift}")


def test_second_pass_nbits_matches_reference():
    for need in (0, 3, 4, 15, 16, 255, 256, 4080, 65535):
        assert tconv.second_pass_nbits(need, 1) == jconv.second_pass_nbits(need, 1)
    with pytest.raises(ValueError, match="16-bit"):
        tconv.second_pass_nbits(1 << 16, 1)


# ------------------------- broad sweep against the reference's plain oracle

@pytest.mark.parametrize("method", SWEEP_METHODS)
@pytest.mark.parametrize("name", FILTER_NAMES)
def test_every_filter_dataflow_and_impl_matches_oracle(name, method):
    """direct, two_pass and fused, each with kcm and recurse, against the
    reference's `apply_filter_ref` on fingerprint inputs."""
    x = _fingerprints()
    spec = FILTER_BANK[name]
    want_direct = np.asarray(jref.apply_filter_ref(
        jnp.asarray(x), name, method=method, separable=False))
    plans = [dict(separable=False)]
    if spec.separable:
        want_sep = np.asarray(jref.apply_filter_ref(
            jnp.asarray(x), name, method=method, separable=True))
        plans += [dict(fused=False), dict(fused=True)]
    for plan in plans:
        want = want_direct if plan.get("separable") is False else want_sep
        for impl in ("kcm", "recurse"):
            got = apply_filter(x, name, method=method, mult_impl=impl,
                               device="cpu", **plan).numpy()
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, want, err_msg=f"{plan} {impl}")


# ------------------------------- plain versions against the port's oracle

@pytest.mark.parametrize("method", SWEEP_METHODS)
def test_plain_passes_match_port_oracle(method):
    """Each kernel's plain version against `repro_torch.filters.ref`, on
    8-bit pixels and on a signed 16-bit second-pass input."""
    x = torch.from_numpy(_batch((2, 9, 11), seed=5))
    signed = torch.from_numpy(_batch((2, 9, 11), seed=6, lo=-4080, hi=4081))
    for name in ("sharpen3", "laplacian", "gaussian5"):
        spec = FILTER_BANK[name]
        kh, kw = spec.taps.shape
        want = tref.conv2d_ref(x, spec.taps, method=method, nbits=8,
                               shift=spec.shift, post=spec.post)
        rom = tconv.rom_stack(method, spec.taps.astype(np.int64), 8, x.device)
        assert torch.equal(tconv.conv_pass_kcm_plain(
            x, rom, kh, kw, shift=spec.shift, post=spec.post), want), name
        assert torch.equal(tconv.conv_pass_recurse_plain(
            x, spec.taps.astype(np.int64), method=method, nbits=8,
            shift=spec.shift, post=spec.post), want), name
    col = np.array([[1], [-2], [1]])
    want = tref.conv2d_ref(signed, col, method=method, nbits=16, shift=0,
                           post="none")
    rom = tconv.rom_stack(method, col, 16, x.device)
    assert torch.equal(tconv.conv_pass_kcm_plain(signed, rom, 3, 1, shift=0,
                                                 post="none"), want)
    assert torch.equal(tconv.conv_pass_recurse_plain(
        signed, col, method=method, nbits=16, shift=0, post="none"), want)
    for name in SEPARABLE:
        spec = FILTER_BANK[name]
        row, colv = spec.sep_row.astype(np.int64), spec.sep_col.astype(np.int64)
        want = tref.conv2d_ref(
            tref.conv2d_ref(x, row[None], method=method, nbits=8, shift=0,
                            post="none"),
            colv[:, None], method=method, nbits=16, shift=spec.shift,
            post=spec.post)
        got_kcm = tconv.fused_separable_kcm_plain(
            x, tconv.rom_stack(method, row, 8, x.device),
            tconv.rom_stack(method, colv, 16, x.device), shift=spec.shift,
            post=spec.post)
        got_rec = tconv.fused_separable_recurse_plain(
            x, row, colv, method=method, nbits=8, nbits2=16, shift=spec.shift,
            post=spec.post)
        assert torch.equal(got_kcm, want) and torch.equal(got_rec, want), name


def test_port_oracle_matches_reference_oracle():
    x = _fingerprints(n=1, hw=(11, 9))
    for name in ("sharpen3", "sobel_y"):
        want = np.asarray(jref.apply_filter_ref(jnp.asarray(x), name,
                                                method="refmlm_nc"))
        got = tref.apply_filter_ref(torch.from_numpy(x), name,
                                    method="refmlm_nc").numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_kcm_operand_beyond_rom_gives_the_reference_fill():
    """|x| >= 2**nbits gathers the reference's `jnp.take` fill, the int16
    stack's minimum, summed in its int16 carry, as the Pallas pass does."""
    x = torch.tensor([[[300, 5]]], dtype=torch.int32)
    rom = tconv.rom_stack("exact", np.array([[1, 1]]), 8, x.device)
    assert (rom.fill, rom.carry_bits) == (-(1 << 15), 16)
    got = tconv.conv_pass_kcm_plain(x, rom, 1, 2, shift=0, post="none")
    want = np.asarray(jconv.conv2d_pass(jnp.asarray(x.numpy()), np.array([[1, 1]]),
                                        method="exact", nbits=8, shift=0, post="none",
                                        mult_impl="kcm", interpret=True))
    assert got.tolist() == want.tolist() == [[[-32768, -32763]]]


# ----------------------------------------------------- wrappers and build

def test_wrappers_raise_on_devices_without_a_kernel():
    """A wrapper takes its plain version only for CPU tensors; any other
    device gets the kernel or an error, never a fallback."""
    x = torch.zeros((1, 4, 4), dtype=torch.int32, device="meta")
    rom = tconv.RomStack(torch.zeros((9, 256), dtype=torch.int32, device="meta"),
                         -(1 << 15), 0, 256)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tconv.conv_pass_kcm(x, rom, 3, 3, shift=0, post="none")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tconv.conv_pass_recurse(x, np.ones((3, 3), np.int64), method="refmlm",
                                nbits=8, shift=0, post="none")
    assert all(v == 0 for v in tconv.LAUNCHES.values())


def test_bad_arguments_raise():
    x = torch.zeros((1, 4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="mult_impl"):
        tconv.conv2d_pass(x, np.ones((3, 3)), mult_impl="rom")
    with pytest.raises(ValueError, match="post"):
        tconv.conv2d_pass(x, np.ones((3, 3)), post="relu")
    with pytest.raises(ValueError, match="nbits"):
        tconv.conv2d_pass(x, np.ones((3, 3)), nbits=6, mult_impl="recurse")
    with pytest.raises(ValueError, match="N, H, W"):
        tconv.conv2d_pass(x[0], np.ones((3, 3)))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


def test_source_digest_covers_every_source():
    names = {p.name for p in build.CSRC.iterdir()}
    assert {f"{s}.cu" for s in build.SOURCES} <= names
    assert len(build.source_digest()) == 16
