"""The host plans of the port's recurse conv kernels
(`repro_torch.filters.recurse_plan`) against the JAX package.

The kernels evaluate a tap product from a per-tap plan built on the host:
the pixel side split once, then only the plan's live entries (REFMLM
leaves read from packed rows and shifted into place; Mitchell stages from
the coefficient's (k2, x2)). `plan_products` evaluates products the same
way in plain PyTorch; here it is held against the reference's
`repro.core.kcm.tap_multiplier`:

  * exhaustively over every 8-bit pair (a, |c|) for every method;
  * exhaustively at nbits 2, 4 and 6 (REFMLM only at its widths 2 and 4);
  * on seeded 16-bit samples with 65535 and the powers of two;

and a plain pass built from it against the reference's recurse pass. Also:
the plan's device layout, its cache, and the rule that sends a tap shape
to the persistent kernels or to the tiled ones. The datapath is all
integers: the tolerance is zero. The CUDA kernels run only on the card,
where `chip_smoke.py` holds them against their plain versions.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.kcm as jkcm
import repro.filters.conv as jconv
import repro_torch.filters.conv as tconv
from repro.filters.bank import FILTER_BANK, get_filter
from repro_torch.filters import recurse_plan as rp

# The suite runs in several worker processes; one torch thread each keeps
# them from oversubscribing the cores.
torch.set_num_threads(1)

METHODS = ["exact", "refmlm", "refmlm_nc", "mitchell", "mitchell_ecc1",
           "mitchell_ecc2", "mitchell_ecc3", "odma"]
REFMLM = ("refmlm", "refmlm_nc")


def _reference(method: str, a: np.ndarray, mags: np.ndarray, nbits: int):
    """(len(mags), len(a)) int64: the reference's tap_multiplier(a, |c|)."""
    aa = jnp.broadcast_to(jnp.asarray(a, jnp.int32)[None, :], (mags.size, a.size))
    cc = jnp.broadcast_to(jnp.asarray(mags, jnp.int32)[:, None], (mags.size, a.size))
    return np.asarray(jkcm.tap_multiplier(method)(aa, cc, nbits)).astype(np.int64)


def _check(method: str, a: np.ndarray, coeffs: np.ndarray, nbits: int) -> None:
    plan = rp.recurse_plan(method, coeffs, nbits)
    got = rp.plan_products(plan, torch.from_numpy(a.astype(np.int64)))
    want = _reference(method, a, np.abs(coeffs), nbits)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


# ------------------------------------------------- products against the reference

@pytest.mark.parametrize("method", METHODS)
def test_plan_products_exhaustive_8bit(method):
    """All 65,536 pairs (a, |c|) of the main path's width."""
    xs = np.arange(256)
    _check(method, xs, xs, 8)


NARROW = [(m, nb) for nb in (2, 4, 6) for m in METHODS
          if m not in REFMLM or nb in (2, 4)]


@pytest.mark.parametrize("method,nbits", NARROW)
def test_plan_products_exhaustive_narrow(method, nbits):
    """Every pair at nbits 2, 4 and 6; nbits 2 is REFMLM's unmasked base."""
    xs = np.arange(1 << nbits)
    _check(method, xs, xs, nbits)


def _samples16(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Seeded 16-bit pixels and coefficients, with 0, 65535, 65534 and
    every power of two in both."""
    rng = np.random.default_rng(seed)
    edges = np.array([0, 1, 3, 65534, 65535, *(1 << k for k in range(16))])
    a = np.concatenate([rng.integers(0, 1 << 16, 1024), edges])
    c = np.concatenate([rng.integers(0, 1 << 16, 40), edges])
    return a, c


@pytest.mark.parametrize("method", METHODS)
def test_plan_products_16bit_samples(method):
    """The two-pass second pass's width; products past 2**31 wrap like the
    reference's int32 cast."""
    a, c = _samples16(seed=METHODS.index(method))
    _check(method, a, c, 16)


@pytest.mark.parametrize("method", ["refmlm", "mitchell_ecc2", "odma"])
def test_negative_coefficient_plans_its_magnitude(method):
    """A negative coefficient keeps its sign in the plan and has the
    products of |c|."""
    pos = rp.recurse_plan(method, [19, 255, 170], 8)
    neg = rp.recurse_plan(method, [-19, -255, -170], 8)
    a = torch.arange(256)
    assert torch.equal(rp.plan_products(pos, a), rp.plan_products(neg, a))
    words = rp.plan_words(neg)
    assert words[:, 0].tolist() == [-19, -255, -170]
    np.testing.assert_array_equal(words[:, 1:], rp.plan_words(pos)[:, 1:])


# ------------------------------------------------------- the plan's contents

def test_refmlm_plan_keeps_only_nonzero_digits():
    """fig9 (19 / 32 / 52) has 14 non-zero digits of 36; gaussian5's
    column (1, 4, 6, 4, 1) has 6 of 40 at 16 bits."""
    fig9 = np.array([[19, 32, 19], [32, 52, 32], [19, 32, 19]])
    plan = rp.recurse_plan("refmlm", fig9, 8)
    assert sum(len(t.leaves) for t in plan.taps) == 14
    col = get_filter("gaussian5").sep_col
    assert sum(len(t.leaves) for t in rp.recurse_plan("refmlm", col, 16).taps) == 6
    tap = rp.recurse_plan("refmlm", [19], 8).taps[0]      # 19 = digits 3, 0, 1, 0
    assert [(lf.shift, lf.digit) for lf in tap.leaves] == [(0, 3), (4, 1)]
    assert tap.leaves[0].row == 0x9630                    # efmlm2(v, 3) = 3v
    nc = rp.recurse_plan("refmlm_nc", [19], 8).taps[0]
    assert nc.leaves[0].row == 0x8630                     # mlm2(3, 3) = 8


@pytest.mark.parametrize("num_ecc", [0, 1, 2, 3])
def test_ecc_stages_end_where_the_residue_does(num_ecc):
    """mitchell_ecc{k}: at most k + 1 stages, fewer once |c|'s residue is 0."""
    for c in (1, 6, 0b1011, 255):
        stages = rp.recurse_plan(f"mitchell_ecc{num_ecc}", [c], 8).taps[0].stages
        assert len(stages) == min(num_ecc + 1, bin(c).count("1"))
        residue = c
        for st in stages:
            assert residue == (1 << st.k2) + st.x2
            residue = st.x2
    assert rp.recurse_plan("mitchell_ecc3", [0], 8).taps[0].stages == ()


def test_plan_words_layout():
    plan = rp.recurse_plan("refmlm", [[19, 0], [52, -3]], 8)
    words = rp.plan_words(plan)
    assert words.shape == (4, rp.WORDS) and words.dtype == np.int32
    assert not words.flags.writeable
    assert words[:, 1].tolist() == [2, 0, 2, 1]           # live digits a tap
    a, b = words[:, 2:2 + rp.SLOTS], words[:, 2 + rp.SLOTS:]
    assert a[0, 0] == 0x09060300                          # the row as four bytes
    assert b[0, :2].tolist() == [0, 4]                    # the digits' shifts


@pytest.mark.parametrize("method,want", [
    ("exact", [1, 0]), ("mitchell", [1, 0]), ("mitchell_ecc3", [3, 0]),
    ("odma", [1, 0]),
])
def test_plan_words_counts(method, want):
    """A zero tap has no live entry; 13 = 0b1101 has three Babic stages."""
    assert rp.plan_words(rp.recurse_plan(method, [13, 0], 8))[:, 1].tolist() == want


def test_plan_words_refuse_more_stages_than_the_kernels_hold():
    plan = rp.recurse_plan("mitchell_ecc20", [(1 << 20) - 1], 16)
    with pytest.raises(ValueError, match="stages"):
        rp.plan_words(plan)


def test_plan_cache_returns_the_same_object():
    taps = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]])
    plan = rp.recurse_plan("refmlm", taps, 8)
    assert rp.recurse_plan("refmlm", taps.tolist(), 8) is plan
    assert rp.recurse_plan("refmlm", torch.from_numpy(taps).numpy(), 8) is plan
    assert rp.plan_words(plan) is rp.plan_words(rp.recurse_plan("refmlm", taps, 8))
    assert rp.recurse_plan("refmlm", taps, 16) is not plan
    assert rp.recurse_plan("mitchell", taps, 8) is not plan


# ------------------------------------------------------------- the route rule

BANK_DIRECT = sorted({FILTER_BANK[n].taps.shape for n in FILTER_BANK}
                     | {(1, s.sep_row.size) for s in FILTER_BANK.values() if s.separable}
                     | {(s.sep_col.size, 1) for s in FILTER_BANK.values() if s.separable})


@pytest.mark.parametrize("shape", BANK_DIRECT)
def test_bank_shapes_take_the_persistent_direct_kernel(shape):
    assert tconv.kernel_route(*shape) == "persistent"


@pytest.mark.parametrize("shape", [(2, 3), (7, 5), (3, 5), (1, 7), (15, 15)])
def test_other_shapes_take_the_tiled_direct_kernel(shape):
    assert tconv.kernel_route(*shape) == "tiled"


@pytest.mark.parametrize("name", [n for n in FILTER_BANK if FILTER_BANK[n].separable])
def test_bank_separable_filters_take_the_persistent_fused_kernel(name):
    spec = FILTER_BANK[name]
    assert tconv.kernel_route(spec.sep_col.size, spec.sep_row.size,
                               fused=True) == "persistent"


@pytest.mark.parametrize("shape", [(2, 3), (7, 5), (3, 5), (5, 3), (1, 3)])
def test_other_shapes_take_the_tiled_fused_kernel(shape):
    assert tconv.kernel_route(*shape, fused=True) == "tiled"


# ------------------------------------------------------- a pass from the plan

def _plan_pass(x: np.ndarray, taps: np.ndarray, method: str, nbits: int,
               shift: int, post: str) -> np.ndarray:
    """The direct pass with every product from the plan: per tap,
    sgn(t) * sgn(c) * plan product, zero padding, a wrapping int32 sum."""
    kh, kw = taps.shape
    n, h, w = x.shape
    plan = rp.recurse_plan(method, taps, nbits)
    padded = np.pad(x.astype(np.int64), ((0, 0), (kh // 2, kh - 1 - kh // 2),
                                         (kw // 2, kw - 1 - kw // 2)))
    acc = torch.zeros(x.shape, dtype=torch.int64)
    for t, (di, dj) in enumerate(itertools.product(range(kh), range(kw))):
        view = torch.from_numpy(padded[:, di:di + h, dj:dj + w].copy())
        one = rp.RecursePlan(plan.method, plan.family, plan.num_ecc, nbits,
                             (plan.taps[t],))
        prod = rp.plan_products(one, view.abs())[0].to(torch.int64)
        acc += int(np.sign(taps.flat[t])) * torch.sign(view) * prod
    return tconv.apply_post(tconv.wrap_int32(acc), post=post, shift=shift).numpy()


PASS_CASES = [(m, "sharpen3") for m in METHODS] + [
    ("refmlm", "fig9"), ("mitchell_ecc2", "fig9"), ("odma", "odd7x5")]


def _pass_taps(name: str) -> tuple[np.ndarray, int, str]:
    if name == "fig9":
        return np.array([[19, 32, 19], [32, 52, 32], [19, 32, 19]]), 8, "clip"
    if name == "odd7x5":
        return np.random.default_rng(3).integers(-20, 21, (7, 5)), 6, "clip"
    spec = get_filter(name)
    return np.asarray(spec.taps, np.int64), spec.shift, spec.post


@pytest.mark.parametrize("method,name", PASS_CASES)
def test_plan_pass_matches_the_reference_pass(method, name):
    """The pass built from plans equals the reference's recurse pass (its
    Pallas kernel in interpret mode) on 8-bit pixels."""
    taps, shift, post = _pass_taps(name)
    x = np.random.default_rng(5).integers(0, 256, (1, 9, 11)).astype(np.int32)
    want = np.asarray(jconv.conv2d_pass(
        jnp.asarray(x), taps, method=method, nbits=8, shift=shift, post=post,
        mult_impl="recurse"))
    np.testing.assert_array_equal(_plan_pass(x, taps, method, 8, shift, post), want)


@pytest.mark.parametrize("method", ["refmlm", "refmlm_nc", "mitchell_ecc3", "odma"])
def test_plan_pass_16bit_signed_second_pass(method):
    """The two-pass second pass: signed row sums up to +-4080 at nbits=16
    through gaussian5's column, against the reference's recurse pass (its
    Pallas kernel in interpret mode) and the port's plain one."""
    x = np.random.default_rng(6).integers(-4080, 4081, (2, 8, 5)).astype(np.int32)
    col = get_filter("gaussian5").sep_col.astype(np.int64)[:, None]
    want = np.asarray(jconv.conv2d_pass(
        jnp.asarray(x), col, method=method, nbits=16, shift=8, post="clip",
        mult_impl="recurse"))
    got = _plan_pass(x, col, method, 16, 8, "clip")
    np.testing.assert_array_equal(got, want)
    plain = tconv.conv_pass_recurse_plain(torch.from_numpy(x), col, method=method,
                                          nbits=16, shift=8, post="clip")
    np.testing.assert_array_equal(got, plain.numpy())
