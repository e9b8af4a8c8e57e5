"""Parity of the port's quantized-matmul path with the JAX package, byte for
byte.

  * the two raw kernels (`mitchell_matmul_kernel`, `karatsuba_matmul_kernel`)
    on the CPU, where their wrappers run the plain versions, against the
    Pallas kernels in interpret mode (as `tests/test_matmul_impl.py` runs
    them) and the reference's jnp oracles, over every variant, on ragged
    shapes, with quantized-range and full-range int32 operands;
  * `matmul` for every method x impl against the reference's
    impl='reference' / 'pallas', a batched (3, 4, K) lhs included;
  * the limb kernel's route on the card as a plain function
    (`karatsuba_matmul_i8.select_route`): int8 limbs, and for Karatsuba
    hi + lo in int8 too, take the int8 tensor-core kernel, all else the
    wide one; CPU limbs take the plain version either way;
  * `lns_matmul` / `limb_matmul` against the reference's entry points run
    op by op (under `jax.jit` XLA refolds their float32 scale constants, a
    last-bit difference held to rtol 5e-7), and the `quant`, `lns` and
    `karatsuba` modules, including the w=7 saturation cases of
    tests/test_quant_edges.py.

Integer outputs, and float outputs rescaled from them, are compared with
zero tolerance. The reference route sums LNS products in float32, exact for
K <= 256 at 8 bits, so its cases keep K there. The float32 'exact' method is
a torch.matmul against an XLA matmul, whose sums may be ordered differently:
rtol 1e-5. The CUDA kernels run only on the card, where `chip_smoke.py`
holds each against its plain version.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.approx_matmul as jam
import repro.kernels.ops as jops
import repro.kernels.ref as jref
import repro_torch.core.approx_matmul as tam
import repro_torch.kernels.ops as tops
import repro_torch.kernels.ref as tref
from repro.kernels.gaussian_conv import gaussian_kernel_3x3
from repro.kernels.karatsuba_matmul import karatsuba_matmul_kernel as j_karatsuba
from repro.kernels.mitchell_matmul import mitchell_matmul_kernel as j_mitchell
from repro_torch.kernels import build
from repro_torch.kernels import karatsuba_matmul as tkm
from repro_torch.kernels import karatsuba_matmul_i8 as tkm8
from repro_torch.kernels import mitchell_matmul as tmm

# The suite runs in several worker processes; one torch thread each keeps
# them from oversubscribing the cores.
torch.set_num_threads(1)

# `repro.core` and `repro_torch.core` re-export functions named like their
# modules, so the modules are fetched by name.
jquant, jlns, jkar, jrefmlm = (importlib.import_module(f"repro.core.{m}")
                               for m in ("quant", "lns", "karatsuba", "refmlm"))
tquant, tlns, tkar, trefmlm = (importlib.import_module(f"repro_torch.core.{m}")
                               for m in ("quant", "lns", "karatsuba", "refmlm"))

RNG = np.random.default_rng(7)
A = RNG.standard_normal((5, 19)).astype(np.float32)
B = RNG.standard_normal((19, 11)).astype(np.float32)
A3 = RNG.standard_normal((3, 4, 19)).astype(np.float32)
QUANTIZED = [m for m in tam.METHODS if m != "exact"]
LNS_VARIANTS = [(0, True), (1, False), (2, False), (3, False), (0, False), (2, True)]
# (shape, operand range): ragged shapes, smaller than and across the
# reference's tiles, with 8-bit quantized and full-range int32 operands
RAW_CASES = [((5, 19, 11), 256), ((17, 40, 33), 256), ((9, 33, 17), 1 << 31)]


def _ints(shape, bound, seed):
    return np.random.default_rng(seed).integers(-bound, bound, shape,
                                                dtype=np.int64).astype(np.int32)


def _pad(x, rows, cols):
    return jnp.asarray(np.pad(x, ((0, -x.shape[0] % rows), (0, -x.shape[1] % cols))))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------ raw kernels

@pytest.mark.parametrize("num_ecc,case_split", LNS_VARIANTS)
@pytest.mark.parametrize("shape,bound", RAW_CASES)
def test_mitchell_matmul_matches_pallas_and_oracle(shape, bound, num_ecc,
                                                   case_split):
    m, k, n = shape
    a, b = _ints((m, k), bound, 1), _ints((k, n), bound, 2)
    a[0, :3] = (0, -bound, 1)                # a zero, the range's edge, a one
    kw = dict(num_ecc=num_ecc, case_split=case_split)
    got = tmm.mitchell_matmul_kernel(_t(a), _t(b), **kw)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    pallas = j_mitchell(_pad(a, 8, 16), _pad(b, 16, 16), block_m=8, block_n=16,
                        block_k=16, interpret=True, **kw)
    oracle = jref.mitchell_matmul_ref(jnp.asarray(a), jnp.asarray(b), **kw)
    assert np.array_equal(got.numpy(), np.asarray(pallas)[:m, :n])
    assert np.array_equal(got.numpy(), np.asarray(oracle))
    assert np.array_equal(tref.mitchell_matmul_ref(_t(a), _t(b), **kw).numpy(),
                          got.numpy())


@pytest.mark.parametrize("karatsuba", [True, False])
@pytest.mark.parametrize("shape,bound", [((5, 19, 11), 128), ((17, 40, 33), 64),
                                         ((9, 33, 17), 1 << 31)])
def test_karatsuba_matmul_matches_pallas_and_oracle(shape, bound, karatsuba):
    m, k, n = shape
    limbs = [_ints(s, bound, 3 + i) for i, s in enumerate(((m, k), (m, k),
                                                           (k, n), (k, n)))]
    got = tkm.karatsuba_matmul_kernel(*map(_t, limbs), karatsuba=karatsuba)
    pallas = j_karatsuba(*(_pad(x, 8 if i < 2 else 16, 16) for i, x in enumerate(limbs)),
                         karatsuba=karatsuba, block_m=8, block_n=16, block_k=16,
                         interpret=True)
    oracle = jref.karatsuba_matmul_ref(*map(jnp.asarray, limbs), karatsuba=karatsuba)
    for g, p, o in zip(got, pallas, oracle):
        assert g.dtype == torch.int32 and g.shape == (m, n)
        assert np.array_equal(g.numpy(), np.asarray(p)[:m, :n])
        assert np.array_equal(g.numpy(), np.asarray(o))


def test_limb_partials_reconstruct_the_product():
    """hh 2^2w + mid 2^w + ll == a @ b for balanced limbs (both modes)."""
    a, b = _ints((6, 30), 8000, 5), _ints((30, 7), 8000, 6)
    want = a.astype(np.int64) @ b.astype(np.int64)
    for kar, w in ((True, 7), (False, 8)):
        ah, al = tquant.balanced_limbs(_t(a), w)
        bh, bl = tquant.balanced_limbs(_t(b), w)
        hh, mid, ll = (x.numpy().astype(np.int64) for x in
                       tkm.karatsuba_matmul_kernel(ah, al, bh, bl, karatsuba=kar))
        assert np.array_equal((hh << (2 * w)) + (mid << w) + ll, want)


def test_int_matmul_wraps_like_int32():
    a, b = _ints((4, 9), 1 << 31, 7), _ints((9, 3), 1 << 31, 8)
    want = (a.astype(np.int64) @ b.astype(np.int64)).astype(np.int32)
    assert np.array_equal(tkm.int_matmul(_t(a), _t(b)).numpy(), want)


def test_empty_and_degenerate_shapes():
    a = torch.zeros((0, 5), dtype=torch.int32)
    assert tmm.mitchell_matmul_kernel(a, torch.ones((5, 3), dtype=torch.int32)).shape == (0, 3)
    z = torch.zeros((2, 0), dtype=torch.int32)
    out = tmm.mitchell_matmul_kernel(z, torch.zeros((0, 4), dtype=torch.int32))
    assert out.shape == (2, 4) and not out.any()
    hh, mid, ll = tkm.karatsuba_matmul_kernel(z, z, torch.zeros((0, 4), dtype=torch.int32),
                                              torch.zeros((0, 4), dtype=torch.int32))
    assert hh.shape == mid.shape == ll.shape == (2, 4)


def test_wrappers_raise_on_devices_without_a_kernel():
    """A wrapper takes its plain version only for CPU tensors; any other
    device gets the kernel or an error, never a fallback."""
    a = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    b = torch.zeros((3, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tmm.mitchell_matmul_kernel(a, b)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tkm.karatsuba_matmul_kernel(a, a, b, b)
    assert tmm.LAUNCHES == {"mitchell_matmul": 0}
    assert tkm.LAUNCHES == {"karatsuba_matmul": 0}


def test_bad_operands_raise():
    a = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        tmm.mitchell_matmul_kernel(a.float(), a.T.contiguous())
    with pytest.raises(ValueError, match="inner dimensions"):
        tmm.mitchell_matmul_kernel(a, a)
    with pytest.raises(ValueError, match="num_ecc"):
        tmm.mitchell_matmul_kernel(a, a.T.contiguous(), num_ecc=-1)
    with pytest.raises(ValueError, match="same shape"):
        tkm.karatsuba_matmul_kernel(a, a[:1], a.T.contiguous(), a.T.contiguous())


def test_build_lists_both_matmul_sources():
    assert {"mitchell_matmul", "karatsuba_matmul"} <= set(build.SOURCES)
    names = {p.name for p in build.CSRC.iterdir()}
    assert {"mitchell_matmul.cu", "karatsuba_matmul.cu"} <= names


# -------------------------------------------------------------- matmul API

_JAX_CACHE: dict = {}


def _jax_matmul(a, method, impl):
    key = (a.shape, method, impl)
    if key not in _JAX_CACHE:
        kw = {"interpret": True} if impl == "pallas" else {}
        _JAX_CACHE[key] = np.asarray(jam.matmul(a, B, method, impl=impl, **kw))
    return _JAX_CACHE[key]


@pytest.mark.parametrize("impl", tam.IMPLS)
@pytest.mark.parametrize("method", QUANTIZED)
@pytest.mark.parametrize("lhs", ["2d", "batched"])
def test_matmul_matches_reference(lhs, method, impl):
    a = A if lhs == "2d" else A3
    got = tam.matmul(a, B, method, impl=impl, device="cpu").numpy()
    want = _jax_matmul(a, method, "pallas" if impl == "kernel" else "reference")
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("impl", tam.IMPLS)
def test_exact_matmul_within_float32_rounding(impl):
    for a in (A, A3):
        got = tam.matmul(a, B, "exact", impl=impl, device="cpu").numpy()
        np.testing.assert_allclose(got, _jax_matmul(a, "exact", "reference"),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", tam.KERNEL_LNS_METHODS)
def test_lns_routes_agree_up_to_k_256_and_kernel_is_exact_beyond(method):
    """At 8 bits the reference's float32 sums are exact up to K = 256, where
    the kernel route gives the same bytes; past it the kernel route still
    equals the reference's Pallas route (both rescale exact int32 sums)."""
    rng = np.random.default_rng(11)
    b = rng.standard_normal((300, 6)).astype(np.float32)
    a = rng.standard_normal((4, 300)).astype(np.float32)
    for impl in ("reference", "kernel"):
        got = tam.matmul(a[:, :256], b[:256], method, impl=impl, device="cpu")
        want = jam.matmul(a[:, :256], b[:256], method, impl="reference")
        assert np.array_equal(got.numpy(), np.asarray(want))
    got = tam.matmul(a, b, method, impl="kernel", device="cpu")
    want = jam.matmul(a, b, method, impl="pallas", interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_impl_resolution():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tam.resolve_impl("auto", "mitchell", cpu) == "reference"
    assert tam.resolve_impl("auto", "mitchell", cuda) == "kernel"
    assert tam.resolve_impl("kernel", "karatsuba_int16", cpu) == "kernel"
    for method in ("exact", "int8", "odma", "refmlm", "refmlm_kom3"):
        assert tam.resolve_impl("kernel", method, cuda) == "reference"
    with pytest.raises(ValueError, match="impl must be one of"):
        tam.matmul(A, B, "mitchell", impl="pallas", device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        tam.matmul(A, B, "booth", device="cpu")
    assert tam.METHODS == jam.METHODS


def test_matmul_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tam.matmul(A, B, "mitchell")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.lns_matmul(A, B)


@pytest.mark.parametrize("method", [m for m in tam.METHODS
                                    if m not in ("exact", "int8")
                                    and not m.endswith("int16")])
def test_scalar_multiplier_matches_reference(method):
    xs = np.arange(256, dtype=np.int32)
    a, b = np.repeat(xs, 256), np.tile(xs, 256)
    got = tam.scalar_multiplier(method, 8)(_t(a), _t(b))
    want = jam.scalar_multiplier(method, 8)(jnp.asarray(a), jnp.asarray(b))
    assert np.array_equal(got.numpy().astype(np.int64), np.asarray(want).astype(np.int64))


# ---------------------------------------------------- float-in entry points

def _jax_op_by_op(fn, *args, **kw):
    """The reference's jitted entry point run op by op, i.e. with the float32
    arithmetic its source states (under jit XLA may refold the scales)."""
    with jax.disable_jit():
        return np.asarray(fn(*args, interpret=True, **kw))


@pytest.mark.parametrize("num_ecc,case_split", LNS_VARIANTS[:4])
def test_lns_matmul_matches_reference(num_ecc, case_split):
    kw = dict(num_ecc=num_ecc, case_split=case_split)
    got = tops.lns_matmul(A, B, device="cpu", **kw).numpy()
    assert np.array_equal(got, _jax_op_by_op(jops.lns_matmul, A, B, **kw))
    # the jitted reference rounds its rescale factor differently: a few
    # float32 ulps (eps 1.19e-7) apart at most
    np.testing.assert_allclose(got, np.asarray(jops.lns_matmul(A, B, interpret=True, **kw)),
                               rtol=5e-7, atol=0)
    assert np.array_equal(got, tam.matmul(A, B, "mitchell" if num_ecc == 0 else
                                          f"mitchell_ecc{num_ecc}", impl="kernel",
                                          device="cpu").numpy())


@pytest.mark.parametrize("karatsuba", [True, False])
def test_limb_matmul_matches_reference(karatsuba):
    got = tops.limb_matmul(A, B, karatsuba=karatsuba, device="cpu").numpy()
    assert np.array_equal(got, _jax_op_by_op(jops.limb_matmul, A, B, karatsuba=karatsuba))
    np.testing.assert_allclose(
        got, np.asarray(jops.limb_matmul(A, B, karatsuba=karatsuba, interpret=True)),
        rtol=5e-7, atol=0)


@pytest.mark.parametrize("method", ["refmlm", "mitchell", "odma", "exact"])
def test_gaussian_conv3x3_ref_matches_reference(method):
    img = np.random.default_rng(9).integers(0, 256, (13, 17)).astype(np.int32)
    kern = gaussian_kernel_3x3(1.0, 256)
    got = tref.gaussian_conv3x3_ref(_t(img), kern, method=method)
    want = jref.gaussian_conv3x3_ref(jnp.asarray(img), jnp.asarray(kern), method=method)
    assert np.array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------ quant

X = np.random.default_rng(3).standard_normal((7, 9)).astype(np.float32)


@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("nbits", [4, 7, 8, 12])
def test_quantize_magnitude_matches_reference(nbits, axis):
    got = tquant.quantize_magnitude(_t(X), nbits, axis)
    want = jquant.quantize_magnitude(jnp.asarray(X), nbits, axis)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    deq = tquant.dequantize_product(got.magnitude, got, got)
    assert np.array_equal(deq.numpy(), np.asarray(
        jquant.dequantize_product(want.magnitude, want, want)))
    fq = tquant.fake_quant(_t(X), nbits, axis)
    assert np.array_equal(fq.numpy(), np.asarray(jquant.fake_quant(jnp.asarray(X), nbits, axis)))


@pytest.mark.parametrize("axis", [None, 1])
@pytest.mark.parametrize("karatsuba", [True, False])
def test_quantize_limbs_matches_reference(karatsuba, axis):
    x = np.concatenate([X, -X, np.zeros((1, 9), np.float32)])
    (d, s) = tquant.quantize_limbs(_t(x), karatsuba=karatsuba, axis=axis)
    (jd, js) = jquant.quantize_limbs(jnp.asarray(x), karatsuba=karatsuba, axis=axis)
    assert d.limb_bits == jd.limb_bits
    assert np.array_equal(d.hi.numpy(), np.asarray(jd.hi))
    assert np.array_equal(d.lo.numpy(), np.asarray(jd.lo))
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert np.array_equal(tquant.limbs_to_int(d).numpy(), np.asarray(jquant.limbs_to_int(jd)))


def test_karatsuba_limbs_saturate_at_qlim_8127():
    x = np.array([-1e6, -1.0, 0.0, 1.0, 1e6], dtype=np.float32)
    d, scale = tquant.quantize_limbs(_t(x), karatsuba=True)
    q = tquant.limbs_to_int(d).numpy()
    assert q[-1] == 8127 and q[0] == -8127
    assert d.hi[-1] == 63 and d.lo[-1] == 63
    jd, jscale = jquant.quantize_limbs(jnp.asarray(x), karatsuba=True)
    assert np.array_equal(q, np.asarray(jquant.limbs_to_int(jd)))
    assert float(scale) == float(jscale)


def test_karatsuba_limbs_confined_to_w7_range():
    x = np.linspace(-3.0, 3.0, 4001).astype(np.float32)
    d, _ = tquant.quantize_limbs(_t(x), karatsuba=True)
    hi, lo = d.hi.numpy(), d.lo.numpy()
    assert hi.min() >= -64 and hi.max() <= 63 and lo.min() >= -64 and lo.max() <= 63
    assert (hi + lo).min() >= -128 and (hi + lo).max() <= 127
    jd, _ = jquant.quantize_limbs(jnp.asarray(x), karatsuba=True)
    assert np.array_equal(hi, np.asarray(jd.hi)) and np.array_equal(lo, np.asarray(jd.lo))


def test_schoolbook_limbs_saturate_at_qlim_32639():
    d, _ = tquant.quantize_limbs(_t(np.array([7.0, -7.0], np.float32)), karatsuba=False)
    assert d.limb_bits == 8
    assert tquant.limbs_to_int(d).tolist() == [32639, -32639]


@pytest.mark.parametrize("w", [7, 8])
def test_balanced_limbs_round_trip_exhaustive(w):
    lim = 63 * 128 + 63 if w == 7 else 32639
    q = np.arange(-lim, lim + 1, dtype=np.int32)
    hi, lo = tquant.balanced_limbs(_t(q), w)
    jhi, jlo = jquant.balanced_limbs(jnp.asarray(q), w)
    assert np.array_equal(hi.numpy(), np.asarray(jhi))
    assert np.array_equal(lo.numpy(), np.asarray(jlo))
    assert np.array_equal(((hi << w) + lo).numpy(), q)


def test_scale_floor_guards_zero_input():
    q = tquant.quantize_magnitude(torch.zeros((4, 4)), 8)
    assert np.isfinite(float(q.scale)) and not q.magnitude.any()
    jq = jquant.quantize_magnitude(jnp.zeros((4, 4)), 8)
    assert float(q.scale) == float(jq.scale)
    d, scale = tquant.quantize_limbs(torch.zeros((4,)), karatsuba=True)
    assert np.isfinite(float(scale)) and not tquant.limbs_to_int(d).any()


# -------------------------------------------------------------------- lns

@pytest.mark.parametrize("nbits,frac_bits", [(8, None), (8, 4), (8, 10), (4, None),
                                             (16, None)])
def test_lns_codec_matches_reference(nbits, frac_bits):
    rng = np.random.default_rng(nbits)
    v = np.concatenate([np.arange(min(1 << nbits, 4096)),
                        rng.integers(0, 1 << nbits, 512)]).astype(np.int32)
    w = rng.permutation(v)
    tc, jc = tlns.encode(_t(v), nbits, frac_bits), jlns.encode(jnp.asarray(v), nbits, frac_bits)
    assert np.array_equal(tc.code.numpy(), np.asarray(jc.code))
    assert np.array_equal(tc.is_zero.numpy(), np.asarray(jc.is_zero))
    assert np.array_equal(tlns.decode(tc).numpy(), np.asarray(jlns.decode(jc)))
    tp = tlns.lns_multiply(tc, tlns.encode(_t(w), nbits, frac_bits))
    jp = jlns.lns_multiply(jc, jlns.encode(jnp.asarray(w), nbits, frac_bits))
    assert np.array_equal(tp.code.numpy(), np.asarray(jp.code))
    assert np.array_equal(tlns.decode(tp).numpy(), np.asarray(jlns.decode(jp)))


# -------------------------------------------------------------- karatsuba

@pytest.mark.parametrize("variant", ["kom4", "kom3"])
@pytest.mark.parametrize("nbits,base_nbits", [(4, 2), (8, 2), (8, 4), (16, 2), (16, 8)])
def test_kom_exact_base_matches_reference(nbits, base_nbits, variant):
    rng = np.random.default_rng(nbits + base_nbits)
    a = rng.integers(0, 1 << nbits, 2048).astype(np.int32)
    b = rng.integers(0, 1 << nbits, 2048).astype(np.int32)
    got = tkar.kom(_t(a), _t(b), nbits, base_nbits=base_nbits, variant=variant)
    want = jkar.kom(jnp.asarray(a), jnp.asarray(b), nbits, base_nbits=base_nbits,
                    variant=variant)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert np.array_equal(got.numpy(), (a.astype(np.int64) * b) % (1 << 32))


@pytest.mark.parametrize("variant", ["kom4", "kom3"])
@pytest.mark.parametrize("base", ["efmlm2", "mlm2"])
def test_kom_approximate_base_matches_reference(base, variant):
    xs = np.arange(256, dtype=np.int32)
    a, b = np.repeat(xs, 256), np.tile(xs, 256)
    got = tkar.kom(_t(a), _t(b), 8, base_fn=getattr(trefmlm, base), variant=variant)
    want = jkar.kom(jnp.asarray(a), jnp.asarray(b), 8, base_fn=getattr(jrefmlm, base),
                    variant=variant)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_kom_rejects_bad_widths_and_op_counts_match():
    with pytest.raises(ValueError, match="base_nbits"):
        tkar.kom(torch.ones(2), torch.ones(2), 12, base_nbits=8)
    for nbits in (2, 4, 8, 16):
        for variant in ("kom4", "kom3"):
            assert tkar.op_counts(nbits, 2, variant) == jkar.op_counts(nbits, 2, variant)


# ------------------------------------------- the int8 route of the limb kernel

@pytest.mark.parametrize("axis", [None, 1])
@pytest.mark.parametrize("karatsuba", [True, False])
def test_quantized_limbs_select_the_int8_kernel(karatsuba, axis):
    """Every limb `quantize_limbs` gives (saturated edges included) fits the
    int8 tensor-core kernel, in both modes."""
    a = RNG.standard_normal((9, 70)).astype(np.float32) * 50
    b = RNG.standard_normal((70, 6)).astype(np.float32)
    a[0, :2], b[:2, 0] = (1e9, -1e9), (-1e9, 1e9)    # q at +-qlim
    da, _ = tquant.quantize_limbs(_t(a), karatsuba=karatsuba, axis=axis)
    db, _ = tquant.quantize_limbs(_t(b), karatsuba=karatsuba, axis=axis)
    route = tkm8.select_route(da.hi, da.lo, db.hi, db.lo, karatsuba=karatsuba)
    assert route == tkm8.KERNEL == "karatsuba_matmul_i8"


# (hi, lo) placed in one limb pair, karatsuba, the kernel it must select
EDGE_CASES = [((-128, 0), False, "i8"), ((127, -128), False, "i8"),
              ((-129, 0), False, "wide"), ((0, 128), False, "wide"),
              ((64, 64), False, "i8"),           # schoolbook never adds the limbs
              ((-64, -64), True, "i8"), ((127, 0), True, "i8"),
              ((64, 64), True, "wide"), ((-65, -64), True, "wide"),
              ((-128, 0), True, "i8"), ((0, -129), True, "wide"),
              ((1 << 30, 1 << 30), True, "wide")]


@pytest.mark.parametrize("operand", ["a", "b"])
@pytest.mark.parametrize("pair,karatsuba,route", EDGE_CASES)
def test_route_selection_at_the_int8_edges(pair, karatsuba, route, operand):
    limbs = [torch.zeros(s, dtype=torch.int32) for s in ((3, 5), (3, 5), (5, 4), (5, 4))]
    at = 0 if operand == "a" else 2
    limbs[at][1, 2], limbs[at + 1][1, 2] = pair
    want = tkm8.KERNEL if route == "i8" else tkm8.WIDE_KERNEL
    assert tkm8.select_route(*limbs, karatsuba=karatsuba) == want
    assert tkm8.limbs_fit_int8(*limbs, karatsuba=karatsuba) == (route == "i8")


def test_route_selection_of_empty_limbs():
    z = torch.zeros((0, 3), dtype=torch.int32)
    assert tkm8.select_route(z, z, z.T, z.T, karatsuba=True) == tkm8.KERNEL


@pytest.mark.parametrize("karatsuba", [True, False])
@pytest.mark.parametrize("shape", [(3, 70, 5), (1, 129, 2)])
def test_cpu_limbs_take_the_plain_version(shape, karatsuba):
    """On CPU tensors the dispatcher and the wide entry run
    `karatsuba_matmul_plain` (no launch counted) and stay byte-equal to the
    Pallas kernel in interpret mode, for int8-range and wider limbs; K
    crosses the int8 kernel's K padding."""
    m, k, n = shape
    w = 7 if karatsuba else 8
    for bound in (8000, 1 << 22):                # int8 limbs in both modes, wider
        a, b = _ints((m, k), bound, 11), _ints((k, n), bound, 12)
        ah, al = tquant.balanced_limbs(_t(a), w)
        bh, bl = tquant.balanced_limbs(_t(b), w)
        limbs = [x.numpy() for x in (ah, al, bh, bl)]
        assert tkm8.limbs_fit_int8(ah, al, bh, bl, karatsuba=karatsuba) == (bound == 8000)
        plain = tkm.karatsuba_matmul_plain(ah, al, bh, bl, karatsuba=karatsuba)
        pallas = j_karatsuba(*(_pad(x, 8 if i < 2 else 16, 16) for i, x in enumerate(limbs)),
                             karatsuba=karatsuba, block_m=8, block_n=16, block_k=16,
                             interpret=True)
        for entry in (tkm.karatsuba_matmul_kernel, tkm.karatsuba_matmul_wide):
            got = entry(ah, al, bh, bl, karatsuba=karatsuba)
            for g, p, q in zip(got, plain, pallas):
                assert torch.equal(g, p)
                assert np.array_equal(g.numpy(), np.asarray(q)[:m, :n])
    assert tkm.LAUNCHES == {"karatsuba_matmul": 0}
    assert tkm8.LAUNCHES == {"karatsuba_matmul_i8": 0}


def test_int8_kernel_is_built_and_raises_off_the_cpu():
    assert "karatsuba_matmul_i8" in build.SOURCES
    assert (build.CSRC / "karatsuba_matmul_i8.cu").is_file()
    a = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    b = torch.zeros((3, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tkm.karatsuba_matmul_wide(a, a, b, b)
    assert tkm8.LAUNCHES == {"karatsuba_matmul_i8": 0}


LNS_METHODS = ("mitchell", "mitchell_ecc1", "mitchell_ecc2", "mitchell_ecc3", "odma",
               "refmlm", "refmlm_kom3")


@pytest.mark.parametrize("nbits", [2, 4, tam.TABLE_NBITS])
@pytest.mark.parametrize("method", LNS_METHODS)
def test_lns_product_table_equals_the_element_function(method, nbits, monkeypatch):
    """At nbits <= TABLE_NBITS the plain LNS route looks its products up in
    a table of every magnitude pair: the same bytes as the element
    function's route (TABLE_NBITS = 0), zeros, signs and a batched lhs
    included."""
    rng = np.random.default_rng(nbits)
    a = _t(rng.standard_normal((3, 5, 40)).astype(np.float32))
    b = _t(rng.standard_normal((40, 9)).astype(np.float32))
    a[0, 0, :7] = 0.0
    table = tam._lns_matmul(a, b, method, nbits)
    monkeypatch.setattr(tam, "TABLE_NBITS", 0)
    element = tam._lns_matmul(a, b, method, nbits)
    assert table.shape == (3, 5, 9)
    assert torch.equal(table, element)
