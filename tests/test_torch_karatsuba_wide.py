"""The wide limb kernel's launch plan and the arithmetic of its routes, on
the CPU.

  * `launch_plan` at 132 SMs (an H100): the five limb calls of the
    inference path at 64x64 x 256 images take the thin route (one span of
    whole rows at K = 9, K splits at M = 256 with K = 2048 / 4096), and
    2048 x 896 x 4864 takes the digit route at the digit count it is given;
    every K index falls in exactly one split, a split's B range fits the
    block's shared memory, the row tiles cover M; shapes past the grid
    raise;
  * the digit route's arithmetic (`digit_product_plain`: balanced int8
    digits, the pair products with i + j <= 3, the shifts and wraps) and the
    wide entry byte-equal to `karatsuba_matmul_plain`, to the JAX package's
    oracle and to its Pallas kernel in interpret mode, in both modes, at 2,
    3 and 4 digits, on limbs over the whole int32 range with -2**31,
    2**31 - 1, +-128 and +-32768 placed in;
  * the digit count of the pack step's flag (`flag_digits`) and its plain
    mirror (`limb_digits`) at the range edges, Karatsuba's wrapped sums
    included;
  * the thin route's K splits: the plain version on each split's K range,
    the partials summed with a wrap in any order, gives the same bytes;
  * the plan's constants are the CUDA sources'.

All comparisons are exact. The kernels run only on the card, where
`chip_smoke.py` holds each route against its plain version.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ref as jref
from repro.kernels.karatsuba_matmul import karatsuba_matmul_kernel as j_karatsuba
from repro_torch.core.bitops import wrap32
from repro_torch.kernels import build
from repro_torch.kernels import karatsuba_matmul as tkm
from repro_torch.kernels import karatsuba_matmul_i8 as tkm8

torch.set_num_threads(1)

SMS = 132
INT_MIN, INT_MAX = -(1 << 31), (1 << 31) - 1
# the inference path's limb calls at 64x64 x 256 images: cnn conv1, conv2,
# dense; mlp dense1, dense2
WIDE_SHAPES = [(1048576, 9, 4), (262144, 36, 8), (256, 2048, 4), (256, 4096, 32),
               (256, 32, 4)]
LARGE = (2048, 896, 4864)
PLAN_SHAPES = WIDE_SHAPES + [
    LARGE, (1, 1, 1), (3, 0, 5), (5, 19, 11), (7, 10, 32), (37, 300, 33), (100, 5000, 17),
    (513, 18, 3), (1000, 9, 4), (300, 2100, 32), (64, 127, 16), (2, 1 << 20, 1),
    (1000, (1 << 20) + 3, 3), (1, 8, 64 * 65535)]
# value bounds whose limbs need 2, 3 and 4 balanced int8 digits in both
# modes (|hi + lo| stays within the same digit count)
DIGIT_CASES = [(2, 16000), (3, 4_000_000), (4, 1 << 31)]
EDGES = (INT_MIN, INT_MAX, 128, -128, 32768, -32768)


def _pad(x, rows, cols):
    return jnp.asarray(np.pad(x, ((0, -x.shape[0] % rows), (0, -x.shape[1] % cols))))


def _limbs(shape, bound, seed):
    """Seeded limbs in [-bound, bound) with the EDGES that fit placed in
    A's first row and B's first column."""
    m, k, n = shape
    rng = np.random.default_rng(seed)
    out = [rng.integers(-bound, bound, s, dtype=np.int64) for s in ((m, k), (m, k), (k, n), (k, n))]
    edges = [v for v in EDGES if -bound <= v < bound]
    for j, v in enumerate(edges[:k]):
        out[0][0, j], out[1][m - 1, k - 1 - j] = v, -v if -v < bound else v
        out[2][j, 0], out[3][k - 1 - j, n - 1] = v, v
    return [x.astype(np.int32) for x in out]


# --------------------------------------------------------------- the plan

@pytest.mark.parametrize("m,k,n", WIDE_SHAPES)
def test_wide_path_shapes_take_the_thin_route(m, k, n):
    plan = tkm.launch_plan(m, k, n, 2, SMS)
    assert plan.route == "thin" and plan.tile_n >= n and plan.tile_n in tkm.THIN_TILE_N
    assert plan.tile_m * (plan.tile_n // 4) == tkm.THIN_THREADS
    assert plan.smem_bytes(k) <= tkm.SMEM_PER_BLOCK
    assert 1 <= plan.blocks <= -(-m // plan.tile_m)
    assert plan == tkm.launch_plan(m, k, n, 4, SMS)       # the thin route ignores digits
    if k == 9:                                            # conv1: whole 9-wide rows, one span
        assert plan.span and plan.kc == plan.stride == 9 and plan.splits == 1
    if m == 256 and k >= 2048:                            # few row tiles: K split
        assert plan.splits > 1 and plan.grid(m, n)[0] * plan.splits <= 4 * SMS
    if m > 256:
        assert plan.splits == 1 and plan.blocks * (plan.smem_bytes(k) + 1024) <= \
            tkm.THIN_BLOCKS_PER_SM * tkm.SMEM_PER_SM * SMS // 4 * 4


@pytest.mark.parametrize("digits", [1, 2, 3, 4])
def test_large_shape_takes_the_digit_route(digits):
    m, k, n = LARGE
    plan = tkm.launch_plan(m, k, n, digits, SMS)
    assert plan.route == "digits" and plan.digits == max(2, digits)
    assert (plan.tile_m, plan.tile_n) == tkm.DIGIT_TILE
    assert plan.grid(m, n) == (32, 76, 1) and plan.kp(k) == 896
    assert plan.pairs() == {2: 4, 3: 8, 4: 10}[plan.digits]


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_plan_splits_cover_k_exactly(m, k, n):
    plan = tkm.launch_plan(m, k, n, 3, SMS)
    if plan.route == "digits":
        assert plan.splits == 1 and plan.kp(k) % tkm.DIGIT_K_ALIGN == 0 and plan.kp(k) >= k
        return
    ranges = plan.k_ranges(k)
    assert len(ranges) == plan.splits <= tkm.GRID_YZ_MAX
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(b % 4 == 0 for b, _ in ranges)
    lengths = [e - b for b, e in ranges]
    assert max(lengths) == plan.b_rows(k) and (k == 0 or min(lengths) > 0)
    assert plan.b_rows(k) * plan.tile_n <= tkm.THIN_B_ELEMS
    assert plan.smem_bytes(k) <= tkm.SMEM_PER_BLOCK
    if plan.span:
        assert k % 4 and plan.kc == plan.stride == k and plan.splits == 1
    elif k % 4 == 0:                       # 16-byte rows, conflict-free 16-byte reads
        assert plan.kc % 4 == 0 and plan.stride % 8 == 4 and plan.stride >= plan.kc
    else:                                  # 4-byte copies, an odd stride
        assert plan.stride % 2 == 1 and plan.stride >= plan.kc


def test_plan_grid_and_argument_limits():
    with pytest.raises(ValueError, match="grid"):
        tkm.launch_plan(1, 8, 64 * 65535 + 1, 2, SMS)     # digit tiles past gridDim.y
    with pytest.raises(ValueError, match="grid"):
        tkm.launch_plan(1 << 31, 8, 4, 2, SMS)
    with pytest.raises(ValueError, match="grid"):
        tkm.launch_plan(1, (1 << 31) - 1, 32, 2, SMS)     # > 65535 K splits
    with pytest.raises(ValueError, match="thin route"):
        tkm.route_plan("thin", 4, 8, 33, 2, SMS)
    with pytest.raises(ValueError, match="unknown route"):
        tkm.route_plan("tiled", 4, 8, 8, 2, SMS)
    for bad in ((0, 8, 4, 2), (4, -1, 4, 2), (4, 8, 4, 0), (4, 8, 4, 5)):
        with pytest.raises(ValueError, match="launch_plan needs"):
            tkm.launch_plan(*bad, SMS)
    # the forced thin route reaches N = 32 at any M; the digit route any N
    assert tkm.route_plan("thin", 2048, 896, 32, 2, SMS).tile_n == 32
    assert tkm.route_plan("digits", 1048576, 9, 4, 2, SMS).grid(1048576, 4) == (16384, 1, 1)


# ------------------------------------------------------------- the digits

@pytest.mark.parametrize("digits", [2, 3, 4])
def test_split_digits_reconstruct(digits):
    lo, hi = tkm.DIGIT_RANGE.get(digits, (INT_MIN, INT_MAX))
    x = np.random.default_rng(digits).integers(lo, hi + 1, 4000, dtype=np.int64)
    x[:6] = (lo, hi, 0, -1, 127, -128)
    ds = tkm.split_digits(torch.from_numpy(x.astype(np.int32)), digits)
    assert len(ds) == digits
    assert all(int(d.min()) >= -128 and int(d.max()) <= 127 for d in ds)
    back = sum(d.to(torch.int64) << (8 * i) for i, d in enumerate(ds))
    want = torch.from_numpy(x)
    assert torch.equal(back if digits < 4 else wrap32(back), want)


@pytest.mark.parametrize("hi,lo,karatsuba,want", [
    (0, 0, True, 1), (-64, -64, True, 1), (127, -128, False, 1), (64, 64, True, 2),
    (32639, 0, False, 2), (32640, 0, False, 3), (-32896, 0, False, 2), (0, -32897, False, 3),
    (20000, 20000, False, 2), (20000, 20000, True, 3),        # the Karatsuba sum counts
    (8355711, 0, False, 3), (8355712, 0, False, 4), (-8421504, 0, True, 3),
    (-8421505, 0, False, 4), (INT_MAX, 1, False, 4), (INT_MAX, 1, True, 4),
    (INT_MIN, INT_MIN, True, 4),                              # wraps to 0; the limbs count
    (-(1 << 30), -(1 << 30), True, 4)])
@pytest.mark.parametrize("operand", ["a", "b"])
def test_limb_digits_at_the_range_edges(hi, lo, karatsuba, want, operand):
    limbs = [torch.zeros(s, dtype=torch.int32) for s in ((3, 5), (3, 5), (5, 4), (5, 4))]
    at = 0 if operand == "a" else 2
    limbs[at][1, 2], limbs[at + 1][1, 2] = hi, lo
    assert tkm.limb_digits(*limbs, karatsuba=karatsuba) == want
    assert tkm8.limbs_fit_int8(*limbs, karatsuba=karatsuba) == (want == 1)


@pytest.mark.parametrize("flag,want", [(0, 1), (1, 2), (3, 3), (7, 4), (5, 4)])
def test_flag_digits_decodes_the_pack_bits(flag, want):
    assert tkm8.flag_digits(flag) == want


@pytest.mark.parametrize("karatsuba", [True, False])
@pytest.mark.parametrize("digits,bound", DIGIT_CASES)
@pytest.mark.parametrize("shape", [(5, 19, 11), (9, 33, 40)])
def test_digit_product_matches_reference(shape, digits, bound, karatsuba):
    """`digit_product_plain` at its own digit count and at every larger one,
    the wide entry and the dispatcher on CPU limbs: the Pallas kernel's and
    the oracle's bytes."""
    m, k, n = shape
    limbs = _limbs(shape, bound, 10 * digits + k)
    t = [torch.from_numpy(x) for x in limbs]
    need = tkm.limb_digits(*t, karatsuba=karatsuba)
    assert need == digits
    pallas = j_karatsuba(*(_pad(x, 8 if i < 2 else 16, 16) for i, x in enumerate(limbs)),
                         karatsuba=karatsuba, block_m=8, block_n=16, block_k=16, interpret=True)
    oracle = jref.karatsuba_matmul_ref(*map(jnp.asarray, limbs), karatsuba=karatsuba)
    got = [tkm.digit_product_plain(*t, karatsuba=karatsuba, digits=d) for d in range(need, 5)]
    got += [entry(*t, karatsuba=karatsuba) for entry in
            (tkm.karatsuba_matmul_wide, tkm.karatsuba_matmul_kernel)]
    for parts in got:
        for g, p, o in zip(parts, pallas, oracle):
            assert g.dtype == torch.int32 and g.shape == (m, n)
            assert np.array_equal(g.numpy(), np.asarray(p)[:m, :n])
            assert np.array_equal(g.numpy(), np.asarray(o))
    assert tkm.LAUNCHES == {"karatsuba_matmul": 0}
    assert tkm.ROUTE_LAUNCHES == {"thin": 0, "digits": 0}


def test_digit_product_refuses_too_few_digits():
    t = [torch.full(s, 40000, dtype=torch.int32) for s in ((2, 3), (2, 3), (3, 2), (3, 2))]
    with pytest.raises(ValueError, match="need 3 int8 digits"):
        tkm.digit_product_plain(*t, karatsuba=False, digits=2)


# ------------------------------------------------------------ the splits

@pytest.mark.parametrize("karatsuba", [True, False])
@pytest.mark.parametrize("m,k,n", [(256, 2048, 4), (256, 4096, 32), (3, 1001, 5)])
def test_split_partials_sum_in_any_order(m, k, n, karatsuba):
    """The plain version on each K range of the thin plan, the partials
    added with a wrap in three orders, on full-range limbs: the bytes of
    the whole product and of the JAX package's oracle."""
    plan = tkm.launch_plan(m, k, n, 4, SMS)
    assert plan.route == "thin" and plan.splits > 1
    limbs = _limbs((m, k, n), 1 << 31, k)
    t = [torch.from_numpy(x) for x in limbs]
    parts = [tkm.karatsuba_matmul_plain(t[0][:, b:e], t[1][:, b:e], t[2][b:e], t[3][b:e],
                                        karatsuba=karatsuba) for b, e in plan.k_ranges(k)]
    whole = tkm.karatsuba_matmul_plain(*t, karatsuba=karatsuba)
    oracle = jref.karatsuba_matmul_ref(*map(jnp.asarray, limbs), karatsuba=karatsuba)
    rng = np.random.default_rng(k)
    for order in (range(plan.splits), reversed(range(plan.splits)),
                  rng.permutation(plan.splits)):
        order = list(order)
        for j in range(3):
            total = torch.zeros((m, n), dtype=torch.int64)
            for i in order:
                total = wrap32(total + parts[i][j])
            assert torch.equal(total.to(torch.int32), whole[j])
            assert np.array_equal(whole[j].numpy(), np.asarray(oracle[j]))


# ------------------------------------------------------------ the sources

def test_plan_constants_are_the_sources():
    src = (build.CSRC / "karatsuba_matmul.cu").read_text()
    pack = (build.CSRC / "karatsuba_matmul_i8.cu").read_text()

    def const(name, text=src):
        return int(re.search(rf"\b{name} = (\d+)[,;]", text).group(1))

    assert const("kThinThreads") == tkm.THIN_THREADS
    assert const("kThinMaxTileN") == tkm.THIN_TILE_N[-1] == tkm.THIN_MAX_N
    assert const("kSmemMax") == tkm.SMEM_PER_BLOCK
    assert (const("kBM"), const("kBN")) == tkm.DIGIT_TILE
    assert const("kKAlign") == tkm.DIGIT_K_ALIGN
    (lo2, hi2), (lo3, hi3) = tkm.DIGIT_RANGE[2], tkm.DIGIT_RANGE[3]
    assert f"v < {lo2} || v > {hi2} ? 2" in pack and f"v < {lo3} || v > {hi3} ? 4" in pack
    assert {"karatsuba_thin", "karatsuba_digits"} <= set(re.findall(r'extern "C" int (\w+)', src))


def test_wide_entry_raises_off_the_cpu():
    a = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    b = torch.zeros((3, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tkm.karatsuba_matmul_wide(a, a, b, b)
    assert tkm.ROUTE_LAUNCHES == {"thin": 0, "digits": 0}
