"""The launch plan of the port's `mitchell_matmul` kernel, and the exactness
of its K splits, on the CPU.

  * `launch_plan` at 132 SMs (an H100): every K index falls in exactly one
    split and no split is empty or shorter than a K chunk; the row and
    column tiles cover (M, N); the Qwen2-0.5B decode and prefill shapes
    take the thin route and fill 2 x 132 blocks where K or N allow;
    2048 x 896 x 4864 takes the tiled route with one split, and tiled
    calls with few tiles split K; shapes past the grid raise;
  * the split sum is exact: `mitchell_matmul_plain` on each K range of the
    plan, the partials summed with a wrap to int32, is byte-equal to the
    JAX package's oracle (`repro.kernels.ref.mitchell_matmul_ref`) and to
    its Pallas kernel in interpret mode, for every LNS variant, on 8-bit
    operands and on the full int32 range with INT_MIN, INT_MAX, 0 and 2**16
    placed in;
  * the plan's constants are the CUDA source's.

All comparisons are exact (zero tolerance): int32 addition modulo 2**32 is
associative and commutative, so partial sums added in any order, as the
kernel's atomics add them, give the reference's bits. The kernel itself
runs only on the card, where `chip_smoke.py` holds it against its plain
version at each route.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ref as jref
from repro.kernels.mitchell_matmul import mitchell_matmul_kernel as j_mitchell
from repro_torch.core.bitops import wrap32
from repro_torch.kernels import build
from repro_torch.kernels import mitchell_matmul as tmm

torch.set_num_threads(1)

SMS = 132
INT_MIN, INT_MAX = -(1 << 31), (1 << 31) - 1
LNS_VARIANTS = [(0, True), (1, False), (2, False), (3, False), (0, False), (2, True)]
# Qwen2-0.5B's dense calls at batch-4 decode (M = 4) and at a 4 x 32 prefill
DECODE = [(4, 896, 896), (4, 896, 128), (4, 896, 4864), (4, 4864, 896)]
PREFILL = [(128, 896, 896), (128, 896, 128), (128, 896, 4864), (128, 4864, 896)]
LARGE = (2048, 896, 4864)
PLAN_SHAPES = DECODE + PREFILL + [
    LARGE, (1, 4864, 896), (1, 1, 1), (7, 1000, 77), (16, 300, 129), (17, 300, 129),
    (5, 63, 11), (5, 64, 11), (5, 129, 11), (3, 0, 5), (64, 65, 64), (65, 10000, 3),
    (48, 896, 4864), (1024, 896, 4864), (1025, 896, 4864), (40, 100, 7), (200, 97, 65),
    (1100, 65, 1), (1100, 300, 70),
    (2, 2 ** 20, 1), (1, 8, 64 * 65535 + 1)]


# --------------------------------------------------------------- the plan

@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_plan_splits_cover_k_exactly(m, k, n):
    plan = tmm.launch_plan(m, k, n, SMS)
    ranges = plan.k_ranges(k)
    assert len(ranges) == plan.splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (_, end), (begin, _) in zip(ranges, ranges[1:]):
        assert end == begin                      # contiguous: each index once
    if k:
        assert all(end > begin for begin, end in ranges)
    assert all(begin % plan.k_step == 0 for begin, _ in ranges)
    if plan.splits > 1:
        assert min(end - begin for begin, end in ranges) >= tmm.K_CHUNK[plan.route]


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_plan_tiles_cover_the_output(m, k, n):
    plan = tmm.launch_plan(m, k, n, SMS)
    x, y, z = plan.grid(m, n)
    rows, cols = (x, y) if plan.route == "tiled" else (y, x)
    assert (rows - 1) * plan.tile_m < m <= rows * plan.tile_m
    assert (cols - 1) * plan.tile_n < n <= cols * plan.tile_n
    assert z == plan.splits and max(y, z) <= tmm.GRID_YZ_MAX
    if m <= tmm.THIN_MAX_M:
        assert plan.route == "thin" and plan.tile_n == tmm.THIN_TILE_N
        assert plan.tile_m == min([r for r in tmm.THIN_ROWS if r >= m] or [16])
        assert plan.k_step == 1
        assert rows == 1 or plan.tile_m == 16
    else:
        assert plan.route == "tiled" and (plan.tile_m, plan.tile_n) == tmm.TILED_TILE
        assert plan.k_step == tmm.TILED_K_STEP


@pytest.mark.parametrize("m,k,n", DECODE + [(1, 4864, 896)])
def test_decode_shapes_take_the_thin_route_and_fill_the_card(m, k, n):
    plan = tmm.launch_plan(m, k, n, SMS)
    assert plan.route == "thin" and plan.tile_m == (1 if m == 1 else 4)
    blocks = np.prod(plan.grid(m, n))
    # 2 x 132 blocks, unless K holds fewer chunks than that needs
    assert blocks >= 2 * SMS or plan.splits == k // tmm.K_CHUNK["thin"]
    assert plan.splits > 1


@pytest.mark.parametrize("m,k,n", PREFILL)
def test_prefill_shapes_split_k_on_the_thin_route(m, k, n):
    plan = tmm.launch_plan(m, k, n, SMS)
    assert plan.route == "thin" and plan.tile_m == 16 and plan.splits > 1
    assert np.prod(plan.grid(m, n)) >= 2 * SMS or plan.splits == k // tmm.K_CHUNK["thin"]


@pytest.mark.parametrize("m,k,n", [(1100, 300, 70), (2048, 4864, 128), (1025, 896, 896)])
def test_tiled_shapes_split_k_where_the_tiles_are_few(m, k, n):
    plan = tmm.launch_plan(m, k, n, SMS)
    assert plan.route == "tiled" and plan.splits > 1
    assert np.prod(plan.grid(m, n)) >= 2 * SMS or plan.splits == k // tmm.TILED_K_STEP


def test_large_shape_keeps_one_split_on_the_tiled_route():
    plan = tmm.launch_plan(*LARGE, SMS)
    assert plan == tmm.LaunchPlan("tiled", 64, 64, 1, 32)
    assert plan.grid(LARGE[0], LARGE[2]) == (32, 76, 1)


def test_plan_is_a_function_of_the_shape():
    for shape in PLAN_SHAPES:
        assert tmm.launch_plan(*shape, SMS) == tmm.launch_plan(*shape, SMS)
    # fewer SMs ask for fewer splits, never more
    assert tmm.launch_plan(4, 4864, 896, 66).splits <= tmm.launch_plan(4, 4864, 896, SMS).splits


@pytest.mark.parametrize("m,k,n", [(1025, 8, 64 * 65535 + 1), (1, 1 << 31, 4), (1 << 31, 1, 1),
                                   (4, 4, 1 << 31), (0, 4, 4), (4, 4, 0), (4, -1, 4)])
def test_plan_refuses_shapes_past_the_grid(m, k, n):
    with pytest.raises(ValueError):
        tmm.launch_plan(m, k, n, SMS)


def test_route_plan_keeps_the_split_rule():
    for m in (4, 32, 2048):
        for route in ("thin", "tiled"):
            plan = tmm.route_plan(route, m, 896, 4864, SMS)
            assert plan.route == route
            assert 1 <= plan.splits <= 896 // tmm.K_CHUNK[route]
            if tmm.launch_plan(m, 896, 4864, SMS).route == route:
                assert plan == tmm.launch_plan(m, 896, 4864, SMS)
    assert tmm.route_plan("thin", 2048, 896, 4864, SMS).tile_m == 16
    assert tmm.route_plan("tiled", 4, 896, 4864, SMS) == tmm.LaunchPlan("tiled", 64, 64, 10, 32)


def test_route_cut():
    assert tmm.launch_plan(tmm.THIN_MAX_M, 896, 4864, SMS).route == "thin"
    assert tmm.launch_plan(tmm.THIN_MAX_M + 1, 896, 4864, SMS).route == "tiled"


def test_route_counts_reset_with_the_launch_count():
    tmm.ROUTE_LAUNCHES["thin"] += 2
    tmm.LAUNCHES[tmm.KERNEL] += 1
    tmm.reset_launches()
    assert tmm.ROUTE_LAUNCHES == {"tiled": 0, "thin": 0}
    assert tmm.LAUNCHES == {tmm.KERNEL: 0}
    a = torch.ones((4, 300), dtype=torch.int32)
    tmm.mitchell_matmul_kernel(a, torch.ones((300, 7), dtype=torch.int32))
    assert tmm.ROUTE_LAUNCHES == {"tiled": 0, "thin": 0}   # the CPU runs the plain version


def test_plan_constants_are_the_kernels():
    src = (build.CSRC / "mitchell_matmul.cu").read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)[,;]", src).group(1))

    assert tmm.TILED_TILE == (const("kThreadsY") * const("kMicro"),
                              const("kThreadsX") * const("kMicro"))
    assert tmm.THIN_TILE_N == 32 * const("kThinCols")
    assert tmm.TILED_K_STEP == const("kTileK")
    assert tmm.K_CHUNK["thin"] == const("kThinWarps") * const("kUnroll")
    assert re.search(r"k_range\(k, kTileK, kb, ke\)", src)      # tiled: K-tile steps
    assert re.search(r"k_range\(k, 1, kb, ke\)", src)           # thin: single K steps
    cases = tuple(int(c) for c in re.findall(r"case (\d+): return launch_thin<", src))
    assert cases == tmm.THIN_ROWS
    assert re.search(r"kTiled = 0, kThin = 1", src)


# ---------------------------------------------------- split sums are exact

def _operands(m, k, n, full_range, seed):
    rng = np.random.default_rng(seed)
    lo, hi = (INT_MIN, INT_MAX + 1) if full_range else (-255, 256)
    a = rng.integers(lo, hi, (m, k), dtype=np.int64)
    b = rng.integers(lo, hi, (k, n), dtype=np.int64)
    if full_range:
        a[0, :4] = (INT_MIN, INT_MAX, 0, 1 << 16)
        a[-1, -4:] = (1 << 16, 0, INT_MIN, INT_MIN)
        b[:4, 0] = (INT_MAX, INT_MIN, 1 << 16, 0)
        b[-4:, -1] = (INT_MIN, 1 << 16, INT_MAX, INT_MIN)
    return a.astype(np.int32), b.astype(np.int32)


def _split_sum(a, b, ranges, **kw):
    """The kernel's split-K sum, done with the plain version: one partial
    a K range, added with a wrap to int32 in the order of `ranges`."""
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    total = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int64)
    for begin, end in ranges:
        part = tmm.mitchell_matmul_plain(ta[:, begin:end].contiguous(),
                                         tb[begin:end].contiguous(), **kw)
        total = wrap32(total + part.to(torch.int64))
    return total.to(torch.int32).numpy()


def _pad(x, rows, cols):
    return jnp.asarray(np.pad(x, ((0, -x.shape[0] % rows), (0, -x.shape[1] % cols))))


@pytest.mark.parametrize("full_range", [False, True], ids=["8bit", "int32"])
@pytest.mark.parametrize("num_ecc,case_split", LNS_VARIANTS)
@pytest.mark.parametrize("m,k,n", [(1, 300, 77), (4, 1000, 129), (5, 1000, 33),
                                   (4, 300, 200), (1, 1000, 17), (40, 300, 20),
                                   (1100, 300, 5)])
def test_split_sum_equals_the_reference(m, k, n, num_ecc, case_split, full_range):
    plan = tmm.launch_plan(m, k, n, SMS)
    assert plan.route == ("thin" if m <= tmm.THIN_MAX_M else "tiled") and plan.splits > 1
    a, b = _operands(m, k, n, full_range, seed=m * 1000 + k + n)
    kw = dict(num_ecc=num_ecc, case_split=case_split)
    oracle = np.asarray(jref.mitchell_matmul_ref(jnp.asarray(a), jnp.asarray(b), **kw))
    ranges = plan.k_ranges(k)
    assert np.array_equal(_split_sum(a, b, ranges, **kw), oracle)
    # the partials added in the reverse order give the same bits
    assert np.array_equal(_split_sum(a, b, ranges[::-1], **kw), oracle)


@pytest.mark.parametrize("full_range", [False, True], ids=["8bit", "int32"])
@pytest.mark.parametrize("num_ecc,case_split", LNS_VARIANTS)
def test_split_sum_equals_the_pallas_kernel(num_ecc, case_split, full_range):
    """Against the Pallas kernel in interpret mode, padded to its blocks as
    tests/test_torch_matmul.py pads it; its K grid axis carries the sum
    over 4 blocks of 256."""
    m, k, n = 5, 1000, 77
    plan = tmm.launch_plan(m, k, n, SMS)
    a, b = _operands(m, k, n, full_range, seed=17)
    kw = dict(num_ecc=num_ecc, case_split=case_split)
    pallas = j_mitchell(_pad(a, 8, 256), _pad(b, 256, 128), block_m=8, block_n=128,
                        block_k=256, interpret=True, **kw)
    assert np.array_equal(_split_sum(a, b, plan.k_ranges(k), **kw),
                          np.asarray(pallas)[:m, :n])
