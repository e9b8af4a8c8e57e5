"""Differential harness for the port's execution plans: every `PlanConfig`
-- random, degenerate, or poisoned -- gives the bytes of the reference's
untuned direct dataflow, local and streamed, on the CPU.

Counterpart of `tests/test_plan_equivalence.py`: the same plan space
(dataflow x mult_impl x grid, degenerate grids included) through the
port's `apply_filter` plan resolution, held against the JAX package's
`apply_filter(..., separable=False)` on the same seeded images. A poisoned
cache entry may only cost time: in the CPU cache it must give the same
bytes through default arguments, and in the 'cuda' cache `sanitize_plan`
must degrade it to a tile of the kernels' menu, which the card's passes
accept. The tolerance is zero.
"""
import json

import numpy as np
import pytest
import torch

import repro.filters as jfilters
from repro_torch.filters import apply_filter, get_filter
from repro_torch.tuning import invalidate_cache, plan_key, resolve_plan, store_cache
from repro_torch.tuning.blocks import TILE_MENU, menu_tile
from repro_torch.tuning.cache import CACHE_ENV, cache_path
from repro_torch.tuning.plans import PlanConfig, plan_routes, sanitize_plan

torch.set_num_threads(1)

SHAPE = (3, 24, 20)                     # (n, h, w): small, halo-exercising


@pytest.fixture()
def tmp_cache(tmp_path, monkeypatch):
    monkeypatch.setenv(CACHE_ENV, str(tmp_path))
    invalidate_cache()
    yield tmp_path
    invalidate_cache()


def _imgs(n, h, w):
    return np.random.default_rng(7).integers(0, 256, (n, h, w)).astype(np.int32)


_REFS: dict[tuple, np.ndarray] = {}


def _ref(name: str, method: str) -> np.ndarray:
    """The reference's bytes: its direct dataflow on the seeded batch."""
    key = (name, method)
    if key not in _REFS:
        _REFS[key] = np.asarray(jfilters.apply_filter(_imgs(*SHAPE), name, method=method,
                                                      separable=False))
    return _REFS[key]


def _run_plan(imgs, name, plan, *, method, exec_mode="local"):
    """Dispatch one fully explicit plan the way the tuner does."""
    kw = dict(method=method, mult_impl=plan.mult_impl, block_rows=plan.block_rows,
              block_cols=plan.block_cols, batch_fold=plan.batch_fold, device="cpu")
    if exec_mode == "streamed":
        kw.update(exec="streamed", tile=(16, 16), tile_batch=2)
    if plan.dataflow == "direct":
        out = apply_filter(imgs, name, separable=False, **kw)
    elif plan.dataflow == "two_pass":
        out = apply_filter(imgs, name, separable=True, fused=False, **kw)
    else:
        out = apply_filter(imgs, name, fused=True, **kw)
    return np.asarray(out)


def _random_plan(rng, separable_ok: bool, h: int, w: int) -> PlanConfig:
    """One valid random plan, degenerate grids and the card's menu tiles
    included (block_rows > H, block_cols > W)."""
    dataflow = rng.choice(["direct", "two_pass", "fused"] if separable_ok else ["direct"])
    return PlanConfig(str(dataflow), str(rng.choice(["kcm", "recurse"])),
                      int(rng.choice([8, 16, 24, 32, h, 4 * h])),
                      int(rng.choice([8, 16, w, 2 * w, 64])),
                      bool(rng.choice([False, True])))


class TestRandomPlans:
    @pytest.mark.parametrize("name,method", [
        ("gaussian5", "refmlm"), ("gaussian5", "exact"), ("sobel_x", "refmlm"),
        ("laplacian", "refmlm"), ("laplacian", "exact"), ("gaussian3", "mitchell")])
    def test_random_plans_bit_identical_local(self, name, method, tmp_cache):
        imgs = _imgs(*SHAPE)
        rng = np.random.default_rng(sum(map(ord, name + method)))
        for _ in range(4):
            plan = _random_plan(rng, get_filter(name).separable, *SHAPE[1:])
            np.testing.assert_array_equal(_run_plan(imgs, name, plan, method=method),
                                          _ref(name, method), err_msg=str(plan))

    @pytest.mark.parametrize("name", ["gaussian5", "laplacian"])
    def test_random_plans_bit_identical_streamed(self, name, tmp_cache):
        imgs = _imgs(*SHAPE)
        rng = np.random.default_rng(11)
        for _ in range(2):
            plan = _random_plan(rng, get_filter(name).separable, *SHAPE[1:])
            out = _run_plan(imgs, name, plan, method="refmlm", exec_mode="streamed")
            np.testing.assert_array_equal(out, _ref(name, "refmlm"), err_msg=str(plan))

    def test_degenerate_blocks_bit_identical(self, tmp_cache):
        """One band taller than the batch, a tile wider than the image, the
        shallow floor, and the card's two persistent tiles."""
        n, h, w = SHAPE
        imgs = _imgs(n, h, w)
        for plan in (PlanConfig("fused", "kcm", 16 * h, w, True),
                     PlanConfig("two_pass", "kcm", h, 2 * w, False),
                     PlanConfig("direct", "recurse", 8, 8, True),
                     PlanConfig("fused", "recurse", 32, 64, False),
                     PlanConfig("two_pass", "recurse", 16, 64, False)):
            np.testing.assert_array_equal(_run_plan(imgs, "gaussian5", plan, method="refmlm"),
                                          _ref("gaussian5", "refmlm"), err_msg=str(plan))


class TestPoisonedCache:
    ENTRY = {"dataflow": "direct", "mult_impl": "recurse", "block_rows": 10_000,
             "block_cols": 4, "batch_fold": True, "us_per_call": 1.0}

    def _poison(self, name, n, h, w, entry, backend="cpu"):
        plans = {plan_key(name, n, h, w): entry}
        # the streamed mode re-enters with tile-local shapes: poison those too
        for tn in (1, 2, n):
            for (th, tw) in ((16, 16), (20, 20), (h, w), (h + 4, w + 4)):
                plans[plan_key(name, tn, th, tw)] = entry
        store_cache({}, plans, backend=backend)
        assert json.loads(cache_path(backend).read_text())["plans"]

    @pytest.mark.parametrize("exec_mode", ["local", "streamed"])
    def test_absurd_winner_only_costs_time(self, tmp_cache, exec_mode):
        """The worst dataflow, the slow mult_impl, a band far taller than the
        image, a tile narrower than the halo floor and a fold: the same
        bytes through default-argument `apply_filter`."""
        n, h, w = SHAPE
        self._poison("gaussian5", n, h, w, self.ENTRY)
        kw = ({"exec": "streamed", "tile": (16, 16), "tile_batch": 2}
              if exec_mode == "streamed" else {})
        out = np.asarray(apply_filter(_imgs(n, h, w), "gaussian5", device="cpu", **kw))
        np.testing.assert_array_equal(out, _ref("gaussian5", "refmlm"))

    def test_malformed_entry_falls_back_to_defaults(self, tmp_cache):
        n, h, w = SHAPE
        self._poison("gaussian5", n, h, w, {**self.ENTRY, "dataflow": "systolic"})
        out = np.asarray(apply_filter(_imgs(n, h, w), "gaussian5", device="cpu"))
        np.testing.assert_array_equal(out, _ref("gaussian5", "refmlm"))

    def test_sanitize_clamps_poisoned_blocks(self):
        clamped = sanitize_plan(PlanConfig("fused", "kcm", 10_000, 4, False), 3, 24, 20, 5, 5)
        assert clamped is not None
        assert clamped.block_rows <= 24 and clamped.block_cols >= 8
        assert sanitize_plan(PlanConfig("systolic", "kcm", 8, 8, False),
                             3, 24, 20, 5, 5) is None
        assert sanitize_plan(PlanConfig("fused", "auto", 8, 8, False), 3, 24, 20, 5, 5) is None

    @pytest.mark.parametrize("dataflow", ["direct", "two_pass", "fused"])
    @pytest.mark.parametrize("blocks", [(10_000, 4, True), (20, 64, False), (1, 1, True),
                                        (32, 64, False), (16, 10_000, False)])
    def test_sanitize_clamps_to_the_cards_menu(self, dataflow, blocks):
        """On 'cuda' a cached grid becomes a tile of its route's menu,
        unfolded -- one the card's passes accept (`menu_tile` does not
        raise) -- and never an explicit argument's error."""
        plan = sanitize_plan(PlanConfig(dataflow, "kcm", *blocks), 8, 480, 640, 5, 5,
                             backend="cuda")
        (route,) = plan_routes(dataflow, 5, 5)
        assert (plan.block_rows, plan.block_cols) in TILE_MENU[route]
        assert plan.batch_fold is False
        assert menu_tile(route, plan.block_rows, plan.block_cols, plan.batch_fold)

    def test_mixed_route_two_pass_defers_its_grid(self):
        """A 7x5 two-pass plan runs a persistent 1x5 pass and a tiled 7x1
        pass: no one tile fits both, so a cached grid defers to each pass."""
        plan = sanitize_plan(PlanConfig("two_pass", "kcm", 32, 64, False), 8, 64, 64, 7, 5,
                             backend="cuda")
        assert plan == PlanConfig("two_pass", "kcm")

    def test_poisoned_cuda_cache_resolves_to_a_menu_plan(self, tmp_cache):
        n, h, w = 8, 480, 640
        self._poison("gaussian5", n, h, w, self.ENTRY, backend="cuda")
        plan = resolve_plan("gaussian5", n, h, w, 5, 5, separable_ok=True, backend="cuda")
        assert plan == PlanConfig("direct", "recurse", 32, 64, False)
        assert resolve_plan("gaussian5", n, h, w, 5, 5, separable_ok=True, backend="cpu") \
            == PlanConfig("fused", "auto")


class TestSeededProperty:
    """The differential property over a wider seeded grid of plans (the
    reference widens it with hypothesis where installed; a seeded sweep
    runs everywhere)."""

    def test_any_valid_plan_is_bit_identical(self, tmp_cache):
        imgs = _imgs(*SHAPE)
        rng = np.random.default_rng(2024)
        for _ in range(15):
            name = str(rng.choice(["gaussian5", "laplacian"]))
            plan = _random_plan(rng, get_filter(name).separable, *SHAPE[1:])
            np.testing.assert_array_equal(_run_plan(imgs, name, plan, method="refmlm"),
                                          _ref(name, "refmlm"), err_msg=str(plan))
