"""The port's tuning layer (`repro_torch.tuning`) against the JAX package's
(`repro.tuning`), on the CPU.

  * the CPU backend's heuristic and candidates equal the reference's for
    every shape the reference's tests and sweeps use; the 'cuda' backend
    takes the kernels' tile menu, refuses a tile off it and a fold, and
    clamps a cached entry to it;
  * the v2 cache: round trip, v1 migration, a byte-deterministic store
    under BENCH_TIMESTAMP, the port's own directory override;
  * resolution order, explicit > cached > heuristic, for blocks and plans,
    equal to the reference's on the same cache entries;
  * the autotune CLI's selection and pruning with monkeypatched timings,
    and the recurse kernels' chunk sweep.

Everything is integer bookkeeping: the comparisons are exact.
"""
import json

import numpy as np
import pytest
import torch

import repro.tuning as jtuning
import repro.tuning.autotune as jautotune
import repro_torch.tuning.autotune as tautotune
from repro_torch.filters import conv as tconv
from repro_torch.tuning import (
    TILE_MENU,
    BlockConfig,
    PlanConfig,
    choose_block_rows,
    config_key,
    default_blocks,
    invalidate_cache,
    load_cache,
    load_plans,
    plan_key,
    resolve_blocks,
    resolve_plan,
    store_cache,
)
from repro_torch.tuning.blocks import clamp_tile, menu_tile, round_up
from repro_torch.tuning.cache import CACHE_ENV, cache_path, load_meta

torch.set_num_threads(1)

CPU = "cpu"


@pytest.fixture()
def tmp_cache(tmp_path, monkeypatch):
    """Point both packages' caches at empty directories for a test."""
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    monkeypatch.setenv(CACHE_ENV, str(tmp_path / "port"))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "ref"))
    invalidate_cache()
    jtuning.invalidate_cache()
    yield tmp_path / "port"
    invalidate_cache()
    jtuning.invalidate_cache()


# the shapes of the reference's tuning tests and sweeps
REF_SHAPES = sorted({
    ("direct", 8, 128, 128, 3, 3), ("direct", 1, 128, 128, 5, 5),
    ("direct", 4, 1024, 1024, 3, 3), ("fused", 2, 8, 64, 5, 5),
    ("direct", 2, 48, 40, 3, 3),
    *(row[:6] for row in jautotune.DEFAULT_SWEEP),
    *(row[:6] for row in jautotune.DIST_SWEEP),
    *(row[:6] for row in jautotune.QUICK_SWEEP),
})


class TestHeuristic:
    def test_round_up(self):
        assert round_up(130, 8) == 136
        assert round_up(128, 8) == 128

    @pytest.mark.parametrize("shape", REF_SHAPES)
    def test_cpu_default_blocks_equal_the_reference(self, shape):
        for fold in (None, True, False):
            got = default_blocks(*shape, batch_fold=fold, backend=CPU)
            want = jtuning.default_blocks(*shape, batch_fold=fold)
            assert tuple(got) == tuple(want), (shape, fold)
        for h in (7, 8, 96, 130, 256, 512, 1000):
            assert choose_block_rows(h) == jtuning.choose_block_rows(h)

    def test_small_batches_fold(self):
        cfg = default_blocks("direct", 8, 128, 128, 3, 3, backend=CPU)
        assert cfg.batch_fold and cfg.block_rows % 8 == 0
        assert -(-8 * 130 // cfg.block_rows) == 2 and cfg.block_cols is None

    def test_large_images_do_not_fold_but_do_tile_columns(self):
        cfg = default_blocks("direct", 4, 1024, 1024, 3, 3, backend=CPU)
        assert not cfg.batch_fold and cfg.block_cols == 256

    @pytest.mark.parametrize("kind,kh,kw,route", [
        ("direct", 3, 3, "persistent"), ("direct", 1, 5, "persistent"),
        ("fused", 5, 5, "persistent"), ("fused", 3, 5, "tiled"),
        ("direct", 7, 7, "tiled")])
    def test_cuda_default_is_the_routes_first_tile(self, kind, kh, kw, route):
        got = default_blocks(kind, 8, 480, 640, kh, kw, backend="cuda")
        assert got == BlockConfig(*TILE_MENU[route][0], False)

    def test_menu_tile_refuses_off_menu_and_fold(self):
        assert menu_tile("persistent", None, None, None) == (32, 64)
        assert menu_tile("persistent", 16, None, False) == (16, 64)
        assert menu_tile("tiled", None, 32, None) == (16, 32)
        for rows, cols in ((48, 64), (32, 128), (16, 32)):
            with pytest.raises(ValueError, match="not a compiled persistent tile"):
                menu_tile("persistent", rows, cols, False)
        with pytest.raises(ValueError, match="tiled"):
            menu_tile("tiled", 32, 64, False)
        # a fold runs the same pass on the tall image: the tile stands
        assert menu_tile("persistent", 32, 64, True) == (32, 64)

    def test_clamp_tile_degrades_to_the_menu(self):
        assert clamp_tile("persistent", 1040, None) == (32, 64)
        assert clamp_tile("persistent", 24, 999) == (16, 64)
        assert clamp_tile("persistent", 1, 1) == (16, 64)
        assert clamp_tile("tiled", 128, 256) == (16, 32)


class TestCandidates:
    @pytest.mark.parametrize("row", jautotune.DEFAULT_SWEEP[:6])
    def test_cpu_candidates_equal_the_reference(self, row):
        kind, n, h, w, kh, kw, _ = row
        got = list(tautotune.candidate_blocks(kind, n, h, w, kh, kw, backend=CPU))
        want = list(jautotune.candidate_blocks(kind, n, h, w, kh, kw))
        assert [tuple(c) for c in got] == [tuple(c) for c in want]
        assert len(got) == len(set(got))

    @pytest.mark.parametrize("row", tautotune.DEFAULT_SWEEP + tautotune.DIST_SWEEP)
    def test_cuda_candidates_are_the_menu(self, row):
        kind, n, h, w, kh, kw, _ = row
        cands = list(tautotune.candidate_blocks(kind, n, h, w, kh, kw))
        assert cands == [BlockConfig(r, c, False) for r, c in TILE_MENU["persistent"]]


class TestCache:
    KEY = config_key("direct", 2, 48, 40, 3, 3, "kcm")
    ENTRY = {"block_rows": 24, "block_cols": 16, "batch_fold": True,
             "us_per_call": 1.0}

    def test_key_format(self):
        assert self.KEY == jtuning.config_key("direct", 2, 48, 40, 3, 3, "kcm") \
            == "direct/kcm/n2x48x40/k3x3"
        assert plan_key("gaussian5", 2, 64, 64) == jtuning.plan_key("gaussian5", 2, 64, 64)

    def test_store_load_roundtrip(self, tmp_cache):
        path = store_cache({self.KEY: self.ENTRY}, backend=CPU)
        assert path == tmp_cache / "blocks_cpu.json"
        assert load_cache(CPU)[self.KEY] == self.ENTRY

    def test_store_is_deterministic_under_pinned_timestamp(self, tmp_cache, monkeypatch):
        monkeypatch.setenv("BENCH_TIMESTAMP", "2026-01-01T00:00:00Z")
        configs = {self.KEY: self.ENTRY,
                   config_key("fused", 1, 8, 8, 3, 3, "kcm"):
                       {"block_rows": 8, "block_cols": None,
                        "batch_fold": False, "us_per_call": 2.0}}
        path = store_cache(configs, backend="cuda", meta={"device_name": "card"})
        first = path.read_bytes()
        store_cache(configs, backend="cuda", meta={"device_name": "card"})
        assert path.read_bytes() == first
        meta = json.loads(first)["meta"]
        assert meta == {"backend": "cuda", "device_name": "card",
                        "generated": "2026-01-01T00:00:00Z", "version": 2}
        assert load_meta("cuda")["device_name"] == "card"

    def test_missing_or_corrupt_cache_falls_back(self, tmp_cache):
        assert load_cache(CPU) == {}
        cache_path(CPU).write_text("{not json")
        invalidate_cache()
        assert load_cache(CPU) == {}
        cfg = resolve_blocks("direct", 2, 48, 40, 3, 3, "kcm", backend=CPU)
        assert cfg == default_blocks("direct", 2, 48, 40, 3, 3, backend=CPU)

    def test_port_never_reads_the_reference_cache(self, tmp_cache, tmp_path):
        """The reference's directory override and file are its own: a winner
        stored there is not the port's."""
        jtuning.store_cache({self.KEY: self.ENTRY})
        assert jtuning.load_cache()[self.KEY] == self.ENTRY
        assert load_cache(CPU) == {}
        assert resolve_blocks("direct", 2, 48, 40, 3, 3, "kcm", backend=CPU) == \
            default_blocks("direct", 2, 48, 40, 3, 3, backend=CPU)


def _both_store(blocks: dict, plans: dict | None = None) -> None:
    """The same entries in both packages' (CPU) caches."""
    store_cache(blocks, plans, backend=CPU)
    jtuning.store_cache(blocks, plans)


class TestResolve:
    def test_cached_entry_wins_over_heuristic(self, tmp_cache):
        _both_store({TestCache.KEY: TestCache.ENTRY})
        cfg = resolve_blocks("direct", 2, 48, 40, 3, 3, "kcm", backend=CPU)
        assert cfg == BlockConfig(24, 16, True)
        assert tuple(cfg) == tuple(jtuning.resolve_blocks("direct", 2, 48, 40, 3, 3, "kcm"))

    @pytest.mark.parametrize("explicit", [
        dict(block_rows=8, batch_fold=False), dict(batch_fold=True),
        dict(batch_fold=False), dict(block_rows=24), dict(block_cols=40),
        dict(block_rows=16, block_cols=16, batch_fold=True)])
    def test_explicit_fields_win_over_cache_as_the_reference(self, tmp_cache, explicit):
        """Explicit values land; a disagreeing entry is rejected as a unit
        (the rest from the heuristic), an agreeing one donates the rest --
        field for field the reference's resolution."""
        _both_store({TestCache.KEY: TestCache.ENTRY})
        got = resolve_blocks("direct", 2, 48, 40, 3, 3, "kcm", backend=CPU, **explicit)
        want = jtuning.resolve_blocks("direct", 2, 48, 40, 3, 3, "kcm", **explicit)
        assert tuple(got) == tuple(want)

    def test_unfolding_a_fold_tuned_entry_gets_per_image_bands(self, tmp_cache):
        key = config_key("direct", 8, 128, 128, 3, 3, "kcm")
        store_cache({key: {"block_rows": 1040, "block_cols": None,
                           "batch_fold": True, "us_per_call": 1.0}}, backend=CPU)
        cfg = resolve_blocks("direct", 8, 128, 128, 3, 3, "kcm", batch_fold=False,
                             backend=CPU)
        assert cfg == BlockConfig(choose_block_rows(128), None, False)

    def test_other_impl_misses_the_cache(self, tmp_cache):
        store_cache({TestCache.KEY: TestCache.ENTRY}, backend=CPU)
        cfg = resolve_blocks("direct", 2, 48, 40, 3, 3, "recurse", backend=CPU)
        assert cfg == default_blocks("direct", 2, 48, 40, 3, 3, backend=CPU)

    def test_cuda_entry_off_the_menu_is_clamped(self, tmp_cache):
        """A poisoned 'cuda' block entry costs time, never an error: it
        degrades to a menu tile without a fold."""
        key = config_key("fused", 8, 480, 640, 5, 5, "kcm")
        for entry, want in (({"block_rows": 1040, "block_cols": None, "batch_fold": True},
                             BlockConfig(32, 64, False)),
                            ({"block_rows": 20, "block_cols": 64, "batch_fold": False},
                             BlockConfig(16, 64, False)),
                            ({"block_rows": "x"}, BlockConfig(32, 64, False))):
            store_cache({key: entry}, backend="cuda")
            assert resolve_blocks("fused", 8, 480, 640, 5, 5, "kcm", backend="cuda") == want


PLAN_ENTRY = {"dataflow": "two_pass", "mult_impl": "kcm",
              "block_rows": 136, "block_cols": 64, "batch_fold": True,
              "us_per_call": 500.0, "generated": "2026-01-01T00:00:00Z",
              "candidates": 54, "swept": 13, "pruned": 41}


class TestCacheV2:
    def test_plans_roundtrip(self, tmp_cache):
        key = plan_key("gaussian5", 2, 64, 64)
        store_cache({}, {key: PLAN_ENTRY}, backend=CPU)
        assert load_plans(CPU)[key] == PLAN_ENTRY
        data = json.loads(cache_path(CPU).read_text())
        assert data["meta"]["version"] == 2
        assert set(data) == {"meta", "blocks", "plans"}

    def test_blocks_only_store_preserves_plans(self, tmp_cache):
        pkey = plan_key("gaussian5", 2, 64, 64)
        store_cache({}, {pkey: PLAN_ENTRY}, backend=CPU)
        store_cache({TestCache.KEY: TestCache.ENTRY}, backend=CPU)
        assert load_plans(CPU)[pkey] == PLAN_ENTRY
        assert load_cache(CPU)[TestCache.KEY] == TestCache.ENTRY

    def test_v1_file_migrates_on_load(self, tmp_cache):
        cache_path(CPU).write_text(json.dumps(
            {"meta": {"backend": CPU, "version": 1},
             "configs": {TestCache.KEY: TestCache.ENTRY}}))
        invalidate_cache()
        assert load_cache(CPU)[TestCache.KEY] == TestCache.ENTRY
        assert load_plans(CPU) == {}
        store_cache(load_cache(CPU), backend=CPU)
        data = json.loads(cache_path(CPU).read_text())
        assert data["meta"]["version"] == 2 and "configs" not in data
        assert data["blocks"][TestCache.KEY] == TestCache.ENTRY


class TestResolvePlan:
    N, H, W = 2, 64, 64
    KEY = plan_key("gaussian5", 2, 64, 64)

    def _resolve(self, backend=CPU, **kw):
        return resolve_plan("gaussian5", self.N, self.H, self.W, 5, 5,
                            separable_ok=True, backend=backend, **kw)

    def test_miss_reproduces_the_reference_defaults(self, tmp_cache):
        assert self._resolve() == PlanConfig("fused", "auto", None, None, None)
        assert resolve_plan("laplacian", 2, 64, 64, 3, 3, separable_ok=False,
                            backend=CPU) == PlanConfig("direct", "auto")
        assert self._resolve(backend="cuda") == PlanConfig("fused", "auto")

    @pytest.mark.parametrize("explicit", [
        {}, dict(fused=True), dict(separable=False), dict(mult_impl="recurse"),
        dict(block_rows=32), dict(batch_fold=True), dict(separable=True),
        dict(fused=True, mult_impl="recurse", block_rows=16, block_cols=32,
             batch_fold=False)])
    def test_resolution_order_equals_the_reference(self, tmp_cache, explicit):
        """explicit > cached > defaults, with the same entry in both caches:
        the same plan, field for field."""
        _both_store({}, {self.KEY: PLAN_ENTRY})
        got = self._resolve(**explicit)
        want = jtuning.resolve_plan("gaussian5", self.N, self.H, self.W, 5, 5,
                                    separable_ok=True, **explicit)
        assert tuple(got) == tuple(want)

    def test_cached_plan_wins_on_default_args(self, tmp_cache):
        store_cache({}, {self.KEY: PLAN_ENTRY}, backend=CPU)
        assert self._resolve() == PlanConfig("two_pass", "kcm", 136, 64, True)

    def test_pinned_mult_impl_keeps_dataflow_drops_blocks(self, tmp_cache):
        store_cache({}, {self.KEY: PLAN_ENTRY}, backend=CPU)
        assert self._resolve(mult_impl="recurse") == PlanConfig("two_pass", "recurse")

    def test_cuda_plan_is_clamped_to_the_menu(self, tmp_cache):
        """The same (TPU-style) entry in the 'cuda' cache keeps its dataflow
        and degrades its grid to a menu tile without a fold."""
        store_cache({}, {self.KEY: PLAN_ENTRY}, backend="cuda")
        assert self._resolve(backend="cuda") == PlanConfig("two_pass", "kcm", 32, 64, False)
        assert self._resolve(backend="cuda", block_rows=16) == \
            PlanConfig("two_pass", "kcm", 16, None, None)

    def test_fully_explicit_fast_path_skips_cache(self, tmp_cache):
        store_cache({}, {self.KEY: PLAN_ENTRY}, backend=CPU)
        got = self._resolve(fused=True, mult_impl="recurse", block_rows=16,
                            block_cols=32, batch_fold=False)
        assert got == PlanConfig("fused", "recurse", 16, 32, False)


class TestPlanSweep:
    def test_candidates_deterministic_and_concrete(self):
        for backend in (CPU, "cuda"):
            a = tautotune.plan_candidates("gaussian5", 2, 64, 64, backend=backend)
            assert a == tautotune.plan_candidates("gaussian5", 2, 64, 64, backend=backend)
            assert len(a) == len(set(a))
            for p in a:
                assert p.dataflow in ("direct", "two_pass", "fused")
                assert p.mult_impl in ("recurse", "kcm")
                assert None not in (p.block_rows, p.block_cols, p.batch_fold)
        cpu = tautotune.plan_candidates("gaussian5", 2, 64, 64, backend=CPU)
        assert [tuple(p) for p in cpu] == \
            [tuple(p) for p in jautotune.plan_candidates("gaussian5", 2, 64, 64)]
        assert len(tautotune.plan_candidates("gaussian5", 8, 480, 640)) == 3 * 2 * 2

    def test_non_separable_filter_gets_direct_only(self):
        assert {p.dataflow for p in tautotune.plan_candidates("laplacian", 2, 64, 64)
                } == {"direct"}

    @staticmethod
    def _fake_timer(winner):
        def fn(p):
            return 10.0 if p == winner else 100.0 + sum(map(hash, map(str, p))) % 97
        return fn

    def test_pruned_sweep_audits_and_keeps_winner(self, tmp_cache):
        cands = tautotune.plan_candidates("gaussian5", 2, 64, 64, backend=CPU)
        # the bound-cheapest candidate as winner: it is always swept first
        winner = min(cands, key=lambda p: (tautotune.plan_bound_us(p, "gaussian5", 2, 64,
                                                                   64, CPU), p))
        entry, records = tautotune.sweep_plan(
            "gaussian5", 2, 64, 64, prune=True, backend=CPU,
            measure_fn=self._fake_timer(winner), verbose=False)
        assert entry["candidates"] == len(cands)
        assert entry["swept"] + entry["pruned"] == len(cands) and entry["pruned"] > 0
        assert entry["swept"] == len(records)
        assert PlanConfig(*(entry[k] for k in ("dataflow", "mult_impl", "block_rows",
                                               "block_cols", "batch_fold"))) == winner

    def test_exhaustive_sweep_times_everything(self, tmp_cache):
        cands = tautotune.plan_candidates("gaussian5", 8, 480, 640)
        entry, records = tautotune.sweep_plan(
            "gaussian5", 8, 480, 640, prune=False,
            measure_fn=self._fake_timer(cands[-1]), verbose=False)
        assert entry["swept"] == len(cands) == len(records) and entry["pruned"] == 0
        assert (entry["dataflow"], entry["block_rows"]) == (cands[-1].dataflow,
                                                            cands[-1].block_rows)


def _stub_timers(monkeypatch):
    """Deterministic timings as a pure function of the swept point."""
    def measure_stub(kind, cfg, n, h, w, kh, kw, impl, iters=3, device=None):
        return float(100 + cfg.block_rows % 89 + (cfg.block_cols or 0) % 13
                     + cfg.batch_fold + len(kind))

    def measure_plan_stub(name, plan, n, h, w, iters=3, device=None):
        return float(100 + plan.block_rows % 89 + plan.block_cols % 13
                     + bool(plan.batch_fold) + len(plan.dataflow)
                     + 900 * (plan.mult_impl == "recurse"))

    monkeypatch.setattr(tautotune, "measure", measure_stub)
    monkeypatch.setattr(tautotune, "measure_plan", measure_plan_stub)


class TestReproducibility:
    def test_two_quick_runs_write_identical_bytes(self, tmp_cache, monkeypatch):
        _stub_timers(monkeypatch)
        monkeypatch.setenv("BENCH_TIMESTAMP", "2026-01-01T00:00:00Z")
        assert tautotune.main(["--quick", "--no-merge", "--device", CPU]) == 0
        first = cache_path(CPU).read_bytes()
        assert json.loads(first)["plans"]
        invalidate_cache()
        assert tautotune.main(["--quick", "--no-merge", "--device", CPU]) == 0
        assert cache_path(CPU).read_bytes() == first

    def test_dist_run_merges_blocks_and_keeps_plans(self, tmp_cache, monkeypatch):
        _stub_timers(monkeypatch)
        assert tautotune.main(["--quick", "--device", CPU]) == 0
        plans = load_plans(CPU)
        assert tautotune.main(["--dist", "--device", CPU]) == 0
        assert load_plans(CPU) == plans
        blocks = load_cache(CPU)
        assert config_key("fused", 8, 260, 260, 5, 5, "kcm") in blocks
        assert config_key("fused", *tautotune.MAIN_SHAPE, 3, 3, "kcm") in blocks


class TestTune:
    def test_tune_records_the_fastest_candidate(self, tmp_cache, monkeypatch):
        fake = {BlockConfig(32, 64, False): 30.0, BlockConfig(16, 64, False): 10.0}

        def measure_stub(kind, cfg, n, h, w, kh, kw, impl, iters=3, device=None):
            return fake[cfg]

        monkeypatch.setattr(tautotune, "measure", measure_stub)
        configs = tautotune.tune([("fused", 8, 480, 640, 5, 5, "kcm")], verbose=False)
        key = config_key("fused", 8, 480, 640, 5, 5, "kcm")
        assert configs[key] == {"block_rows": 16, "block_cols": 64, "batch_fold": False,
                                "us_per_call": 10.0}
        store_cache(configs, backend="cuda")
        assert resolve_blocks("fused", 8, 480, 640, 5, 5, "kcm",
                              backend="cuda") == BlockConfig(16, 64, False)

    def test_chunk_sweep_names_the_fastest_tile_and_chunk(self, monkeypatch):
        def stub(kernel, filt, n, h, w, tile, chunk, iters=3, device=None):
            return 50.0 + tile[0] + (0 if chunk == 4 else 7)

        monkeypatch.setattr(tautotune, "measure_chunk", stub)
        out = tautotune.tune_chunks(tautotune.CHUNK_QUICK, verbose=False)
        assert set(out) == {f"{k}/{f}/n8x480x640" for k, f, *_ in tautotune.CHUNK_QUICK}
        for row in out.values():
            assert row["winner"] == {"tile": "16x64", "chunk": "4", "us_per_call": 66.0}
            assert set(row["32x64"]) == {"own", "0", "4", "8", "16"}

    def test_chunk_menu_is_where_the_kernels_compile_it(self):
        assert tconv.chunk_menu("conv_pass_recurse", "refmlm", 8, 3, 3) == tconv.CHUNKS
        assert tconv.chunk_menu("conv_pass_recurse", "refmlm_nc", 4, 3, 3) == tconv.CHUNKS
        assert tconv.chunk_menu("conv_pass_recurse", "refmlm", 8, 5, 5) == ()
        assert tconv.chunk_menu("conv_pass_recurse", "mitchell", 8, 3, 3) == ()
        assert tconv.chunk_menu("fused_separable_recurse", "refmlm", 8, 5, 5, 16) == tconv.CHUNKS
        assert tconv.chunk_menu("fused_separable_recurse", "refmlm", 8, 3, 3, 8) == ()
        assert tconv.chunk_menu("fused_separable_recurse", "refmlm", 8, 3, 5, 16) == ()
        x = torch.zeros((1, 8, 8), dtype=torch.int32)
        taps = np.ones((3, 3), np.int64)
        for chunk in tconv.CHUNKS:
            tconv.conv_pass_recurse(x, taps, method="refmlm", nbits=8, shift=0,
                                    post="none", chunk=chunk)
        with pytest.raises(ValueError, match="chunk"):
            tconv.conv_pass_recurse(x, taps, method="exact", nbits=8, shift=0,
                                    post="none", chunk=4)

    def test_measuring_needs_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tautotune.measure("fused", BlockConfig(32, 64, False), 1, 8, 8, 3, 3, "kcm")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tautotune.main(["--quick"])
