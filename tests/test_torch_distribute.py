"""The port's scale-out modes (`repro_torch.distribute`) against the JAX
package's, on the CPU.

  * planning: `plan_tiles`, `auto_mesh_shape`, `shard_dims` and
    `shard_local_shape` equal the reference's over a dense grid of shapes
    (the reference's own hypothesis-free cases included);
  * streamed: `stream_filter` gives the reference's `stream_filter` bytes
    (interpret mode, small sizes), with NumPy arrays and with memmaps in
    and out, for every bank filter at the contract's multiplier configs;
  * sharded: `sharded_apply_filter` on 1, 2 and 4 logical CPU shards, both
    halos, every mesh shape, non-divisible batches and rows and images
    smaller than one shard, equals the reference's local pass; the raw
    pass wrappers equal the port's local passes;
  * cache keying: the plan cache is consulted with the tile-local and
    shard-local shapes, never the global one;
  * crash-resume: the cases of `test_fault_tolerance.py::
    TestStreamCrashResume`, and a run the reference killed resumed by the
    port, byte-identical.

The tolerance is zero.
"""
import itertools

import numpy as np
import pytest
import torch

import repro.distribute as jdist
import repro.filters as jfilters
import repro.runtime.fault as jfault
import repro_torch.distribute as tdist
import repro_torch.filters.pipeline as tpipeline
from repro_torch.distribute import (
    JOURNAL_MAGIC,
    auto_mesh_shape,
    filter_mesh,
    journal_fingerprint,
    load_journal,
    plan_tiles,
    shard_dims,
    shard_local_shape,
    sharded_apply_filter,
    sharded_conv2d_pass,
    sharded_fused_separable_pass,
    stream_filter,
)
from repro_torch.filters import FILTER_NAMES, apply_filter, conv2d_pass, fused_separable_pass
from repro_torch.runtime.fault import SITE_SHARD, SITE_TILE, FaultInjector, InjectedFault, fault_scope
from repro_torch.tuning import invalidate_cache, plan_key, store_cache
from repro_torch.tuning.cache import CACHE_ENV

torch.set_num_threads(1)

CPU = "cpu"
RNG = np.random.default_rng(7)
BATCH = RNG.integers(0, 256, (2, 48, 40)).astype(np.int32)
#: the multiplier configs of the invariance contract (the reference's)
MULT_CONFIGS = (("exact", "auto"), ("refmlm", "recurse"), ("refmlm", "kcm"))

_REF_LOCAL: dict[tuple, np.ndarray] = {}


def ref_local(imgs: np.ndarray, name: str, method: str = "refmlm",
              impl: str = "auto") -> np.ndarray:
    """The reference's local pass (interpret mode), memoised per input."""
    key = (imgs.tobytes(), imgs.shape, name, method, impl)
    if key not in _REF_LOCAL:
        _REF_LOCAL[key] = np.asarray(jfilters.apply_filter(imgs, name, method=method,
                                                           mult_impl=impl))
    return _REF_LOCAL[key]


# ----------------------------------------------------------------- planning

PLAN_GRID = list(itertools.product((1, 5, 33, 48), (1, 17, 40), (1, 7, 16), (1, 8, 24)))


@pytest.mark.parametrize("h,w,th,tw", PLAN_GRID)
def test_plan_tiles_equal_the_reference(h, w, th, tw):
    for ph, pw in itertools.product((0, 1, 2), (0, 1, 2)):
        got = plan_tiles(h, w, th, tw, ph, pw)
        assert [tuple(t) for t in got] == \
            [tuple(t) for t in jdist.plan_tiles(h, w, th, tw, ph, pw)]
        owned = np.zeros((h, w), np.int32)
        for t in got:
            owned[t.r0:t.r1, t.c0:t.c1] += 1
            assert (t.sr1 - t.sr0 + t.pad_top <= th + 2 * ph
                    and t.sc1 - t.sc0 + t.pad_left <= tw + 2 * pw)
        assert (owned == 1).all()


def test_bad_tile_raises():
    with pytest.raises(ValueError, match="must be positive"):
        plan_tiles(8, 8, 0, 4, 1, 1)


def test_mesh_planning_equals_the_reference():
    for ndev, n in itertools.product(range(1, 17), range(0, 20)):
        assert auto_mesh_shape(ndev, n) == jdist.auto_mesh_shape(ndev, n)
    for n, h, nb, nr, ph in itertools.product((1, 3, 8), (1, 2, 5, 48, 97), (1, 2, 4),
                                              (1, 2, 3, 8), (0, 1, 2)):
        assert shard_dims(n, h, nb, nr, ph) == jdist.shard_dims(n, h, nb, nr, ph)
        for w in (1, 40):
            got = shard_local_shape(n, h, w, nb, nr, ph)
            assert got == jdist.shard_local_shape(n, h, w, nb, nr, ph)
            if nr > 1 and ph > 0:
                assert got != (n, h, w) or h == got[1]


def test_filter_mesh_on_logical_cpu_shards():
    mesh = filter_mesh(4, device=CPU, n=2)
    assert mesh.shape == (2, 2) and mesh.ids.tolist() == [[0, 1], [2, 3]]
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert filter_mesh(None, device=CPU).shape == (1, tdist.CPU_LOGICAL_DEVICES)
    assert filter_mesh([5, 3], (1, 2), device=CPU).ids.tolist() == [[5, 3]]
    with pytest.raises(ValueError, match="are visible"):
        filter_mesh(None, (4, 4), device=CPU)
    with pytest.raises(ValueError, match="unknown device ids"):
        filter_mesh([0, 9], device=CPU)
    with pytest.raises(ValueError, match="needs 4 devices"):
        filter_mesh(2, (2, 2), device=CPU)


# ------------------------------------------------------------------ streamed

class TestStreamed:
    @pytest.mark.parametrize("name", FILTER_NAMES)
    @pytest.mark.parametrize("method,impl", MULT_CONFIGS)
    def test_bytes_equal_the_reference_stream(self, name, method, impl):
        got = apply_filter(BATCH, name, method=method, mult_impl=impl, exec="streamed",
                           tile=(16, 16), tile_batch=5, device=CPU)
        assert isinstance(got, np.ndarray) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref_local(BATCH, name, method, impl))

    def test_reference_stream_matches(self):
        """The reference's own streamed run, tile for tile."""
        want = jdist.stream_filter(BATCH, "gaussian5", tile=(16, 24), tile_batch=3)
        got = stream_filter(BATCH, "gaussian5", tile=(16, 24), tile_batch=3, device=CPU)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("tile", [(8, 8), (16, 24), (48, 40), (64, 64), (13, 9)])
    def test_tile_shape_invariance(self, tile):
        got = stream_filter(BATCH, "gaussian5", tile=tile, device=CPU)
        np.testing.assert_array_equal(got, ref_local(BATCH, "gaussian5"))

    def test_single_image_and_nhwc(self):
        img = BATCH[0]
        got = apply_filter(img, "sobel_x", exec="streamed", tile=(16, 16), device=CPU)
        np.testing.assert_array_equal(got, ref_local(img, "sobel_x"))
        got4 = apply_filter(torch.from_numpy(BATCH[..., None]), "sobel_x", exec="streamed",
                            tile=(16, 16), device=CPU)
        assert got4.shape == BATCH[..., None].shape

    def test_memmap_source_and_out_equal_the_reference(self, tmp_path):
        """Both endpoints disk-backed, in both packages: the same bytes on
        disk."""
        h, w = 96, 80
        data = RNG.integers(0, 256, (h, w)).astype(np.uint8)
        np.memmap(tmp_path / "src.u8", np.uint8, "w+", shape=(h, w))[:] = data
        src = np.memmap(tmp_path / "src.u8", np.uint8, "r", shape=(h, w))
        outs = {}
        for pkg, run in (("ref", jdist.stream_filter), ("port", stream_filter)):
            out = np.memmap(tmp_path / f"{pkg}.u8", np.uint8, "w+", shape=(h, w))
            kw = {"device": CPU} if pkg == "port" else {}
            assert run(src, "gaussian3", method="refmlm", tile=(32, 32), out=out, **kw) is out
            out.flush()
            outs[pkg] = np.array(np.memmap(tmp_path / f"{pkg}.u8", np.uint8, "r",
                                           shape=(h, w)))
        np.testing.assert_array_equal(outs["port"], outs["ref"])
        assert (tmp_path / "port.u8.journal").read_text() == \
            (tmp_path / "ref.u8.journal").read_text()

    def test_stats_count_the_run(self):
        stats = {}
        stream_filter(BATCH, "gaussian3", tile=(16, 16), tile_batch=4, device=CPU,
                      stats=stats)
        assert stats["tiles"] == 2 * 3 * 3 and stats["batches"] == 5
        assert stats["host_s"] >= 0 and stats["device_s"] > 0

    def test_out_guards(self):
        with pytest.raises(ValueError, match="out shape"):
            stream_filter(np.zeros((8, 8), np.uint8), "gaussian3",
                          out=np.zeros((4, 4), np.uint8), device=CPU)
        buf = RNG.integers(0, 256, (32, 32)).astype(np.uint8)
        with pytest.raises(ValueError, match="alias"):
            stream_filter(buf, "gaussian3", tile=(8, 8), out=buf, device=CPU)

    def test_exec_arg_validation(self):
        for kw, match in ((dict(exec="remote"), "exec must be one of"),
                          (dict(tile=(8, 8)), "require exec="),
                          (dict(halo="embedded"), "require exec="),
                          (dict(exec="streamed", devices=2), "sharded-mode"),
                          (dict(exec="streamed", halo="embedded"), "sharded-mode"),
                          (dict(exec="sharded", tile=(8, 8)), "streamed-mode"),
                          (dict(exec="sharded", tile_batch=4), "streamed-mode")):
            with pytest.raises(ValueError, match=match):
                apply_filter(BATCH, "gaussian3", device=CPU, **kw)


# ------------------------------------------------------------------- sharded

SHARD_CASES = [(1, None), (2, None), (2, (1, 2)), (2, (2, 1)), (4, None),
               (4, (1, 4)), (4, (2, 2)), (4, (4, 1))]


class TestSharded:
    @pytest.mark.parametrize("name", FILTER_NAMES)
    @pytest.mark.parametrize("halo", ["exchange", "embedded"])
    def test_every_mesh_equals_the_reference(self, name, halo):
        want = ref_local(BATCH, name)
        for devices, mesh_shape in SHARD_CASES:
            got = apply_filter(BATCH, name, exec="sharded", devices=devices,
                               mesh_shape=mesh_shape, halo=halo, device=CPU)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{devices} {mesh_shape}")

    @pytest.mark.parametrize("method,impl", [("exact", "auto"), ("refmlm", "kcm")])
    @pytest.mark.parametrize("shape", [(3, 37, 23), (1, 5, 17), (5, 3, 8)])
    def test_ragged_and_small_shapes(self, method, impl, shape):
        """Non-divisible batch and rows, and images smaller than a shard."""
        imgs = RNG.integers(0, 256, shape).astype(np.int32)
        want = ref_local(imgs, "gaussian5", method, impl)
        for devices, mesh_shape in ((2, (2, 1)), (4, (1, 4)), (4, (2, 2))):
            for halo in ("exchange", "embedded"):
                got = sharded_apply_filter(imgs, "gaussian5", devices=devices,
                                           mesh_shape=mesh_shape, halo=halo, device=CPU,
                                           method=method, mult_impl=impl)
                np.testing.assert_array_equal(got.numpy(), want)

    def test_pass_wrappers_equal_the_local_passes(self):
        x = torch.from_numpy(BATCH)
        taps = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]])
        row, col = np.array([1, 4, 6, 4, 1]), np.array([1, 4, 6, 4, 1])
        for halo in ("exchange", "embedded"):
            got = sharded_conv2d_pass(x, taps, devices=4, mesh_shape=(1, 4), halo=halo,
                                      device=CPU, shift=4)
            assert torch.equal(got, conv2d_pass(x, taps, shift=4))
            got = sharded_fused_separable_pass(x, row, col, devices=4, halo=halo,
                                               device=CPU, shift=8)
            assert torch.equal(got, fused_separable_pass(x, row, col, shift=8))

    def test_mirror_defaults_to_sharded(self):
        got = tdist.apply_filter(BATCH, "box3", devices=2, device=CPU)
        np.testing.assert_array_equal(got.numpy(), ref_local(BATCH, "box3"))

    def test_bad_halo_raises(self):
        with pytest.raises(ValueError, match="halo must be one of"):
            apply_filter(BATCH, "gaussian3", exec="sharded", mesh_shape=(1, 1),
                         halo="telepathy", device=CPU)

    def test_a_shard_probe_fails_the_call(self):
        """One probe per participating shard, keyed by its device id: a rule
        on one shard fails the whole call (a lost mesh member)."""
        inj = FaultInjector().on_key(SITE_SHARD, "dev2")
        with fault_scope(inj), pytest.raises(InjectedFault):
            apply_filter(BATCH, "gaussian3", exec="sharded", devices=4, device=CPU)
        counter = FaultInjector()
        with fault_scope(counter):
            apply_filter(BATCH, "gaussian3", exec="sharded", devices=4, device=CPU)
        assert counter.calls[SITE_SHARD] == 4


# -------------------------------------------------------------- cache keying

@pytest.fixture()
def tmp_cache(tmp_path, monkeypatch):
    monkeypatch.setenv(CACHE_ENV, str(tmp_path))
    invalidate_cache()
    yield tmp_path
    invalidate_cache()


class TestDistributedCacheKeying:
    """Under exec != 'local' the plan cache is consulted with the per-tile
    and per-shard shapes the passes run with; a winner cached for the
    global shape is never inherited."""

    ENTRY = {"dataflow": "direct", "mult_impl": "recurse", "block_rows": 104,
             "block_cols": 40, "batch_fold": False, "us_per_call": 1.0}

    def _recording(self, monkeypatch):
        calls = []
        real = tpipeline.resolve_plan

        def spy(name, n, h, w, *a, **kw):
            plan = real(name, n, h, w, *a, **kw)
            calls.append(((n, h, w), plan))
            return plan

        monkeypatch.setattr(tpipeline, "resolve_plan", spy)
        return calls

    def test_streamed_ignores_global_shape_winner(self, tmp_cache, monkeypatch):
        n, h, w = BATCH.shape
        store_cache({}, {plan_key("gaussian5", n, h, w): self.ENTRY}, backend=CPU)
        calls = self._recording(monkeypatch)
        got = apply_filter(BATCH, "gaussian5", exec="streamed", tile=(16, 16), device=CPU)
        assert calls
        for shape, plan in calls:
            assert shape != (n, h, w) and plan.block_rows != 104
        np.testing.assert_array_equal(got, ref_local(BATCH, "gaussian5"))

    def test_streamed_honors_tile_shape_winner(self, tmp_cache, monkeypatch):
        # gaussian5 / tile 16x16 / batch 5 -> passes on (5, 20, 20)
        entry = {**self.ENTRY, "block_rows": 16, "block_cols": 16}
        store_cache({}, {plan_key("gaussian5", 5, 20, 20): entry}, backend=CPU)
        calls = self._recording(monkeypatch)
        apply_filter(BATCH, "gaussian5", exec="streamed", tile=(16, 16), tile_batch=5,
                     device=CPU)
        hits = [plan for shape, plan in calls if shape == (5, 20, 20)]
        assert hits and all(tuple(p) == ("direct", "recurse", 16, 16, False) for p in hits)

    @pytest.mark.parametrize("devices,mesh_shape", [(1, (1, 1)), (4, (1, 4)), (4, (2, 2))])
    def test_sharded_keys_on_shard_local_shape(self, tmp_cache, monkeypatch, devices,
                                               mesh_shape):
        n, h, w = BATCH.shape
        store_cache({}, {plan_key("gaussian5", n, h, w): self.ENTRY}, backend=CPU)
        calls = self._recording(monkeypatch)
        got = apply_filter(BATCH, "gaussian5", exec="sharded", devices=devices,
                           mesh_shape=mesh_shape, device=CPU)
        want_shape = shard_local_shape(n, h, w, *mesh_shape, 2)
        assert calls and all(shape == want_shape for shape, _ in calls)
        if mesh_shape != (1, 1):
            assert all(plan.block_rows != 104 for _, plan in calls)
        np.testing.assert_array_equal(got.numpy(), ref_local(BATCH, "gaussian5"))


# -------------------------------------------------------------- crash-resume

class TestStreamCrashResume:
    SHAPE = (48, 40)
    TILE = (16, 16)

    def _src(self):
        return np.random.default_rng(5).integers(0, 256, self.SHAPE).astype(np.int32)

    def test_killed_then_resumed_is_byte_identical(self, tmp_path):
        src = self._src()
        cold = stream_filter(src, "gaussian3", tile=self.TILE, tile_batch=2, device=CPU)
        out = np.memmap(tmp_path / "out.u8", np.uint8, "w+", shape=self.SHAPE)
        inj = FaultInjector().at_index(SITE_TILE, 7)      # 9 tiles, groups of 2
        with fault_scope(inj), pytest.raises(InjectedFault):
            stream_filter(src, "gaussian3", tile=self.TILE, tile_batch=2, out=out,
                          device=CPU)
        jpath = tmp_path / "out.u8.journal"
        fp = journal_fingerprint(self.SHAPE, "gaussian3", *self.TILE, {})
        assert load_journal(jpath, fp) == {0, 1, 2, 3, 4, 5}
        counter = FaultInjector()
        with fault_scope(counter):
            res = stream_filter(src, "gaussian3", tile=self.TILE, tile_batch=2, out=out,
                                resume=True, device=CPU)
        np.testing.assert_array_equal(np.asarray(res), cold)
        assert counter.calls[SITE_TILE] == 3
        assert load_journal(jpath, fp) == set(range(9))

    def test_reference_killed_port_resumes(self, tmp_path):
        """The journals are one format: a run the reference's injector
        killed finishes under the port, byte-identical."""
        src = self._src()
        out = np.memmap(tmp_path / "x.u8", np.uint8, "w+", shape=self.SHAPE)
        inj = jfault.FaultInjector().at_index(jfault.SITE_TILE, 5)
        with jfault.fault_scope(inj), pytest.raises(jfault.InjectedFault):
            jdist.stream_filter(src, "gaussian3", tile=self.TILE, tile_batch=2, out=out)
        counter = FaultInjector()
        with fault_scope(counter):
            stream_filter(src, "gaussian3", tile=self.TILE, tile_batch=2, out=out,
                          resume=True, device=CPU)
        assert counter.calls[SITE_TILE] == 5
        np.testing.assert_array_equal(np.asarray(out), ref_local(src, "gaussian3"))
        assert journal_fingerprint(self.SHAPE, "gaussian3", *self.TILE, {"method": "exact"}) \
            == jdist.streamed.journal_fingerprint(self.SHAPE, "gaussian3", *self.TILE,
                                                  {"method": "exact"})

    def test_resume_with_complete_journal_recomputes_nothing(self, tmp_path):
        src = self._src()
        out = np.memmap(tmp_path / "o.u8", np.uint8, "w+", shape=self.SHAPE)
        stream_filter(src, "gaussian3", tile=self.TILE, out=out, device=CPU)
        counter = FaultInjector()
        with fault_scope(counter):
            stream_filter(src, "gaussian3", tile=self.TILE, out=out, resume=True, device=CPU)
        assert counter.calls.get(SITE_TILE, 0) == 0

    def test_fresh_run_truncates_stale_journal(self, tmp_path):
        src = self._src()
        out = np.memmap(tmp_path / "o.u8", np.uint8, "w+", shape=self.SHAPE)
        jpath = tmp_path / "o.u8.journal"
        jpath.write_text(f"{JOURNAL_MAGIC} bogus-fingerprint\n0\n1\n")
        stream_filter(src, "gaussian3", tile=self.TILE, out=out, device=CPU)
        fp = journal_fingerprint(self.SHAPE, "gaussian3", *self.TILE, {})
        assert load_journal(jpath, fp) == set(range(9))

    def test_journal_guards(self, tmp_path):
        fp = journal_fingerprint(self.SHAPE, "gaussian3", *self.TILE, {})
        assert load_journal(tmp_path / "nope.journal", fp) == set()
        torn = tmp_path / "torn.journal"
        torn.write_text(f"{JOURNAL_MAGIC} {fp}\n0\n1\n2")
        assert load_journal(torn, fp) == {0, 1, 2}
        torn.write_text(f"{JOURNAL_MAGIC} {fp}\n0\n1\n1x")
        assert load_journal(torn, fp) == {0, 1}
        bad = tmp_path / "bad.journal"
        bad.write_text("not a journal\n0\n")
        with pytest.raises(ValueError, match="not a"):
            load_journal(bad, fp)
        other = tmp_path / "other.journal"
        other.write_text(f"{JOURNAL_MAGIC} "
                         f"{journal_fingerprint(self.SHAPE, 'sobel_x', *self.TILE, {})}\n0\n")
        with pytest.raises(ValueError, match="different stream plan"):
            load_journal(other, fp)

    def test_resume_requires_out_and_journal(self):
        src = self._src()
        with pytest.raises(ValueError, match="resume=True needs"):
            stream_filter(src, "gaussian3", tile=self.TILE, resume=True, device=CPU)
        with pytest.raises(ValueError, match="resume=True needs journal"):
            stream_filter(src, "gaussian3", tile=self.TILE, out=np.empty(self.SHAPE, np.uint8),
                          resume=True, device=CPU)

    def test_resume_mismatched_plan_refuses(self, tmp_path):
        src = self._src()
        out = np.memmap(tmp_path / "o.u8", np.uint8, "w+", shape=self.SHAPE)
        stream_filter(src, "gaussian3", tile=self.TILE, out=out, device=CPU)
        with pytest.raises(ValueError, match="different stream plan"):
            stream_filter(src, "sobel_x", tile=self.TILE, out=out, resume=True, device=CPU)

    def test_pipeline_plumbs_journal_and_resume(self, tmp_path):
        src = self._src()
        jpath = tmp_path / "j.journal"
        out = np.empty(self.SHAPE, np.uint8)
        inj = FaultInjector().at_index(SITE_TILE, 4)
        with fault_scope(inj), pytest.raises(InjectedFault):
            apply_filter(src, "gaussian3", exec="streamed", tile=self.TILE, out=out,
                         journal=str(jpath), device=CPU)
        res = apply_filter(src, "gaussian3", exec="streamed", tile=self.TILE, out=out,
                           journal=str(jpath), resume=True, device=CPU)
        np.testing.assert_array_equal(np.asarray(res), ref_local(src, "gaussian3"))
        with pytest.raises(ValueError, match="journal/resume"):
            apply_filter(src, "gaussian3", journal=str(jpath), device=CPU)
        with pytest.raises(ValueError, match="streamed-mode"):
            apply_filter(src, "gaussian3", exec="sharded", journal=str(jpath), device=CPU)
