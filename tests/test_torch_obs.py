"""The port's serving telemetry and cost model (`repro_torch.obs`,
`repro_torch.roofline.conv_model`, `repro_torch.runtime.fault`, the
shape-aware plan resolution), on the CPU.

  * the metrics registry and the fault injector behave as the reference's
    on the same operation / probe streams;
  * trace compatibility: a JSONL trace written by the port's server is read
    by the reference's `repro.obs.snapshot` (and the port's snapshot gives
    the same summary), with exactly one terminal per request, poisoned
    ones included, and a Chrome export;
  * the dispatch profile: one drift row per (bucket, plan) with the route
    tile in the plan tag;
  * the roofline: the 'cuda' preset's rates, unknown backends raising, the
    same op and byte accounting as the reference's model, the launch floor,
    and the filter workload's bound;
  * plan resolution: the reference's signature and defaults, each plan's
    route tile, and the backend key taken from the torch device.
"""
import json

import numpy as np
import pytest
import torch

import repro.filters as jfilters
import repro.obs as jobs
import repro.runtime.fault as jfault
import repro_torch.obs as tobs
import repro_torch.runtime.fault as tfault
import repro_torch.serve as tserve
from repro.obs.snapshot import load_jsonl as ref_load_jsonl
from repro.obs.snapshot import main as ref_snapshot_main
from repro.roofline import conv_model as jmodel
from repro_torch.filters import FILTER_NAMES, apply_filter, get_filter
from repro_torch.filters.pipeline import plan_tile, resolve_filter_plan
from repro_torch.obs.snapshot import main as port_snapshot_main
from repro_torch.roofline import conv_model as tmodel
from repro_torch.tuning import PlanConfig, backend_key, invalidate_cache
from repro_torch.tuning.cache import CACHE_ENV

# The suite runs in several worker processes; one torch thread each keeps
# them from oversubscribing the cores.
torch.set_num_threads(1)

FAR = 3_600_000.0


def image(seed: int, shape=(16, 24)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


# -------------------------------------------------------------- parity

def _registry_ops(pkg):
    reg = pkg.MetricsRegistry(max_series=6)
    c = reg.counter("c_total")
    g = reg.gauge("g")
    h = reg.histogram("h_seconds", buckets=(0.1, 1.0))
    for i in range(10):
        c.inc(i % 3, bucket=f"b{i % 4}")
        g.set(i * 0.5, bucket=f"b{i % 2}")
        h.observe(i * 0.15, bucket="x")
    return (reg.snapshot(), c.total(), c.group_by("bucket"), h.series(bucket="x"))


def test_metrics_registry_matches_the_reference():
    assert _registry_ops(tobs) == _registry_ops(jobs)


def _probe_log(fault):
    inj = (fault.FaultInjector()
           .at_call(fault.SITE_EXECUTE, 3)
           .every(fault.SITE_EXECUTE, 5, times=2)
           .on_key(fault.SITE_EXECUTE, "sobel", times=1)
           .poison(fault.SITE_EXECUTE, 17))
    fired = []
    with fault.fault_scope(inj):
        for call in range(1, 25):
            key = "sobel_x/n2" if call == 8 else "gaussian3/n2"
            try:
                fault.probe(fault.SITE_EXECUTE, key=key, seqs=(call, call + 10))
            except fault.InjectedFault:
                fired.append(call)
    fault.probe(fault.SITE_EXECUTE, seqs=(17,))      # out of scope: no-op
    return fired, [e[:4] for e in inj.events]


def test_fault_injector_fires_as_the_reference():
    got, want = _probe_log(tfault), _probe_log(jfault)
    assert got == want and len(got[0]) >= 4


# ---------------------------------------------------------------- tracing

def _traced_server(path: str):
    """A port server writing a JSONL trace: 10 requests at mixed
    priorities, seq 4 poisoned, one rejected admission."""
    srv = tserve.ImageFilterServer(tserve.ServerConfig(
        device="cpu", max_batch=4, max_delay_ms=FAR, trace=path, max_pending=12,
        admission_timeout_s=0.01))
    inj = tfault.FaultInjector().poison(tfault.SITE_EXECUTE, 4)
    with tfault.fault_scope(inj):
        futs = [srv.submit(image(i), ("gaussian3", "sobel_x")[i % 2],
                           priority=("high", "normal", "low")[i % 3])
                for i in range(10)]
        with pytest.raises(tserve.ServerOverloaded):
            srv.submit(image(99, (256, 256)), "box3", timeout=0.0)
        srv.close(drain=True)
    return srv, futs


def test_port_trace_is_read_by_the_reference_snapshot(tmp_path, capsys):
    path = str(tmp_path / "port.jsonl")
    srv, futs = _traced_server(path)
    events = ref_load_jsonl(path)
    summary = jobs.TraceRecorder.from_events(events).summary()
    assert summary["spans"] == 10 == srv.stats()["submitted"]
    assert summary["terminals"] == {"fulfil": 9, "shed": 0, "fail": 1}
    assert summary["events"]["reject"] == 1 and summary["events"]["fault"] >= 1
    # the port's reader gives the same roll-up
    assert tobs.TraceRecorder.from_events(events).summary() == summary
    chrome = str(tmp_path / "port.chrome.json")
    assert ref_snapshot_main([path, "--chrome", chrome]) == 0
    out = capsys.readouterr().out
    assert "spans: 10" in out and "WARNING" not in out
    assert json.load(open(chrome))["traceEvents"]
    assert port_snapshot_main([path, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["spans"] == 10
    for i, f in enumerate(futs, start=1):
        if i != 4:
            assert torch.equal(f.result(0), apply_filter(
                image(i - 1), ("gaussian3", "sobel_x")[(i - 1) % 2], device="cpu"))


def test_every_span_has_one_terminal_in_stage_order(tmp_path):
    srv, _ = _traced_server(str(tmp_path / "t.jsonl"))
    spans = srv.trace.spans()
    assert len(spans) == 10
    for seq, evs in spans.items():
        names = [e["event"] for e in evs]
        assert sum(n in tobs.TERMINALS for n in names) == 1, (seq, names)
        order = [tobs.STAGES.index(n) for n in names if n in tobs.STAGES]
        assert order == sorted(order), (seq, names)
        if seq == 4:
            assert names[-1] == "fail"


def test_reference_trace_is_read_by_the_port_snapshot(tmp_path):
    rec = jobs.TraceRecorder()
    for seq in (1, 2):
        for name in ("submit", "admit", "enqueue", "flush", "dispatch", "fulfil"):
            rec.event(name, seq=seq, bucket="b")
    path = str(tmp_path / "ref.jsonl")
    rec.write_jsonl(path)
    assert port_snapshot_main([path]) == 0
    assert tobs.TraceRecorder.from_events(ref_load_jsonl(path)).summary() == rec.summary()


def test_dispatch_profile_rows_carry_the_route_tile():
    srv = tserve.ImageFilterServer(tserve.ServerConfig(
        device="cpu", max_batch=2, max_delay_ms=FAR, profile=True))
    futs = [srv.submit(image(i), name) for i, name in
            enumerate(("gaussian5", "gaussian5", "laplacian", "laplacian"))]
    srv.close()
    [f.result(0) for f in futs]
    prof = srv.stats()["profile"]
    assert sorted(r["plan"] for r in prof.values()) == \
        ["direct/kcm/br32xbc64", "fused/kcm/br32xbc64"]
    for row in prof.values():
        assert row["n_obs"] == 1 and row["observed_mean_s"] > 0
        assert row["drift_mean"] > 0


def test_trace_off_is_a_noop_without_a_profile():
    srv = tserve.ImageFilterServer(tserve.ServerConfig(device="cpu", max_delay_ms=FAR))
    fut = srv.submit(image(0), "box3")
    srv.close()
    fut.result(0)
    assert srv.trace is tobs.NOOP and "profile" not in srv.stats()


# --------------------------------------------------------------- roofline

def test_cuda_preset_rates_and_launch_floor():
    hw = tmodel.hw_for("cuda")
    assert (hw.peak_flops, hw.hbm_bw) == (1.6727e13, 3.35e12)
    assert set(tmodel.launch_overhead_for("cuda").values()) == {1.98e-5}


@pytest.mark.parametrize("backend", ("tpu", None, "rocm"))
def test_unknown_backend_raises(backend):
    with pytest.raises(ValueError, match="no roofline preset"):
        tmodel.hw_for(backend)
    with pytest.raises(ValueError, match="no roofline preset"):
        tmodel.plan_cost("direct", "kcm", 1, 8, 8, 3, 3, block_rows=32,
                         block_cols=64, batch_fold=False, backend=backend)


@pytest.mark.parametrize("dataflow,kh,kw", [("direct", 3, 3), ("direct", 5, 5),
                                            ("two_pass", 5, 5), ("fused", 3, 3),
                                            ("fused", 5, 5)])
@pytest.mark.parametrize("tile", ((32, 64), (16, 32)))
def test_kcm_accounting_matches_the_reference_model(dataflow, kh, kw, tile):
    """The same ops and bytes as the reference's model on the same plan
    point; only the rates and the launch floor are the card's."""
    kw_ = dict(block_rows=tile[0], block_cols=tile[1], batch_fold=False)
    got = tmodel.plan_cost(dataflow, "kcm", 8, 480, 640, kh, kw, backend="cuda", **kw_)
    want = jmodel.plan_cost(dataflow, "kcm", 8, 480, 640, kh, kw, backend="tpu", **kw_)
    assert (got.flops, got.hbm_bytes) == (want.flops, want.hbm_bytes)
    assert got.memory_s == got.hbm_bytes / 3.35e12
    assert got.lower_bound_s == max(got.compute_s, got.memory_s) + got.overhead_s


def test_cost_orders_plans_and_sizes():
    kw_ = dict(block_rows=32, block_cols=64, batch_fold=False, backend="cuda")
    fused = tmodel.plan_cost("fused", "kcm", 16, 2048, 2048, 5, 5, **kw_)
    two = tmodel.plan_cost("two_pass", "kcm", 16, 2048, 2048, 5, 5, **kw_)
    assert two.hbm_bytes > fused.hbm_bytes and fused.bottleneck == "memory"
    small = tmodel.plan_cost("fused", "kcm", 1, 16, 16, 5, 5, **kw_)
    assert small.bottleneck == "dispatch"
    rec = tmodel.plan_cost("direct", "recurse", 8, 480, 640, 3, 3, **kw_)
    kcm = tmodel.plan_cost("direct", "kcm", 8, 480, 640, 3, 3, **kw_)
    assert rec.flops == kcm.flops                  # factor 1 on the card
    cpu_rec = tmodel.plan_cost("direct", "recurse", 8, 480, 640, 3, 3,
                               **{**kw_, "backend": "cpu"})
    assert cpu_rec.flops == 32 * kcm.flops


def test_filter_workload_bound_prices_the_route_tile(tmp_path, monkeypatch):
    """On the cache-miss plan (an empty tuning cache): the fused kernel on
    the persistent route's first tile."""
    monkeypatch.setenv(CACHE_ENV, str(tmp_path))
    invalidate_cache()
    wl = tserve.FilterWorkload()
    req = tserve.FilterRequest(img=np.zeros((480, 640), np.int32), filt="gaussian5",
                               method="refmlm", mult_impl="auto", exec="local",
                               nbits=8, future=tserve.FilterFuture(), submitted=0.0,
                               seq=1)
    bound = wl.model_bound(req, 8, backend="cuda")
    want = tmodel.plan_cost("fused", "kcm", 8, 480, 640, 5, 5, block_rows=32,
                            block_cols=64, batch_fold=False, backend="cuda")
    assert bound == want.lower_bound_s
    assert wl.model_bound(req, 16, backend="cuda") > bound
    invalidate_cache()


# ---------------------------------------------------------- plan resolution

@pytest.mark.parametrize("filt", FILTER_NAMES)
def test_shape_aware_plan_keeps_the_reference_defaults(filt):
    for impl in ("auto", "recurse"):
        got = resolve_filter_plan(filt, 4, 24, 32, method="mitchell", mult_impl=impl,
                                  device="cpu")
        want = jfilters.resolve_filter_plan(filt, 4, 24, 32, method="mitchell",
                                            mult_impl=impl)
        assert got == PlanConfig(*want)
        tile = plan_tile(filt, got)
        assert tile == ("persistent", 32, 64, False)
        for dataflow in ("direct", "two_pass", "fused"):
            if dataflow == "direct" or get_filter(filt).separable:
                assert plan_tile(filt, got._replace(dataflow=dataflow)).route == "persistent"


def test_off_bank_shapes_take_the_tiled_route():
    spec = get_filter("box3")._replace(taps=np.ones((7, 7), np.int64),
                                        sep_row=np.ones(7, np.int64),
                                        sep_col=np.ones(7, np.int64))
    assert plan_tile(spec, PlanConfig("direct", "kcm")) == ("tiled", 16, 32, False)
    assert plan_tile(spec, PlanConfig("fused", "recurse")) == ("tiled", 16, 32, False)


def test_plan_rejects_empty_shapes():
    with pytest.raises(ValueError, match="positive"):
        resolve_filter_plan("gaussian3", 0, 8, 8)


def test_backend_key_comes_from_the_torch_device():
    assert backend_key("cpu") == "cpu"
    assert backend_key(torch.device("meta")) == "meta"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            backend_key()
