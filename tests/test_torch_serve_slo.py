"""Service levels of the port's server (`repro_torch.serve`) on the CPU:
the adaptive batching controller, weighted admission and tenant quotas,
priority shedding, the plan memo, and the infer workload.

  * decision parity: the same fake-clock schedule through the reference's
    `AdaptiveBatchController` and the port's (one shared stub cost model)
    gives the same flush sizes, deadlines and calibration, and the same
    acquire / release sequence through both `AdmissionGate`s admits,
    refuses and accounts alike;
  * behaviour end to end: the adaptive server stays byte-equal to the
    direct call, overload sheds queued low-priority work and never high,
    quotas isolate tenants, weights count pixels, a blown deadline sheds;
  * `InferWorkload`: served logits equal the port's direct `forward`,
    which equals the reference's on the same model;
  * the executor's plan memo: LRU counters and the cache generation.

The datapath is all integers (and the logits a float32 function of them):
the tolerance is zero.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.infer as J
import repro.serve as jserve
import repro_torch.serve as tserve
from repro.data.images import inference_batch
from repro.serve.controller import AdaptiveBatchController as JController
from repro_torch.convert import from_reference_model
from repro_torch.filters import apply_filter
from repro_torch.infer import forward
from repro_torch.infer.serving import InferWorkload
from repro_torch.serve.controller import AdaptiveBatchController as TController
from repro_torch.tuning import invalidate_cache

# The suite runs in several worker processes; one torch thread each keeps
# them from oversubscribing the cores.
torch.set_num_threads(1)

FAR = 3_600_000.0


def image(seed: int, shape=(24, 32)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def direct(seed: int, filt: str, shape=(24, 32)) -> torch.Tensor:
    return apply_filter(image(seed, shape), filt, device="cpu")


def cpu_server(**kw) -> tserve.ImageFilterServer:
    return tserve.ImageFilterServer(tserve.ServerConfig(device="cpu", **kw))


# ------------------------------------------------------- controller parity

class StubCost:
    """One cost model for both packages' controllers: 0.4 ms + 0.1 ms a
    frame, scaled by pixels."""

    def model_bound(self, req, n, *, backend=None):
        h, w = req.img.shape
        return (4e-4 + 1e-4 * n) * (h * w) / (24 * 32)


def _decisions(pkg, controller_cls, seed: int):
    rng = np.random.default_rng(seed)
    ctl = controller_cls(16, 0.004, workloads={"filter": StubCost()})
    out = []
    now = 0.0
    for step in range(60):
        now += float(rng.choice([0.0, 0.0005, 0.002]))
        shape = [(24, 32), (64, 64)][int(rng.integers(2))]
        queue = tuple(
            pkg.FilterRequest(img=np.zeros(shape, np.int32), filt="gaussian3",
                              method="refmlm", mult_impl="auto", exec="local",
                              nbits=8, future=pkg.FilterFuture(),
                              submitted=now - 0.001 * i, seq=step * 10 + i,
                              slo=(None if rng.random() < 0.2
                                   else now + float(rng.uniform(0.001, 0.05))))
            for i in range(int(rng.integers(1, 5))))
        key = queue[0].key
        size, delay = ctl.params(key, queue)
        out.append((key, size, round(delay, 12)))
        if rng.random() < 0.5:
            ctl.observe(key, queue[0], size, float(rng.uniform(2e-4, 5e-3)))
    st = ctl.stats()
    return out, st


@pytest.mark.parametrize("seed", range(5))
def test_controller_decisions_match_the_reference(seed):
    want, want_st = _decisions(jserve, JController, seed)
    got, got_st = _decisions(tserve, TController, seed)
    assert got == want
    assert got_st == want_st
    assert len({size for _, size, _ in got}) > 1


def _gate_log(pkg, seed: int):
    rng = np.random.default_rng(seed)
    gate = pkg.AdmissionGate(10, 0.0, tenant_quota=6, tenant_quotas={"bulk": 3})
    held, log = [], []
    for _ in range(80):
        if held and rng.random() < 0.4:
            w, t = held.pop(int(rng.integers(len(held))))
            gate.release(w, t)
            log.append(("release", w, t))
        else:
            w = int(rng.integers(1, 5))
            t = ["bulk", "cam", "default"][int(rng.integers(3))]
            try:
                gate.acquire(w, t, 0.0)
                held.append((w, t))
                log.append(("admit", w, t))
            except Exception as err:             # noqa: BLE001
                log.append((type(err).__name__, w, t))
        log.append(gate.snapshot())
    return log


@pytest.mark.parametrize("seed", range(3))
def test_admission_gate_matches_the_reference(seed):
    got, want = _gate_log(tserve, seed), _gate_log(jserve, seed)
    assert got == want
    kinds = {e[0] for e in got if isinstance(e, tuple)}
    assert {"admit", "release", "ServerOverloaded", "TenantOverQuota"} <= kinds


# ----------------------------------------------------------- end to end

def test_adaptive_server_stays_byte_equal():
    with cpu_server(max_batch=4, max_delay_ms=5.0, adaptive=True) as srv:
        futs = [(srv.submit(image(i), "gaussian5", priority=p, slo_ms=500.0), i)
                for i, p in enumerate(("high", "normal", "low") * 3)]
        for fut, i in futs:
            assert torch.equal(fut.result(60), direct(i, "gaussian5"))
        st = srv.stats()
    assert st["controller"]["decisions"] > 0
    assert all(n <= 4 for n in st["controller"]["chosen"].values())
    assert st["served_priority"]["high"] == 3


def test_overload_sheds_the_newest_low_request():
    srv = cpu_server(max_batch=64, max_delay_ms=FAR, max_pending=2,
                     overload_shed=True, admission_timeout_s=10.0)
    try:
        f_old = srv.submit(image(1), "gaussian3", priority="low")
        f_new = srv.submit(image(2), "gaussian3", priority="low")
        f_high = srv.submit(image(3), "gaussian3", priority="high")
    finally:
        srv.close(drain=True)
    with pytest.raises(tserve.ServerOverloaded):
        f_new.result(5)
    assert torch.equal(f_old.result(5), direct(1, "gaussian3"))
    assert torch.equal(f_high.result(5), direct(3, "gaussian3"))
    st = srv.stats()
    assert st["shed_overload"] == 1 and st["served"] == 2


def test_high_priority_is_never_overload_shed():
    srv = cpu_server(max_batch=64, max_delay_ms=FAR, max_pending=2,
                     overload_shed=True, admission_timeout_s=0.3)
    try:
        f1 = srv.submit(image(1), "gaussian3", priority="high")
        f2 = srv.submit(image(2), "gaussian3", priority="high")
        with pytest.raises(tserve.ServerOverloaded):
            srv.submit(image(3), "gaussian3", priority="high")
    finally:
        srv.close(drain=True)
    assert torch.equal(f1.result(5), direct(1, "gaussian3"))
    assert torch.equal(f2.result(5), direct(2, "gaussian3"))
    assert srv.stats()["shed_overload"] == 0


def test_tenant_quota_isolates_tenants():
    srv = cpu_server(max_batch=64, max_delay_ms=FAR, max_pending=8,
                     tenant_quotas={"bulk": 1}, admission_timeout_s=0.2)
    try:
        f_bulk = srv.submit(image(1), "gaussian3", tenant="bulk")
        with pytest.raises(tserve.TenantOverQuota):
            srv.submit(image(2), "gaussian3", tenant="bulk")
        f_other = srv.submit(image(3), "gaussian3", tenant="fast")
    finally:
        srv.close(drain=True)
    assert torch.equal(f_bulk.result(5), direct(1, "gaussian3"))
    assert torch.equal(f_other.result(5), direct(3, "gaussian3"))
    assert srv.stats()["rejected"] == 1


def test_weighted_admission_counts_pixels():
    """One 256x256 frame (weight 4) fills a max_pending=4 server."""
    srv = cpu_server(max_batch=64, max_delay_ms=FAR, max_pending=4,
                     admission_timeout_s=0.2)
    try:
        big = srv.submit(image(1, (256, 256)), "box3")
        with pytest.raises(tserve.ServerOverloaded):
            srv.submit(image(2), "box3")
    finally:
        srv.close(drain=True)
    assert torch.equal(big.result(10), direct(1, "box3", (256, 256)))


def test_deadline_sheds_and_slo_only_shapes_batching():
    clock_t = [0.0]
    srv = tserve.ImageFilterServer(
        tserve.ServerConfig(device="cpu", max_batch=8, max_delay_ms=FAR),
        clock=lambda: clock_t[0])
    try:
        shed = srv.submit(image(1), "gaussian3", deadline_ms=5.0)
        kept = srv.submit(image(2), "gaussian3", slo_ms=1e-3)
        clock_t[0] = 1.0                      # past the deadline and the SLO
    finally:
        srv.close(drain=True)
    with pytest.raises(tserve.DeadlineExceeded):
        shed.result(5)
    assert torch.equal(kept.result(5), direct(2, "gaussian3"))
    st = srv.stats()
    assert st["shed"] == 1 and st["served"] == 1


# ------------------------------------------------------------ plan memo

def test_plan_memo_lru_counters():
    ex = tserve.BatchExecutor(device="cpu", plan_memo_max=2)
    for h, w in [(32, 32), (48, 48), (64, 64)]:
        ex._plan("gaussian3", "refmlm", "auto", 1, h, w)
    assert ex.stats()["plan_memo"] == {"size": 2, "max": 2, "hits": 0,
                                       "misses": 3, "evicts": 1}
    ex._plan("gaussian3", "refmlm", "auto", 1, 64, 64)
    assert ex.stats()["plan_memo"]["hits"] == 1
    ex._plan("gaussian3", "refmlm", "auto", 1, 32, 32)
    pm = ex.stats()["plan_memo"]
    assert pm["misses"] == 4 and pm["evicts"] == 2


def test_plan_memo_pins_the_plan_and_follows_the_cache_generation():
    ex = tserve.BatchExecutor(device="cpu")
    plan = ex._plan("gaussian5", "refmlm", "recurse", 4, 480, 640)
    assert plan == {"separable": True, "fused": True, "mult_impl": "recurse",
                    "route": "persistent", "block_rows": 32, "block_cols": 64,
                    "batch_fold": False}
    assert ex._exec_kw("local", "sharpen3", "refmlm", "auto", 4, 8, 8) == \
        {"separable": False, "fused": False, "mult_impl": "kcm"}
    invalidate_cache()
    ex._plan("gaussian5", "refmlm", "recurse", 4, 480, 640)
    assert ex.stats()["plan_memo"]["misses"] == 3


# ------------------------------------------------------------ infer workload

HW = (8, 8)


@pytest.fixture(scope="module")
def infer_models():
    out = {}
    for name in ("cnn", "mlp"):
        g = J.MODELS[name](HW)
        ref = J.calibrate(g, J.init_params(g, seed=1), inference_batch(4, HW, seed=100))
        port = from_reference_model(
            g.name, g.input_hw, [(type(l).__name__, dataclasses.asdict(l)) for l in g.layers],
            g.num_classes, ref.params, J.export_scales(ref), device="cpu")
        out[name] = (ref, port)
    return out


@pytest.mark.parametrize("method", ("refmlm", "mitchell_ecc2", "karatsuba_int16", "odma"))
@pytest.mark.parametrize("model", ("cnn", "mlp"))
def test_infer_served_logits_equal_direct_and_reference(infer_models, model, method):
    ref, port = infer_models[model]
    x = inference_batch(3, HW, seed=5)
    wl = InferWorkload({model: port})
    with cpu_server(max_batch=4, max_delay_ms=2.0, workloads={"infer": wl}) as srv:
        futs = [srv.submit(x[i], model, method=method, workload="infer")
                for i in range(3)]
        served = torch.stack([f.result(60) for f in futs])
    port_direct = forward(port, x, method)
    want = np.asarray(J.forward(ref, x, method))
    assert served.device.type == "cpu" and served.dtype == torch.float32
    assert torch.equal(served, port_direct)
    np.testing.assert_array_equal(served.numpy(), want)
    assert wl.compiles == 1


def test_infer_workload_refuses_a_model_on_another_device(infer_models):
    _, port = infer_models["mlp"]
    ex = tserve.BatchExecutor(device="meta",
                              workloads={"infer": InferWorkload({"mlp": port})})
    with pytest.raises(ValueError, match="lives on"):
        ex.warm(HW, "mlp", method="refmlm", workload="infer")
