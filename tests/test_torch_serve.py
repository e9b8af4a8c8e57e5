"""The port's serving path (`repro_torch.serve`) against its own direct
calls and against the JAX package's server, on the CPU.

  * scheduling parity: the same fake-clock schedule through the
    reference's `ShapeBucketedBatcher` and the port's flushes the same
    batches, for the same reasons, in the same order, and sheds the same
    requests;
  * port-served bytes equal port-direct bytes (`apply_filter(...,
    device='cpu')`) for every bank filter x multiplier x mult_impl;
  * port-served bytes equal reference-served bytes (interpret mode) for
    the bank at refmlm kcm and for recurse cases;
  * serving behaviour: exactly-once delivery under concurrent mixed load,
    poison isolation through `fault_scope`, the scale-out exec modes
    served byte-equal to the direct call (per request and as the server's
    default), the pool refused at construction, the server refusing to
    start without a card unless the CPU is asked for, warmup.

The datapath is all integers: the tolerance is zero. The kernels run only
on the card, where `chip_smoke.py`'s serve phase drives this server.
"""
import threading

import numpy as np
import pytest
import torch

import repro.serve as jserve
import repro_torch.serve as tserve
from repro.serve.batcher import ShapeBucketedBatcher as JBatcher
from repro_torch.filters import FILTER_NAMES, apply_filter
from repro_torch.runtime.fault import SITE_EXECUTE, FaultInjector, InjectedFault, fault_scope
from repro_torch.serve.batcher import ShapeBucketedBatcher as TBatcher

# The suite runs in several worker processes; one torch thread each keeps
# them from oversubscribing the cores.
torch.set_num_threads(1)

METHODS = ("exact", "refmlm", "refmlm_nc", "mitchell", "mitchell_ecc2", "odma")
SHAPE = (24, 32)
FAR = 3_600_000.0          # a flush deadline no test reaches


def image(seed: int, shape=SHAPE) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def cpu_server(**kw) -> tserve.ImageFilterServer:
    kw.setdefault("max_delay_ms", 1.0)
    return tserve.ImageFilterServer(tserve.ServerConfig(device="cpu", **kw))


# ------------------------------------------------------------ scheduling parity

def _schedule(seed: int):
    """A seeded schedule of (time step, request fields) with mixed shapes,
    filters, priorities, deadlines and weights, plus overload sheds."""
    rng = np.random.default_rng(seed)
    steps = []
    for seq in range(1, 41):
        steps.append(dict(
            dt=float(rng.choice([0.0, 0.0, 0.0, 0.0002, 0.0005, 0.004])),
            shape=[(8, 8), (130, 130)][int(rng.integers(2))],
            filt=["gaussian3", "sobel_x"][int(rng.random() < 0.2)],
            priority=["high", "normal", "low"][int(rng.integers(3))],
            deadline=(None if rng.random() < 0.7 else float(rng.uniform(0.001, 0.006))),
            shed=int(rng.integers(0, 4)) if rng.random() < 0.1 else 0,
            seq=seq))
    return steps


def _run_schedule(pkg, batcher_cls, steps):
    """Drive one batcher through `steps`; -> the flush/shed log."""
    clock = FakeClock()
    b = batcher_cls(max_batch=2, max_delay_s=0.003, clock=clock)
    log = []
    for st in steps:
        clock.t += st["dt"]
        h, w = st["shape"]
        req = pkg.FilterRequest(
            img=np.zeros((h, w), np.int32), filt=st["filt"], method="refmlm",
            mult_impl="auto", exec="local", nbits=8, future=pkg.FilterFuture(),
            submitted=clock.t, seq=st["seq"],
            deadline=None if st["deadline"] is None else clock.t + st["deadline"],
            priority=st["priority"], weight=pkg.request_weight(h, w))
        b.add(req)
        if st["shed"]:
            log.append(("overload", b.shed_overload(st["shed"])))
        for mb in b.ready():
            log.append((mb.key, mb.reason, tuple(r.seq for r in mb.requests)))
        log.extend(("shed", s.cause, s.request.seq) for s in b.take_shed())
        log.append(("next", b.next_deadline()))
    for mb in b.drain():
        log.append((mb.key, mb.reason, tuple(r.seq for r in mb.requests)))
    log.extend(("shed", s.cause, s.request.seq) for s in b.take_shed())
    return log


@pytest.mark.parametrize("seed", range(6))
def test_batcher_schedule_matches_the_reference(seed):
    steps = _schedule(seed)
    want = _run_schedule(jserve, JBatcher, steps)
    got = _run_schedule(tserve, TBatcher, steps)
    assert got == want
    reasons = {e[1] for e in got if e[0] not in ("next", "overload", "shed")}
    assert reasons == {"size", "deadline", "drain"}


def test_keys_and_weights_match_the_reference():
    for args in [("gaussian3", "refmlm", "kcm", "local", 8, 480, 640, "high"),
                 ("sobel_x", "mitchell", "auto", "local", 16, 7, 9, "low", "infer")]:
        assert tserve.bucket_key(*args) == jserve.bucket_key(*args)
        assert tserve.serve_key(tserve.bucket_key(*args), 4) == \
            jserve.serve_key(jserve.bucket_key(*args), 4)
    for hw in [(1, 1), (128, 128), (129, 128), (2048, 2048)]:
        assert tserve.request_weight(*hw) == jserve.request_weight(*hw)
    assert [tserve.next_pow2(n) for n in range(1, 18)] == \
        [jserve.next_pow2(n) for n in range(1, 18)]


# ------------------------------------------------------ served == direct (port)

@pytest.mark.parametrize("mult_impl", ("kcm", "recurse"))
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("filt", FILTER_NAMES)
def test_served_bytes_equal_direct_bytes(filt, method, mult_impl):
    imgs = [image(i) for i in range(3)]
    with cpu_server(max_batch=4) as srv:
        futs = [srv.submit(im, filt, method=method, mult_impl=mult_impl)
                for im in imgs]
        outs = [f.result(60) for f in futs]
    for im, out in zip(imgs, outs):
        want = apply_filter(im, filt, method=method, mult_impl=mult_impl,
                            device="cpu")
        assert out.device.type == "cpu" and out.dtype == torch.uint8
        assert torch.equal(out, want)


# -------------------------------------------------- served == reference-served

REF_RECURSE = (("gaussian3", "mitchell"), ("sobel_x", "refmlm"))


@pytest.fixture(scope="module")
def reference_served():
    """Both servers over the same requests: the bank at refmlm kcm and the
    REF_RECURSE cases, two 16x24 frames each."""
    imgs = [image(100 + i, (16, 24)) for i in range(2)]
    cases = [(f, "refmlm", "kcm") for f in FILTER_NAMES]
    cases += [(f, m, "recurse") for f, m in REF_RECURSE]

    def serve(pkg, cfg):
        with pkg.ImageFilterServer(cfg) as srv:
            futs = {(c, i): srv.submit(im, c[0], method=c[1], mult_impl=c[2])
                    for c in cases for i, im in enumerate(imgs)}
            return {k: np.asarray(f.result(300)) for k, f in futs.items()}

    ref = serve(jserve, jserve.ServerConfig(max_batch=2, max_delay_ms=5.0,
                                            interpret=True))
    port = serve(tserve, tserve.ServerConfig(max_batch=2, max_delay_ms=5.0,
                                             device="cpu"))
    return ref, port


@pytest.mark.parametrize("filt", FILTER_NAMES)
def test_bank_served_at_refmlm_kcm_equals_reference_served(reference_served, filt):
    ref, port = reference_served
    for i in range(2):
        key = ((filt, "refmlm", "kcm"), i)
        np.testing.assert_array_equal(port[key], ref[key])


@pytest.mark.parametrize("filt,method", REF_RECURSE)
def test_recurse_served_equals_reference_served(reference_served, filt, method):
    ref, port = reference_served
    for i in range(2):
        key = ((filt, method, "recurse"), i)
        np.testing.assert_array_equal(port[key], ref[key])


# --------------------------------------------------------------- behaviour

def test_concurrent_mixed_load_is_exactly_once():
    """4 client threads, mixed shapes / filters / priorities: every future
    resolves once, to its own image's bytes."""
    jobs = [(seed, ["gaussian3", "sobel_y", "sharpen3"][seed % 3],
             [(12, 16), (20, 12)][seed % 2], ["high", "normal", "low"][seed % 3])
            for seed in range(48)]
    results: dict[int, torch.Tensor] = {}
    lock = threading.Lock()
    with cpu_server(max_batch=4, max_delay_ms=2.0) as srv:
        def client(part):
            for seed, filt, shape, pri in part:
                out = srv.submit(image(seed, shape), filt, priority=pri).result(60)
                with lock:
                    assert seed not in results
                    results[seed] = out
        threads = [threading.Thread(target=client, args=(jobs[k::4],)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = srv.stats()
    assert sorted(results) == list(range(48))
    for seed, filt, shape, _ in jobs:
        assert torch.equal(results[seed],
                           apply_filter(image(seed, shape), filt, device="cpu"))
    assert stats["submitted"] == stats["served"] == 48
    assert stats["failed"] == stats["pending"] == 0
    assert sum(n * c for n, c in stats["occupancy"].items()) == 48


def test_poisoned_request_is_isolated_and_neighbours_reserved():
    imgs = [image(200 + i) for i in range(8)]
    with cpu_server(max_batch=8, max_delay_ms=FAR) as srv:
        inj = FaultInjector().poison(SITE_EXECUTE, 3)
        with fault_scope(inj):
            futs = [srv.submit(im, "gaussian5") for im in imgs]
            srv.close(drain=True)
        stats = srv.stats()
    for seq, (im, fut) in enumerate(zip(imgs, futs), start=1):
        if seq == 3:
            assert isinstance(fut.exception(), InjectedFault)
        else:
            assert torch.equal(fut.result(0), apply_filter(im, "gaussian5", device="cpu"))
    assert stats["failed"] == 1 and stats["served"] == 7
    assert stats["isolated"] == 1 and stats["retries"] > 0
    assert inj.events and all(e[0] == SITE_EXECUTE for e in inj.events)


@pytest.mark.parametrize("mode", ("sharded", "streamed"))
def test_scale_out_request_is_refused_before_admission(mode):
    """A scale-out request is admitted and served through its mode (2
    logical CPU shards, or 8x16 tiles), byte-equal to the direct call,
    beside a local one; no dispatch fails, so nothing degrades."""
    with cpu_server(devices=2, tile=(8, 16), tile_batch=3) as srv:
        futs = [srv.submit(image(i), "gaussian3", exec=mode) for i in range(3)]
        local = srv.submit(image(9), "gaussian3")
        got = [f.result(60) for f in futs]
        assert torch.equal(local.result(60), apply_filter(image(9), "gaussian3", device="cpu"))
        stats = srv.stats()
    for i, out in enumerate(got):
        assert torch.equal(out, apply_filter(image(i), "gaussian3", device="cpu"))
    assert stats["submitted"] == stats["served"] == 4
    assert stats["degraded"] == {} and stats["dispatch_failures"] != {}
    assert all(v == 0 for v in stats["dispatch_failures"].values())


@pytest.mark.parametrize("mode", ("sharded", "streamed"))
def test_scale_out_default_exec_is_refused_at_construction(mode):
    """`ServerConfig.exec` makes a scale-out mode every request's default:
    the server starts, and serves the direct call's bytes."""
    with cpu_server(exec=mode, devices=4, tile=(16, 16)) as srv:
        futs = {f: srv.submit(image(3), f) for f in ("gaussian5", "sobel_x", "sharpen3")}
        outs = {f: fut.result(60) for f, fut in futs.items()}
    for f, out in outs.items():
        assert torch.equal(out, apply_filter(image(3), f, device="cpu")), f"{mode} {f}"


def test_pool_is_refused_at_construction():
    with pytest.raises(NotImplementedError, match="pool"):
        tserve.ImageFilterServer(tserve.ServerConfig(device="cpu", pool=((0,),)))


def test_executor_never_runs_a_scale_out_dispatch_locally():
    """Handed to the executor directly, a healthy scale-out batch runs on
    its own mode, however often it comes: the degraded ladder's local
    fallback serves a bucket only after `degrade_after` failed dispatches
    (here a shard probe that fails once, then the local path)."""
    from repro_torch.runtime.fault import SITE_SHARD
    ex = tserve.BatchExecutor(device="cpu", devices=2, degrade_after=1)
    for seq in range(1, 4):
        req = tserve.FilterRequest(img=image(5), filt="gaussian3", method="refmlm",
                                   mult_impl="auto", exec="sharded", nbits=8,
                                   future=tserve.FilterFuture(), submitted=0.0,
                                   seq=seq)
        ex.run(tserve.MicroBatch(req.key, (req,), "size"))
        assert torch.equal(req.future.result(0),
                           apply_filter(image(5), "gaussian3", device="cpu"))
    assert ex.stats()["misses"] == 1 and not ex.degraded_mode
    assert ex.degraded == {}
    req = tserve.FilterRequest(img=image(6), filt="gaussian3", method="refmlm",
                               mult_impl="auto", exec="sharded", nbits=8,
                               future=tserve.FilterFuture(), submitted=0.0, seq=4)
    inj = FaultInjector().at_call(SITE_SHARD, 1)
    with fault_scope(inj):
        ex.run(tserve.MicroBatch(req.key, (req,), "size"))
    assert torch.equal(req.future.result(0), apply_filter(image(6), "gaussian3", device="cpu"))
    assert ex.degraded_mode and ex.degraded == {req.key: 1}
    assert inj.events and inj.events[0][0] == SITE_SHARD


def test_server_needs_a_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the server starts on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.ImageFilterServer(tserve.ServerConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.BatchExecutor()


def test_warmup_makes_the_first_request_a_hit():
    with cpu_server(max_batch=4, max_delay_ms=FAR) as srv:
        keys = srv.warmup(shapes=[SHAPE], filters=("gaussian3", "laplacian"),
                          mult_impls=("kcm", "recurse"), batches=(4,))
        assert len(keys) == 4 and all(k.endswith("/n4") for k in keys)
        futs = [srv.submit(image(i), "laplacian", mult_impl="recurse") for i in range(4)]
        [f.result(60) for f in futs]
        compile_ = srv.stats()["compile"]
    assert compile_ == {"warmed": 4, "hits": 1, "misses": 0}


def test_result_is_a_cpu_copy_of_the_direct_call_for_hwc_frames():
    frame = image(9)[..., None]
    with cpu_server() as srv:
        out = srv.submit(frame, "box3").result(60)
    assert torch.equal(out, apply_filter(frame[..., 0], "box3", device="cpu"))
