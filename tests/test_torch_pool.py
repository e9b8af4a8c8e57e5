"""The port's elastic executor pool (`repro_torch.serve.pool`) and device
probes (`repro_torch.runtime.elastic`) against their own direct calls and
against the JAX package's pool, on the CPU.

Device ids are logical CPU shards (`device='cpu'`, ids 0-7), the
counterpart of the reference tests' single CPU device and their 8-device
subprocess. The §12 injector models device loss: a `SITE_SHARD` rule on
`dev<id>` fails that id's shard dispatches and its probes alike.

  * probes: a healthy id passes, an unknown id and an injected loss fail,
    survivors of a mesh with two lost ids still serve a sharded dispatch;
  * routing: the port's rendezvous scores equal the reference's, and
    removing a member re-routes only its buckets;
  * serving: pooled, retired-member and rebuilt-member serving byte-equal
    to the direct call; the last member is never drained; warmup warms
    the member that serves; pooled bytes equal the reference's pooled
    server's bytes (interpret mode).

The datapath is all integers: the tolerance is zero.
"""
import numpy as np
import pytest
import torch

import repro.serve as jserve
import repro_torch.serve as tserve
from repro.serve.pool import rendezvous_score as ref_rendezvous_score
from repro_torch.distribute import apply_filter as dist_apply_filter
from repro_torch.filters import apply_filter
from repro_torch.runtime.elastic import probe_device, surviving_devices
from repro_torch.runtime.fault import SITE_EXECUTE, SITE_SHARD, FaultInjector, fault_scope
from repro_torch.serve.pool import ExecutorPool, rendezvous_score
from repro_torch.serve.request import bucket_key

torch.set_num_threads(1)

SHAPE = (24, 32)


def image(seed: int, shape=SHAPE) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def direct(img, filt, **kw) -> torch.Tensor:
    return apply_filter(img, filt, device="cpu", **kw)


def cpu_server(**kw) -> tserve.ImageFilterServer:
    kw.setdefault("max_delay_ms", 2.0)
    return tserve.ImageFilterServer(tserve.ServerConfig(device="cpu", **kw))


def routed_member(filt: str, members=("m0", "m1"), exec_mode="sharded",
                  shape=SHAPE) -> str:
    h, w = shape
    key = bucket_key(filt, "refmlm", "auto", exec_mode, 8, h, w, "normal")
    return max(members, key=lambda m: rendezvous_score(m, key))


# --------------------------------------------------------- device probing

@pytest.mark.parametrize("dev_id", (0, 7))
def test_healthy_device_probes_true(dev_id):
    assert probe_device(dev_id, "cpu")


@pytest.mark.parametrize("dev_id", (8, 99, -1))
def test_unknown_id_probes_false(dev_id):
    assert not probe_device(dev_id, "cpu")


def test_injected_device_loss_probes_false():
    inj = FaultInjector().on_key(SITE_SHARD, "dev0")
    with fault_scope(inj):
        assert not probe_device(0, "cpu")
    # the loss is scoped: the device is back outside the injector
    assert probe_device(0, "cpu")


def test_surviving_devices_filters_the_lost_id():
    assert surviving_devices((0,), "cpu") == (0,)
    inj = FaultInjector().on_key(SITE_SHARD, "dev0")
    with fault_scope(inj):
        assert surviving_devices((0,), "cpu") == ()


def test_survivors_across_a_mesh():
    """Kill ids 3 and 5 of eight: the survivors name the rest, and a
    sharded dispatch over four of them equals the local pass."""
    inj = FaultInjector().on_key(SITE_SHARD, "dev3").on_key(SITE_SHARD, "dev5")
    img = (np.arange(48 * 40, dtype=np.int32).reshape(48, 40) % 251).astype(np.uint8)
    with fault_scope(inj):
        alive = surviving_devices(range(8), "cpu")
        assert alive == (0, 1, 2, 4, 6, 7)
        out = dist_apply_filter(img, "gaussian3", exec="sharded", devices=alive[:4],
                                device="cpu")
    assert torch.equal(out, direct(img, "gaussian3"))


# ---------------------------------------------------------------- routing

def test_rendezvous_scores_equal_the_reference():
    keys = [bucket_key(f"f{i}", "refmlm", "auto", mode, 8, 32, 32)
            for i in range(20) for mode in ("local", "sharded")]
    for key in keys:
        for member in ("m0", "m1", "m2", "m17"):
            assert rendezvous_score(member, key) == ref_rendezvous_score(member, key)


def test_rendezvous_is_stable_under_member_removal():
    """Removing one member re-routes only that member's keys."""
    keys = [bucket_key(f"f{i}", "refmlm", "auto", "local", 8, 32, 32)
            for i in range(60)]
    full = {k: max(("m0", "m1", "m2"), key=lambda m: rendezvous_score(m, k))
            for k in keys}
    less = {k: max(("m0", "m1"), key=lambda m: rendezvous_score(m, k))
            for k in keys}
    assert any(v == "m2" for v in full.values())
    for k in keys:
        if full[k] != "m2":
            assert less[k] == full[k]


def test_member_specs_resolve_to_logical_cpu_ids():
    pool = ExecutorPool([None, 3, (5, 6)], device="cpu")
    assert [m.device_ids for m in pool.members()] == [tuple(range(8)), (0, 1, 2), (5, 6)]
    with pytest.raises(ValueError, match="wants 9 devices"):
        ExecutorPool([9], device="cpu")


def test_executor_reports_each_dispatch_with_the_mode_used():
    """`on_dispatch` hears the mode actually used: a failed sharded
    dispatch, then the degraded ladder's local serve."""
    heard = []
    ex = tserve.BatchExecutor(device="cpu", devices=2, degrade_after=1,
                              on_dispatch=lambda *a: heard.append(a))
    req = tserve.FilterRequest(img=image(5), filt="gaussian3", method="refmlm",
                               mult_impl="auto", exec="sharded", nbits=8,
                               future=tserve.FilterFuture(), submitted=0.0, seq=1)
    with fault_scope(FaultInjector().on_key(SITE_SHARD, "dev1")):
        ex.run(tserve.MicroBatch(req.key, (req,), "size"))
    assert torch.equal(req.future.result(0), direct(image(5), "gaussian3"))
    assert heard == [(req.key, "sharded", False), (req.key, "local", True)]


# ---------------------------------------------------------------- serving

def test_pool_serves_bit_identically():
    with cpu_server(max_batch=4, pool=((0,), (0,))) as srv:
        futs = [(srv.submit(image(i), f), f, i)
                for i in range(4) for f in ("gaussian3", "sharpen3")]
        for fut, f, i in futs:
            assert torch.equal(fut.result(60), direct(image(i), f))
        st = srv.stats()
    assert st["pool"]["active"] == 2 and st["healthy"]
    assert sum(m["dispatches"] for m in st["pool"]["members"].values()) == st["batches"]


def test_failing_member_is_retired_and_buckets_rebalance():
    """Kill one member's scale-out dispatches: its §12 local fallback
    covers the detection window bit-identically, the pool retires it, and
    later traffic re-rendezvouses onto the survivor."""
    filt = "gaussian3"
    target = routed_member(filt)
    inj = FaultInjector().on_key(SITE_EXECUTE, f"exec=sharded|member={target}")
    with fault_scope(inj):
        with cpu_server(max_batch=2, exec="sharded", pool=((0,), (0,)),
                        drain_after=2, degrade_after=1) as srv:
            outs = [srv.submit(image(7), filt).result(120) for _ in range(6)]
            st = srv.stats()
    for out in outs:
        assert torch.equal(out, direct(image(7), filt))
    members = st["pool"]["members"]
    assert members[target]["state"] == "dead"
    survivor = "m1" if target == "m0" else "m0"
    assert members[survivor]["state"] == "active"
    assert members[survivor]["routes"] > 0
    assert st["pool"]["drains"] == 1
    assert st["healthy"] and st["served"] == 6


def test_member_losing_one_device_is_rebuilt_on_the_survivors():
    """A member over ids (0, 1) loses id 1: the drain probes both, rebuilds
    the member on (0,), and its sharded buckets are served there, byte-equal
    to the direct call, with no bucket left degraded."""
    filt = "sharpen3"
    target = routed_member(filt)
    pool = ((0, 1), (2, 3)) if target == "m0" else ((2, 3), (0, 1))
    inj = FaultInjector().on_key(SITE_SHARD, "dev1")
    with fault_scope(inj):
        with cpu_server(max_batch=2, exec="sharded", pool=pool,
                        drain_after=2, degrade_after=1) as srv:
            outs = [srv.submit(image(11), filt).result(120) for _ in range(5)]
            st = srv.stats()
    for out in outs:
        assert torch.equal(out, direct(image(11), filt))
    member = st["pool"]["members"][target]
    assert member["state"] == "active" and member["devices"] == [0]
    assert member["rebuilds"] == 1 and st["pool"]["rebuilds"] == 1
    assert st["pool"]["drains"] == 0 and st["healthy"]


def test_last_member_is_never_drained():
    """A one-member pool refuses the drain and survives on the §12 local
    fallback (the server reports degraded, not dead)."""
    inj = FaultInjector().on_key(SITE_EXECUTE, "exec=sharded|member=m0")
    with fault_scope(inj):
        with cpu_server(max_batch=2, exec="sharded", pool=((0,),),
                        drain_after=2, degrade_after=1) as srv:
            outs = [srv.submit(image(9), "gaussian3").result(120) for _ in range(4)]
            st = srv.stats()
    for out in outs:
        assert torch.equal(out, direct(image(9), "gaussian3"))
    assert st["pool"]["members"]["m0"]["state"] == "active"
    assert st["pool"]["drain_refused"] >= 1
    assert st["state"] == "degraded"      # pinned fallback, by design


def test_pool_warmup_routes_to_the_serving_member():
    with cpu_server(max_batch=4, pool=((0,), (0,))) as srv:
        keys = srv.warmup(shapes=[SHAPE], filters=["gaussian3", "sharpen3"])
        assert len(keys) == 2
        srv.submit(image(3), "gaussian3").result(60)
        st = srv.stats()
    assert st["compile"]["hits"] >= 1 and st["compile"]["misses"] == 0
    target = routed_member("gaussian3", exec_mode="local")
    assert st["pool"]["members"][target]["dispatches"] == 1


def test_pooled_bytes_equal_the_reference_pooled_server():
    """Both packages' pooled servers over the same local and sharded
    requests (the reference in interpret mode)."""
    imgs = [image(200 + i, (16, 24)) for i in range(2)]
    cases = [("gaussian3", "local"), ("sobel_x", "sharded"), ("sharpen3", "sharded")]

    def serve(pkg, cfg):
        with pkg.ImageFilterServer(cfg) as srv:
            futs = {(c, i): srv.submit(im, c[0], exec=c[1])
                    for c in cases for i, im in enumerate(imgs)}
            return {k: np.asarray(f.result(300)) for k, f in futs.items()}, srv.stats()

    ref, ref_st = serve(jserve, jserve.ServerConfig(
        max_batch=2, max_delay_ms=5.0, pool=((0,), (0,)), interpret=True))
    port, port_st = serve(tserve, tserve.ServerConfig(
        max_batch=2, max_delay_ms=5.0, pool=((0,), (0,)), device="cpu"))
    for key, want in ref.items():
        np.testing.assert_array_equal(port[key], want)
    for st in (ref_st, port_st):
        assert st["pool"]["active"] == 2 and st["served"] == len(cases) * len(imgs)
    # the same buckets land on the same members in both packages
    assert ({m: v["routes"] > 0 for m, v in port_st["pool"]["members"].items()}
            == {m: v["routes"] > 0 for m, v in ref_st["pool"]["members"].items()})
