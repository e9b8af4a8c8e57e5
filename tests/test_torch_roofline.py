"""The port's roofline layer (`repro_torch.roofline.analysis`) against the
reference's (`repro.roofline.analysis`), and the kernel wrappers' counting
path for fake tensors, on the CPU.

  * `model_flops` and the parameter count of every arch at its full config
    equal the reference's in each of its 31 runnable cells (the port's
    params counted on fake tensors, the reference's by `jax.eval_shape`);
  * `RooflineReport.to_json` has the reference's keys, and `analyze_step`
    on canned counts gives the reference's `analyze_compiled` terms and
    bottleneck on the same canned numbers (a stub compiled module) at the
    reference's rates;
  * `collective_bytes` reads `core.collectives`' kinds under the
    reference's five names;
  * `StepCounter`: a float32 and a bf16 matmul count exactly 2MNK flops
    and (MK + KN + MN) x itemsize bytes; views move none; the peak of live
    bytes and the arguments' / outputs' bytes;
  * the kernel wrappers on fake tensors (`mitchell_matmul_kernel`,
    `karatsuba_matmul_kernel` through `pack` / `product`): the kernel's
    output shape and dtype, no launch counted, the work recorded by the
    wrapper's formula; on real CPU tensors the plain bytes, nothing
    recorded.
"""
import collections
import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.models.model import build_model as ref_build_model
from repro.roofline import analysis as ref_analysis
from repro_torch.configs import SHAPES, get_config, list_archs, supported_shapes
from repro_torch.core.collectives import count_collective
from repro_torch.kernels import karatsuba_matmul as km
from repro_torch.kernels import karatsuba_matmul_i8 as km8
from repro_torch.kernels import mitchell_matmul as mm
from repro_torch.models import build_model
from repro_torch.roofline import HW, RooflineReport, analyze_step, collective_bytes, model_flops
from repro_torch.roofline.analysis import StepCounter, StepCounts, memory_analysis_dict

REF_HW = dict(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9)


def port_n_params(arch: str) -> int:
    with FakeTensorMode():
        model = build_model(get_config(arch), "cpu")
        return model.count_params(model.init(torch.Generator("cpu")))


def ref_n_params(arch: str) -> int:
    model = ref_build_model(ref_get_config(arch))
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return int(sum(p.size for p in jax.tree.leaves(params)))


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_and_params_equal_the_reference(arch):
    n = port_n_params(arch)
    assert n == ref_n_params(arch)
    cells = [s for s, ok in supported_shapes(get_config(arch)).items() if ok == "ok"]
    for shape in cells:
        assert model_flops(get_config(arch), n, SHAPES[shape]) == ref_analysis.model_flops(
            ref_get_config(arch), n, REF_SHAPES[shape]), shape
    assert model_flops(get_config(arch), n, SHAPES["train_4k"]) > 0


def test_thirty_one_cells():
    assert sum(ok == "ok" for a in list_archs()
               for ok in supported_shapes(get_config(a)).values()) == 31


class StubCompiled:
    """What `analyze_compiled` reads of a compiled module."""
    def __init__(self, flops: float, nbytes: float, ar_elems: int):
        self._cost = {"flops": flops, "bytes accessed": nbytes}
        self._hlo = f"%ar = f32[{ar_elems}]{{0}} all-reduce(f32[{ar_elems}]{{0}} %x)"

    def cost_analysis(self):
        return self._cost

    def as_text(self):
        return self._hlo


def canned(flops: float, nbytes: float, ar_elems: int) -> StepCounts:
    return StepCounts(flops_by_dtype={"bfloat16": flops}, hbm_bytes=nbytes,
                      collectives={"all_reduce_sum": 1, "all_reduce_sum_bytes": 4 * ar_elems},
                      kernels={}, aten_ops=1, argument_bytes=0, output_bytes=0,
                      alias_bytes=0, peak_bytes=0)


@pytest.mark.parametrize("flops,nbytes,ar_elems", [
    (1e15, 1e9, 1000), (1e12, 1e12, 1000), (1e9, 1e6, 10**9), (3.3e13, 2.2e11, 12345)])
def test_report_equals_the_reference_on_canned_terms(flops, nbytes, ar_elems):
    hw = HW(**REF_HW)
    want = ref_analysis.analyze_compiled(StubCompiled(flops, nbytes, ar_elems),
                                         hw=ref_analysis.HW(), model_flops_val=5e15,
                                         chips=256)
    got = analyze_step(canned(flops, nbytes, ar_elems), hw=hw, model_flops_val=5e15,
                       chips=256)
    got, want = got.to_json(), want.to_json()
    assert set(got) == set(want)
    assert got.pop("coll_breakdown") == want.pop("coll_breakdown")
    assert got == pytest.approx(want, rel=1e-12)
    assert got["bottleneck"] == want["bottleneck"]


def test_report_keys_and_compute_term_by_dtype():
    assert [f.name for f in dataclasses.fields(RooflineReport)] == [
        f.name for f in dataclasses.fields(ref_analysis.RooflineReport)]
    hw = HW()
    counts = StepCounts(flops_by_dtype={"bfloat16": 989e12, "float32": 67e12,
                                        "int8": 1979e12, "int32": 1.6727e13},
                        hbm_bytes=3.35e12, collectives={}, kernels={}, aten_ops=4,
                        argument_bytes=10, output_bytes=2, alias_bytes=3, peak_bytes=25)
    r = analyze_step(counts, hw=hw)
    assert r.compute_s == pytest.approx(4.0) and r.memory_s == pytest.approx(1.0)
    assert r.bottleneck == "compute" and r.collective_s == 0.0
    assert memory_analysis_dict(counts) == {
        "argument_size_in_bytes": 10, "output_size_in_bytes": 2, "temp_size_in_bytes": 15,
        "generated_code_size_in_bytes": None, "alias_size_in_bytes": 3}


def test_collective_bytes_under_the_reference_names():
    counts = collections.Counter()
    total, breakdown = collective_bytes(counts)
    assert total == 0 and set(breakdown) == set(ref_analysis._COLLECTIVES)
    counts.update({"all_reduce_sum": 2, "all_reduce_sum_bytes": 400, "all_reduce_max": 1,
                   "all_reduce_max_bytes": 4, "all_gather": 1, "all_gather_bytes": 1024})
    total, breakdown = collective_bytes(counts)
    assert breakdown == {"all-reduce": 404.0, "all-gather": 1024.0, "reduce-scatter": 0.0,
                         "all-to-all": 0.0, "collective-permute": 0.0}
    assert total == 1428.0
    with pytest.raises(KeyError):
        collective_bytes({"broadcast_bytes": 8})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fake", [False, True])
def test_a_matmul_counts_2mnk_flops_and_its_bytes(dtype, fake):
    m, k, n = 37, 53, 29
    ctx = FakeTensorMode() if fake else contextlib.nullcontext()
    with ctx:
        a = torch.ones((m, k), dtype=dtype)
        b = torch.ones((k, n), dtype=dtype)
        counter = StepCounter()
        counter.track_inputs((a, b))
        with counter:
            c = torch.mm(a, b)
            c.t()                                         # a view: no bytes
        counter.track_outputs(c)
    counts = counter.counts()
    name = str(dtype).removeprefix("torch.")
    assert counts.flops_by_dtype == {name: 2 * m * n * k}
    assert counts.hbm_bytes == (m * k + k * n + m * n) * dtype.itemsize
    assert counts.argument_bytes == (m * k + k * n) * dtype.itemsize
    assert counts.output_bytes == m * n * dtype.itemsize and counts.alias_bytes == 0
    assert counts.peak_bytes == (m * k + k * n + m * n) * dtype.itemsize
    assert counts.aten_ops == 2


def test_peak_follows_the_live_storages():
    with FakeTensorMode():
        counter = StepCounter()
        with counter:
            x = torch.zeros(1000)                          # 4000 bytes
            y = x + 1                                      # 8000 live
            del x
            z = y * 2                                      # 8000 live again
            del y, z
            w = torch.zeros(3000)                          # 12000 live
        assert counter.peak_bytes == 12000 and counter.live_bytes == 12000
        del w
    assert counter.live_bytes == 0


def test_the_collectives_counted_under_the_counter():
    with FakeTensorMode():
        counter = StepCounter()
        with counter:
            count_collective("all_gather", torch.empty(256, dtype=torch.bfloat16))
    assert counter.counts().collectives == {"all_gather": 1, "all_gather_bytes": 512}
    r = analyze_step(counter.counts())
    assert r.coll_bytes == 512 and r.coll_breakdown["all-gather"] == 512


# ------------------------------------------------------- the kernel wrappers --
SHAPE = (6, 300, 70)


def launches() -> tuple:
    return (dict(mm.LAUNCHES), dict(mm.ROUTE_LAUNCHES), dict(km8.LAUNCHES), dict(km.LAUNCHES))


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("num_ecc,case_split", [(0, True), (2, False)])
def test_fake_mitchell_call_counts_and_launches_nothing(device, num_ecc, case_split):
    m, k, n = SHAPE
    before = launches()
    with FakeTensorMode():
        a = torch.empty((m, k), dtype=torch.int32, device=device)
        b = torch.empty((k, n), dtype=torch.int32, device=device)
        counter = StepCounter()
        with counter:
            out = mm.mitchell_matmul_kernel(a, b, num_ecc=num_ecc, case_split=case_split)
    assert out.shape == (m, n) and out.dtype == torch.int32 and out.device.type == device
    assert launches() == before
    ops = mm.ops_per_product(num_ecc, case_split)
    assert ops == (11 if (num_ecc, case_split) == (0, True) else 6 * 3 + 2)
    counts = counter.counts()
    assert counts.kernels == {"mitchell_matmul": {"calls": 1, "ops": ops * m * k * n,
                                                  "bytes": 4 * (m * k + k * n + m * n)}}
    assert counts.flops_by_dtype == {"int32": ops * m * k * n}
    assert counts.hbm_bytes == 4 * (m * k + k * n + m * n)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("karatsuba", [True, False])
def test_fake_limb_call_counts_and_launches_nothing(device, karatsuba):
    m, k, n = SHAPE
    kp = -(-k // 128) * 128                               # K as the kernel runs it
    before = launches()
    with FakeTensorMode():
        limbs = [torch.empty(s, dtype=torch.int32, device=device)
                 for s in ((m, k), (m, k), (k, n), (k, n))]
        counter = StepCounter()
        with counter:
            outs = km.karatsuba_matmul_kernel(*limbs, karatsuba=karatsuba)
    assert [tuple(o.shape) for o in outs] == [(m, n)] * 3
    assert all(o.dtype == torch.int32 and o.device.type == device for o in outs)
    assert launches() == before
    passes = 3 if karatsuba else 4
    want = {"calls": 1, "ops": passes * 2 * m * kp * n,
            "bytes": 4 * (2 * m * kp + 2 * kp * n + 3 * m * n)}
    assert counter.counts().kernels == {"karatsuba_matmul_i8": want}
    assert counter.counts().flops_by_dtype["int8"] == want["ops"]


def test_real_cpu_calls_are_unchanged():
    rng = np.random.default_rng(0)
    m, k, n = SHAPE
    a = torch.from_numpy(rng.integers(-255, 256, (m, k), dtype=np.int32))
    b = torch.from_numpy(rng.integers(-255, 256, (k, n), dtype=np.int32))
    limbs = [torch.from_numpy(rng.integers(-64, 64, s, dtype=np.int32))
             for s in ((m, k), (m, k), (k, n), (k, n))]
    before = launches()
    counter = StepCounter()
    with counter:
        got = mm.mitchell_matmul_kernel(a, b)
        outs = km.karatsuba_matmul_kernel(*limbs, karatsuba=True)
    assert torch.equal(got, mm.mitchell_matmul_plain(a, b))
    for o, p in zip(outs, km.karatsuba_matmul_plain(*limbs, karatsuba=True)):
        assert torch.equal(o, p)
    assert launches() == before and counter.counts().kernels == {}
    with pytest.raises(ValueError):
        with FakeTensorMode():
            mm.mitchell_matmul_kernel(torch.empty((2, 3), dtype=torch.int32),
                                      torch.empty((3, 4), dtype=torch.int32), num_ecc=-1)
