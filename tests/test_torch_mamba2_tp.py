"""Mamba2 tensor parallelism over "model" (`models.ssm`, the selection mode
of `core.collectives.fsdp_gather`, the conv cache's selection in
`runtime.serve_lib`), zamba2-1.2b's reduced config (16 SSM heads of 16,
ssm_state 16; in_proj 128 x 560, conv channels 288) on gloo ranks on the
CPU (`tests/test_torch_train_mesh.py::run_ranks`, at most 4 a test).

  * the meshed train step on (2, 2), on (1, 2) in 2 microbatches and on
    (1, 2) under mitchell, each layer on its ranks' heads, against the
    reference's jitted single-device step and the port's unmeshed step
    (`test_torch_tp.check_case`: `check_both` at its tolerances, NaN held
    equal to NaN where the reduced init gives NaN grads, R10, under
    mitchell too since the quantizer's abs-max spreads a NaN cotangent as
    `jnp.max` does, R14; and the tensor-parallel collectives);
  * prefill + 3 decode steps on (1, 2) and (2, 2) under mitchell and
    karatsuba_int16 (`tests/test_torch_serve_tp.py`'s prompt, steps and
    `blocked_oracle`: the unmeshed mixer between its projections in each
    rank's heads, the gated norm's squares added in rank order): the
    logits of every step byte-equal to the oracle's on the same rows (on
    (2, 2) the rows split over "data", `dp_generate`), the greedy tokens
    equal; on (1, 2) the SSD and conv states too, gathered whole, byte-equal
    (the conv state's x channels gathered back over "model"), on (2, 2)
    within 1e-5 of their largest value (the float products of 2 rows and
    of 4 take other paths through the CPU's gemm); the collectives: the
    quantizer's max of the split operands over "model" and the sums;
  * a count on the fake (16, 16) production mesh (`launch.dryrun.
    count_cell`, zamba2 at full width, 2 layers, prefill_32k): a rank's
    peak with the heads split over "model" is below an eighth of the peak
    with each layer computed whole on every rank (`sharding.model_parallel`
    false, the plan before Mamba2 had a rule): the SSD scan's
    intermediates fall with "model".
"""
import dataclasses

import pytest
import torch

from test_torch_train_mesh import run_ranks
from test_torch_tp import check_case

torch.set_num_threads(1)

ARCH = "zamba2-1.2b"
SERVE_METHODS = ("mitchell", "karatsuba_int16")


@pytest.mark.parametrize("shape,changes", (((2, 2), {}), ((1, 2), {"microbatches": 2}),
                                           ((1, 2), {"matmul_method": "mitchell"})),
                         ids=("2x2", "1x2-microbatches", "1x2-mitchell"))
def test_mamba2_tp_train_step(tmp_path, shape, changes):
    check_case(tmp_path, ARCH, changes, shape)


def serve_worker(out_file: str, shape: tuple[int, int]) -> None:
    """Rank worker: zamba2 under each SERVE_METHODS unmeshed (in the
    ranks' blocks) and on a `shape` mesh; rank 0 saves both."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.runtime import sharding as shd
    from test_torch_serve_tp import blocked_oracle, config, dp_generate, generate
    mesh = make_host_mesh(data=shape[0], model=shape[1])
    results = {}
    for method in SERVE_METHODS:
        cfg = config("hybrid", method)
        model = build_model(cfg, "cpu")
        params = model.init(torch.Generator("cpu").manual_seed(0))
        with blocked_oracle(cfg, mesh):
            want = generate(model, params)
            rows = dp_generate(model, params, mesh)
        p = shd.distribute_tree(params, shd.param_shardings(params, cfg, mesh, multi_pod=False))
        shd.reset_collectives()
        got = generate(model, p, mesh=mesh)
        results[method] = {"want": want, "rows": rows, "got": got,
                           "collectives": dict(shd.COLLECTIVES)}
    if dist.get_rank() == 0:
        torch.save(results, out_file)


@pytest.mark.parametrize("shape", ((1, 2), (2, 2)), ids=lambda s: f"{s[0]}x{s[1]}")
def test_mamba2_tp_serve_steps_and_states(tmp_path, shape):
    out = str(tmp_path / "serve.pt")
    run_ranks(tmp_path, shape[0] * shape[1], f"m.serve_worker({out!r}, {tuple(shape)!r})",
              timeout=240.0, module="test_torch_mamba2_tp")
    for method, r in torch.load(out, weights_only=False).items():
        want, rows, got = r["want"], r["rows"], r["got"]
        for i, (g, w, wr) in enumerate(zip(got["logits"], want["logits"], rows["logits"])):
            assert torch.equal(g, wr), (method, i, float((g - wr).abs().max()))
            if shape[0] == 1:
                assert torch.equal(g, w), (method, i)
        assert torch.equal(got["tokens"], want["tokens"]), method
        assert sorted(got["caches"]) == sorted(want["caches"])
        leaves = {path.split("/")[-1] for path in want["caches"]}
        assert leaves == {"ssm", "conv"}, leaves
        for path, w in want["caches"].items():
            g = got["caches"][path]
            assert g.shape == w.shape, (method, path)
            if shape[0] == 1:
                assert torch.equal(g, w), (method, path, float((g - w).abs().max()))
            else:
                torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * float(w.abs().max()),
                                           msg=f"{method} {path}")
        coll = r["collectives"]
        # the abs-max of the split in_proj / out_proj operands over "model";
        # the norm's squares and out_proj's partial products summed over it
        assert coll.get("all_reduce_max", 0) > 0 and coll.get("all_reduce_sum", 0) > 0, \
            (method, coll)


def test_a_mamba2_layers_peak_falls_with_model(monkeypatch):
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import count_cell
    from repro_torch.launch.mesh import fake_production_mesh
    from repro_torch.runtime import sharding

    cfg = dataclasses.replace(get_config(ARCH), num_layers=2)

    def peak() -> int:
        with fake_production_mesh() as mesh:
            counts, _ = count_cell(cfg, SHAPES["prefill_32k"], mesh, device="cpu")
        return counts.peak_bytes

    split = peak()
    monkeypatch.setattr(sharding, "model_parallel", lambda cfg, mesh: False)
    whole = peak()
    assert 8 * split < whole, (split, whole)
