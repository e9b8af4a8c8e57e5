"""The meshed train step with tensor- and expert-parallel layers and the
per-layer FSDP gather (`make_train_step(..., mesh=...)` on meshes whose
"model" axis is more than one rank), on gloo ranks on the CPU.

The ranks and the two oracles are `tests/test_torch_train_mesh.py`'s:
the reference's jitted single-device step (R12: its sharded step fails
under this JAX), the loss within rtol 2e-5 and every param within 5e-5,
and the port's unmeshed step, each param's change (new less old) within
`check_step`'s tolerances of the oracle's. Reduced configs that take each
tensor-parallel path of the layers (the last three, FAMILY_CASES, run from
`tests/test_torch_tp_families.py`):
  * qwen2-0.5b (4 query heads, 2 kv heads, tied table split over the
    vocab) on (1, 2) under mitchell (`tests/test_torch_train_mesh.py`
    runs it on (2, 2) and (2, 4) too);
  * the same with 1 kv head (wk / wv gathered, each rank taking the kv
    head its query heads read) on (2, 2);
  * deepseek-v3-671b (MLA + MoE) on (1, 2): its MLA attention column- and
    row-parallel over its 4 heads (the latent c_kv and k_rope
    replicated), its 8 experts split over "model" (each rank running 4 on
    the replicated dispatch, their partial combines all-reduced), the
    shared expert a tensor-parallel MLP;
  * zamba2-1.2b on (1, 2): its Mamba2 layers split their 16 SSM heads
    over "model" (`models.ssm`): in_proj's z / x / dt columns and the
    conv's x channels selected from their gathered blocks (B and C on
    both ranks, their grads reduce-scattered back over "model"), the
    gated norm's squares summed over "model", out_proj row-parallel;
  * llama-3.2-vision-90b on (1, 2): gated cross-attention over the image
    keys and values (the gates opened), its kv heads split over "model".
Besides: a shard-local abs-max of a split weight or activation gives
other integers than the unsplit operand's, the model-wide one the same;
and the per-layer gather's peak, counted by `StepCounter` on the fake
(16, 16) mesh, is below the params' whole bytes where the layers split
over "model", and does not grow with the layers where the rows split
over "model" instead.
"""
import dataclasses

import pytest
import torch

from test_torch_train_mesh import check_both, port_config, run_mesh, run_ranks

CASES = {
    "dense-mitchell-1x2": ("qwen2-0.5b", {"matmul_method": "mitchell"}, (1, 2)),
    "kv_gathered-2x2": ("qwen2-0.5b", {"num_kv_heads": 1}, (2, 2)),
}
#: the families' cases, run by `tests/test_torch_tp_families.py`: in one
#: file with CASES they would pass 120 s in one process
FAMILY_CASES = {
    "mla_moe-1x2": ("deepseek-v3-671b", {}, (1, 2)),
    "hybrid-1x2": ("zamba2-1.2b", {}, (1, 2)),
    "cross-1x2": ("llama-3.2-vision-90b", {}, (1, 2)),
}


@pytest.mark.parametrize("case", CASES)
def test_tp_step_matches_the_single_device_step(tmp_path, case):
    check_case(tmp_path, *CASES[case])


def check_case(tmp_path, arch: str, changes: dict, shape: tuple[int, int]) -> None:
    """The mesh step of `arch` on `shape` against both oracles, and its
    collectives."""
    got, ref, path = run_mesh(tmp_path, arch, changes, shape)
    check_both(got, ref, path, arch, changes)
    coll = got["collectives"]
    hybrid = arch == "zamba2-1.2b"
    # every case's layers split over "model": the tensor-parallel sums over
    # it and the max of a split operand (the vocab-parallel logsumexp's);
    # the FSDP reduce-scatters where the rows split, and Mamba2's selected
    # in_proj / conv_w blocks, gathered over "model", reduce-scattered back
    assert coll["all_reduce_sum"] > 0 and coll["all_gather"] > 0, coll
    assert coll.get("all_reduce_max", 0) > 0, coll
    assert (coll.get("reduce_scatter", 0) > 0) == (shape[0] > 1 or hybrid), coll
    if hybrid:
        # a layer's forward: the norm's squares and out_proj's partial
        # products summed over "model"; its backward: the norm's and the
        # input's cotangents (copy_to_model); in_proj and conv_w reduce-
        # scattered (they rest split over "model"), conv_b all-reduced;
        # each microbatch
        cfg = port_config(arch, changes)
        passes = cfg.num_layers * cfg.microbatches
        assert coll["all_reduce_sum"] >= 5 * passes, coll
        if shape[0] == 1:
            assert coll["reduce_scatter"] == 2 * passes, coll


# ------------------------------------------------------------- abs-max ------
def absmax_probe(out_file: str) -> None:
    """Rank worker on (1, 2): a weight's column block, a weight's row
    block and an activation's column block (K) quantized with the
    model-wide abs-max and with this rank's own; rank 0 saves them."""
    import torch.distributed as dist

    from repro_torch.core import collectives as coll
    from repro_torch.core.quant import quantize_magnitude
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(data=1, model=2)
    m = coll.mesh_axes(mesh)["model"]
    g = torch.Generator().manual_seed(3)
    w, x = torch.randn(128, 64, generator=g), torch.randn(16, 128, generator=g)
    blocks = {"col": (w, 1, lambda: coll.weight_block("col")),
              "row": (w, 0, lambda: coll.weight_block("row")),
              "act": (x, 1, lambda: coll.batch_rows("row"))}
    out = {}
    with coll.mesh_state(coll.MeshState(rows=(), model=m)):
        for name, (t, dim, ctx) in blocks.items():
            mine = coll.block(t, m, dim)
            with ctx():
                glob = quantize_magnitude(mine, 8).magnitude
            out[name] = (glob, quantize_magnitude(mine, 8).magnitude)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, out)
    if dist.get_rank() == 0:
        torch.save({"ranks": every, "w": w, "x": x}, out_file)


def test_a_shard_local_absmax_gives_other_integers(tmp_path):
    from repro_torch.core.quant import quantize_magnitude
    out = str(tmp_path / "probe.pt")
    run_ranks(tmp_path, 2, f"m.absmax_probe({out!r})", module="test_torch_tp")
    got = torch.load(out, weights_only=False)
    wholes = {"col": (got["w"], 1), "row": (got["w"], 0), "act": (got["x"], 1)}
    for name, (t, dim) in wholes.items():
        whole = quantize_magnitude(t, 8).magnitude
        glob = torch.cat([r[name][0] for r in got["ranks"]], dim)
        local = torch.cat([r[name][1] for r in got["ranks"]], dim)
        assert torch.equal(glob, whole), name
        assert not torch.equal(local, whole), name


# ---------------------------------------------------------------- peak ------
def test_the_per_layer_gather_peak_is_below_the_whole_params():
    """qwen2-0.5b at full width with remat, a train step of 256-token rows
    on the fake (16, 16) mesh, counted by `StepCounter`:
      * 4 layers, 16 rows: the rows do not split over "model", so the
        layers compute on their "model" shard (the MLP and the tied table
        split, the 14 heads gathered whole): one rank's peak is below a
        quarter of the params' whole bytes (the step that gathered them
        whole before its forward held all of them), its all-gathers below
        twice those bytes;
      * 4 and 8 layers, 256 rows: one row a rank, over "data" and "model"
        (the heads do not divide it), each layer gathered whole over both
        axes, one layer at a time: 4 more layers raise the peak by less
        than a quarter of their whole bytes (each layer's gathered block is
        freed after it), and the all-gathers by about twice them (each
        layer gathered in the forward and again in remat's recompute; over
        "model", then "data")."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import count_cell, param_bytes
    from repro_torch.launch.mesh import fake_production_mesh

    def count(layers: int, rows: int):
        cfg = dataclasses.replace(get_config("qwen2-0.5b"), num_layers=layers, remat=True)
        shape = dataclasses.replace(SHAPES["train_4k"], global_batch=rows, seq_len=256)
        with fake_production_mesh() as mesh:
            counts, _ = count_cell(cfg, shape, mesh, device="cpu")
        assert counts.collectives["reduce_scatter"] > 0
        return counts.peak_bytes, counts.collectives["all_gather_bytes"], param_bytes(cfg)

    peak, gathered, whole = count(4, 16)
    assert peak < whole / 4, (peak, whole)
    assert gathered < 2 * whole, (gathered, whole)
    (peak4, gathered4, whole4), (peak8, gathered8, whole8) = count(4, 256), count(8, 256)
    layers = whole8 - whole4
    assert peak8 - peak4 < layers / 4, (peak4, peak8, layers)
    assert 2 * layers <= gathered8 - gathered4 <= 2 * layers * (1 + 1 / 16), \
        (gathered4, gathered8, layers)
