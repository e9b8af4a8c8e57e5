"""The port's data-parallel train step on meshes of gloo ranks
(`make_train_step(..., mesh=...)`, `runtime.sharding`, `launch.mesh`)
against the reference's single-device step, on the CPU.

Every multi-rank run here is `world` Python processes, each a gloo rank of
a process group that meets through a `file://` rendezvous in the test's
`tmp_path` (no TCP port is chosen, so the suite runs under xdist). A rank
runs one of this module's worker functions (`mesh_step`, ...), which
import no JAX; rank 0 gathers the state whole and writes it to a file.

The reference's side is its own test's (`tests/test_distribution.py::
test_sharded_train_step_matches_single_device`, whose sharded half fails
under this JAX: ROADMAP R12): its jitted single-device step from its
`make_train_state` at `PRNGKey(0)` (the VLM's cross-attention gates
opened, as tests/test_torch_train.py does), with `make_train_step`'s
defaults, on `lm_batch(cfg, batch=8, seq=32)`, reduced config. The port
starts from that state carried across (`convert.from_reference_train_state`)
and sharded (`shard_state`).

Two oracles, each with `tests/test_torch_train.py::check_step`: every
metric, each param's change (new less old) against the oracle's within a
fraction of its leaf's largest change plus 2 ulps (an element whose grad
is within the grad tolerance of zero may take either sign in the first
AdamW / Adafactor step, and is exempt), and the optimizer state (AdamW's
m / v, Adafactor's vr / vc) within a fraction of each leaf's largest
value plus what the grad tolerance allows. At the defaults' step-0 lr of
3e-6 a param moves by about 3e-6, so the change, not the param, is what
can show a wrong update.
  * The reference's step: check_step's tolerances as tests/test_torch_train.py
    sets them (exact), and as tests/test_torch_train_quant.py sets them
    under mitchell (twice the reference's own jit-against-eager spread).
    Besides, the reference's own test's criterion: the loss within rtol
    2e-5, every param within 5e-5.
  * The port's unmeshed step from the same state, whose grads give the
    exemption: check_step's exact tolerances under both methods (the sums
    over ranks differ from one device's in their order only).
"""
import dataclasses
import functools
import os
import subprocess
import sys
import uuid
from datetime import timedelta
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, list_archs
from repro_torch.core.tree import tree_map_with_path
from repro_torch.data.tokens import lm_batch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.optim import param_groups
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.train_lib import (
    grads_of,
    make_train_step,
    row_split,
    shard_state,
)

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
TESTS = os.path.dirname(os.path.abspath(__file__))
BATCH = dict(batch=8, seq=32)
LOSS_RTOL = 2e-5
PARAM_TOL = 5e-5
MESHES = ((1, 1), (2, 1), (2, 2), (2, 4))
#: check_step's tolerances against the reference's jitted step, by method
#: (tests/test_torch_train_quant.py's under mitchell)
REF_TOL = {"exact": {},
           "mitchell": dict(loss_rtol=2e-4, grad_tol=6e-3, exempt=1.2e-2, delta_tol=2e-3)}


# ------------------------------------------------------------ the ranks -----
def run_ranks(tmp_path, world: int, call: str, timeout: float = 120.0,
              module: str = "test_torch_train_mesh") -> list[str]:
    """Run `call` (Python, with the test module `module` imported as `m`)
    in `world` gloo ranks that meet in `tmp_path`; -> each rank's stdout.
    A rank that fails (or a run past `timeout`) fails the test with every
    rank's output."""
    init = tmp_path / f"rdzv-{uuid.uuid4().hex}"
    code = (f"import sys; sys.path[:0] = [{SRC!r}, {TESTS!r}]\n"
            f"import {module} as m\nimport test_torch_train_mesh as mesh_tests\n"
            f"mesh_tests.start({str(init)!r})\n{call}\n"
            "mesh_tests.dist.destroy_process_group()\n")
    env = {**os.environ, "WORLD_SIZE": str(world), "OMP_NUM_THREADS": "1",
           "PYTHONPATH": SRC}
    procs = [subprocess.Popen([sys.executable, "-c", code], env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            p.kill()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, "\n".join(f"--- rank {r} rc {procs[r].returncode}\n{o}\n{e}"
                              for r, (o, e) in enumerate(outs))
    return [o for o, _ in outs]


def start(init: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=timedelta(seconds=90))


def port_config(arch: str, changes: dict):
    return dataclasses.replace(get_config(arch).reduced(), **changes)


def dump(state, metrics: dict, path: str) -> None:
    """Gather `state` whole on every rank; rank 0 writes it with the
    metrics and the collectives counted."""
    whole = tree_map_with_path(lambda _, t: shd.gather(t).detach(), state)
    if dist.get_rank() == 0:
        torch.save({"state": whole, "metrics": {k: float(v) for k, v in metrics.items()},
                    "collectives": dict(shd.COLLECTIVES)}, path)


def mesh_step(state_file: str, out_file: str, arch: str, changes: dict,
              shape: tuple[int, int], local_max: bool = False) -> None:
    """One mesh step from the whole state in `state_file` (rank worker).
    `local_max` takes each activation's abs-max over this rank's rows
    only: the step the global abs-max is there to prevent."""
    cfg = port_config(arch, changes)
    model = build_model(cfg, "cpu")
    mesh = make_host_mesh(data=shape[0], model=shape[1])
    state = shard_state(torch.load(state_file, weights_only=False), cfg, mesh)
    if local_max:
        import repro_torch.core.quant as quant
        quant.operand_max = lambda x: x.max()
    shd.reset_collectives()
    new, metrics = make_train_step(model, mesh=mesh)(state, lm_batch(cfg, **BATCH))
    dump(new, metrics, out_file)


def absmax_probe(state_file: str, out_file: str, arch: str, changes: dict) -> None:
    """The first quantized dense's activation integers of this rank's rows
    (the embeddings, cast to the model dtype), quantized under the mesh's
    activation context and with this rank's rows alone (rank worker)."""
    from repro_torch.core.collectives import batch_rows
    from repro_torch.core.quant import quantize_magnitude
    cfg = port_config(arch, changes)
    mesh = make_host_mesh()
    state = torch.load(state_file, weights_only=False)
    n, per = row_split(cfg, lm_batch(cfg, **BATCH), dist.get_world_size())
    lo = dist.get_rank() * per
    tokens = torch.as_tensor(lm_batch(cfg, **BATCH)["tokens"][lo:lo + per], dtype=torch.long)
    x = state.params["emb"].detach()[tokens].reshape(-1, cfg.d_model)
    with shd.activation_sharding_ctx(mesh, cfg, rows=("data",)):
        with batch_rows():
            glob = quantize_magnitude(x, 8)
    local = quantize_magnitude(x, 8)
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, (glob.magnitude, local.magnitude))
    if dist.get_rank() == 0:
        torch.save(out, out_file)


# -------------------------------------------------------- the reference -----
def ref_paths(tree) -> dict:
    from test_torch_train import ref_paths
    return ref_paths(tree)


@functools.lru_cache(maxsize=None)
def reference(arch: str, changes: tuple = ()):
    """(state before, state after, metrics, grads) of the reference's
    jitted single-device step (module docstring), as numpy trees."""
    import jax
    import jax.numpy as jnp
    from test_torch_train import open_gates

    from repro.configs import get_config as ref_get_config
    from repro.data.tokens import lm_batch as ref_lm_batch
    from repro.models.model import build_model as ref_build_model
    from repro.runtime.train_lib import make_train_state, make_train_step
    cfg = dataclasses.replace(ref_get_config(arch).reduced(), **dict(changes))
    model = ref_build_model(cfg)
    s0 = make_train_state(model, jax.random.PRNGKey(0))
    s0 = s0._replace(params=open_gates(s0.params))
    batch = {k: jnp.asarray(v) for k, v in ref_lm_batch(cfg, **BATCH).items()}
    step = make_train_step(model)
    grad = jax.grad(lambda p: model.loss_fn(p, batch)[0])
    (s1, metrics), grads = jax.jit(lambda s: (step(s, batch), grad(s.params)))(s0)
    return (jax.tree.map(np.asarray, s0), jax.tree.map(np.asarray, s1),
            {k: float(v) for k, v in metrics.items()}, jax.tree.map(np.asarray, grads))


def state_file(tmp_path, arch: str, changes: dict, s0_np) -> str:
    from repro_torch.convert import from_reference_train_state
    path = str(tmp_path / "state0.pt")
    torch.save(from_reference_train_state(s0_np, port_config(arch, changes), "cpu"), path)
    return path


def stacked_params(state, cfg) -> dict:
    return {g.key: (torch.stack(g.params) if g.stacked else g.params[0]).detach().numpy()
            for g in param_groups(state.params, cfg)}


def as_reference(state, cfg) -> SimpleNamespace:
    """A port's whole `TrainState` in the reference's paths and stacked
    shapes, as check_step reads an oracle's state."""
    return SimpleNamespace(
        step=state.step, params=stacked_params(state, cfg),
        opt={"count": state.opt["count"],
             "state": {k: {kind: t.numpy() for kind, t in s.items()}
                       for k, s in state.opt["state"].items()}},
        ef=None if state.ef is None else {k: t.numpy() for k, t in state.ef.items()})


def unmeshed(arch: str, changes: dict, path: str):
    """(the port's one-process step from the state in `path` as the
    reference's, its metrics, its grads by the reference's path)."""
    cfg = port_config(arch, changes)
    model = build_model(cfg, "cpu")
    state = torch.load(path, weights_only=False)
    batch = lm_batch(cfg, **BATCH)
    groups = param_groups(state.params, cfg)
    _, _, gs = grads_of(model, state.params, batch, [t for g in groups for t in g.params])
    grads = {}
    for g in groups:
        mine, gs = gs[:len(g.params)], gs[len(g.params):]
        grads[g.key] = (torch.stack(mine) if g.stacked else mine[0]).numpy()
    state, metrics = make_train_step(model)(state, batch)
    return as_reference(state, cfg), {k: float(v) for k, v in metrics.items()}, grads


def run_mesh(tmp_path, arch: str, changes: dict, shape, **kw):
    """(the mesh step's whole state, metrics and collectives; the
    reference's step; the state file it started from)."""
    ref = reference(arch, tuple(sorted(changes.items())))
    path = state_file(tmp_path, arch, changes, ref[0])
    out = str(tmp_path / "out.pt")
    extra = "".join(f", {k}={v!r}" for k, v in kw.items())
    run_ranks(tmp_path, shape[0] * shape[1],
              f"m.mesh_step({path!r}, {out!r}, {arch!r}, {changes!r}, {tuple(shape)!r}{extra})")
    return torch.load(out, weights_only=False), ref, path


def check_against(cfg, got: dict, s0, s1, metrics: dict, grads, tol: dict,
                  criterion: bool = False, free=None) -> None:
    """The mesh step `got` against an oracle's (s0 -> s1, metrics, grads)
    by check_step at `tol`; with `criterion`, also the reference's own
    test's loss rtol 2e-5 and params within 5e-5."""
    from test_torch_train import check_step
    check_step(cfg, s0, s1, metrics, grads, got["state"], got["metrics"], free=free, **tol)
    if criterion:
        np.testing.assert_allclose(got["metrics"]["loss"], metrics["loss"], rtol=LOSS_RTOL)
        have, want = stacked_params(got["state"], cfg), ref_paths(s1.params)
        worst = max(float(np.nanmax(np.abs(have[k] - want[k]), initial=0.0)) for k in want)
        assert worst < PARAM_TOL, worst


def check_both(got: dict, ref, path: str, arch: str, changes: dict) -> None:
    """`got` against the reference's step and the port's unmeshed one."""
    cfg = port_config(arch, changes)
    s0, s1, metrics, grads = ref
    check_against(cfg, got, s0, s1, metrics, grads, REF_TOL[cfg.matmul_method],
                  criterion=True)
    check_against(cfg, got, s0, *unmeshed(arch, changes, path), {})


# ---------------------------------------------------------------- tests -----
@pytest.mark.parametrize("method", ("exact", "mitchell"))
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_step_matches_the_single_device_step(tmp_path, shape, method):
    changes = {"matmul_method": method}
    cfg = port_config("qwen2-0.5b", changes)
    got, ref, path = run_mesh(tmp_path, "qwen2-0.5b", changes, shape)
    check_both(got, ref, path, "qwen2-0.5b", changes)
    coll = got["collectives"]
    dense = 7 * cfg.num_layers if method != "exact" else 0
    data, model = shape
    rows = data > 1                 # the rows split over "data" (the batch axis)
    # a step's gathers of a param over "data", each reduce-scattered back:
    # 7 a layer (wq, wk, wv, wo, wi, wg, the MLP's wo) and the tied table
    # twice (the embedding, the head); of a param whole on "data", each
    # all-reduced back: 5 a layer (2 norms, the q / k / v biases) and the
    # final norm
    fsdp, whole = 7 * cfg.num_layers + 2, 5 * cfg.num_layers + 1
    assert coll.get("reduce_scatter", 0) == fsdp * rows
    if model == 1:
        # the quantizer: a max a quantized dense forward, a (cotangent, ties)
        # sum backward; + the label count, the metrics, the grad norm
        assert coll.get("all_reduce_max", 0) == dense * rows
        assert coll.get("all_reduce_sum", 0) == (dense + 3 + whole) * rows
    else:
        layers, quantized = cfg.num_layers, method != "exact"
        kv = cfg.num_kv_heads % model == 0      # on (2, 4) wk / wv are gathered
        # a layer's quantized denses by their split: column-parallel (wq,
        # wk, wv, wi, wg), row-parallel (the two wo), whole (wk, wv gathered)
        col, row, whole_w = (5, 2, 0) if kv else (3, 2, 2)
        # forward maxes: an activation over "data" (and "model" where it is
        # split on K), a weight block over "model"; + the vocab-parallel
        # logsumexp's
        maxes = quantized * layers * (col * (rows + 1) + row * (rows + 2) + whole_w * rows) + 1
        # their backward sums: (cotangent, ties) over the same axes, or the
        # cotangent over "data" and the ties over the max's axes
        ties = quantized * layers * (col * (rows + 1) + row * (2 * rows + 2) + whole_w * rows)
        # forward: the lookup's partial embeddings, a layer's two row-parallel
        # sums, the logsumexp's and the label logit's; backward: copy_to_model's
        # (a layer's attention and MLP inputs, its k and v where gathered, the
        # head's input)
        tp = 1 + 2 * layers + 2 + layers * (2 + 2 * (not kv)) + 1
        # + the label count and the metrics over "data", the grad norm over
        # "data" and "model" (the FSDP / TP blocks) and "model" (the biases)
        assert coll["all_reduce_max"] == maxes
        assert coll["all_reduce_sum"] == ties + tp + whole * rows + 2 * rows + rows + 2
    sharded = shape[0] * shape[1] > 1
    assert ("all_gather" in coll) == sharded


def test_a_local_absmax_gives_other_integers(tmp_path):
    """Item (a) of the mesh step: quantized under the mesh's activation
    context, each rank's rows give the integers of the whole batch's
    quantization; with each rank's own abs-max they do not, and the step
    built on them leaves the reference's loss."""
    changes = {"matmul_method": "mitchell"}
    cfg = port_config("qwen2-0.5b", changes)
    ref = reference("qwen2-0.5b", tuple(changes.items()))
    path = state_file(tmp_path, "qwen2-0.5b", changes, ref[0])
    out = str(tmp_path / "probe.pt")
    run_ranks(tmp_path, 2, f"m.absmax_probe({path!r}, {out!r}, 'qwen2-0.5b', {changes!r})")
    ranks = torch.load(out, weights_only=False)
    from repro_torch.core.quant import quantize_magnitude
    state = torch.load(path, weights_only=False)
    tokens = torch.as_tensor(lm_batch(cfg, **BATCH)["tokens"], dtype=torch.long)
    whole = quantize_magnitude(state.params["emb"].detach()[tokens].reshape(-1, cfg.d_model), 8)
    assert torch.equal(torch.cat([g for g, _ in ranks]), whole.magnitude)
    assert not torch.equal(torch.cat([loc for _, loc in ranks]), whole.magnitude)
    got, *_ = run_mesh(tmp_path, "qwen2-0.5b", changes, (2, 1), local_max=True)
    rel = abs(got["metrics"]["loss"] - ref[2]["loss"]) / ref[2]["loss"]
    assert rel > LOSS_RTOL, rel


def test_adafactor_fsdp_pod_on_2x2(tmp_path):
    """nemotron-4-340b's reduced config: Adafactor (factored over the
    stacked layers, run on each rank's blocks, its means and clip reduced
    over the axes that split each leaf; its vr / vc held), fsdp_pod."""
    cfg = port_config("nemotron-4-340b", {})
    assert cfg.optimizer == "adafactor" and cfg.fsdp_pod
    got, ref, path = run_mesh(tmp_path, "nemotron-4-340b", {}, (2, 2))
    assert any(k.endswith("/vr") for k in ref_paths(ref[1].opt["state"]))
    check_both(got, ref, path, "nemotron-4-340b", {})


def test_moe_on_2x1_with_aligned_chunks(tmp_path):
    """deepseek-v3-671b's reduced MoE: 256 tokens a step in chunks of 16,
    128 a rank: the global chunks split across the ranks."""
    cfg = port_config("deepseek-v3-671b", {})
    assert row_split(cfg, lm_batch(cfg, **BATCH), 2) == (8, 4)
    got, ref, path = run_mesh(tmp_path, "deepseek-v3-671b", {}, (2, 1))
    check_both(got, ref, path, "deepseek-v3-671b", {})


@pytest.mark.parametrize("case", ("chunk", "rows", "microbatch"))
def test_uneven_splits_are_refused(case):
    cfg = port_config("deepseek-v3-671b", {})
    batch = lm_batch(cfg, **BATCH)
    if case == "chunk":            # 128 tokens a rank, a global chunk of 256
        cfg, world = dataclasses.replace(cfg, moe_seq_chunk=256), 2
    elif case == "rows":
        world = 3
    else:                          # 2 microbatches of 4 rows over 8 ranks
        cfg, world = dataclasses.replace(cfg, microbatches=2), 8
    with pytest.raises(ValueError, match="chunks" if case == "chunk" else "split over"):
        row_split(cfg, batch, world)


def test_microbatches_on_2x2(tmp_path):
    """microbatches = 2: each rank takes its row of each global
    microbatch, as the reference's reshape of the global batch gives."""
    changes = {"microbatches": 2}
    got, ref, path = run_mesh(tmp_path, "qwen2-0.5b", changes, (2, 2))
    check_both(got, ref, path, "qwen2-0.5b", changes)


def compress_free(grads: dict) -> dict:
    """The elements whose int8 quantization (the leaf's abs-max scale)
    sits within the grad tolerance of a rounding boundary: two sums of the
    same grads in another order may round them a step apart, and they are
    free (tests/test_torch_train.py's grad_compress test)."""
    from test_torch_train import GRAD_TOL
    gmax = max(float(np.abs(g).max()) for g in grads.values())
    free = {}
    for k, g in grads.items():
        scale = max(float(np.abs(g).max()), 1e-30) / 127.0
        a = np.abs(g) / scale
        free[k] = np.abs(a - np.floor(a) - 0.5) * scale <= GRAD_TOL * gmax
    return free


def test_grad_compress_on_2x1(tmp_path):
    """grad_compress on the full, reduced grads; the residual kept sharded.
    The reference's train step raises on the LM trees (R11), so its side is
    composed from its pieces in its step's order: grads, compress_grads
    (over the tree with its tuples as lists), the update, the norm of the
    compressed grads."""
    import jax
    import jax.numpy as jnp
    from test_torch_train import GRAD_TOL, open_gates

    from repro.configs import get_config as ref_get_config
    from repro.data.tokens import lm_batch as ref_lm_batch
    from repro.models.model import build_model as ref_build_model
    from repro.optim import get_optimizer
    from repro.optim.grad_compress import compress_grads
    from repro.optim.schedules import cosine_schedule
    from repro.runtime.train_lib import TrainState, make_train_state
    changes = {"grad_compress": True}
    ref_cfg = dataclasses.replace(ref_get_config("qwen2-0.5b").reduced(), **changes)
    model = ref_build_model(ref_cfg)
    s0 = make_train_state(model, jax.random.PRNGKey(0))
    s0 = s0._replace(params=open_gates(s0.params))
    jb = {k: jnp.asarray(v) for k, v in ref_lm_batch(ref_cfg, **BATCH).items()}

    def as_lists(tree):
        if isinstance(tree, dict):
            return {k: as_lists(v) for k, v in tree.items()}
        return [as_lists(v) for v in tree] if isinstance(tree, (list, tuple)) else tree

    @jax.jit
    def step(s):
        (loss, metrics), grads = jax.value_and_grad(model.loss_fn, has_aux=True)(s.params, jb)
        deq, ef = compress_grads(as_lists(grads), as_lists(s.ef))
        deq = jax.tree.unflatten(jax.tree.structure(s.params), jax.tree.leaves(deq))
        lr = cosine_schedule(3e-4, 100, 10_000)(s.step)
        params, opt = get_optimizer(ref_cfg.optimizer).update(deq, s.opt, s.params, lr)
        gnorm = jnp.sqrt(sum(jnp.sum(g ** 2) for g in jax.tree.leaves(deq)))
        return (TrainState(s.step + 1, params, opt, ef),
                {"loss": loss, "lr": lr, "grad_norm": gnorm, **metrics}, grads)

    s1, ref_metrics, ref_grads = jax.tree.map(np.asarray, step(s0))
    s0 = jax.tree.map(np.asarray, s0)
    cfg = port_config("qwen2-0.5b", changes)
    path = state_file(tmp_path, "qwen2-0.5b", changes, s0)
    out = str(tmp_path / "out.pt")
    run_ranks(tmp_path, 2, f"m.mesh_step({path!r}, {out!r}, 'qwen2-0.5b', {changes!r}, (2, 1))")
    got = torch.load(out, weights_only=False)
    unmeshed_ref = unmeshed("qwen2-0.5b", changes, path)
    ref_metrics = {k: float(v) for k, v in ref_metrics.items()}
    for s1_, metrics, grads, criterion in ((s1, ref_metrics, ref_grads, True),
                                           (*unmeshed_ref, False)):
        raw = ref_paths(grads)
        free = compress_free(raw)
        # a leaf whose grads all lie within the tolerance (the key biases'
        # rounding noise) is free whole; the rest hold >= 90% of the elements
        assert 0 < sum(int(f.sum()) for f in free.values()) < \
            0.1 * sum(f.size for f in free.values())
        check_against(cfg, got, s0, s1_, metrics, grads, {}, criterion=criterion, free=free)
        # the residual, the grad less its int8 value, gathered whole
        gmax = max(float(np.abs(g).max()) for g in raw.values())
        want_ef = ref_paths(s1_.ef)
        assert sorted(got["state"].ef) == sorted(want_ef)
        for k, want in want_ef.items():
            np.testing.assert_allclose(got["state"].ef[k].numpy()[~free[k]], want[~free[k]],
                                       rtol=0, atol=GRAD_TOL * gmax, err_msg=f"residual {k}")


@pytest.mark.parametrize("arch", [a for a in list_archs() if a not in
                                  ("qwen2-0.5b", "nemotron-4-340b", "deepseek-v3-671b")])
def test_every_family_steps_on_2x1(tmp_path, arch):
    """The other archs' reduced configs on (2, 1) (the audio frames, the
    hybrid and xLSTM recurrences, kimi-k2's GQA MoE, the VLM's image rows
    and its 0-d gates, kept whole on every rank), against the reference's
    step and the port's unmeshed one. zamba2's reduced init gives NaN grads
    (R10): NaN is held equal to NaN."""
    got, ref, path = run_mesh(tmp_path, arch, {}, (2, 1))
    check_both(got, ref, path, arch, {})
