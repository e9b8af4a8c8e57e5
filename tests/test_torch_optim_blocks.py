"""Adafactor and the int8 gradient codec on each rank's blocks
(`optim.optimizers.Split`, `optim.grad_compress`, the meshed train step of
`runtime.train_lib`), on gloo ranks on the CPU.

The ranks are `tests/test_torch_train_mesh.py`'s (`run_ranks`: a
`file://` rendezvous in the test's tmp_path, one thread a rank), at most 4
a test but for the (2, 4) mesh's 8.

  * nemotron-4-340b's reduced config (Adafactor, `fsdp_pod`) on (2, 2)
    in 2 microbatches (the accumulated blocks) and on (2, 4): one meshed
    step against the reference's jitted single-device step and the port's
    unmeshed step (`test_torch_train_mesh.check_both`, its tolerances as
    they are);
  * Adafactor on single leaves split on both of their dims over a (2, 2)
    mesh, with `vr` / `vc` at rest split over other axes than the grad
    block's (the specs `sharding.opt_shardings` gives a column-parallel
    weight), whole, or on a split 1-D stacked leaf and a split `v`: two
    updates against the reference's jitted update and the port's unmeshed
    one on the whole leaves, the params' change within 1e-5 of the
    largest change plus 2 ulps of the param and the state within 1e-6 of
    its largest value (the cross-rank sums add in another order);
  * `compress_grads` on the same blocks byte-equal to the whole-leaf
    codec, dequantized grads and residual, the residual kept as a block;
  * a meshed step under Adafactor with grad_compress gathers what the
    AdamW step gathers, to the call and the byte: the per-layer FSDP
    gathers, and no grad or optimizer leaf; and it holds the port's
    unmeshed step (the reference's compress_grads fails on LM trees, R11):
    the metrics within 1e-5; with `test_torch_train_mesh.py::
    test_grad_compress_on_2x1`'s exemption of the elements next to a
    rounding boundary, the params' changes within the mitchell steps' 2e-3
    of the largest (a flipped rounding moves its leaf's row and column
    statistics), the factored statistics within 2e-3 of their largest and
    the residual within the grad tolerance.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_train_mesh import (
    BATCH,
    check_both,
    compress_free,
    port_config,
    ref_paths,
    run_mesh,
    run_ranks,
    state_file,
    unmeshed,
)

torch.set_num_threads(1)

ARCH = "nemotron-4-340b"
#: the single leaves: name -> (stacked layers or 0, whole shape of a layer,
#: the grad block's spec, {state leaf: its spec at rest}) on (data, model)
LEAVES = {
    # a column-parallel weight: rows over "data", columns over "model"; vc
    # rests over "data" on the columns (its spec follows the leading names)
    "col": (3, (8, 12), ("data", "model"), {"vr": (None, "data"), "vc": (None, "data")}),
    # a row-parallel weight: rows over "model", columns over "data"
    "row": (3, (8, 12), ("model", "data"), {"vr": (None, "model"), "vc": (None, "model")}),
    # both dims split, the statistics whole
    "whole_stats": (0, (8, 12), ("data", "model"), {"vr": (None,), "vc": (None,)}),
    # a stacked 1-D leaf (a_log's (layers, heads)), factored across the layers
    "stacked_1d": (4, (12,), ("model",), {"vr": (None,), "vc": (None,)}),
    # an unstacked 1-D leaf: element-wise v, split as the grad
    "vector": (0, (12,), ("model",), {"v": ("model",)}),
}
LRS = (1e-3, 3e-4)


def leaf_data(seed: int = 5) -> dict:
    """{leaf: (params, [grads of each update])} as whole numpy arrays,
    the stacked leaves with their layers on axis 0; grads of three scales
    so the clip and eps matter."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, (name, (layers, shape, _, _)) in enumerate(LEAVES.items()):
        full = ((layers,) if layers else ()) + shape
        out[name] = (rng.standard_normal(full).astype(np.float32),
                     [(rng.standard_normal(full) * 10.0 ** -(i % 3)).astype(np.float32)
                      for _ in LRS])
    return out


def groups_of(data: dict, mesh=None):
    """Port `Group`s of the leaves (a stacked leaf as its layers), their
    params as DTensor blocks on `mesh` where given."""
    from repro_torch.optim.optimizers import Group
    from repro_torch.runtime import sharding as shd
    groups = []
    for name, (layers, _, spec, _) in LEAVES.items():
        p = torch.from_numpy(data[name][0].copy())
        ts = list(p.unbind(0)) if layers else [p]
        if mesh is not None:
            ts = [shd.distribute(t, shd.Sharding(mesh, spec)) for t in ts]
        groups.append(Group(name, [t.clone() if mesh is None else t for t in ts], bool(layers)))
    return groups


def grads_of_update(data: dict, i: int, groups, mesh=None) -> list:
    """The i-th update's grads per group, per layer (this rank's blocks on
    `mesh`)."""
    from repro_torch.runtime import sharding as shd
    out = []
    for name, (layers, _, spec, _) in LEAVES.items():
        g = torch.from_numpy(data[name][1][i].copy())
        gs = list(g.unbind(0)) if layers else [g]
        if mesh is not None:
            pl = shd.placements(spec, mesh)
            gs = [shd.shard_of(t, mesh, pl).clone() for t in gs]
        out.append(gs)
    return out


def blocks_worker(out_file: str) -> None:
    """Rank worker on (2, 2): two Adafactor updates of the leaves on their
    blocks, and the codec on their first grads; rank 0 saves them whole."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import get_optimizer
    from repro_torch.optim.grad_compress import compress_grads
    from repro_torch.optim.optimizers import Group
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.train_lib import _local, _splits
    mesh = make_host_mesh(data=2, model=2)
    data = leaf_data()
    opt = get_optimizer("adafactor")
    groups = groups_of(data, mesh=mesh)
    whole = opt.init(groups_of(data))
    state = {"count": whole["count"], "state": {
        name: {k: shd.distribute(t, shd.Sharding(mesh, LEAVES[name][3][k]))
               for k, t in whole["state"][name].items()} for name in LEAVES}}
    splits = _splits(groups, state["state"], mesh)
    local = [Group(g.key, _local(g.params), g.stacked) for g in groups]
    for i, lr in enumerate(LRS):
        opt.update(grads_of_update(data, i, groups, mesh),
                   {"count": state["count"], "state": _local(state["state"])}, local,
                   torch.tensor(lr, dtype=torch.float32), splits)
    ef = {name: shd.distribute(torch.from_numpy(data[name][1][1].copy()),
                               shd.Sharding(mesh, (None,) * bool(LEAVES[name][0])
                                            + LEAVES[name][2])) for name in LEAVES}
    ef_local = _local(ef)
    deq, new_ef = compress_grads(grads_of_update(data, 0, groups, mesh), ef_local,
                                 local, [s.axes for s in splits])
    kept = all(new_ef[k].shape == ef_local[k].shape for k in LEAVES)
    from torch.distributed.tensor import DTensor

    def whole_of(t, like):
        return shd.gather(DTensor.from_local(t, like.device_mesh, like.placements,
                                             run_check=False))
    result = {
        "params": {g.key: torch.stack([shd.gather(t) for t in g.params]) if g.stacked
                   else shd.gather(g.params[0]) for g in groups},
        "state": {n: {k: shd.gather(t) for k, t in s.items()} for n, s in state["state"].items()},
        "deq": {g.key: torch.stack([whole_of(t, p) for t, p in zip(d, g.params)]) if g.stacked
                else whole_of(d[0], g.params[0]) for g, d in zip(groups, deq)},
        "ef": {k: whole_of(new_ef[k], ef[k]) for k in LEAVES},
        "ef_kept_as_blocks": kept,
    }
    if dist.get_rank() == 0:
        torch.save(result, out_file)


def reference_updates(data: dict) -> tuple[dict, dict]:
    """(params, state) of the reference's jitted Adafactor after the two
    updates on the whole leaves."""
    import jax
    import jax.numpy as jnp

    from repro.optim import get_optimizer as ref_get_optimizer
    opt = ref_get_optimizer("adafactor")
    params = {k: jnp.asarray(p) for k, (p, _) in data.items()}
    state = opt.init(params)
    update = jax.jit(opt.update)
    for i, lr in enumerate(LRS):
        params, state = update({k: jnp.asarray(g[i]) for k, (_, g) in data.items()},
                               state, params, jnp.float32(lr))
    return ({k: np.asarray(v) for k, v in params.items()},
            {f"{k}/{kind}": np.asarray(v) for k, s in state["state"].items()
             for kind, v in s.items()})


def unmeshed_updates(data: dict) -> tuple[dict, dict]:
    from repro_torch.optim import get_optimizer
    opt = get_optimizer("adafactor")
    groups = groups_of(data)
    state = opt.init(groups)
    for i, lr in enumerate(LRS):
        opt.update(grads_of_update(data, i, groups), state, groups,
                   torch.tensor(lr, dtype=torch.float32))
    return ({g.key: (torch.stack(g.params) if g.stacked else g.params[0]).numpy()
             for g in groups},
            {f"{k}/{kind}": t.numpy() for k, s in state["state"].items() for kind, t in s.items()})


@pytest.fixture(scope="module")
def blocks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("blocks")
    out = str(tmp / "blocks.pt")
    run_ranks(tmp, 4, f"m.blocks_worker({out!r})", module="test_torch_optim_blocks")
    return torch.load(out, weights_only=False)


@pytest.mark.parametrize("oracle", ("reference", "unmeshed"))
def test_adafactor_on_blocks_split_on_both_dims(blocks, oracle):
    data = leaf_data()
    want_p, want_s = (reference_updates if oracle == "reference" else unmeshed_updates)(data)
    for k, (p0, _) in data.items():
        got, want = blocks["params"][k].numpy() - p0, want_p[k] - p0
        # a change within 1e-5 of the largest, plus the 2 ulps of the param
        # it is read from (check_step's form)
        atol = 1e-5 * np.abs(want).max() + 2 * np.finfo(np.float32).eps * np.abs(want_p[k])
        assert (np.abs(got - want) <= atol).all(), (oracle, k, float(np.abs(got - want).max()))
    got_s = {f"{k}/{kind}": t.numpy() for k, s in blocks["state"].items() for kind, t in s.items()}
    assert sorted(got_s) == sorted(want_s)
    for k, want in want_s.items():
        np.testing.assert_allclose(got_s[k], want, rtol=0, atol=1e-6 * np.abs(want).max(),
                                   err_msg=f"{oracle} state {k}")


def test_compress_grads_on_blocks_is_the_whole_leaf_codec(blocks):
    from repro_torch.optim.grad_compress import compress_grads
    data = leaf_data()
    groups = groups_of(data)
    ef = {k: torch.from_numpy(d[1][1].copy()) for k, d in data.items()}
    deq, new_ef = compress_grads(grads_of_update(data, 0, groups), ef, groups)
    assert blocks["ef_kept_as_blocks"]
    for g, d in zip(groups, deq):
        whole = torch.stack(d) if g.stacked else d[0]
        assert torch.equal(blocks["deq"][g.key], whole), g.key
        assert torch.equal(blocks["ef"][g.key], new_ef[g.key]), g.key


# ------------------------------------------------------------ the step ------
@pytest.mark.parametrize("shape,changes", (((2, 2), {"microbatches": 2}), ((2, 4), {})),
                         ids=("2x2-microbatches", "2x4"))
def test_adafactor_step_on_blocks(tmp_path, shape, changes):
    cfg = port_config(ARCH, changes)
    assert cfg.optimizer == "adafactor" and cfg.fsdp_pod
    got, ref, path = run_mesh(tmp_path, ARCH, changes, shape)
    assert any(k.endswith("/vc") for k in ref_paths(ref[1].opt["state"]))
    check_both(got, ref, path, ARCH, changes)


def gathers_worker(state_file_: str, out_file: str) -> None:
    """Rank worker on (2, 2): one meshed step under Adafactor with
    grad_compress and one under AdamW from the same params; rank 0 saves
    the first's state whole and both steps' collectives."""
    import torch.distributed as dist

    from repro_torch.data.tokens import lm_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.train_lib import make_train_state, make_train_step, shard_state
    from test_torch_train_mesh import dump
    mesh = make_host_mesh(data=2, model=2)
    collectives = {}
    for name, changes in (("adamw", {"optimizer": "adamw"}),
                          ("adafactor", {"grad_compress": True})):
        cfg = port_config(ARCH, changes)
        model = build_model(cfg, "cpu")
        if name == "adafactor":
            state = shard_state(torch.load(state_file_, weights_only=False), cfg, mesh)
        else:
            state = make_train_state(model, torch.Generator().manual_seed(0), mesh)
        shd.reset_collectives()
        new, metrics = make_train_step(model, mesh=mesh)(state, lm_batch(cfg, **BATCH))
        collectives[name] = dict(shd.COLLECTIVES)
    dump(new, metrics, out_file)
    if dist.get_rank() == 0:
        got = torch.load(out_file, weights_only=False)
        torch.save({**got, "steps": collectives}, out_file)


def test_a_compressed_adafactor_step_gathers_no_grad_or_optimizer_leaf(tmp_path):
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.models.model import build_model as ref_build_model
    from repro.runtime.train_lib import make_train_state
    from repro_torch.optim import param_groups
    from test_torch_train import GRAD_TOL, LOSS_RTOL
    changes = {"grad_compress": True}
    cfg = port_config(ARCH, changes)
    ref_cfg = dataclasses.replace(ref_get_config(ARCH).reduced(), **changes)
    s0 = jax.tree.map(np.asarray, make_train_state(ref_build_model(ref_cfg),
                                                   jax.random.PRNGKey(0)))
    path = state_file(tmp_path, ARCH, changes, s0)
    out = str(tmp_path / "out.pt")
    run_ranks(tmp_path, 4, f"m.gathers_worker({path!r}, {out!r})",
              module="test_torch_optim_blocks")
    got = torch.load(out, weights_only=False)
    adamw, adafactor = got["steps"]["adamw"], got["steps"]["adafactor"]
    # the same per-layer FSDP gathers: nothing more is gathered for the update
    assert adafactor["all_gather"] == adamw["all_gather"] > 0, (adafactor, adamw)
    assert adafactor["all_gather_bytes"] == adamw["all_gather_bytes"], (adafactor, adamw)
    assert adafactor["reduce_scatter"] == adamw["reduce_scatter"] > 0, (adafactor, adamw)
    # the codec's abs-max over the blocks, and Adafactor's sums
    assert adafactor["all_reduce_max"] > adamw.get("all_reduce_max", 0), (adafactor, adamw)
    assert adafactor["all_reduce_sum"] > adamw["all_reduce_sum"], (adafactor, adamw)
    s1, metrics, grads = unmeshed(ARCH, changes, path)
    raw = ref_paths(grads)
    free = compress_free(raw)
    gmax = max(float(np.abs(g).max()) for g in raw.values())
    for k, v in metrics.items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=LOSS_RTOL, err_msg=k)
    # an int8 rounding that flips between the two sums of the same grads
    # (`free`) moves its leaf's Adafactor row and column statistics, so the
    # rest of its row and column moves too (by ~5e-4 of the largest change
    # here): the other changes are held within the mitchell steps' 2e-3 of
    # the largest plus 2 ulps of the param (check_step's form, whose masks
    # cannot exempt elements of the factored statistics), the statistics
    # within 2e-3 of each one's largest
    p0, p1 = ref_paths(s0.params), s1.params
    have = {g.key: (torch.stack(g.params) if g.stacked else g.params[0]).detach().numpy()
            for g in param_groups(got["state"].params, cfg)}
    assert sorted(have) == sorted(p1)
    for k, want in p1.items():
        d_want, d_got = want - p0[k], have[k] - p0[k]
        atol = 2e-3 * np.abs(d_want).max() + 2 * np.finfo(np.float32).eps * np.abs(want)
        bad = ~free[k] & (np.abs(d_got - d_want) > atol)
        assert not bad.any(), (k, int(bad.sum()), float(np.abs(d_got - d_want)[bad].max()))
    for k, st in s1.opt["state"].items():
        for kind, want in st.items():
            np.testing.assert_allclose(got["state"].opt["state"][k][kind].numpy(), want, rtol=0,
                                       atol=2e-3 * np.abs(want).max(), err_msg=f"{k}/{kind}")
    # the residual, kept as blocks, gathered whole
    want_ef = ref_paths(s1.ef)
    assert sorted(got["state"].ef) == sorted(want_ef)
    for k, want in want_ef.items():
        np.testing.assert_allclose(got["state"].ef[k].numpy()[~free[k]], want[~free[k]],
                                   rtol=0, atol=GRAD_TOL * gmax, err_msg=f"residual {k}")
