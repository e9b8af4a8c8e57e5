"""The port's train step (`repro_torch.runtime.train_lib`, `Model.loss_fn`,
remat in `models.transformer`, `convert.from_reference_train_state`,
`launch.train`) against the JAX package, on the CPU, for every arch.

Both packages start from the reference's `make_train_state` at
`PRNGKey(0)` on the reduced config (float32), carried across by
`from_reference_train_state` (the VLM's `xgate` set to 0.5 in both: the
zero init would erase the cross-attention), and take one step on the
reference's `lm_batch` (batch 2, seq 16) at peak_lr 1e-3, warm-up 1, so
step 0 trains at 1e-3. The reference's step is jitted, with its grads
(`jax.grad` of its `loss_fn`) from the same program.

Tolerances, and why (exact method; the probe behind them, this file's
checks at rtol 0, saw loss / grad_norm gaps <= 6e-7 relative and grads
<= 3e-6 of the largest grad):
  * loss, ce, z_loss, moe_aux, grad_norm: rtol 1e-5 (the float32 forward
    and backward in each library's order and transcendental functions,
    ROADMAP Queue 3, R6);
  * grads: max |port - reference| <= 1e-5 x the largest |grad| of the
    model;
  * the new params: AdamW's first step is (m / c1) / (sqrt(v / c2) + eps)
    = g / (|g| + eps), a sign, so an element whose grad is within the grad
    tolerance of zero (2e-5 x the largest |grad|; e.g. a key bias, whose
    grad is rounding noise: softmax ignores a shift of every score) may
    move either way. Those are exempt. Every other element, and every
    element whose grad is exactly zero in both packages (moved by weight
    decay alone), is held within 2e-4 of the leaf's largest |update| +
    2 ulps of the param (the subtraction p - lr * (...) rounds at the
    param's scale). Adafactor's archs the same: its first step is
    g * rsqrt(g^2 + eps) factored, then clipped;
  * the optimizer state within 1e-5 of each leaf's largest |value|, plus
    what the grad tolerance allows it (AdamW's m = 0.1 g and v = 0.05 g^2,
    Adafactor's row and column means of g^2: GRAD_TOL x the largest |grad|
    x max(1, 2 x the leaf's largest |grad|)).
zamba2's reduced model at the reference's init gives NaN grads in both
packages (the SSD scan's masked exp overflows above the diagonal and its
backward multiplies 0 by inf: ROADMAP Queue 3, R10); NaN is held equal to
NaN, position for position.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data.tokens import lm_batch as ref_lm_batch
from repro.models.model import build_model as ref_build_model
from repro.optim import get_optimizer as ref_get_optimizer
from repro.optim.grad_compress import compress_grads as ref_compress_grads
from repro.optim.grad_compress import init_error_feedback as ref_init_ef
from repro.optim.schedules import cosine_schedule as ref_cosine_schedule
from repro.runtime.train_lib import TrainState as RefTrainState
from repro.runtime.train_lib import make_train_state as ref_make_train_state
from repro.runtime.train_lib import make_train_step as ref_make_train_step
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import from_reference_lm_params, from_reference_train_state
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from repro_torch.optim import param_groups
from repro_torch.runtime.train_lib import grads_of, make_train_state, make_train_step

torch.set_num_threads(1)

XGATE = 0.5
STEP = dict(peak_lr=1e-3, warmup=1)
BATCH = dict(batch=2, seq=16)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5
EXEMPT = 2e-5
DELTA_TOL = 2e-4
STATE_TOL = 1e-5


def open_gates(tree):
    def gate(path, leaf):
        return jnp.full_like(leaf, XGATE) if path[-1] == jax.tree_util.DictKey("xgate") else leaf
    return jax.tree_util.tree_map_with_path(gate, tree)


def ref_paths(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    name = lambda e: str(getattr(e, "key", getattr(e, "idx", getattr(e, "name", e))))  # noqa: E731
    return {"/".join(name(e) for e in p): np.asarray(v) for p, v in leaves}


def configs(arch: str, **changes):
    return (dataclasses.replace(ref_get_config(arch).reduced(), **changes),
            dataclasses.replace(get_config(arch).reduced(), **changes))


@functools.lru_cache(maxsize=None)
def ref_state0(arch: str, optimizer: str, grad_compress: bool):
    """The reference's fresh TrainState (the VLM's gates open)."""
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(), grad_compress=grad_compress)
    s = ref_make_train_state(ref_build_model(ref_cfg), jax.random.PRNGKey(0))
    return s._replace(params=open_gates(s.params))


def ref_step(ref_cfg, batch: dict):
    """(the reference's state before, after, metrics, grads) of one jitted
    step on `batch`."""
    model = ref_build_model(ref_cfg)
    s0 = ref_state0(ref_cfg.name, ref_cfg.optimizer, False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step = ref_make_train_step(model, **STEP)
    grad = jax.grad(lambda p: model.loss_fn(p, jb)[0])
    (s1, metrics), grads = jax.jit(lambda s: (step(s, jb), grad(s.params)))(s0)
    return s0, s1, metrics, grads


def port_state(ref_state, cfg):
    return from_reference_train_state(jax.tree.map(np.asarray, ref_state), cfg, "cpu")


def stacked(groups) -> dict:
    return {g.key: (torch.stack(g.params) if g.stacked else g.params[0]).detach().numpy()
            for g in groups}


def close(got, want, atol, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, equal_nan=True, err_msg=what)


def check_step(cfg, s0, s1, ref_metrics, ref_grads, state, metrics, port_grads=None,
               loss_rtol=LOSS_RTOL, grad_tol=GRAD_TOL, exempt=EXEMPT,
               delta_tol=DELTA_TOL, state_tol=STATE_TOL, free=None) -> None:
    """The port's step (`state`, `metrics`) against the reference's (module
    docstring); `free` maps a path to the elements that may differ besides."""
    for k, v in ref_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=loss_rtol, atol=1e-30,
                                   equal_nan=True, err_msg=f"{cfg.name} {k}")
    assert int(state.step) == int(s1.step) == 1
    g_ref = ref_paths(ref_grads)
    gmax = max(float(np.nanmax(np.abs(g))) for g in g_ref.values())
    if port_grads is not None:
        for k, g in port_grads.items():
            close(g, g_ref[k], grad_tol * gmax, f"{cfg.name} grad {k}")
    p0, p1 = ref_paths(s0.params), ref_paths(s1.params)
    got = stacked(param_groups(state.params, cfg))
    assert sorted(got) == sorted(p1)
    for k, want in p1.items():
        g, d_ref, d_port = g_ref[k], want - p0[k], got[k] - p0[k]
        both_zero = (g == 0) & ((port_grads[k] == 0) if port_grads is not None else True)
        held = (np.abs(g) > exempt * gmax) | both_zero | np.isnan(g)
        if free is not None:
            held &= ~free[k]
        atol = delta_tol * float(np.nanmax(np.abs(d_ref), initial=0.0)) + \
            2 * np.finfo(np.float32).eps * np.abs(want)
        bad = held & ~((np.abs(d_port - d_ref) <= atol) | (np.isnan(d_port) & np.isnan(d_ref)))
        assert not bad.any(), (cfg.name, k, int(bad.sum()), float(np.nanmax(np.abs(
            d_port - d_ref)[bad])), float(np.nanmax(np.abs(d_ref))))
    want_state = ref_paths(s1.opt["state"])
    got_state = {f"{k}/{kind}": t.numpy() for k, s in state.opt["state"].items()
                 for kind, t in s.items()}
    assert sorted(got_state) == sorted(want_state)
    for k, want in want_state.items():
        leaf = k.rsplit("/", 1)[0]
        leaf_g = float(np.nanmax(np.abs(g_ref[leaf]), initial=0.0))
        atol = state_tol * float(np.nanmax(np.abs(want), initial=0.0)) + \
            grad_tol * gmax * max(1.0, 2 * leaf_g)
        keep = ~free[leaf] if free is not None else np.ones(want.shape, bool)
        close(got_state[k][keep], want[keep], atol, f"{cfg.name} state {k}")
    assert int(state.opt["count"]) == int(s1.opt["count"]) == 1


def port_step(cfg, s0, batch, *, with_grads: bool = True):
    """(the port's state after one step from the reference's s0, its
    metrics, its grads by the reference's path)."""
    model = build_model(cfg, "cpu")
    state = port_state(s0, cfg)
    grads = None
    if with_grads:
        groups = param_groups(state.params, cfg)
        _, _, gs = grads_of(model, state.params, batch, [t for g in groups for t in g.params])
        grads = {}
        for g in groups:
            mine, gs = gs[:len(g.params)], gs[len(g.params):]
            grads[g.key] = (torch.stack(mine) if g.stacked else mine[0]).numpy()
    new, metrics = make_train_step(model, **STEP)(state, batch)
    return new, metrics, grads


@pytest.mark.parametrize("arch", list_archs())
def test_train_step_matches_the_reference(arch):
    ref_cfg, cfg = configs(arch)
    batch = ref_lm_batch(ref_cfg, **BATCH)
    s0, s1, ref_metrics, ref_grads = ref_step(ref_cfg, batch)
    state, metrics, grads = port_step(cfg, s0, batch)
    assert sorted(metrics) == sorted(ref_metrics) == ["ce", "grad_norm", "loss", "lr",
                                                      "moe_aux", "z_loss"]
    assert all(t.ndim == 0 and t.dtype == torch.float32 for t in metrics.values())
    check_step(cfg, s0, s1, ref_metrics, ref_grads, state, metrics, grads)
    nan = np.isnan(float(ref_metrics["grad_norm"]))
    assert nan == (arch == "zamba2-1.2b"), "R10: only zamba2's reduced init gives NaN grads"


def test_zamba2_shared_block_is_moved_by_weight_decay_alone():
    """R7: the reference never applies zamba2's shared block, so its grads
    are zeros (None from autograd in the port), and AdamW's weight decay
    moves each leaf to p - lr * 0.1 * p, in both packages."""
    ref_cfg, cfg = configs("zamba2-1.2b")
    batch = ref_lm_batch(ref_cfg, **BATCH)
    s0, s1, _, ref_grads = ref_step(ref_cfg, batch)
    state, metrics, grads = port_step(cfg, s0, batch)
    p0, p1 = ref_paths(s0.params), ref_paths(s1.params)
    got = stacked(param_groups(state.params, cfg))
    keys = [k for k in p1 if k.startswith("backbone/shared_block/")]
    assert len(keys) == 9
    lr = np.float32(1e-3)
    for k in keys:
        assert not ref_paths(ref_grads)[k].any() and not grads[k].any(), k
        want = p0[k] - lr * (np.float32(0.1) * p0[k])
        assert np.array_equal(got[k], want), k
        # the jitted reference fuses the expression: within an ulp of it
        np.testing.assert_allclose(p1[k], want, rtol=np.finfo(np.float32).eps, atol=0)
        assert not np.array_equal(got[k], p0[k])


def test_microbatches_accumulate_as_the_reference():
    """microbatches = 2: the port against the reference's scan, and against
    the port's own single batch (the reference's own test's 1e-5)."""
    ref_cfg, cfg = configs("qwen2-0.5b", microbatches=2)
    batch = ref_lm_batch(ref_cfg, batch=4, seq=16)
    s0, s1, ref_metrics, ref_grads = ref_step(ref_cfg, batch)
    state, metrics, _ = port_step(cfg, s0, batch, with_grads=False)
    check_step(cfg, s0, s1, ref_metrics, ref_grads, state, metrics)
    single, met1, _ = port_step(dataclasses.replace(cfg, microbatches=1), s0, batch,
                                with_grads=False)
    np.testing.assert_allclose(float(metrics["loss"]), float(met1["loss"]), rtol=1e-5)
    for a, b in zip(param_groups(state.params, cfg), param_groups(single.params, cfg)):
        for x, y in zip(a.params, b.params):
            assert float((x - y).detach().abs().max()) < 1e-5, a.key


def test_grad_compress_matches_the_reference():
    """grad_compress=True: the reference's train step raises on the LM
    trees (R11: `compress_grads` mistakes the segment tuples for its
    pairs), so the test runs its pieces in its train step's order -- grads,
    `compress_grads` (over the tree with its tuples as lists), the
    optimizer update at the schedule's lr, the norm of the compressed grads
    -- against the port's step, whose residual is held too."""
    ref_cfg, cfg = configs("qwen2-0.5b", grad_compress=True)
    model = ref_build_model(ref_cfg)
    batch = ref_lm_batch(ref_cfg, **BATCH)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    s0 = ref_state0(ref_cfg.name, ref_cfg.optimizer, True)
    with pytest.raises(IndexError):
        ref_make_train_step(model, **STEP)(s0, jb)

    def as_lists(tree):
        if isinstance(tree, dict):
            return {k: as_lists(v) for k, v in tree.items()}
        return [as_lists(v) for v in tree] if isinstance(tree, (list, tuple)) else tree

    @jax.jit
    def step(s):
        (loss, metrics), grads = jax.value_and_grad(model.loss_fn, has_aux=True)(s.params, jb)
        deq, ef = ref_compress_grads(as_lists(grads), as_lists(s.ef))
        deq = jax.tree.unflatten(jax.tree.structure(s.params), jax.tree.leaves(deq))
        lr = ref_cosine_schedule(STEP["peak_lr"], STEP["warmup"], 10_000)(s.step)
        params, opt = ref_get_optimizer(ref_cfg.optimizer).update(deq, s.opt, s.params, lr)
        gnorm = jnp.sqrt(sum(jnp.sum(g ** 2) for g in jax.tree.leaves(deq)))
        return (RefTrainState(s.step + 1, params, opt, ef),
                {"loss": loss, "lr": lr, "grad_norm": gnorm, **metrics}, grads)

    s1, ref_metrics, ref_grads = step(s0)
    raw = ref_paths(ref_grads)
    gmax = max(float(np.abs(g).max()) for g in raw.values())
    free = {}
    for k, g in raw.items():
        scale = max(float(np.abs(g).max()), 1e-30) / 127.0
        a = np.abs(g) / scale
        free[k] = np.abs(a - np.floor(a) - 0.5) * scale <= GRAD_TOL * gmax
    # a leaf whose grads all lie within the tolerance (the key biases'
    # rounding noise) is free whole; the rest hold >= 90% of the elements
    assert 0 < sum(int(f.sum()) for f in free.values()) < 0.1 * sum(f.size for f in free.values())
    state, metrics, _ = port_step(cfg, s0, batch, with_grads=False)
    check_step(cfg, s0, s1, ref_metrics, ref_grads, state, metrics, free=free)
    want_ef = ref_paths(s1.ef)
    assert sorted(state.ef) == sorted(want_ef)
    for k, want in want_ef.items():
        close(state.ef[k].numpy()[~free[k]], want[~free[k]], GRAD_TOL * gmax, f"residual {k}")


@pytest.mark.parametrize("arch", ("qwen2-0.5b", "deepseek-v3-671b", "llama-3.2-vision-90b"))
def test_remat_gives_byte_equal_grads(arch):
    """cfg.remat (each pattern application checkpointed, `pattern_runs`)
    and remat_policy 'dots' against no remat: loss and every grad
    byte-equal; the serving path never checkpoints."""
    cfg = get_config(arch).reduced()
    batch = ref_lm_batch(cfg, **BATCH)
    out = {}
    for name, changes in (("off", dict(remat=False)), ("full", dict(remat=True)),
                          ("dots", dict(remat=True, remat_policy="dots"))):
        model = build_model(dataclasses.replace(cfg, **changes), "cpu")
        state = make_train_state(model, torch.Generator("cpu").manual_seed(0))
        leaves = [t for g in param_groups(state.params, cfg) for t in g.params]
        loss, _, grads = grads_of(model, state.params, batch, leaves)
        out[name] = (loss, grads)
    for name in ("full", "dots"):
        assert torch.equal(out[name][0], out["off"][0]), name
        for g, h in zip(out[name][1], out["off"][1]):
            assert torch.equal(g, h), name


def test_remat_checkpoints_each_pattern_application(monkeypatch):
    from repro_torch.models import transformer
    calls = []
    real = transformer.checkpoint
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda fn, *a, **kw: calls.append(a[:2]) or real(fn, *a, **kw))
    cfg = dataclasses.replace(get_config("llama-3.2-vision-90b").reduced(), remat=True)
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0))
    batch = ref_lm_batch(cfg, **BATCH)
    model.loss_fn(params, batch)
    assert calls == [(0, 2), (2, 2)] == transformer.pattern_runs(cfg)
    calls.clear()
    with torch.no_grad():
        model.loss_fn(params, batch)
    caches = model.init_cache(2, 20)
    model.prefill(params, {k: v for k, v in batch.items() if k != "labels"}, caches)
    assert calls == []


def test_from_reference_train_state_carries_every_leaf():
    ref_cfg, cfg = configs("deepseek-v3-671b", grad_compress=True)
    s0 = ref_state0(cfg.name, cfg.optimizer, True)
    state = port_state(s0, cfg)
    got = {f"opt/state/{k}/{kind}": t for k, s in state.opt["state"].items()
           for kind, t in s.items()}
    got.update({f"ef/{k}": t for k, t in state.ef.items()})
    want = {f"opt/state/{k}": v for k, v in ref_paths(s0.opt["state"]).items()}
    want.update({f"ef/{k}": v for k, v in ref_paths(s0.ef).items()})
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k].numpy(), want[k]) for k in want)
    assert all(t.requires_grad for g in param_groups(state.params, cfg) for t in g.params)
    bad = jax.tree.map(np.asarray, s0)
    bad.opt["state"]["emb"]["vr"] = bad.opt["state"]["emb"]["vr"][:-1]
    with pytest.raises(ValueError, match="emb/vr"):
        from_reference_train_state(bad, cfg, "cpu")


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    state, losses = train_cli.main(["--device", "cpu", "--steps", "3", "--ckpt-dir",
                                    str(tmp_path), "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "done: 3 steps, 657,536 params" in out
    assert len(losses) == 3 and all(np.isfinite(losses)) and int(state.step) == 3
    import json
    manifest = json.loads((tmp_path / "step_00000002" / "manifest.json").read_text())
    assert manifest["mesh_shape"] == [1, 1] and manifest["complete"]


def test_train_cli_restarts_after_an_injected_fault(tmp_path, capsys):
    _, losses = train_cli.main(["--device", "cpu", "--steps", "4", "--ckpt-dir", str(tmp_path),
                                "--ckpt-every", "2", "--inject-fault-at", "3"])
    _, clean = train_cli.main(["--device", "cpu", "--steps", "4", "--ckpt-dir",
                               str(tmp_path / "clean"), "--ckpt-every", "2"])
    assert losses == clean[:3] + clean[2:]          # step 2 replayed from the step-2 checkpoint
