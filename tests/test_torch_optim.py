"""The port's training data, schedule, optimizers and gradient compression
(`repro_torch.data.tokens`, `repro_torch.optim`) against the JAX package,
on the CPU.

Both packages start from the same numbers: the reference's reduced-config
params at `PRNGKey(0)`, carried across by
`repro_torch.convert.from_reference_lm_params`, and grads drawn from
seeds with numpy in the reference's stacked shapes.

Tolerances, and why:
  * `lm_batch` and `compress_grads` (the dequantized grads and the new
    residual) are byte-equal: NumPy draws; an abs-max, a division by a
    float32 tensor, round half to even and a clip. The reference's
    `compress_grads` unzips its per-leaf (deq, residual) pairs with
    `is_leaf=isinstance(o, tuple)`, which also matches the segment tuples
    of an LM's params and raises IndexError (ROADMAP Queue 3, R11); the
    test hands it the same tree with those tuples as lists.
  * `cosine_schedule`: byte-equal in the warm-up (a multiply and a
    division); within one float32 ulp (rtol 2**-22) in the decay, where
    each library's float32 `cos` can differ in the last bit (ROADMAP
    Queue 3, R6).
  * One and two `adamw` / `adafactor` updates: within 1e-6 of each leaf's
    largest |value|, on the params and the state. The updates are the reference's float32 expressions in its
    order; `sqrt`, `rsqrt` and `pow` (the bias corrections, Adafactor's
    beta) may differ in the last bit, and Adafactor's means and its
    update-clipping RMS sum in each library's order.
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
from repro.optim.schedules import cosine_schedule as ref_cosine_schedule
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import from_reference_lm_params
from repro_torch.data.tokens import global_batch_iter, lm_batch
from repro_torch.optim import cosine_schedule, get_optimizer, param_groups
from repro_torch.optim.grad_compress import compress_grads, init_error_feedback

torch.set_num_threads(1)

#: one arch of each input kind, optimizer and stacking case: AdamW over
#: one stacked segment (qwen2); Adafactor with layernorm biases (stacked
#: 1-D leaves, factored across the layers: nemotron), with 3-D expert
#: stacks and a one-layer segment (deepseek), with the 0-d `xgate` (the VLM)
OPT_ARCHS = ("qwen2-0.5b", "nemotron-4-340b", "deepseek-v3-671b", "llama-3.2-vision-90b",
             "hubert-xlarge")


@functools.lru_cache(maxsize=None)
def ref_params(arch: str):
    return ref_build_model(ref_get_config(arch).reduced()).init(jax.random.PRNGKey(0))


def ref_paths(tree) -> dict:
    """{'/'-joined path: numpy leaf} of a reference pytree."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    name = lambda e: str(getattr(e, "key", getattr(e, "idx", getattr(e, "name", e))))  # noqa: E731
    return {"/".join(name(e) for e in p): np.asarray(v) for p, v in leaves}


def seeded_grads(tree, seed: int):
    """Normal draws in the shapes of a reference pytree, some scaled down
    so Adafactor's clipping and AdamW's eps both matter."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree.flatten(tree)
    out = [rng.standard_normal(np.shape(x)).astype(np.float32) * np.float32(10.0 ** -(i % 4))
           for i, x in enumerate(leaves)]
    return jax.tree.unflatten(treedef, out)


def tuples_as_lists(tree):
    """A reference pytree with its tuples (the segments) as lists."""
    if isinstance(tree, dict):
        return {k: tuples_as_lists(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tuples_as_lists(v) for v in tree]
    return tree


def port_grads(groups, ref_grad_tree) -> list:
    """The reference's stacked grads split per layer, per group."""
    flat = ref_paths(ref_grad_tree)
    return [[torch.from_numpy(np.array(flat[g.key][i] if g.stacked else flat[g.key]))
             for i in range(len(g.params))] for g in groups]


@pytest.mark.parametrize("arch", list_archs())
def test_lm_batch_is_byte_equal_to_the_reference(arch):
    cfg = get_config(arch).reduced()
    ref_cfg = ref_get_config(arch).reduced()
    for kw in (dict(batch=2, seq=16), dict(batch=3, seq=7, seed=5, step=11, shard=2)):
        got, want = lm_batch(cfg, **kw), ref_lm_batch(ref_cfg, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (arch, k)
    step, first = next(global_batch_iter(cfg, global_batch=2, seq=8, start_step=4))
    assert step == 4 and all(np.array_equal(first[k], v) for k, v in
                             lm_batch(cfg, batch=2, seq=8, step=4).items())


@pytest.mark.parametrize("args", [(3e-4, 100, 10_000), (1e-3, 2, 30), (1e-3, 0, 5),
                                  (3e-4, 100, 100)])
def test_cosine_schedule_matches_the_reference(args):
    ref, port = ref_cosine_schedule(*args), cosine_schedule(*args)
    steps = list(range(0, 160)) + [9_999, 10_000, 20_000]
    want = np.array([float(ref(jnp.asarray(s, jnp.int32))) for s in steps], np.float32)
    got = [port(torch.tensor(s, dtype=torch.int32)) for s in steps]
    assert all(t.dtype == torch.float32 and t.ndim == 0 for t in got)
    got = np.array([float(t) for t in got], np.float32)
    warm = np.array(steps) < args[1]
    assert np.array_equal(got[warm], want[warm])
    np.testing.assert_allclose(got, want, rtol=2.0**-22, atol=0)


def check_tree(got: dict, want: dict, what: str, rtol: float = 1e-6) -> None:
    assert sorted(got) == sorted(want), what
    for k in want:
        g = got[k].detach().numpy() if isinstance(got[k], torch.Tensor) else got[k]
        scale = float(np.abs(want[k]).max()) if want[k].size else 0.0
        np.testing.assert_allclose(g, want[k], rtol=rtol, atol=rtol * scale,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", ("adamw", "adafactor"))
@pytest.mark.parametrize("arch", OPT_ARCHS)
def test_optimizer_updates_match_the_reference_on_the_stacked_tree(arch, name):
    cfg = get_config(arch).reduced()
    params0 = ref_params(arch)
    ref_opt = ref_get_optimizer(name)
    opt = get_optimizer(name)
    params = from_reference_lm_params(jax.tree.map(np.asarray, params0), cfg, "cpu")
    groups = param_groups(params, cfg)
    ref_state, ref_p = ref_opt.init(params0), params0
    state = opt.init(groups)
    # the state has the reference's stacked shapes, keyed by its tree paths
    want_state = ref_paths(ref_state["state"])
    assert {f"{k}/{kind}": tuple(t.shape) for k, s in state["state"].items()
            for kind, t in s.items()} == {k: v.shape for k, v in want_state.items()}
    for i, lr in enumerate((1e-3, 3e-4)):
        grads = seeded_grads(params0, seed=i)
        ref_p, ref_state = ref_opt.update(grads, ref_state, ref_p, jnp.float32(lr))
        out = opt.update(port_grads(groups, grads), state, groups,
                         torch.tensor(lr, dtype=torch.float32))
        assert out is state and int(state["count"]) == int(ref_state["count"]) == i + 1
        check_tree({g.key: torch.stack(g.params) if g.stacked else g.params[0] for g in groups},
                   ref_paths(ref_p), f"{arch} {name} update {i + 1} params")
        check_tree({f"{k}/{kind}": t for k, s in state["state"].items() for kind, t in s.items()},
                   ref_paths(ref_state["state"]), f"{arch} {name} update {i + 1} state")


def test_adafactor_factors_a_stacked_norm_vector_across_the_layers():
    """nemotron's reduced ln1 bias: (4, 128) stacked, so `vr` (4,) and
    `vc` (128,), as in the reference; an unstacked (128,) vector keeps `v`."""
    cfg = get_config("nemotron-4-340b").reduced()
    params = from_reference_lm_params(jax.tree.map(np.asarray, ref_params(cfg.name)), cfg, "cpu")
    groups = param_groups(params, cfg)
    state = get_optimizer("adafactor").init(groups)["state"]
    key = "backbone/segments/0/0/ln1/bias"
    assert {k: tuple(v.shape) for k, v in state[key].items()} == {"vr": (4,), "vc": (128,)}
    assert {k: tuple(v.shape) for k, v in state["backbone/final_ln/bias"].items()} == \
        {"v": (128,)}


@pytest.mark.parametrize("arch", list_archs())
def test_param_groups_are_the_references_stacked_leaves(arch):
    cfg = get_config(arch).reduced()
    params0 = ref_params(arch)
    params = from_reference_lm_params(jax.tree.map(np.asarray, params0), cfg, "cpu")
    groups = param_groups(params, cfg)
    want = ref_paths(params0)
    assert [g.key for g in groups] == list(want)          # the reference's leaf order
    for g in groups:
        got = torch.stack(g.params) if g.stacked else g.params[0]
        assert g.shape == want[g.key].shape and np.array_equal(got.numpy(), want[g.key]), g.key
    assert sum(len(g.params) for g in groups) == \
        len([t for t in jax.tree.leaves(from_reference_lm_params(
            jax.tree.map(np.asarray, params0), cfg, "cpu"))])


@pytest.mark.parametrize("arch", ("qwen2-0.5b", "nemotron-4-340b"))
def test_compress_grads_is_byte_equal_with_its_residual(arch):
    cfg = get_config(arch).reduced()
    params0 = ref_params(arch)
    params = from_reference_lm_params(jax.tree.map(np.asarray, params0), cfg, "cpu")
    groups = param_groups(params, cfg)
    ef = init_error_feedback(groups)
    ref_ef = tuples_as_lists(jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params0))
    assert {k: tuple(v.shape) for k, v in ef.items()} == \
        {k: v.shape for k, v in ref_paths(ref_ef).items()}
    for i in range(3):
        grads = tuples_as_lists(seeded_grads(params0, seed=10 + i))
        with pytest.raises(IndexError):                   # R11: the tuples as they are
            ref_compress_grads(seeded_grads(params0, seed=10 + i),
                               jax.tree.map(jnp.zeros_like, params0))
        ref_deq, ref_ef = ref_compress_grads(grads, ref_ef)
        deq, ef = compress_grads(port_grads(groups, grads), ef, groups)
        want_deq, want_ef = ref_paths(ref_deq), ref_paths(ref_ef)
        for g, gs in zip(groups, deq):
            got = torch.stack(gs) if g.stacked else gs[0]
            assert np.array_equal(got.numpy(), want_deq[g.key]), (i, g.key)
            assert np.array_equal(ef[g.key].numpy(), want_ef[g.key]), (i, g.key)


def test_unknown_optimizer_is_refused():
    with pytest.raises(ValueError, match="unknown optimizer"):
        get_optimizer("sgd")
