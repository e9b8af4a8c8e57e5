"""The port's train step under the quantized matmul methods (`mitchell`,
`karatsuba_int16`) against the JAX package, on the CPU, and the gradient
of a quantized `dense` (ROADMAP Queue 3, R9).

Same set-up as tests/test_torch_train.py (reduced configs in float32, the
reference's `make_train_state` at PRNGKey(0), batch 2 x seq 16, one step
at lr 1e-3), for qwen2-0.5b (AdamW) and deepseek-v3-671b (Adafactor, MoE).

What the gradient of a quantized model is: the integer products carry no
gradient, so a quantized `dense` passes gradient only through the abs-max
scales of its two operands -- one element of `w` and one of `x` (R9) -- and
every weight behind such a layer gets a gradient in one element. Those
few scale gradients are long sums of products of both signs that mostly
cancel, so a last-bit difference upstream (R6) moves them by far more
than a float32 ulp of their result.

Tolerances, from the reference's own spread. The reference's jitted step
and the same step under `jax.disable_jit()` differ (XLA refolds the
scale products): by 3.0e-3 (mitchell) / 3.1e-4 (karatsuba_int16) of the
largest |grad| for qwen2, 2.0e-3 / 6.1e-4 for deepseek, and by 3.3e-5 /
7.5e-5 of the loss under mitchell. The port against the eager reference:
2.1e-7 / 5.8e-7 of the largest |grad| under mitchell (the port computes
what the reference's op-by-op program computes: held at 1e-6 below, loss
within 1e-6); under karatsuba_int16 4.4e-4 / 5.4e-4, the size of the
reference's own spread. That gap is the 8127-level quantizer's: the first
layer's norm output differs in the last bits (R6), a few of its elements
round the other way, and the flips cascade through the later layers;
given the reference's integers at every quantized `dense`, the port's
qwen2 grads come within 2.0e-7 of the largest and its loss within 4.8e-7
(`test_karatsuba_grad_gap_is_the_quantizers_rounding_flips`).
Against the jitted reference the port is held to twice the reference's
own spread: grads within GRAD_TOL[method] x the largest |grad|, the loss
within rtol 2e-4; an element whose grad is within that of zero may take
either sign in the first AdamW / Adafactor step and is exempt in the
params. AdamW's first step saturates to the grad's sign, so the others
hold within DELTA_TOL (2e-3) of their leaf's largest |update|;
Adafactor's divides each grad by its row's and column's RMS, so a grad's
relative gap (up to the grad tolerance over its size) passes into its
update: within 10% of the leaf's largest |update| (observed 3.8%, one
embedding element of deepseek under mitchell). The non-zero pattern of every grad is the
reference's, but for elements within the grad tolerance of zero (one key
bias element: softmax ignores the bias, so its grad is rounding noise, 0
in the port and -2.3e-10 in the reference under mitchell).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data.tokens import lm_batch as ref_lm_batch
from repro.models.layers import dense as ref_dense
from repro.models.model import build_model as ref_build_model
from repro.runtime.train_lib import make_train_state as ref_make_train_state
from repro.runtime.train_lib import make_train_step as ref_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import from_reference_lm_params, from_reference_train_state
from repro_torch.models import build_model
from repro_torch.models.layers import dense
from repro_torch.optim import param_groups
from repro_torch.runtime.train_lib import grads_of, make_train_step

torch.set_num_threads(1)

STEP = dict(peak_lr=1e-3, warmup=1)
BATCH = dict(batch=2, seq=16)
#: twice the reference's own jit-vs-eager grad spread (module docstring)
GRAD_TOL = {"mitchell": 6e-3, "karatsuba_int16": 1.5e-3}
LOSS_RTOL = 2e-4
DELTA_TOL = {"adamw": 2e-3, "adafactor": 0.1}


def ref_paths(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    name = lambda e: str(getattr(e, "key", getattr(e, "idx", getattr(e, "name", e))))  # noqa: E731
    return {"/".join(name(e) for e in p): np.asarray(v) for p, v in leaves}


def setup(arch: str, method: str):
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(), matmul_method=method)
    cfg = dataclasses.replace(get_config(arch).reduced(), matmul_method=method)
    ref_model = ref_build_model(ref_cfg)
    s0 = ref_make_train_state(ref_model, jax.random.PRNGKey(0))
    batch = ref_lm_batch(ref_cfg, **BATCH)
    return ref_model, s0, cfg, batch


def port_loss_grads(cfg, params, batch):
    """(loss, {reference path: grad}) of the port, None grads as zeros."""
    groups = param_groups(params, cfg)
    loss, _, gs = grads_of(build_model(cfg, "cpu"), params, batch,
                           [t for g in groups for t in g.params])
    out = {}
    for g in groups:
        mine, gs = gs[:len(g.params)], gs[len(g.params):]
        out[g.key] = (torch.stack(mine) if g.stacked else mine[0]).numpy()
    return float(loss), out


def check_pattern(got: dict, want: dict, tol: float) -> None:
    for k, w in want.items():
        differ = (got[k] != 0) != (w != 0)
        assert not (differ & ((np.abs(got[k]) > tol) | (np.abs(w) > tol))).any(), k


@pytest.mark.parametrize("method", ("mitchell", "karatsuba_int16"))
@pytest.mark.parametrize("arch", ("qwen2-0.5b", "deepseek-v3-671b"))
def test_quantized_train_step_matches_the_reference(arch, method):
    ref_model, s0, cfg, batch = setup(arch, method)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step = ref_make_train_step(ref_model, **STEP)
    grad = jax.grad(lambda p: ref_model.loss_fn(p, jb)[0])
    (s1, ref_metrics), ref_grads = jax.jit(lambda s: (step(s, jb), grad(s.params)))(s0)
    state = from_reference_train_state(jax.tree.map(np.asarray, s0), cfg, "cpu")
    _, port_grads = port_loss_grads(cfg, state.params, batch)
    state, metrics = make_train_step(build_model(cfg, "cpu"), **STEP)(state, batch)

    for k in ("loss", "ce", "z_loss", "moe_aux"):
        np.testing.assert_allclose(float(metrics[k]), float(ref_metrics[k]), rtol=LOSS_RTOL,
                                   atol=1e-30, err_msg=k)
    want = ref_paths(ref_grads)
    gmax = max(float(np.abs(g).max()) for g in want.values())
    tol = GRAD_TOL[method] * gmax
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(ref_metrics["grad_norm"]),
                               rtol=GRAD_TOL[method])
    for k, w in want.items():
        np.testing.assert_allclose(port_grads[k], w, rtol=0, atol=tol, err_msg=k)
    check_pattern(port_grads, want, tol)
    p0, p1 = ref_paths(s0.params), ref_paths(s1.params)
    groups = param_groups(state.params, cfg)
    for g in groups:
        got = (torch.stack(g.params) if g.stacked else g.params[0]).detach().numpy()
        d_ref, d_port = p1[g.key] - p0[g.key], got - p0[g.key]
        held = (np.abs(want[g.key]) > 2 * tol) | ((want[g.key] == 0) & (port_grads[g.key] == 0))
        atol = DELTA_TOL[cfg.optimizer] * float(np.abs(d_ref).max()) + \
            2 * np.finfo(np.float32).eps * np.abs(p1[g.key])
        bad = held & (np.abs(d_port - d_ref) > atol)
        assert not bad.any(), (g.key, int(bad.sum()), float(np.abs(d_port - d_ref)[bad].max()))


def test_mitchell_grads_equal_the_references_op_by_op_program():
    """Under `jax.disable_jit()` the reference computes what the port
    computes: the loss within 1e-6, every grad within 1e-6 of the largest
    |grad|, while its jitted program differs from both by ~3e-3 (XLA's
    refolding of the scale products)."""
    ref_model, s0, cfg, batch = setup("qwen2-0.5b", "mitchell")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    f = lambda p: ref_model.loss_fn(p, jb)[0]                          # noqa: E731
    jit_loss, jit_grads = jax.jit(jax.value_and_grad(f))(s0.params)
    with jax.disable_jit():
        loss, grads = jax.value_and_grad(f)(s0.params)
    params = from_reference_lm_params(jax.tree.map(np.asarray, s0.params), cfg, "cpu")
    for t in (t for g in param_groups(params, cfg) for t in g.params):
        t.requires_grad_(True)
    port_loss, port_grads = port_loss_grads(cfg, params, batch)
    assert abs(port_loss - float(loss)) <= 1e-6
    want, jit = ref_paths(grads), ref_paths(jit_grads)
    gmax = max(float(np.abs(g).max()) for g in want.values())
    gap = max(float(np.abs(port_grads[k] - w).max()) for k, w in want.items()) / gmax
    jit_gap = max(float(np.abs(jit[k] - w).max()) for k, w in want.items()) / gmax
    assert gap <= 1e-6 < 1e-4 <= jit_gap, (gap, jit_gap)
    check_pattern(port_grads, want, 1e-6 * gmax)


def test_karatsuba_grad_gap_is_the_quantizers_rounding_flips(monkeypatch):
    """Under karatsuba_int16 the port's grads stand ~4e-4 of the largest
    |grad| from the reference's op-by-op program, and this is the cause:
    the quantized `dense` inputs agree bit for bit until the first layer's
    norm output, which differs in the last bits (XLA's reductions against
    PyTorch's); there the 8127-level quantizer rounds a few elements apart
    -- each one grid step, each with its quotient x / scale on a
    half-integer in one package and a few ulps (at most 4) off it in the
    other. A flip moves a
    `dense` output by a grid step, so later inputs differ by far more and
    round apart in many places. Given the reference's integers at every
    quantized `dense`, the port's loss is within 1e-6 of the reference's
    and every grad within 1e-6 of the largest |grad|."""
    import repro.core.approx_matmul as ref_approx
    import repro_torch.core.approx_matmul as port_approx
    from repro_torch.core.quant import LimbDecomposition, balanced_limbs, limbs_to_int

    ref_model, s0, cfg, batch = setup("qwen2-0.5b", "karatsuba_int16")
    assert not cfg.remat                    # one quantize call per operand a forward
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    f = lambda p: ref_model.loss_fn(p, jb)[0]                          # noqa: E731
    ref_q = []                              # (x, scale, ints) of each quantize call
    real_ref = ref_approx.quantize_limbs

    def ref_record(x, *, karatsuba, axis=None):
        d, scale = real_ref(x, karatsuba=karatsuba, axis=axis)
        ref_q.append((np.asarray(x, np.float32), np.asarray(scale),
                      np.asarray((d.hi << d.limb_bits) + d.lo)))
        return d, scale

    with jax.disable_jit():
        with monkeypatch.context() as m:
            m.setattr(ref_approx, "quantize_limbs", ref_record)
            f(s0.params)
        loss, grads = jax.value_and_grad(f)(s0.params)

    real_port = port_approx.quantize_limbs
    port_q, run = [], {"calls": 0, "given": False}

    def port_quantize(x, *, karatsuba, axis=None):
        d, scale = real_port(x, karatsuba=karatsuba, axis=axis)
        i, run["calls"] = run["calls"], run["calls"] + 1
        if run["given"]:                    # the reference's integers for this call
            q = torch.from_numpy(ref_q[i][2].copy()).reshape(d.hi.shape)
            return LimbDecomposition(*balanced_limbs(q, d.limb_bits), d.limb_bits), scale
        port_q.append((x.detach().to(torch.float32).numpy().copy(),
                       scale.detach().numpy().copy(), limbs_to_int(d).numpy()))
        return d, scale

    monkeypatch.setattr(port_approx, "quantize_limbs", port_quantize)
    params = from_reference_lm_params(jax.tree.map(np.asarray, s0.params), cfg, "cpu")
    for t in (t for g in param_groups(params, cfg) for t in g.params):
        t.requires_grad_(True)
    want = ref_paths(grads)
    gmax = max(float(np.abs(g).max()) for g in want.values())
    out = {}
    for given in (False, True):
        run.update(calls=0, given=given)
        port_loss, port_grads = port_loss_grads(cfg, params, batch)
        assert run["calls"] == len(ref_q)
        gap = max(float(np.abs(port_grads[k] - w).max()) for k, w in want.items()) / gmax
        out[given] = (abs(port_loss - float(loss)), gap, port_grads)

    differ = [i for i, (r, p) in enumerate(zip(ref_q, port_q))
              if not np.array_equal(r[2].reshape(p[2].shape), p[2])]
    first = differ[0]
    (xr, sr, qr), (xp, sp, qp) = ref_q[first], port_q[first]
    xr, qr = xr.reshape(xp.shape), qr.reshape(qp.shape)
    assert all(np.array_equal(r[0].reshape(p[0].shape), p[0]) for r, p in
               zip(ref_q[:first], port_q[:first]))     # the same inputs before it
    assert (np.abs(xr - xp) <= 4 * np.spacing(np.abs(xp))).all()   # last bits apart
    flips = qr != qp
    assert (xr != xp)[flips].all()          # every flip has an input of its own
    assert 0 < flips.sum() < 16 and (np.abs(qr - qp)[flips] == 1).all()

    def to_half(x, scale):                  # distance of x / scale to a half-integer
        u = x[flips] / scale
        return np.abs(u - np.floor(u) - np.float32(0.5)), np.spacing(np.abs(u))

    (dr, ulp), (dp, _) = to_half(xr, sr), to_half(xp, sp)
    assert (np.minimum(dr, dp) == 0).all() and (np.maximum(dr, dp) <= 4 * ulp).all(), (dr, dp)
    (loss_gap, gap, _), (given_loss_gap, given_gap, given_grads) = out[False], out[True]
    assert given_loss_gap <= 1e-6 and given_gap <= 1e-6 < 1e-4 <= gap, out
    assert loss_gap > given_loss_gap
    check_pattern(given_grads, want, 1e-6 * gmax)


@pytest.mark.parametrize("method", ("mitchell", "karatsuba_int16"))
def test_quantized_dense_grad_flows_only_through_the_scales(method):
    """R9: `jax.grad` of a quantized `dense` is non-zero in exactly one
    element of `w` and one of `x` -- each operand's abs-max, which sets its
    scale -- in both packages, at the same positions, within 1e-6."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((6, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 16)) * 0.1).astype(np.float32)
    up = rng.standard_normal((6, 16)).astype(np.float32)

    def ref_f(x, w):
        return jnp.sum(ref_dense({"w": w}, x, method=method) * up)

    with jax.disable_jit():
        gx, gw = jax.grad(ref_f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    out = dense({"w": tw}, tx, method=method, impl="reference")
    px, pw = torch.autograd.grad((out * torch.from_numpy(up)).sum(), (tx, tw))
    for got, want, a in ((px.numpy(), np.asarray(gx), x), (pw.numpy(), np.asarray(gw), w)):
        assert np.count_nonzero(want) == 1 and np.count_nonzero(got) == 1
        assert np.array_equal(got != 0, want != 0)
        assert np.argmax(np.abs(want)) == np.argmax(np.abs(a))       # the abs-max element
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
