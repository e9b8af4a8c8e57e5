"""The port's Mamba2 mixer (`repro_torch.models.ssm`), xLSTM blocks
(`repro_torch.models.xlstm`) and their block assembly and caches
(`repro_torch.models.transformer`) against the JAX package, on the CPU.

Both packages take the same numpy inputs and weights: inputs made from
seeds with numpy, weights from the reference's initializers at
`jax.random.PRNGKey(0)`, carried across as numpy arrays. Configs are the
reduced zamba2-1.2b and xlstm-1.3b (float32).

Tolerances, and why:
  * The depthwise causal conv's state is byte-equal (a copy of its
    inputs); its output within rtol 1e-4 / atol 1e-5: the taps are summed
    in the reference's order (eager XLA gives the same float32 sums), but
    each library's sigmoid in SiLU differs in the last bit.
  * Everything else in float32: rtol 1e-4 / atol 1e-5 (the LM forward's
    tolerance in `test_torch_lm.py`). The scans exponentiate cumulative
    sums -- SSD exp(cumsum(dt * A)), the mLSTM's exp(i - cumsum(log_sigmoid
    f) - cummax), the sLSTM's exp gates -- with each library's own exp /
    log1p / tanh / rsqrt, which differ in the last bit, and the einsums
    contract in each library's own order. An exponent multiplies such a relative
    difference by its own size (ROADMAP Queue 3, R6); at these sizes the
    outputs and states stay within a few ulps of float32.
  * Under `karatsuba_int16` (the mixers' projections through the limb
    quantizer): max |diff| <= 5e-3 x max |reference|, the LM forward's
    limb tolerance -- a last-bit difference moves an activation across a
    rounding boundary of the per-call absmax quantizer now and then, which
    costs one step of 1/8127 of the absmax.
  * Decode after prefill against the parallel form over the whole
    sequence, in the port alone: rtol 1e-4 / atol 2e-5 (the recurrence and
    the chunked form sum the same terms in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tf
from repro.models import xlstm as ref_xlstm
from repro.models.model import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.convert import from_reference_lm_params
from repro_torch.models import build_model
from repro_torch.models import ssm, transformer, xlstm

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
#: max |port - reference| / max |reference| under the limb quantizer
LIMB_TOL = 5e-3
ZAMBA, XLSTM = "zamba2-1.2b", "xlstm-1.3b"


def cfgs(arch: str, **changes):
    """(reference cfg, port cfg): the reduced config of `arch` with
    `changes`."""
    return (dataclasses.replace(ref_get_config(arch).reduced(), **changes),
            dataclasses.replace(get_config(arch).reduced(), **changes))


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(np.asarray(tree)))


def close(got, want, what: str = "", method: str = "exact", **tol) -> None:
    """Every leaf of got (torch) within tol of want (jax), same dtype; for a
    quantized `method`, max |diff| within LIMB_TOL of max |want|."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            close(got[k], want[k], f"{what}/{k}", method, **tol)
        return
    assert str(got.dtype).removeprefix("torch.") == str(np.asarray(want).dtype), \
        (what, got.dtype, want.dtype)
    got, want = got.float().numpy(), np.asarray(want).astype(np.float32)
    if method == "exact":
        np.testing.assert_allclose(got, want, err_msg=what, **(tol or TOL))
    else:
        assert np.abs(got - want).max() <= LIMB_TOL * np.abs(want).max(), what


def normal(seed: int, *shape: int, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ------------------------------------------------------------- mamba2

@pytest.mark.parametrize("with_state", (False, True))
def test_causal_conv_matches_the_reference(with_state):
    x, w, bias = normal(1, 2, 9, 24), normal(2, 4, 24, scale=0.1), normal(3, 24)
    state = normal(4, 2, 3, 24) if with_state else None
    want, want_state = ref_ssm._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
        None if state is None else jnp.asarray(state))
    got, got_state = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                      torch.from_numpy(bias),
                                      None if state is None else torch.from_numpy(state))
    close(got, want)
    np.testing.assert_array_equal(got_state.numpy(), np.asarray(want_state))


def ssd_inputs(seed: int, b: int = 2, s: int = 16, h: int = 4, p: int = 8, n: int = 8):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 2)).astype(np.float32)
    a_log = np.log(np.linspace(1.0, h, h)).astype(np.float32)
    bmat = rng.standard_normal((b, s, n)).astype(np.float32)
    cmat = rng.standard_normal((b, s, n)).astype(np.float32)
    return xh, dt, a_log, bmat, cmat


@pytest.mark.parametrize("with_h0", (False, True))
@pytest.mark.parametrize("chunk", (4, 8, 16))
def test_ssd_chunked_matches_the_reference(chunk, with_h0):
    args = ssd_inputs(10 + chunk)
    h0 = normal(5, 2, 4, 8, 8) if with_h0 else None
    want_y, want_h = ref_ssm._ssd_chunked(*map(jnp.asarray, args), chunk,
                                          None if h0 is None else jnp.asarray(h0))
    got_y, got_h = ssm._ssd_chunked(*map(torch.from_numpy, args), chunk,
                                    None if h0 is None else torch.from_numpy(h0))
    close(got_y, want_y, "y")
    close(got_h, want_h, "h_last")


def test_ssd_chunked_refuses_a_length_that_is_not_a_chunk_multiple():
    args = ssd_inputs(3, s=12)
    with pytest.raises(AssertionError, match="not a multiple"):
        ssm._ssd_chunked(*map(torch.from_numpy, args), 8, None)


@pytest.mark.parametrize("chunk", (4, 8))
def test_ssd_state_hands_across_two_calls(chunk):
    """The state after the first half, handed to a call on the second
    half, gives the outputs and last state of one call on the whole, and
    the reference's."""
    xh, dt, a_log, bmat, cmat = ssd_inputs(21)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    y1, h1 = ssm._ssd_chunked(t(xh[:, :8]), t(dt[:, :8]), t(a_log), t(bmat[:, :8]),
                              t(cmat[:, :8]), chunk, None)
    y2, h2 = ssm._ssd_chunked(t(xh[:, 8:]), t(dt[:, 8:]), t(a_log), t(bmat[:, 8:]),
                              t(cmat[:, 8:]), chunk, h1)
    whole_y, whole_h = ssm._ssd_chunked(t(xh), t(dt), t(a_log), t(bmat), t(cmat), chunk, None)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), whole_y.numpy(), **TOL)
    np.testing.assert_allclose(h2.numpy(), whole_h.numpy(), **TOL)
    j = jnp.asarray
    ry1, rh1 = ref_ssm._ssd_chunked(j(xh[:, :8]), j(dt[:, :8]), j(a_log), j(bmat[:, :8]),
                                    j(cmat[:, :8]), chunk, None)
    ry2, rh2 = ref_ssm._ssd_chunked(j(xh[:, 8:]), j(dt[:, 8:]), j(a_log), j(bmat[:, 8:]),
                                    j(cmat[:, 8:]), chunk, rh1)
    close(y2, ry2, "second half y")
    close(h2, rh2, "second half state")


@pytest.mark.parametrize("method", ("exact", "karatsuba_int16"))
def test_mamba2_mixer_prefill_then_decode_matches_the_reference(method):
    """Prefill 12 positions from the zero caches (as `init_caches` gives
    them), then 3 decode steps, each fed the state the last call handed
    back; outputs and states against the reference's at every call, and
    the port's decode outputs against its own parallel form over all 15."""
    ref_cfg, cfg = cfgs(ZAMBA, matmul_method=method)
    ref_p = ref_ssm.mamba2_init(jax.random.PRNGKey(0), ref_cfg)
    p = to_torch(ref_p)
    x = normal(7, 2, 15, cfg.d_model)
    cache = transformer._init_cache_for_kind("mamba2", cfg, 2, 15, torch.float32,
                                             torch.device("cpu"))
    rs, rc = jnp.asarray(cache["ssm"].numpy()), jnp.asarray(cache["conv"].numpy())
    s, c = cache["ssm"], cache["conv"]
    outs = []
    for lo, hi, decode in ((0, 12, False), (12, 13, True), (13, 14, True), (14, 15, True)):
        want, rs, rc = ref_ssm.mamba2_mixer(ref_p, jnp.asarray(x[:, lo:hi]), ref_cfg,
                                            ssm_state=rs, conv_state=rc, decode=decode)
        got, s, c = ssm.mamba2_mixer(p, torch.from_numpy(x[:, lo:hi]), cfg, ssm_state=s,
                                     conv_state=c, decode=decode)
        close(got, want, f"y {lo}:{hi}", method)
        close(s, rs, f"ssm state {lo}:{hi}", method)
        close(c, rc, f"conv state {lo}:{hi}", method)
        outs.append(got)
    if method == "exact":      # a quantized call's absmax depends on its rows
        whole, _, _ = ssm.mamba2_mixer(p, torch.from_numpy(x), cfg)
        np.testing.assert_allclose(torch.cat(outs, 1).numpy(), whole.numpy(),
                                   rtol=1e-4, atol=2e-5)


# ------------------------------------------------------------- xLSTM

def mlstm_inputs(seed: int, b: int = 2, s: int = 16, h: int = 4, dh: int = 8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, dh)).astype(np.float32) for _ in range(3))
    k /= np.sqrt(dh)
    i_raw = rng.standard_normal((b, s, h)).astype(np.float32)
    f_raw = (rng.standard_normal((b, s, h)) + 2).astype(np.float32)
    return q, k, v, i_raw, f_raw


@pytest.mark.parametrize("chunk_q", (4, 16, 256))
def test_mlstm_parallel_matches_the_reference(chunk_q):
    args = mlstm_inputs(30 + chunk_q)
    want = ref_xlstm._mlstm_parallel(*map(jnp.asarray, args), chunk_q=chunk_q)
    got = xlstm._mlstm_parallel(*map(torch.from_numpy, args), chunk_q=chunk_q)
    close(got, want)


def test_mlstm_parallel_refuses_a_length_that_is_not_a_chunk_multiple():
    args = mlstm_inputs(3, s=12)
    with pytest.raises(AssertionError):
        xlstm._mlstm_parallel(*map(torch.from_numpy, args), chunk_q=8)


@pytest.mark.parametrize("method", ("exact", "karatsuba_int16"))
def test_mlstm_block_prefill_then_decode_matches_the_reference(method):
    """Prefill 12 positions, then 3 decode steps from the state prefill
    rebuilt; outputs and states against the reference's at every call, and
    the port's decode outputs against its own parallel form over all 15."""
    ref_cfg, cfg = cfgs(XLSTM, matmul_method=method)
    ref_p = ref_xlstm.mlstm_init(jax.random.PRNGKey(0), ref_cfg)
    p = to_torch(ref_p)
    x = normal(8, 2, 15, cfg.d_model)
    rstate = state = None
    outs = []
    for lo, hi, decode in ((0, 12, False), (12, 13, True), (13, 14, True), (14, 15, True)):
        want, rstate = ref_xlstm.mlstm_block_apply(ref_p, jnp.asarray(x[:, lo:hi]), ref_cfg,
                                                   state=rstate, decode=decode)
        got, state = xlstm.mlstm_block_apply(p, torch.from_numpy(x[:, lo:hi]), cfg,
                                             state=state, decode=decode)
        close(got, want, f"y {lo}:{hi}", method)
        close(state, rstate, f"state {lo}:{hi}", method)
        outs.append(got)
    if method == "exact":
        whole, _ = xlstm.mlstm_block_apply(p, torch.from_numpy(x), cfg)
        np.testing.assert_allclose(torch.cat(outs, 1).numpy(), whole.numpy(),
                                   rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("method", ("exact", "karatsuba_int16"))
def test_slstm_apply_matches_the_reference(method):
    """From no state over 10 positions, then 2 more positions from the
    state it handed back."""
    ref_cfg, cfg = cfgs(XLSTM, matmul_method=method)
    ref_p = ref_xlstm.slstm_init(jax.random.PRNGKey(1), ref_cfg)
    p = to_torch(ref_p)
    x = normal(9, 2, 12, cfg.d_model)
    rstate = state = None
    for lo, hi in ((0, 10), (10, 12)):
        want, rstate = ref_xlstm.slstm_apply(ref_p, jnp.asarray(x[:, lo:hi]), ref_cfg,
                                             state=rstate)
        got, state = xlstm.slstm_apply(p, torch.from_numpy(x[:, lo:hi]), cfg, state=state)
        close(got, want, f"y {lo}:{hi}", method)
        close(state, rstate, f"state {lo}:{hi}", method)


# ------------------------------------------------- blocks and caches

@pytest.mark.parametrize("kind", ("attn", "mamba2", "mamba2_shared", "mlstm", "slstm"))
def test_init_cache_for_kind_has_the_reference_shapes_and_dtypes(kind):
    arch = XLSTM if kind in ("mlstm", "slstm") else ZAMBA
    ref_cfg, cfg = cfgs(arch, sliding_window=8)
    want = ref_tf._init_cache_for_kind(kind, ref_cfg, 3, 20, jnp.bfloat16)
    got = transformer._init_cache_for_kind(kind, cfg, 3, 20, torch.bfloat16,
                                           torch.device("cpu"))
    close(got, want, kind, rtol=0, atol=0)


def test_mamba2_shared_block_matches_the_reference():
    """The `mamba2_shared` kind, which no config reaches (R7): the mixer,
    then the weight-shared attention + MLP block over a rolling
    `shared_kv` window of 8 slots in a 16-position cache; prefill 6
    positions, then 6 decode steps, so the window wraps."""
    ref_cfg, cfg = cfgs(ZAMBA, sliding_window=8)
    key = jax.random.PRNGKey(0)
    ref_p = ref_tf._block_init(key, "mamba2_shared", ref_cfg)
    ref_shared = ref_tf._shared_block_init(jax.random.PRNGKey(1), ref_cfg)
    p, shared = to_torch(ref_p), to_torch(ref_shared)
    b, s_max = 2, 16
    rcache = ref_tf._init_cache_for_kind("mamba2_shared", ref_cfg, b, s_max, jnp.float32)
    cache = transformer._init_cache_for_kind("mamba2_shared", cfg, b, s_max, torch.float32,
                                             torch.device("cpu"))
    assert cache["shared_kv"]["k"].shape[1] == 8
    x = normal(11, b, 12, cfg.d_model)
    for lo, hi in ((0, 6),) + tuple((t, t + 1) for t in range(6, 12)):
        decode = lo > 0
        pos = np.broadcast_to(np.arange(lo, hi, dtype=np.int32), (b, hi - lo))
        clen = np.full((b,), lo, np.int32)
        want, rcache, _ = ref_tf._apply_block(
            "mamba2_shared", ref_p, jnp.asarray(x[:, lo:hi]), ref_cfg,
            positions=jnp.asarray(pos), cache=rcache, cache_len=jnp.asarray(clen),
            shared_params=ref_shared, image_embeds=None, decode=decode)
        got, cache, _ = transformer._apply_block(
            "mamba2_shared", p, torch.from_numpy(x[:, lo:hi]), cfg,
            positions=torch.from_numpy(pos.copy()), cache=cache,
            cache_len=torch.from_numpy(clen), shared_params=shared, decode=decode,
            impl="auto")
        close(got, want, f"x {lo}:{hi}")
        close(cache, rcache, f"cache {lo}:{hi}")


def test_mamba2_shared_block_runs_without_a_cache():
    ref_cfg, cfg = cfgs(ZAMBA)
    ref_p = ref_tf._block_init(jax.random.PRNGKey(0), "mamba2_shared", ref_cfg)
    ref_shared = ref_tf._shared_block_init(jax.random.PRNGKey(1), ref_cfg)
    x = normal(12, 2, 16, cfg.d_model)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    want, _, _ = ref_tf._apply_block("mamba2_shared", ref_p, jnp.asarray(x), ref_cfg,
                                     positions=jnp.asarray(pos), cache=None, cache_len=None,
                                     shared_params=ref_shared, image_embeds=None,
                                     decode=False)
    got, new_cache, _ = transformer._apply_block(
        "mamba2_shared", to_torch(ref_p), torch.from_numpy(x), cfg,
        positions=torch.from_numpy(pos.copy()), cache=None, cache_len=None,
        shared_params=to_torch(ref_shared), decode=False, impl="auto")
    assert new_cache is None
    close(got, want)


# ------------------------------------------------------ R7, conversion

def both(arch: str):
    ref_cfg, cfg = cfgs(arch)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(cfg, "cpu")
    params = from_reference_lm_params(jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    return ref_model, ref_params, model, params


def test_zamba2_shared_block_is_built_counted_and_never_applied():
    """R7: zamba2's `shared_block` is carried across, counted by
    `count_params` in both packages alike, and perturbing it leaves the
    logits of both packages unchanged: no layer applies it."""
    ref_model, ref_params, model, params = both(ZAMBA)
    assert set(model.cfg.block_kinds()) == {"mamba2"}
    assert model.count_params(params) == ref_model.count_params(ref_params)
    shared = ref_params["backbone"]["shared_block"]
    close(params["backbone"]["shared_block"], shared, "shared_block", rtol=0, atol=0)
    tokens = np.random.default_rng(2).integers(0, model.cfg.vocab_size, (2, 16)).astype(np.int32)
    want, _ = ref_model.forward(ref_params, {"tokens": jnp.asarray(tokens)})
    got, _ = model.forward(params, {"tokens": tokens})

    ref_bumped = dict(ref_params, backbone=dict(
        ref_params["backbone"], shared_block=jax.tree.map(lambda a: a + 1.0, shared)))
    bumped = dict(params, backbone=dict(
        params["backbone"], shared_block=jax.tree.map(lambda t: t + 1.0,
                                                      params["backbone"]["shared_block"])))
    want2, _ = ref_model.forward(ref_bumped, {"tokens": jnp.asarray(tokens)})
    got2, _ = model.forward(bumped, {"tokens": tokens})
    np.testing.assert_array_equal(np.asarray(want2), np.asarray(want))
    np.testing.assert_array_equal(got2.numpy(), got.numpy())
    n_shared = sum(int(np.asarray(a).size) for a in jax.tree.leaves(shared))
    assert n_shared > 0 and "shared_block" in model.init(
        torch.Generator("cpu").manual_seed(0))["backbone"]


def test_from_reference_lm_params_unstacks_the_xlstm_segment():
    """xlstm's one (mlstm, slstm) x 2 segment becomes 4 layer dicts in
    layer order, with the 3-D maps, the recurrent weights and the conv
    taps taken at each layer's index."""
    ref_model, ref_params, model, params = both(XLSTM)
    (segment,) = ref_params["backbone"]["segments"]
    kinds = model.cfg.block_kinds()
    assert kinds == ["mlstm", "slstm"] * 2 and len(params["backbone"]["layers"]) == 4
    for layer, kind in enumerate(kinds):
        pos, rep = layer % 2, layer // 2
        want = jax.tree.map(lambda a: np.asarray(a)[rep], segment[pos])
        close(params["backbone"]["layers"][layer], want, f"layer {layer} ({kind})",
              rtol=0, atol=0)
    assert params["backbone"]["layers"][0]["mixer"]["wq"].ndim == 3
    assert params["backbone"]["layers"][1]["mixer"]["r_rec"].ndim == 3
    assert "shared_block" not in params["backbone"]


def test_backbone_init_builds_each_kind_of_the_config():
    for arch in (ZAMBA, XLSTM):
        cfg = get_config(arch).reduced()
        params = transformer.backbone_init(torch.Generator("cpu").manual_seed(0), cfg)
        assert len(params["layers"]) == cfg.num_layers
        for kind, layer in zip(cfg.block_kinds(), params["layers"]):
            want = ref_tf._block_init(jax.random.PRNGKey(0), kind,
                                      ref_get_config(arch).reduced())
            shapes = jax.tree.map(lambda a: tuple(a.shape), want)
            assert jax.tree.map(lambda t: tuple(t.shape), layer) == shapes, (arch, kind)
        assert ("shared_block" in params) == bool(cfg.shared_attn_period)
