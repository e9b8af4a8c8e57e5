"""The port's LM serving path (`repro_torch.configs`, `models`,
`runtime.serve_lib`, `launch.serve`) against the JAX package, on the CPU.

Both packages run from the same weights: the reference's
`Model.init(jax.random.PRNGKey(0))`, carried across by
`repro_torch.convert.from_reference_lm_params`. Inputs are made from seeds
with numpy.

Tolerances, and why:
  * `dense` is byte-equal to the reference's for every method, in float32
    and in bfloat16 (the quantized methods sum integers; the float matmul
    and the casts agree bit for bit on this CPU).
  * Forward logits, `exact`: rtol 1e-4 / atol 1e-5. The norms, RoPE,
    softmax and activations use each library's own exp / rsqrt / cos /
    tanh, which differ in the last bit (ulps of float32).
  * Forward logits, quantized: max |diff| <= 5e-2 x max |logit| for the
    8-bit LNS family (`mitchell`), 5e-3 x for the limb family
    (`karatsuba_int16`). Those ulp differences move an activation across a
    rounding boundary of the per-call absmax quantizer now and then, and
    one quantization step (1/255 of the absmax at 8 bits, 1/8127 for the
    limbs) then spreads through the later layers.
  * Greedy tokens: equal for `exact` and `karatsuba_int16`. Under
    `mitchell` the top-2 logit margins of this random-weight model
    (~0.01-0.06) are within that spread, so free-running tokens can part
    at a near-tie (ROADMAP Queue 3, R6); the test feeds the reference's
    tokens to the port and requires each to be within the LNS tolerance
    of the port's largest logit at its step.
  * Prefill then decode against the full forward: the reference's own
    test's rtol 1e-3 / atol 2e-4 (`exact`, as there; a quantized method
    quantizes each call with its own absmax, so a one-token decode and a
    whole-sequence forward quantize differently in both packages).
  * The MoE (deepseek-v3 with MLA, kimi-k2 with GQA) and VLM
    (llama-3.2-vision) families hold the same tolerances, and the MoE aux
    loss rtol 1e-6 (float32 means, summed in each library's order; under a
    quantized method the method's QUANT_TOL, relative: the router reads
    the quantized layers' activations, and its gates move with them). The
    VLM's params have `xgate` set to 0.5 in both packages (the reference's
    zero init would erase the cross-attention) and its batches carry
    seeded `image_embeds`; its greedy tokens are a prefill with the image
    and decode steps in both packages, since `greedy_generate` cannot give
    it an image in either (ROADMAP Queue 3, R8). Prefill then decode
    against the full forward runs MoE at capacity_factor 100, as the
    reference's own test does: token drops depend on the chunking.
  * The hybrid (zamba2) and xLSTM families hold the same tolerances. Their
    scans exponentiate cumulative sums (SSD: exp of cumsum(dt * A); mLSTM:
    exp of i - cumsum(log_sigmoid f) - cummax), which multiplies a last-bit
    difference by the size of the exponent, but at these sizes the float32
    logits stay within 1e-5 of the reference's (observed: 4.5e-6 / 6.6e-6
    of max |logit| 4.0 / 3.8), and the quantized ones within 1e-3 of max
    |logit| for the limbs (observed 5.6e-4 / 7.3e-4) and 5e-7 for
    mitchell. Greedy tokens: equal for exact and karatsuba_int16; under
    mitchell zamba2's free-running tokens part at a near-tie (18 of 32),
    so the reference's tokens are held by teacher forcing as for Qwen2.
    The serve step of these families decodes from the reference's prefill
    states, carried across layer by layer.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro.models.layers import dense as ref_dense
from repro.models.model import build_model as ref_build_model
from repro.runtime.serve_lib import greedy_generate as ref_greedy_generate
from repro.runtime.serve_lib import make_serve_step as ref_make_serve_step
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import from_reference_lm_params
from repro_torch.core.approx_matmul import METHODS
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model
from repro_torch.models.layers import dense
from repro_torch.runtime.serve_lib import greedy_generate, make_serve_step

torch.set_num_threads(1)

RUN_ARCHS = ("qwen2-0.5b", "qwen2.5-3b", "granite-3-2b", "nemotron-4-340b",
             "hubert-xlarge", "zamba2-1.2b", "xlstm-1.3b", "deepseek-v3-671b",
             "kimi-k2-1t-a32b", "llama-3.2-vision-90b")
#: the families with recurrent block kinds (mamba2; mlstm / slstm)
RECURRENT_ARCHS = ("zamba2-1.2b", "xlstm-1.3b")
MOE_ARCHS = ("deepseek-v3-671b", "kimi-k2-1t-a32b")
VLM_ARCH = "llama-3.2-vision-90b"
#: the cross-attention gate of the VLM's params in both packages
XGATE = 0.5
LM_METHODS = ("exact", "mitchell", "karatsuba_int16")
#: max |port - reference| / max |reference| of the forward logits
QUANT_TOL = {"mitchell": 5e-2, "karatsuba_int16": 5e-3}
GREEDY = dict(batch=4, prompt=16, steps=8)


def open_gates(params):
    """The reference's params with every `xgate` (the VLM's cross-attention
    gates, zero at init) set to XGATE."""
    def gate(path, leaf):
        return jnp.full_like(leaf, XGATE) if path[-1] == jax.tree_util.DictKey("xgate") else leaf
    return jax.tree_util.tree_map_with_path(gate, params)


@functools.lru_cache(maxsize=None)
def ref_init(arch: str):
    """The reference's params of the reduced `arch` at PRNGKey(0), the VLM's
    gates open (XGATE); immutable JAX arrays, drawn once a process (the
    matmul method does not enter the init)."""
    return open_gates(ref_build_model(ref_get_config(arch).reduced()).init(
        jax.random.PRNGKey(0)))


def both_models(arch: str, method: str = "exact"):
    """(reference model, its params, port model, port params) for the
    reduced config of `arch` with `matmul_method=method`; the VLM's gates
    open (XGATE)."""
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(), matmul_method=method)
    cfg = dataclasses.replace(get_config(arch).reduced(), matmul_method=method)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_init(arch)
    model = build_model(cfg, "cpu")
    params = from_reference_lm_params(jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    return ref_model, ref_params, model, params


def lm_batch(cfg, b: int, s: int, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "frames":
        return {"frames": rng.standard_normal((b, s, cfg.frame_dim)).astype(np.float32)}
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.input_kind == "tokens+image":
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def jax_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def prompt_of(cfg) -> np.ndarray:
    return np.random.default_rng(0).integers(
        0, cfg.vocab_size, (GREEDY["batch"], GREEDY["prompt"])).astype(np.int32)


def port_caches(ref_caches, cfg) -> list:
    """The reference's caches (one tuple per `segment_kinds` segment, each
    pattern position's leaves stacked over its repeats) as the port's list
    of per-layer caches."""
    from repro_torch.models.transformer import segment_kinds

    def take(tree, i):
        if isinstance(tree, dict):
            return {k: take(v, i) for k, v in tree.items()}
        return torch.from_numpy(np.array(np.asarray(tree)[i]))

    return [take(seg[pi], i)
            for (pattern, reps), seg in zip(segment_kinds(cfg.block_kinds()), ref_caches)
            for i in range(reps) for pi in range(len(pattern))]


# ---------------------------------------------------------------- configs

def test_configs_equal_the_reference():
    assert list_archs() == ref_list_archs()
    for arch in list_archs():
        cfg, ref = get_config(arch), ref_get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref), arch
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(ref.reduced()), arch
        assert cfg.block_kinds() == ref.block_kinds()
        assert cfg.resolved_head_dim == ref.resolved_head_dim


# ------------------------------------------------------------------ dense

@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("method", METHODS)
def test_dense_is_byte_equal_to_the_reference(method, dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 128)).astype(np.float32)
    w = (rng.standard_normal((128, 96)) / 11).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32)
    want = ref_dense({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                     jnp.asarray(x).astype(dtype), method=method)
    got = dense({"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
                torch.from_numpy(x).to(getattr(torch, dtype)), method=method)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------- forward

@pytest.mark.parametrize("method", LM_METHODS)
@pytest.mark.parametrize("arch", RUN_ARCHS)
def test_forward_matches_the_reference(arch, method):
    ref_model, ref_params, model, params = both_models(arch, method)
    assert model.count_params(params) == ref_model.count_params(ref_params)
    batch = lm_batch(model.cfg, 2, 16)
    want, want_aux = ref_model.forward(ref_params, jax_batch(batch))
    got, aux = model.forward(params, batch)
    want = np.asarray(want)
    assert got.shape == want.shape and aux.dtype == torch.float32
    assert (float(aux) == 0.0) == (not model.cfg.moe)
    if method == "exact":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    else:
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= QUANT_TOL[method], (arch, method, err)
        aux_err = abs(float(aux) - float(want_aux)) / max(abs(float(want_aux)), 1e-30)
        assert float(aux) == float(want_aux) == 0.0 or aux_err <= QUANT_TOL[method], aux_err


@pytest.mark.parametrize("arch", [a for a in RUN_ARCHS if get_config(a).causal])
def test_prefill_then_decode_matches_full_forward(arch):
    """The reference's own check (tests/test_models_smoke.py), on the port:
    MoE at capacity_factor 100 (drops depend on the chunking), the VLM
    with its image and open gates."""
    cfg = get_config(arch).reduced()
    if cfg.moe:
        cfg = dataclasses.replace(cfg, capacity_factor=100.0)
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0))
    for layer in params["backbone"]["layers"]:
        if "xgate" in layer:
            layer["xgate"] = torch.tensor(XGATE)
    b, s = 2, 16
    batch = lm_batch(model.cfg, b, s)
    full, _ = model.forward(params, batch)
    caches = model.init_cache(b, 32)
    lg_pre, caches, clen = model.prefill(params, {**batch, "tokens": batch["tokens"][:, :s - 1]},
                                         caches)
    np.testing.assert_allclose(lg_pre[:, 0].numpy(), full[:, s - 2].numpy(),
                               rtol=1e-3, atol=2e-4)
    lg_dec, caches, clen = model.decode_step(params, batch["tokens"][:, s - 1:s],
                                             caches, clen,
                                             image_embeds=batch.get("image_embeds"))
    np.testing.assert_allclose(lg_dec[:, 0].numpy(), full[:, s - 1].numpy(),
                               rtol=1e-3, atol=2e-4)
    assert clen.tolist() == [s] * b


# ----------------------------------------------------------------- decode

def image_of(cfg) -> np.ndarray | None:
    """The seeded image of the greedy runs (None unless the VLM)."""
    if cfg.input_kind != "tokens+image":
        return None
    return np.random.default_rng(2).standard_normal(
        (GREEDY["batch"], cfg.image_tokens, cfg.d_model)).astype(np.float32)


def ref_greedy(ref_model, ref_params, prompt, image, s_max: int) -> np.ndarray:
    """The reference's greedy tokens: its `greedy_generate`, or for the VLM
    the same loop with the image in the prefill batch (which
    `greedy_generate` cannot give it, R8)."""
    if image is None:
        return np.array(ref_greedy_generate(ref_model, ref_params, jnp.asarray(prompt),
                                            steps=GREEDY["steps"], s_max=s_max))
    caches = ref_model.init_cache(prompt.shape[0], s_max)
    logits, caches, clen = ref_model.prefill(
        ref_params, {"tokens": jnp.asarray(prompt), "image_embeds": jnp.asarray(image)}, caches)
    outs = []
    for _ in range(GREEDY["steps"]):
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        outs.append(np.asarray(tok))
        logits, caches, clen = ref_model.decode_step(ref_params, tok, caches, clen)
    return np.concatenate(outs, axis=1)


def port_greedy(model, params, prompt, image, s_max: int) -> torch.Tensor:
    """The port's greedy tokens, as `ref_greedy` takes them."""
    if image is None:
        return greedy_generate(model, params, prompt, steps=GREEDY["steps"], s_max=s_max)
    caches = model.init_cache(prompt.shape[0], s_max)
    logits, caches, clen = model.prefill(params, {"tokens": prompt, "image_embeds": image},
                                         caches)
    outs = []
    for _ in range(GREEDY["steps"]):
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        outs.append(tok)
        logits, caches, clen = model.decode_step(params, tok, caches, clen,
                                                 image_embeds=image)
    return torch.cat(outs, dim=1)


def check_greedy_tokens(arch: str, method: str) -> None:
    ref_model, ref_params, model, params = both_models(arch, method)
    prompt, image = prompt_of(model.cfg), image_of(model.cfg)
    s_max = GREEDY["prompt"] + GREEDY["steps"]
    want = ref_greedy(ref_model, ref_params, prompt, image, s_max)
    got = port_greedy(model, params, prompt, image, s_max)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("method", ("exact", "karatsuba_int16"))
def test_greedy_tokens_equal_the_reference(method):
    check_greedy_tokens("qwen2-0.5b", method)


@pytest.mark.parametrize("method", ("exact", "karatsuba_int16"))
@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_family_greedy_tokens_equal_the_reference(arch, method):
    check_greedy_tokens(arch, method)


@pytest.mark.parametrize("method", ("exact", "karatsuba_int16"))
@pytest.mark.parametrize("arch", MOE_ARCHS + (VLM_ARCH,))
def test_moe_and_vlm_greedy_tokens_equal_the_reference(arch, method):
    check_greedy_tokens(arch, method)


def check_mitchell_teacher_forced(arch: str) -> None:
    """The reference's mitchell greedy tokens, fed to the port step by step:
    at every step the reference's token scores within the LNS tolerance of
    the port's largest logit, and most steps agree exactly."""
    ref_model, ref_params, model, params = both_models(arch, "mitchell")
    prompt, image = prompt_of(model.cfg), image_of(model.cfg)
    s_max = GREEDY["prompt"] + GREEDY["steps"]
    want = ref_greedy(ref_model, ref_params, prompt, image, s_max)
    caches = model.init_cache(prompt.shape[0], s_max)
    batch = {"tokens": prompt} if image is None else {"tokens": prompt, "image_embeds": image}
    logits, caches, clen = model.prefill(params, batch, caches)
    agree = 0
    for step in range(GREEDY["steps"]):
        lg = logits[:, -1]
        top = lg.max(dim=-1).values
        picked = lg.gather(1, torch.from_numpy(want[:, step:step + 1]).long())[:, 0]
        tol = QUANT_TOL["mitchell"] * float(lg.abs().max())
        assert bool(((top - picked) <= tol).all()), (step, (top - picked).tolist())
        agree += int((lg.argmax(-1).numpy() == want[:, step]).sum())
        logits, caches, clen = model.decode_step(params, want[:, step:step + 1],
                                                 caches, clen)
    assert agree >= 0.75 * want.size, f"{agree} of {want.size} steps agree"


def test_mitchell_greedy_tokens_are_the_ports_argmax_within_tolerance():
    check_mitchell_teacher_forced("qwen2-0.5b")


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_family_mitchell_greedy_tokens_within_tolerance(arch):
    check_mitchell_teacher_forced(arch)


@pytest.mark.parametrize("arch", MOE_ARCHS + (VLM_ARCH,))
def test_moe_and_vlm_mitchell_greedy_tokens_within_tolerance(arch):
    check_mitchell_teacher_forced(arch)


def test_serve_step_matches_the_reference():
    ref_model, ref_params, model, params = both_models("qwen2-0.5b")
    seq_len, b = 12, 2
    tokens = np.random.default_rng(5).integers(0, model.cfg.vocab_size, (b, 1)).astype(np.int32)
    ref_caches = ref_model.init_cache(b, seq_len)
    ref_caches = jax.tree.map(lambda c: jnp.asarray(np.random.default_rng(6).standard_normal(
        c.shape).astype(np.float32)), ref_caches)
    caches = [{"k": torch.from_numpy(np.asarray(seg[0]["k"][i])),
               "v": torch.from_numpy(np.asarray(seg[0]["v"][i]))}
              for seg in ref_caches for i in range(seg[0]["k"].shape[0])]
    want, _ = ref_make_serve_step(ref_model, seq_len=seq_len)(
        ref_params, jnp.asarray(tokens), ref_caches)
    got, new_caches = make_serve_step(model, seq_len=seq_len)(params, tokens, caches)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    assert len(new_caches) == model.cfg.num_layers


def check_serve_step_from_reference_prefill(arch: str) -> None:
    """One decode step from the caches the reference's prefill left (the
    VLM's with its image): logits and every new cache leaf against the
    reference's."""
    ref_model, ref_params, model, params = both_models(arch)
    seq_len, b = 12, 2
    rng = np.random.default_rng(5)
    batch = lm_batch(model.cfg, b, seq_len - 1, seed=5)
    tokens = rng.integers(0, model.cfg.vocab_size, (b, 1)).astype(np.int32)
    _, ref_caches, _ = ref_model.prefill(ref_params, jax_batch(batch),
                                         ref_model.init_cache(b, seq_len))
    caches = port_caches(ref_caches, model.cfg)
    want, want_caches = ref_make_serve_step(ref_model, seq_len=seq_len)(
        ref_params, jnp.asarray(tokens), ref_caches)
    got, new_caches = make_serve_step(model, seq_len=seq_len)(params, tokens, caches)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    want_caches = port_caches(want_caches, model.cfg)
    assert len(new_caches) == len(want_caches) == model.cfg.num_layers
    for layer, (g, w) in enumerate(zip(new_caches, want_caches)):
        assert g.keys() == w.keys(), layer
        for name in g:
            assert g[name].dtype == w[name].dtype, (layer, name)
            np.testing.assert_allclose(g[name].numpy(), w[name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=f"{layer} {name}")


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_family_serve_step_matches_the_reference(arch):
    check_serve_step_from_reference_prefill(arch)


@pytest.mark.parametrize("arch", MOE_ARCHS + (VLM_ARCH,))
def test_moe_and_vlm_serve_step_matches_the_reference(arch):
    check_serve_step_from_reference_prefill(arch)


# ------------------------------------------------------------ converter

@pytest.mark.parametrize("arch", MOE_ARCHS + (VLM_ARCH,))
def test_from_reference_lm_params_carries_every_leaf(arch):
    """Every leaf of the reference's stacked pytree lands in its layer's
    dict with the reference's values: the router, the (E, D, F) expert
    stacks, the shared MLP, the MLA projections and norms, `img_proj` and
    each layer's 0-d `xgate`; the parameter counts agree."""
    from repro_torch.models.transformer import segment_kinds
    ref_model, ref_params, model, params = both_models(arch)
    assert model.count_params(params) == ref_model.count_params(ref_params)
    ref_np = jax.tree.map(np.asarray, ref_params)
    want_layers = [jax.tree.map(lambda a, i=i: a[i], seg[pi])
                   for (pattern, reps), seg in zip(segment_kinds(model.cfg.block_kinds()),
                                                   ref_np["backbone"]["segments"])
                   for i in range(reps) for pi in range(len(pattern))]
    want = {**{k: v for k, v in ref_np.items() if k != "backbone"},
            "backbone": {"layers": want_layers, "final_ln": ref_np["backbone"]["final_ln"]}}
    got_leaves = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), params))[0]
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
    names = {jax.tree_util.keystr(p) for p, _ in got_leaves}
    if model.cfg.moe:
        assert any("['router']" in n for n in names) and any("['shared']" in n for n in names)
    if model.cfg.attention == "mla":
        assert any("['wkv_b']" in n for n in names)
    if model.cfg.input_kind == "tokens+image":
        gates = [layer["xgate"] for layer in params["backbone"]["layers"] if "xgate" in layer]
        assert gates and all(g.dim() == 0 and float(g) == XGATE for g in gates)
        assert "['img_proj']['w']" in names


@pytest.mark.parametrize("arch,leaf,cut", [
    ("deepseek-v3-671b", ("moe", "wi"), lambda a: a[:, :-1]),           # an expert short
    ("kimi-k2-1t-a32b", ("moe", "router", "w"), lambda a: a[..., :-1]),
    ("llama-3.2-vision-90b", ("xgate",), lambda a: a[:, None]),         # (1,) a layer
    ("llama-3.2-vision-90b", ("xattn", "wk", "w"), lambda a: a[:-1]),   # a layer short
])
def test_from_reference_lm_params_refuses_a_wrong_shape(arch, leaf, cut):
    from repro_torch.models.transformer import segment_kinds
    cfg = get_config(arch).reduced()
    ref_params = jax.tree.map(np.asarray, ref_build_model(
        ref_get_config(arch).reduced()).init(jax.random.PRNGKey(0)))
    seg, pos = next((si, pi) for si, (pattern, _) in enumerate(segment_kinds(cfg.block_kinds()))
                    for pi, kind in enumerate(pattern) if kind in ("moe", "attn_cross"))
    node = ref_params["backbone"]["segments"][seg][pos]
    for key in leaf[:-1]:
        node = node[key]
    node[leaf[-1]] = cut(node[leaf[-1]])
    with pytest.raises(ValueError, match="the config gives"):
        from_reference_lm_params(ref_params, cfg, "cpu")


# ------------------------------------------------------------- refusals

def test_vlm_greedy_generate_raises_key_error_in_both_packages():
    """R8: `greedy_generate` prefills with the tokens alone, so neither
    package's can serve the VLM (`image_embeds` missing), nor the CLI."""
    ref_model, ref_params, model, params = both_models(VLM_ARCH)
    prompt = prompt_of(model.cfg)
    with pytest.raises(KeyError, match="image_embeds"):
        ref_greedy_generate(ref_model, ref_params, jnp.asarray(prompt), steps=2, s_max=20)
    with pytest.raises(KeyError, match="image_embeds"):
        greedy_generate(model, params, prompt, steps=2, s_max=20)
    with pytest.raises(KeyError, match="image_embeds"):
        serve_cli.main(["--arch", VLM_ARCH, "--device", "cpu", "--gen-len", "2"])


def test_encoder_only_model_has_no_decode_step():
    model = build_model(get_config("hubert-xlarge").reduced(), "cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0))
    with pytest.raises(ValueError, match="encoder-only"):
        model.decode_step(params, np.zeros((1, 1), np.int32), [], torch.zeros(1))
    with pytest.raises(SystemExit, match="encoder-only"):
        serve_cli.main(["--arch", "hubert-xlarge", "--device", "cpu"])


def test_model_needs_a_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_config("qwen2-0.5b").reduced())


# ------------------------------------------------------------------- CLI

def test_serve_cli_runs_on_the_cpu_at_its_defaults(capsys):
    out = serve_cli.main(["--device", "cpu"])
    assert tuple(out.shape) == (4, 32) and out.dtype == torch.int32
    assert int(out.min()) >= 0 and int(out.max()) < get_config("qwen2-0.5b").reduced().vocab_size
    printed = capsys.readouterr().out
    assert "generated (4, 32) tokens" in printed and "sample token ids" in printed


def check_serve_cli(arch: str, capsys) -> None:
    out = serve_cli.main(["--arch", arch, "--device", "cpu", "--gen-len", "8"])
    assert tuple(out.shape) == (4, 8) and out.dtype == torch.int32
    assert int(out.min()) >= 0 and int(out.max()) < get_config(arch).reduced().vocab_size
    assert "generated (4, 8) tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_serve_cli_runs_the_recurrent_families_on_the_cpu(arch, capsys):
    check_serve_cli(arch, capsys)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_cli_runs_the_moe_family_on_the_cpu(arch, capsys):
    check_serve_cli(arch, capsys)
