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
"""
import dataclasses

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
             "hubert-xlarge")
UNPORTED_ARCHS = ("zamba2-1.2b", "deepseek-v3-671b", "kimi-k2-1t-a32b",
                  "llama-3.2-vision-90b", "xlstm-1.3b")
LM_METHODS = ("exact", "mitchell", "karatsuba_int16")
#: max |port - reference| / max |reference| of the forward logits
QUANT_TOL = {"mitchell": 5e-2, "karatsuba_int16": 5e-3}
GREEDY = dict(batch=4, prompt=16, steps=8)


def both_models(arch: str, method: str = "exact"):
    """(reference model, its params, port model, port params) for the
    reduced config of `arch` with `matmul_method=method`."""
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(), matmul_method=method)
    cfg = dataclasses.replace(get_config(arch).reduced(), matmul_method=method)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(cfg, "cpu")
    params = from_reference_lm_params(jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    return ref_model, ref_params, model, params


def lm_batch(cfg, b: int, s: int, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    if cfg.input_kind == "frames":
        return {"frames": rng.standard_normal((b, s, cfg.frame_dim)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def prompt_of(cfg) -> np.ndarray:
    return np.random.default_rng(0).integers(
        0, cfg.vocab_size, (GREEDY["batch"], GREEDY["prompt"])).astype(np.int32)


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
    want, _ = ref_model.forward(ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    got, aux = model.forward(params, batch)
    want = np.asarray(want)
    assert got.shape == want.shape and float(aux) == 0.0
    if method == "exact":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    else:
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= QUANT_TOL[method], (arch, method, err)


@pytest.mark.parametrize("arch", [a for a in RUN_ARCHS if get_config(a).causal])
def test_prefill_then_decode_matches_full_forward(arch):
    """The reference's own check (tests/test_models_smoke.py), on the port."""
    model = build_model(get_config(arch).reduced(), "cpu")
    params = model.init(torch.Generator("cpu").manual_seed(0))
    b, s = 2, 16
    batch = lm_batch(model.cfg, b, s)
    full, _ = model.forward(params, batch)
    caches = model.init_cache(b, 32)
    lg_pre, caches, clen = model.prefill(params, {"tokens": batch["tokens"][:, :s - 1]},
                                         caches)
    np.testing.assert_allclose(lg_pre[:, 0].numpy(), full[:, s - 2].numpy(),
                               rtol=1e-3, atol=2e-4)
    lg_dec, caches, clen = model.decode_step(params, batch["tokens"][:, s - 1:s],
                                             caches, clen)
    np.testing.assert_allclose(lg_dec[:, 0].numpy(), full[:, s - 1].numpy(),
                               rtol=1e-3, atol=2e-4)
    assert clen.tolist() == [s] * b


# ----------------------------------------------------------------- decode

@pytest.mark.parametrize("method", ("exact", "karatsuba_int16"))
def test_greedy_tokens_equal_the_reference(method):
    ref_model, ref_params, model, params = both_models("qwen2-0.5b", method)
    prompt = prompt_of(model.cfg)
    s_max = GREEDY["prompt"] + GREEDY["steps"]
    want = ref_greedy_generate(ref_model, ref_params, jnp.asarray(prompt),
                               steps=GREEDY["steps"], s_max=s_max)
    got = greedy_generate(model, params, prompt, steps=GREEDY["steps"], s_max=s_max)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mitchell_greedy_tokens_are_the_ports_argmax_within_tolerance():
    """The reference's mitchell greedy tokens, fed to the port step by step:
    at every step the reference's token scores within the LNS tolerance of
    the port's largest logit, and most steps agree exactly."""
    ref_model, ref_params, model, params = both_models("qwen2-0.5b", "mitchell")
    prompt = prompt_of(model.cfg)
    s_max = GREEDY["prompt"] + GREEDY["steps"]
    want = np.array(ref_greedy_generate(ref_model, ref_params, jnp.asarray(prompt),
                                        steps=GREEDY["steps"], s_max=s_max))
    caches = model.init_cache(prompt.shape[0], s_max)
    logits, caches, clen = model.prefill(params, {"tokens": prompt}, caches)
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


# ------------------------------------------------------------- refusals

@pytest.mark.parametrize("arch", UNPORTED_ARCHS)
def test_unported_block_kinds_raise_at_build_model(arch):
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        build_model(get_config(arch).reduced(), "cpu")


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
