"""The port's multi-head latent attention (`repro_torch.models.layers.
mla_attention`), cross-attention (`gqa_attention(..., kv_override=...)`)
and the `attn_cross` / MLA blocks and caches (`repro_torch.models.
transformer`) against the JAX package, on the CPU.

Both packages take the same numpy inputs and weights: inputs made from
seeds with numpy, weights from the reference's initializers at
`jax.random.PRNGKey(0)`, carried across as numpy arrays. Configs are the
reduced deepseek-v3-671b (MLA: 4 heads, latent rank 32, RoPE dim 16) and
llama-3.2-vision-90b (GQA, 8 image tokens), in float32.

Tolerances, and why:
  * float32 outputs and caches: rtol 1e-4 / atol 1e-5 (the LM forward's
    tolerance in `test_torch_lm.py`): each library's exp / rsqrt / cos in
    the softmax, norms and RoPE differs in the last bit.
  * the cache rows a call did not write, and the image keys and values a
    decode step carries over: byte-equal (copies).
  * under a quantized method: max |diff| <= the LM forward's QUANT_TOL x
    max |reference| (a last-bit difference moves a value across a rounding
    boundary of the per-call absmax quantizer now and then).
  * `xgate` is set to 0.5 in both packages' params: the reference's zero
    init would multiply the cross path by tanh(0) = 0 and hide it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as ref_layers
from repro.models import transformer as ref_tf
from repro_torch.configs import get_config
from repro_torch.models import layers, transformer

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
QUANT_TOL = {"mitchell": 5e-2, "karatsuba_int16": 5e-3}
METHODS = ("exact", "mitchell", "karatsuba_int16")
MLA_ARCH, VLM_ARCH = "deepseek-v3-671b", "llama-3.2-vision-90b"
XGATE = 0.5


def cfgs(arch: str, **changes):
    return (dataclasses.replace(ref_get_config(arch).reduced(), **changes),
            dataclasses.replace(get_config(arch).reduced(), **changes))


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(np.asarray(tree)))


def close(got, want, method: str = "exact", what: str = "") -> None:
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            close(got[k], want[k], method, f"{what}/{k}")
        return
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, (what, got.shape, want.shape)
    if method == "exact":
        np.testing.assert_allclose(got.numpy(), want, err_msg=what, **TOL)
    else:
        assert np.abs(got.numpy() - want).max() <= QUANT_TOL[method] * np.abs(want).max(), what


def acts(cfg, b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


def positions(b: int, start: int, s: int) -> np.ndarray:
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32)[None], (b, s)).copy()


# ------------------------------------------------------------------- MLA

@pytest.mark.parametrize("method", METHODS)
def test_mla_attention_matches_the_reference_without_a_cache(method):
    ref_cfg, cfg = cfgs(MLA_ARCH, matmul_method=method)
    ref_p = ref_layers.mla_init(jax.random.PRNGKey(0), ref_cfg)
    p = to_torch(jax.tree.map(np.asarray, ref_p))
    x, pos = acts(cfg, 2, 12, 1), positions(2, 0, 12)
    want, want_cache = ref_layers.mla_attention(ref_p, jnp.asarray(x), ref_cfg,
                                                positions=jnp.asarray(pos))
    got, cache = layers.mla_attention(p, torch.from_numpy(x), cfg,
                                      positions=torch.from_numpy(pos))
    assert cache is None and want_cache is None
    close(got, want, method)


def test_mla_attention_prefill_then_decode_on_the_latent_cache():
    """Prefill 10 tokens into a 16-slot latent cache, then two one-token
    decode steps: every output and the cache's c_kv / k_rope after each
    call match the reference's; the rows not yet written stay zero."""
    ref_cfg, cfg = cfgs(MLA_ARCH)
    ref_p = ref_layers.mla_init(jax.random.PRNGKey(0), ref_cfg)
    p = to_torch(jax.tree.map(np.asarray, ref_p))
    b, s_max, s0 = 2, 16, 10
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
    ref_cache = {"c_kv": jnp.zeros((b, s_max, r)), "k_rope": jnp.zeros((b, s_max, 1, dr))}
    cache = {"c_kv": torch.zeros(b, s_max, r), "k_rope": torch.zeros(b, s_max, 1, dr)}
    clen = 0
    for step, s in enumerate((s0, 1, 1)):
        x, pos = acts(cfg, b, s, 10 + step), positions(b, clen, s)
        lens = np.full((b,), clen, np.int32)
        want, ref_cache = ref_layers.mla_attention(
            ref_p, jnp.asarray(x), ref_cfg, positions=jnp.asarray(pos), kv_cache=ref_cache,
            cache_len=jnp.asarray(lens))
        got, cache = layers.mla_attention(
            p, torch.from_numpy(x), cfg, positions=torch.from_numpy(pos), kv_cache=cache,
            cache_len=torch.from_numpy(lens))
        close(got, want, what=f"out {step}")
        close(cache, ref_cache, what=f"cache {step}")
        clen += s
        assert not cache["c_kv"][:, clen:].any() and not cache["k_rope"][:, clen:].any()


# ----------------------------------------------------------- cross-attn

@pytest.mark.parametrize("method", METHODS)
def test_gqa_attention_with_kv_override_matches_the_reference(method):
    """Cross-attention to given image keys and values (B, T, Hkv, Dh): no
    RoPE on q, no mask, no cache."""
    ref_cfg, cfg = cfgs(VLM_ARCH, matmul_method=method)
    ref_p = ref_layers.gqa_init(jax.random.PRNGKey(0), ref_cfg)
    p = to_torch(jax.tree.map(np.asarray, ref_p))
    rng = np.random.default_rng(4)
    b, s, t = 2, 6, cfg.image_tokens
    x = acts(cfg, b, s, 2)
    k, v = (rng.standard_normal((b, t, cfg.num_kv_heads, cfg.resolved_head_dim))
            .astype(np.float32) for _ in range(2))
    pos = positions(b, 3, s)
    want, want_cache = ref_layers.gqa_attention(
        ref_p, jnp.asarray(x), ref_cfg, positions=jnp.asarray(pos),
        kv_override=(jnp.asarray(k), jnp.asarray(v)))
    got, cache = layers.gqa_attention(
        p, torch.from_numpy(x), cfg, positions=torch.from_numpy(pos),
        kv_override=(torch.from_numpy(k), torch.from_numpy(v)))
    assert cache is None and want_cache is None
    close(got, want, method)


# ---------------------------------------------------------------- blocks

def cross_block(method: str = "exact"):
    ref_cfg, cfg = cfgs(VLM_ARCH, matmul_method=method)
    ref_p = ref_tf._block_init(jax.random.PRNGKey(0), "attn_cross", ref_cfg)
    ref_p = {**ref_p, "xgate": jnp.asarray(XGATE, jnp.float32)}
    return ref_cfg, cfg, ref_p, to_torch(jax.tree.map(np.asarray, ref_p))


def apply_both(kind, ref_cfg, cfg, ref_p, p, x, pos, *, ref_cache=None, cache=None,
               clen=None, img=None, decode=False):
    lens = None if clen is None else np.full((x.shape[0],), clen, np.int32)
    want = ref_tf._apply_block(
        kind, ref_p, jnp.asarray(x), ref_cfg, positions=jnp.asarray(pos), cache=ref_cache,
        cache_len=None if lens is None else jnp.asarray(lens), shared_params=None,
        image_embeds=None if img is None else jnp.asarray(img), decode=decode)
    got = transformer._apply_block(
        kind, p, torch.from_numpy(x), cfg, positions=torch.from_numpy(pos), cache=cache,
        cache_len=None if lens is None else torch.from_numpy(lens), shared_params=None,
        image_embeds=None if img is None else torch.from_numpy(img), decode=decode,
        impl="auto")
    return got, want


@pytest.mark.parametrize("method", METHODS)
def test_attn_cross_block_matches_the_reference(method):
    """The whole `attn_cross` block (self-attention, the image keys and
    values projected by xattn.wk / wv, cross-attention scaled by
    tanh(xgate), the MLP), without a cache."""
    ref_cfg, cfg, ref_p, p = cross_block(method)
    x, pos = acts(cfg, 2, 6, 5), positions(2, 0, 6)
    img = acts(cfg, 2, cfg.image_tokens, 6)
    (got, cache, aux), (want, _, _) = apply_both("attn_cross", ref_cfg, cfg, ref_p, p,
                                                 x, pos, img=img)
    assert cache is None and aux is None
    close(got, want, method)
    # the cross path is live: a closed gate changes the output
    shut, _ = apply_both("attn_cross", ref_cfg, cfg, ref_p, {**p, "xgate": torch.tensor(0.0)},
                         x, pos, img=img)
    assert np.abs(shut[0].numpy() - got.numpy()).max() > 1e-3


def test_attn_cross_block_prefill_then_decode_reads_the_image_cache():
    """Prefill projects the image into k_img / v_img of the cache; a decode
    step takes them from the cache (its image_embeds are ignored) and
    hands them on unchanged."""
    ref_cfg, cfg, ref_p, p = cross_block()
    b, s_max, s0 = 2, 12, 7
    ref_cache = ref_tf._init_cache_for_kind("attn_cross", ref_cfg, b, s_max, jnp.float32)
    cache = transformer._init_cache_for_kind("attn_cross", cfg, b, s_max, torch.float32,
                                             torch.device("cpu"))
    img = acts(cfg, b, cfg.image_tokens, 8)
    x, pos = acts(cfg, b, s0, 9), positions(b, 0, s0)
    (got, cache, _), (want, ref_cache, _) = apply_both(
        "attn_cross", ref_cfg, cfg, ref_p, p, x, pos, ref_cache=ref_cache, cache=cache,
        clen=0, img=img)
    close(got, want, what="prefill")
    close(cache, ref_cache, what="prefill cache")
    for step in range(2):
        x, pos = acts(cfg, b, 1, 20 + step), positions(b, s0 + step, 1)
        k_img = cache["k_img"]
        (got, cache, _), (want, ref_cache, _) = apply_both(
            "attn_cross", ref_cfg, cfg, ref_p, p, x, pos, ref_cache=ref_cache, cache=cache,
            clen=s0 + step, decode=True)
        close(got, want, what=f"decode {step}")
        close(cache, ref_cache, what=f"decode cache {step}")
        assert cache["k_img"] is k_img


@pytest.mark.parametrize("kind", ("attn", "moe"))
def test_mla_block_matches_the_reference_over_its_cache(kind):
    """deepseek-v3's `attn` and `moe` blocks (MLA attention; the MLP or the
    MoE layer), prefill then one decode step on the latent cache; the MoE
    block's aux loss too (capacity_factor 100: no drops)."""
    ref_cfg, cfg = cfgs(MLA_ARCH, capacity_factor=100.0)
    ref_p = ref_tf._block_init(jax.random.PRNGKey(0), kind, ref_cfg)
    p = to_torch(jax.tree.map(np.asarray, ref_p))
    b, s_max = 2, 12
    ref_cache = ref_tf._init_cache_for_kind(kind, ref_cfg, b, s_max, jnp.float32)
    cache = transformer._init_cache_for_kind(kind, cfg, b, s_max, torch.float32,
                                             torch.device("cpu"))
    close(cache, ref_cache, what="init")
    for step, (start, s) in enumerate(((0, 9), (9, 1))):
        x, pos = acts(cfg, b, s, 30 + step), positions(b, start, s)
        (got, cache, aux), (want, ref_cache, want_aux) = apply_both(
            kind, ref_cfg, cfg, ref_p, p, x, pos, ref_cache=ref_cache, cache=cache,
            clen=start, decode=step > 0)
        close(got, want, what=f"{kind} {step}")
        close(cache, ref_cache, what=f"{kind} cache {step}")
        if kind == "moe":
            np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
        else:
            assert aux is None and float(want_aux) == 0.0


@pytest.mark.parametrize("arch", (MLA_ARCH, "kimi-k2-1t-a32b", VLM_ARCH))
def test_init_caches_match_the_reference(arch):
    """Per layer: the latent {c_kv, k_rope} (MLA), {k, v} (GQA) and the
    image {k_img, v_img} of `attn_cross`, with the reference's shapes and
    dtypes."""
    ref_cfg, cfg = cfgs(arch, dtype="bfloat16")
    ref_caches = ref_tf.init_caches(ref_cfg, 2, 8, jnp.bfloat16)
    caches = transformer.init_caches(cfg, 2, 8, torch.bfloat16, torch.device("cpu"))
    want = [jax.tree.map(lambda a, i=i: a[i], seg[pi])
            for (pattern, reps), seg in zip(ref_tf.segment_kinds(ref_cfg.block_kinds()),
                                            ref_caches)
            for i in range(reps) for pi in range(len(pattern))]
    assert len(caches) == len(want) == cfg.num_layers
    for got, ref in zip(caches, want):
        assert set(got) == set(ref)
        for name in ref:
            assert tuple(got[name].shape) == ref[name].shape, name
            assert got[name].dtype == torch.bfloat16 and ref[name].dtype == jnp.bfloat16
