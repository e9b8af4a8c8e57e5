"""Core transformer layers: norms, RoPE, GQA / MLA / cross attention, MLPs.

Counterpart of `repro.models.layers`, on plain PyTorch tensors. Params are
plain dicts of tensors; initializers draw float32 tensors from a
`torch.Generator` on the generator's device (cast to the compute dtype at
use, as the reference's master weights are). Every linear goes through
`dense()`, which routes a quantized `method` to
`repro_torch.core.approx_matmul.matmul` with `impl` ('auto' by default):
on the card that is the Hopper kernels (`mitchell_matmul` for the LNS
family, `karatsuba_matmul_i8` or the wide kernel for the limb family), on
the CPU the reference's semantics.

Attention and norms are the reference's own arithmetic (einsums, its mask
value, softmax in `scores_dtype`); the reference computes them outside any
Pallas kernel, so no hand-written kernel stands behind them here either.
Multi-head latent attention (`mla_attention`, the MoE family's) runs the
reference's absorbed form: its up-projections `w_uk` / `w_uv` are einsum
weights, not `dense` calls. Cross-attention (`gqa_attention(...,
kv_override=...)`, the VLM's) attends to precomputed image keys and
values, without RoPE, mask or cache.

Tensor parallelism. Inside a meshed step with a "model" axis
(`core.collectives.model_axis`) a layer computes on its "model" shard
where the split is in whole units, and the step's per-layer gather
(`models.transformer`, `*_keep`) hands it those weight blocks:
  * GQA and cross-attention (`attn_splits`): where `num_heads` divides by
    the axis, wq / wk / wv are column-parallel and wo row-parallel, each
    rank on its `num_heads / model` query heads. Where `num_kv_heads` does
    not divide, wk and wv are gathered whole, every rank projects every kv
    head, and each takes the kv heads its query heads read. Where
    `num_heads` does not divide (qwen2-0.5b's 14 at 16), the train step
    splits its rows over "model" where they divide
    (`runtime.sharding.batch_axes`) and so computes on no "model" shard;
    elsewhere the attention is gathered whole and runs on every head on
    every rank: the reference's divisibility fallback, reported by
    `tp_report`.
  * MLA: wq_b and wkv_b column-parallel over the heads, wo row-parallel;
    wq_a, wkv_a and the latent c_kv / k_rope replicated.
  * the MLP: wi / wg column-parallel and wo row-parallel where `d_ff`
    divides, else gathered.
The input of column-parallel compute passes `copy_to_model` and a
row-parallel product is summed over the axis (`dense(..., split=)`,
`core.approx_matmul.matmul`'s `split`), so every rank's output, and the
cotangent of its input, is the whole layer's. Outside a meshed step
nothing is split.

Conventions:
  x: (B, S, D) activations, in the config's dtype.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.approx_matmul import matmul as core_matmul
from repro_torch.core.collectives import copy_to_model, model_axis, model_split, reduce_from_model

Params = dict[str, Any]


def _randn(gen: torch.Generator, shape: tuple[int, ...]) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)


# ----------------------------------------------------------------- dense ----
def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, bias: bool = False,
               scale: float | None = None) -> Params:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": _randn(gen, (d_in, d_out)).mul_(scale)}     # in place: no second copy
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=gen.device)
    return p


def dense(p: Params, x: torch.Tensor, *, method: str = "exact",
          impl: str = "auto", split: str | None = None) -> torch.Tensor:
    """x @ w (+ b) in x's dtype; a quantized `method` runs `core.matmul`
    on the flattened rows with `impl`, its float32 result cast back.
    `split` "col" / "row": `w` is this rank's block of the weight's
    columns / rows over "model" (`core.approx_matmul.matmul`); a
    row-parallel product is summed over the axis before the bias."""
    w = p["w"].to(x.dtype)
    if method == "exact":
        y = x @ w
        if split == "row":
            y = reduce_from_model(y, model_axis())
    else:
        y = core_matmul(x.reshape(-1, x.shape[-1]), w, method, impl=impl,
                        device=x.device, split=split
                        ).reshape(*x.shape[:-1], w.shape[-1]).to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ----------------------------------------------------------------- norms ----
def norm_init(d: int, kind: str = "rmsnorm", *, device=None) -> Params:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"]
    return out.to(x.dtype)


# ------------------------------------------------------------------ rope ----
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # (Dh/2,)
    ang = positions[..., None].to(torch.float32) * freqs          # (B, S, Dh/2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ------------------------------------------------------------- attention ----
def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
          q_offset: torch.Tensor | None, softcap: float = 0.0, chunk_q: int = 1024,
          valid_mask: torch.Tensor | None = None,
          scores_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Scaled dot-product attention, GQA-aware, q-chunked for long prefill.

    q: (B, Sq, Hq, Dh); k, v: (B, Sk, Hkv, Dh), Hq % Hkv == 0. q_offset:
    (B,) start position of q within the kv sequence (prefill 0, decode the
    cache length). valid_mask: (B, Sk) extra key validity (sliding-window
    caches). Chunking over Sq bounds the score block to (chunk_q, Sk)."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    groups = hq // hkv
    scale = 1.0 / math.sqrt(dh)
    offset = (torch.zeros((b,), dtype=torch.int32, device=q.device)
              if q_offset is None else q_offset)
    neg = -3e4 if scores_dtype == torch.bfloat16 else -1e30
    keys = torch.arange(sk, device=q.device)

    def block(q_blk: torch.Tensor, qpos: torch.Tensor) -> torch.Tensor:
        c = q_blk.shape[1]
        qg = q_blk.reshape(b, c, hkv, groups, dh)
        s = torch.einsum("bchgd,bkhd->bhgck", qg, k).to(scores_dtype) * scale
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        if causal:
            qp = offset[:, None] + qpos[None, :]                      # (B, c)
            mask = qp[:, None, None, :, None] >= keys[None, None, None, None, :]
            s = torch.where(mask, s, neg)
        if valid_mask is not None:
            s = torch.where(valid_mask[:, None, None, None, :], s, neg)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        o = torch.einsum("bhgck,bkhd->bchgd", p, v)
        return o.reshape(b, c, hq, dv)

    pos = torch.arange(sq, dtype=torch.int32, device=q.device)
    if sq <= chunk_q or sq % chunk_q != 0:
        return block(q, pos)
    return torch.cat([block(q[:, lo:lo + chunk_q], pos[lo:lo + chunk_q])
                      for lo in range(0, sq, chunk_q)], dim=1)


def gqa_init(gen: torch.Generator, cfg) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": dense_init(gen, d, cfg.num_heads * hd, bias=cfg.qkv_bias),
        "wk": dense_init(gen, d, cfg.num_kv_heads * hd, bias=cfg.qkv_bias),
        "wv": dense_init(gen, d, cfg.num_kv_heads * hd, bias=cfg.qkv_bias),
        "wo": dense_init(gen, cfg.num_heads * hd, d),
    }


def attn_splits(cfg):
    """(the "model" axis where the attention splits its query heads over
    it, else None; whether its kv heads split too)."""
    m = model_split(cfg.num_heads)
    return m, m is not None and cfg.num_kv_heads % m.size == 0


def attn_keep(cfg, prefix: str) -> dict[str, int]:
    """{param path: the dim kept split over "model"} of a GQA attention's
    params under `prefix` (module docstring); {} where it is gathered."""
    m, kv = attn_splits(cfg)
    if m is None:
        return {}
    names = ("wq", "wk", "wv") if kv else ("wq",)
    keep = {f"{prefix}/{n}/{leaf}": d for n in names for leaf, d in (("w", 1), ("b", 0))}
    keep[f"{prefix}/wo/w"] = 0
    return keep


def kv_proj(p: Params, x: torch.Tensor, cfg, *, impl: str = "auto",
            xp: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The k and v projections of x (B, T, D) -> (B, T, Hkv', Dh) each:
    this rank's kv heads where they split over "model" (from `xp`, x past
    `copy_to_model`, made here for None), else every kv head."""
    b, t, _ = x.shape
    m, kv = attn_splits(cfg)
    mm, hd = cfg.matmul_method, cfg.resolved_head_dim
    if kv:
        src, split, hkv = (copy_to_model(x, m) if xp is None else xp), "col", \
            cfg.num_kv_heads // m.size
    else:
        src, split, hkv = x, None, cfg.num_kv_heads
    k = dense(p["wk"], src, method=mm, impl=impl, split=split).reshape(b, t, hkv, hd)
    v = dense(p["wv"], src, method=mm, impl=impl, split=split).reshape(b, t, hkv, hd)
    return k, v


def _local_kv(k: torch.Tensor, v: torch.Tensor, cfg, m) -> tuple[torch.Tensor, torch.Tensor]:
    """Of every kv head (B, T, Hkv, Dh), the ones this rank's query heads
    read: whole groups where its heads hold them, else one a query head
    (groups of one). Their cotangents, a share each, are summed over "model"."""
    g, hq = cfg.num_heads // cfg.num_kv_heads, cfg.num_heads // m.size
    idx = torch.arange(m.index * hq, (m.index + 1) * hq, device=k.device) // g
    sel = idx[::g] if hq % g == 0 else idx[:1] if g % hq == 0 else idx
    return (copy_to_model(k, m).index_select(2, sel), copy_to_model(v, m).index_select(2, sel))


def gqa_attention(p: Params, x: torch.Tensor, cfg, *, positions: torch.Tensor,
                  kv_cache: Params | None = None,
                  cache_len: torch.Tensor | None = None,
                  kv_override: tuple[torch.Tensor, torch.Tensor] | None = None,
                  impl: str = "auto") -> tuple[torch.Tensor, Params | None]:
    """GQA self-attention, or cross-attention to kv_override = (k, v) (B,
    T, Hkv, Dh; `kv_proj`'s heads): no RoPE, no mask, no cache. Returns
    (out, new_kv_cache); kv_cache = {"k", "v"}: (B, S_max, Hkv, Dh), this
    rank's kv heads where they split over "model"."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    mm = cfg.matmul_method
    m, kv_split = attn_splits(cfg)
    xp = copy_to_model(x, m)
    q = dense(p["wq"], xp, method=mm, impl=impl, split="col" if m else None
              ).reshape(b, s, cfg.num_heads // (m.size if m else 1), hd)
    if kv_override is None:
        k, v = kv_proj(p, x, cfg, impl=impl, xp=xp)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        causal = cfg.causal
    else:
        k, v = kv_override
        causal = False

    new_cache = None
    q_offset = None
    valid_mask = None
    if kv_cache is not None and kv_override is None:
        smax = kv_cache["k"].shape[1]
        window = cfg.sliding_window
        steps = torch.arange(s, device=x.device)[None, :]
        if window and smax == window:
            # Rolling window cache: write modulo the window, attend to every
            # written slot (RoPE phases are absolute, applied pre-cache).
            idx = (cache_len[:, None] + steps) % window
            written = torch.clamp(cache_len + s, max=window)           # (B,)
            valid_mask = torch.arange(window, device=x.device)[None, :] < written[:, None]
            causal = False
        else:
            idx = cache_len[:, None] + steps                           # (B, s)
            q_offset = cache_len
            causal = True                  # masks unwritten slots too
        kc = _scatter_cache(kv_cache["k"], k, idx)
        vc = _scatter_cache(kv_cache["v"], v, idx)
        new_cache = {"k": kc, "v": vc}
        k, v = kc, vc
    if m is not None and not kv_split:
        k, v = _local_kv(k, v, cfg, m)

    o = _sdpa(q, k, v, causal=causal, q_offset=q_offset,
              softcap=cfg.attn_logit_softcap, valid_mask=valid_mask,
              chunk_q=cfg.attn_chunk_q,
              scores_dtype=getattr(torch, cfg.attn_scores_dtype))
    return (dense(p["wo"], o.reshape(b, s, -1), method=mm, impl=impl,
                  split="row" if m else None), new_cache)


_DONATED = False                    # inside donated_caches()


@contextlib.contextmanager
def donated_caches():
    """While active, the caches a step is given are donated to it, as a
    jitted step's donated arguments: new keys and values are written into
    them in place, not into copies (the meshed serve steps, which write
    each rank's blocks back, and so hold one cache a layer, not two)."""
    global _DONATED
    prev, _DONATED = _DONATED, True
    try:
        yield
    finally:
        _DONATED = prev


def _scatter_cache(cache: torch.Tensor, new: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """A copy of cache (B, Smax, H, D) with new (B, s, H, D) written at the
    per-batch positions idx (B, s); the cache itself, written in place,
    inside `donated_caches()`."""
    out = cache if _DONATED else cache.clone()
    bidx = torch.arange(cache.shape[0], device=cache.device)[:, None]
    out[bidx, idx.long()] = new.to(cache.dtype)
    return out


# ------------------------------------------------------------------- MLA ----
def mla_init(gen: torch.Generator, cfg) -> Params:
    d = cfg.d_model
    qdim = cfg.num_heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
    return {
        "wq_a": dense_init(gen, d, cfg.q_lora_rank),
        "q_norm": norm_init(cfg.q_lora_rank, device=gen.device),
        "wq_b": dense_init(gen, cfg.q_lora_rank, qdim),
        "wkv_a": dense_init(gen, d, cfg.kv_lora_rank + cfg.qk_rope_dim),
        "kv_norm": norm_init(cfg.kv_lora_rank, device=gen.device),
        "wkv_b": dense_init(gen, cfg.kv_lora_rank,
                            cfg.num_heads * (cfg.qk_nope_dim + cfg.v_head_dim)),
        "wo": dense_init(gen, cfg.num_heads * cfg.v_head_dim, d),
    }


def mla_keep(cfg, prefix: str) -> dict[str, int]:
    """{param path: dim kept split over "model"} of an MLA attention:
    wq_b and wkv_b by their heads' columns, wo by its rows."""
    if model_split(cfg.num_heads) is None:
        return {}
    return {f"{prefix}/wq_b/w": 1, f"{prefix}/wkv_b/w": 1, f"{prefix}/wo/w": 0}


def mla_attention(p: Params, x: torch.Tensor, cfg, *, positions: torch.Tensor,
                  kv_cache: Params | None = None,
                  cache_len: torch.Tensor | None = None,
                  impl: str = "auto") -> tuple[torch.Tensor, Params | None]:
    """Multi-head latent attention (DeepSeek-V2/V3), the reference's
    absorbed form: W_UK folded into q, scores against the latent c_kv and
    the shared RoPE key, values in the latent, W_UV applied after. Returns
    (out, new_cache); kv_cache = {"c_kv" (B, S_max, r), "k_rope" (B, S_max,
    1, dr)}, in the model dtype. Always causal."""
    b, s, _ = x.shape
    m = model_split(cfg.num_heads)
    h, r = cfg.num_heads // (m.size if m else 1), cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    mm = cfg.matmul_method
    col, row = ("col", "row") if m else (None, None)

    ql = apply_norm(p["q_norm"], dense(p["wq_a"], x, method=mm, impl=impl), cfg.norm)
    q = dense(p["wq_b"], copy_to_model(ql, m), method=mm, impl=impl,
              split=col).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv_a = dense(p["wkv_a"], x, method=mm, impl=impl)                 # (B, S, r + dr)
    c_kv = apply_norm(p["kv_norm"], kv_a[..., :r], cfg.norm)
    k_rope = apply_rope(kv_a[..., None, r:], positions, cfg.rope_theta)   # (B, S, 1, dr)

    wkv_b = p["wkv_b"]["w"].to(x.dtype).reshape(r, h, dn + dv)
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]                      # (r, h, dn), (r, h, dv)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)              # (B, S, h, r)

    new_cache = None
    q_offset = None
    if kv_cache is not None:
        idx = cache_len[:, None] + torch.arange(s, device=x.device)[None, :]
        c_kv = _scatter_cache(kv_cache["c_kv"][..., None, :], c_kv[..., None, :], idx)[..., 0, :]
        k_rope = _scatter_cache(kv_cache["k_rope"], k_rope, idx)
        new_cache = {"c_kv": c_kv, "k_rope": k_rope}
        q_offset = cache_len
    c_kv, k_rope = copy_to_model(c_kv, m), copy_to_model(k_rope, m)   # read by this rank's heads

    q_cat = torch.cat([q_lat, q_rope], dim=-1)                         # (B, S, h, r + dr)
    k_cat = torch.cat([c_kv[:, :, None, :], k_rope], dim=-1)          # (B, Sk, 1, r + dr)
    # keep the 1/sqrt(dn + dr) of the unabsorbed scores; the factor is
    # rounded to the model dtype first, as the reference's weakly typed
    # Python float is (on the host: a device scalar would cost a sync)
    scale_fix = float(torch.tensor(math.sqrt(r + dr) / math.sqrt(dn + dr), dtype=x.dtype))
    o_lat = _sdpa(q_cat * scale_fix, k_cat, c_kv[:, :, None, :], causal=True,
                  q_offset=q_offset, chunk_q=cfg.attn_chunk_q)        # (B, S, h, r)
    o = torch.einsum("bshr,rhd->bshd", o_lat, w_uv)                    # (B, S, h, dv)
    return dense(p["wo"], o.reshape(b, s, h * dv), method=mm, impl=impl,
                 split=row), new_cache


# ------------------------------------------------------------------- MLP ----
def mlp_init(gen: torch.Generator, cfg, d_ff: int | None = None) -> Params:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    p = {"wi": dense_init(gen, d, ff, bias=cfg.mlp_bias)}
    if cfg.mlp == "swiglu":
        p["wg"] = dense_init(gen, d, ff, bias=cfg.mlp_bias)
    p["wo"] = dense_init(gen, ff, d, bias=cfg.mlp_bias)
    return p


def mlp_keep(d_ff: int, prefix: str) -> dict[str, int]:
    """{param path: dim kept split over "model"} of an MLP of width `d_ff`:
    wi / wg by their columns, wo by its rows, where `d_ff` divides."""
    if model_split(d_ff) is None:
        return {}
    keep = {f"{prefix}/{n}/{leaf}": d for n in ("wi", "wg") for leaf, d in (("w", 1), ("b", 0))}
    keep[f"{prefix}/wo/w"] = 0
    return keep


def mlp(p: Params, x: torch.Tensor, cfg, *, impl: str = "auto",
        d_ff: int | None = None) -> torch.Tensor:
    """The MLP of width `d_ff` (`cfg.d_ff` for None), tensor-parallel
    where `mlp_keep` splits it."""
    mm = cfg.matmul_method
    m = model_split(d_ff or cfg.d_ff)
    col, row = ("col", "row") if m else (None, None)
    x = copy_to_model(x, m)
    h = dense(p["wi"], x, method=mm, impl=impl, split=col)
    if cfg.mlp == "swiglu":
        h = F.silu(dense(p["wg"], x, method=mm, impl=impl, split=col)) * h
    elif cfg.mlp == "squared_relu":
        h = torch.square(F.relu(h))
    elif cfg.mlp == "gelu":
        h = F.gelu(h, approximate="tanh")        # jax.nn.gelu's default
    return dense(p["wo"], h, method=mm, impl=impl, split=row)


__all__ = ["apply_norm", "apply_rope", "attn_keep", "attn_splits", "dense", "dense_init",
           "donated_caches",
           "gqa_attention", "gqa_init", "kv_proj", "mla_attention", "mla_init", "mla_keep", "mlp",
           "mlp_init", "mlp_keep", "norm_init", "rope_freqs"]
