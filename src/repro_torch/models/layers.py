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

Conventions:
  x: (B, S, D) activations, in the config's dtype.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.approx_matmul import matmul as core_matmul

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
          impl: str = "auto") -> torch.Tensor:
    """x @ w (+ b) in x's dtype; a quantized `method` runs `core.matmul`
    on the flattened rows with `impl`, its float32 result cast back."""
    w = p["w"].to(x.dtype)
    if method == "exact":
        y = x @ w
    else:
        y = core_matmul(x.reshape(-1, x.shape[-1]), w, method, impl=impl,
                        device=x.device).reshape(*x.shape[:-1], w.shape[-1]).to(x.dtype)
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


def gqa_attention(p: Params, x: torch.Tensor, cfg, *, positions: torch.Tensor,
                  kv_cache: Params | None = None,
                  cache_len: torch.Tensor | None = None,
                  kv_override: tuple[torch.Tensor, torch.Tensor] | None = None,
                  impl: str = "auto") -> tuple[torch.Tensor, Params | None]:
    """GQA self-attention, or cross-attention to kv_override = (k, v) (B,
    T, Hkv, Dh): no RoPE, no mask, no cache. Returns (out, new_kv_cache);
    kv_cache = {"k", "v"}: (B, S_max, Hkv, Dh)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    mm = cfg.matmul_method
    q = dense(p["wq"], x, method=mm, impl=impl).reshape(b, s, cfg.num_heads, hd)
    if kv_override is None:
        k = dense(p["wk"], x, method=mm, impl=impl).reshape(b, s, cfg.num_kv_heads, hd)
        v = dense(p["wv"], x, method=mm, impl=impl).reshape(b, s, cfg.num_kv_heads, hd)
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

    o = _sdpa(q, k, v, causal=causal, q_offset=q_offset,
              softcap=cfg.attn_logit_softcap, valid_mask=valid_mask,
              chunk_q=cfg.attn_chunk_q,
              scores_dtype=getattr(torch, cfg.attn_scores_dtype))
    return dense(p["wo"], o.reshape(b, s, -1), method=mm, impl=impl), new_cache


def _scatter_cache(cache: torch.Tensor, new: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """A copy of cache (B, Smax, H, D) with new (B, s, H, D) written at the
    per-batch positions idx (B, s)."""
    out = cache.clone()
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
    h, r = cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    mm = cfg.matmul_method

    ql = apply_norm(p["q_norm"], dense(p["wq_a"], x, method=mm, impl=impl), cfg.norm)
    q = dense(p["wq_b"], ql, method=mm, impl=impl).reshape(b, s, h, dn + dr)
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

    q_cat = torch.cat([q_lat, q_rope], dim=-1)                         # (B, S, h, r + dr)
    k_cat = torch.cat([c_kv[:, :, None, :], k_rope], dim=-1)          # (B, Sk, 1, r + dr)
    # keep the 1/sqrt(dn + dr) of the unabsorbed scores; the factor is
    # rounded to the model dtype first, as the reference's weakly typed
    # Python float is (on the host: a device scalar would cost a sync)
    scale_fix = float(torch.tensor(math.sqrt(r + dr) / math.sqrt(dn + dr), dtype=x.dtype))
    o_lat = _sdpa(q_cat * scale_fix, k_cat, c_kv[:, :, None, :], causal=True,
                  q_offset=q_offset, chunk_q=cfg.attn_chunk_q)         # (B, S, h, r)
    o = torch.einsum("bshr,rhd->bshd", o_lat, w_uv)                    # (B, S, h, dv)
    return dense(p["wo"], o.reshape(b, s, h * dv), method=mm, impl=impl), new_cache


# ------------------------------------------------------------------- MLP ----
def mlp_init(gen: torch.Generator, cfg, d_ff: int | None = None) -> Params:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    p = {"wi": dense_init(gen, d, ff, bias=cfg.mlp_bias)}
    if cfg.mlp == "swiglu":
        p["wg"] = dense_init(gen, d, ff, bias=cfg.mlp_bias)
    p["wo"] = dense_init(gen, ff, d, bias=cfg.mlp_bias)
    return p


def mlp(p: Params, x: torch.Tensor, cfg, *, impl: str = "auto") -> torch.Tensor:
    mm = cfg.matmul_method
    h = dense(p["wi"], x, method=mm, impl=impl)
    if cfg.mlp == "swiglu":
        h = F.silu(dense(p["wg"], x, method=mm, impl=impl)) * h
    elif cfg.mlp == "squared_relu":
        h = torch.square(F.relu(h))
    elif cfg.mlp == "gelu":
        h = F.gelu(h, approximate="tanh")        # jax.nn.gelu's default
    return dense(p["wo"], h, method=mm, impl=impl)


__all__ = ["apply_norm", "apply_rope", "dense", "dense_init", "gqa_attention",
           "gqa_init", "mla_attention", "mla_init", "mlp", "mlp_init", "norm_init",
           "rope_freqs"]
