"""xLSTM blocks: mLSTM (matrix memory, parallel and O(1) recurrent forms)
and sLSTM (scalar memory, a loop over time) -- Beck et al. 2024,
arXiv:2405.04517.

Counterpart of `repro.models.xlstm`, on plain PyTorch tensors. xlstm-1.3b
has no separate FFN (d_ff = 0): the mLSTM block carries its own
up-projection (cfg.mlstm_proj_factor) and gated down-projection; sLSTM
blocks are post-up-projection. Both are residual pre-norm blocks assembled
in `transformer.py`.

The parallel mLSTM is the stabilised quadratic form, q-chunked like
attention; prefill also rebuilds the recurrent state (matrix memory,
normalizer, stabilizer) so that decode continues from it. The sLSTM's
time scan is a Python loop (the reference's `lax.scan`).

The mLSTM's causal conv is `ssm._causal_conv`: the reference's
`_causal_conv1d` is the same function for a width of 2 or more.

`up_proj`, `w_if`, `down_proj` (mLSTM) and `w_in`, `w_out` (sLSTM) go
through `layers.dense` with `impl`, so a quantized `matmul_method` runs
them on the Hopper matmul kernels on the card. The block-diagonal q / k / v
maps and the recurrent weights are float einsums, as in the reference.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _randn, dense, dense_init
from repro_torch.models.ssm import _causal_conv, _softplus

Params = dict[str, Any]


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.log_sigmoid`: -softplus(-x)."""
    return -_softplus(-x)


def _mlstm_dims(cfg) -> tuple[int, int, int]:
    d_up = int(cfg.mlstm_proj_factor * cfg.d_model)
    nheads = cfg.num_heads
    return d_up, nheads, d_up // nheads


def mlstm_init(gen: torch.Generator, cfg) -> Params:
    d = cfg.d_model
    d_up, nheads, dh = _mlstm_dims(cfg)
    dev = gen.device
    # q / k / v are block-diagonal per head (the xLSTM paper's BlockDiagonal
    # linear): (H, dh, dh) instead of (d_up, d_up)
    def bd() -> torch.Tensor:
        return _randn(gen, (nheads, dh, dh)) / math.sqrt(dh)

    return {
        "up_proj": dense_init(gen, d, 2 * d_up),       # [main ; gate]
        "conv_w": _randn(gen, (cfg.ssm_conv_width or 4, d_up)) * 0.1,
        "conv_b": torch.zeros((d_up,), dtype=torch.float32, device=dev),
        "wq": bd(),
        "wk": bd(),
        "wv": bd(),
        "w_if": dense_init(gen, d_up, 2 * nheads, bias=True),
        "norm_scale": torch.ones((d_up,), dtype=torch.float32, device=dev),
        "down_proj": dense_init(gen, d_up, d),
    }


def _mlstm_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_raw: torch.Tensor, f_raw: torch.Tensor,
                    chunk_q: int = 256) -> torch.Tensor:
    """Stabilised parallel mLSTM. q / k / v: (B, S, H, Dh); gates (B, S, H)
    before activation. k already carries the 1/sqrt(Dh) factor."""
    b, s, h, dh = q.shape
    f32 = torch.float32
    lf = _log_sigmoid(f_raw.to(f32))                              # (B,S,H)
    lcum = torch.cumsum(lf, dim=1)
    u = i_raw.to(f32) - lcum                                      # (B,S,H)
    m = torch.cummax(u, dim=1).values                             # running max of u
    m_true = lcum + m                                             # true stabilizer m_t
    keys = torch.arange(s, device=q.device)
    kf, vf = k.to(f32), v.to(f32)

    def block(q_blk, m_blk, mt_blk, pos):
        # decay D[t, s] = exp(u_s - m'_t) for s <= t (lcum_t cancels via u, m')
        dmat = torch.exp(u[:, None, :, :] - m_blk[:, :, None, :])  # (B,c,S,H)
        mask = pos[None, :, None] >= keys[None, None, :]           # (1,c,S)
        dmat = torch.where(mask[..., None], dmat, 0.0)
        scores = torch.einsum("bchd,bshd->bcsh", q_blk.to(f32), kf)
        cmat = scores * dmat                                      # (B,c,S,H)
        # the clamp uses the true stabilizer m_t = lcum_t + m'_t (as decode)
        norm = torch.maximum(torch.abs(cmat.sum(2)), torch.exp(-mt_blk)) + 1e-6
        out = torch.einsum("bcsh,bshd->bchd", cmat, vf)
        return out / norm[..., None]

    if s <= chunk_q:
        return block(q, m, m_true, keys).to(q.dtype)
    assert s % chunk_q == 0
    outs = [block(q[:, lo:lo + chunk_q], m[:, lo:lo + chunk_q],
                  m_true[:, lo:lo + chunk_q], keys[lo:lo + chunk_q])
            for lo in range(0, s, chunk_q)]
    return torch.cat(outs, dim=1).to(q.dtype)


def mlstm_block_apply(p: Params, x: torch.Tensor, cfg, *, state: Params | None = None,
                      decode: bool = False, impl: str = "auto") -> tuple[torch.Tensor, Params]:
    """x (B, S, D) -> (y (B, S, D), new state {"c", "n", "m", "conv"})."""
    b, s, _ = x.shape
    d_up, h, dh = _mlstm_dims(cfg)
    mm = cfg.matmul_method
    f32 = torch.float32

    up = dense(p["up_proj"], x, method=mm, impl=impl)
    xm, zg = torch.split(up, [d_up, d_up], dim=-1)
    conv_state = state["conv"] if state is not None else None
    xc, new_conv = _causal_conv(xm, p["conv_w"], p["conv_b"], conv_state)

    xch = xc.reshape(b, s, h, dh)
    xmh = xm.reshape(b, s, h, dh)

    def bd(w: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return torch.einsum("bshd,hde->bshe", t, w.to(t.dtype))

    q = bd(p["wq"], xch)
    k = bd(p["wk"], xch) / math.sqrt(dh)
    v = bd(p["wv"], xmh)
    gif = dense(p["w_if"], xc, method=mm, impl=impl).to(f32)
    i_raw, f_raw = gif[..., :h], gif[..., h:]

    if decode:
        c0 = state["c"].to(f32)                                   # (B,H,Dk,Dv)
        n0 = state["n"].to(f32)                                   # (B,H,Dk)
        m0 = state["m"].to(f32)                                   # (B,H)
        ys = []
        for t in range(s):
            lf = _log_sigmoid(f_raw[:, t])                        # (B,H)
            m1 = torch.maximum(lf + m0, i_raw[:, t])
            a = torch.exp(lf + m0 - m1)[:, :, None]
            bgt = torch.exp(i_raw[:, t] - m1)[:, :, None]
            kt = k[:, t].to(f32)                                  # (B,H,Dk)
            vt = v[:, t].to(f32)                                  # (B,H,Dv)
            qt = q[:, t].to(f32)
            c0 = a[..., None] * c0 + bgt[..., None] * kt[..., :, None] * vt[..., None, :]
            n0 = a * n0 + bgt * kt
            m0 = m1
            num = torch.einsum("bhk,bhkv->bhv", qt, c0)
            den = torch.maximum(torch.abs((qt * n0).sum(-1)), torch.exp(-m0)) + 1e-6
            ys.append(num / den[..., None])                       # (B,H,Dv)
        y = torch.stack(ys, dim=1)                                # (B,S,H,Dv)
        new_state = {"c": c0, "n": n0, "m": m0, "conv": new_conv}
    else:
        y = _mlstm_parallel(q, k, v, i_raw, f_raw,
                            chunk_q=min(cfg.attn_chunk_q, 256)
                            if not cfg.scan_unroll else x.shape[1])
        # rebuild the final state so that prefill hands off to decode
        lf = _log_sigmoid(f_raw)
        lcum = torch.cumsum(lf, dim=1)
        u = i_raw - lcum
        m_last = torch.amax(u, dim=1) + lcum[:, -1]               # (B,H)
        wts = torch.exp(lcum[:, -1][:, None] - lcum + i_raw - m_last[:, None])
        kf = k.to(f32).permute(0, 2, 1, 3)                        # (B,H,S,Dk)
        vf = v.to(f32).permute(0, 2, 1, 3)
        wf = wts.permute(0, 2, 1)                                 # (B,H,S)
        c_last = torch.einsum("bhs,bhsk,bhsv->bhkv", wf, kf, vf)
        n_last = torch.einsum("bhs,bhsk->bhk", wf, kf)
        new_state = {"c": c_last, "n": n_last, "m": m_last, "conv": new_conv}

    y = y.reshape(b, s, d_up)
    yf = y.to(f32)
    ms = (yf ** 2).mean(-1, keepdim=True)
    y = (yf * torch.rsqrt(ms + 1e-6) * p["norm_scale"]).to(x.dtype)
    y = y * F.silu(zg)
    return dense(p["down_proj"], y, method=mm, impl=impl), new_state


# --------------------------------------------------------------- sLSTM ------
def slstm_init(gen: torch.Generator, cfg) -> Params:
    d = cfg.d_model
    h = cfg.num_heads
    dh = d // h
    return {
        # 4 gates (z, i, f, o) from the input and block-diagonal recurrent weights
        "w_in": dense_init(gen, d, 4 * d, bias=True),
        "r_rec": _randn(gen, (h, dh, 4 * dh)) / math.sqrt(dh),
        "out_norm": torch.ones((d,), dtype=torch.float32, device=gen.device),
        "w_out": dense_init(gen, d, d),
    }


def slstm_apply(p: Params, x: torch.Tensor, cfg, *, state: Params | None = None,
                impl: str = "auto") -> tuple[torch.Tensor, Params]:
    """sLSTM with exponential gating, a loop over time.

    State: {"h", "c", "n", "m"}, each (B, H, Dh) float32."""
    b, s, d = x.shape
    h = cfg.num_heads
    dh = d // h
    mm = cfg.matmul_method
    f32 = torch.float32
    gates_in = dense(p["w_in"], x, method=mm, impl=impl).to(f32)  # (B,S,4D)
    r = p["r_rec"]

    if state is None:
        zeros = torch.zeros((b, h, dh), dtype=f32, device=x.device)
        state = {"h": zeros, "c": zeros, "n": zeros + 1.0, "m": zeros}
    hp, cp, np_, mp = state["h"], state["c"], state["n"], state["m"]
    hs = []
    for t in range(s):
        rec = torch.einsum("bhd,hdg->bhg", hp, r)                 # (B,H,4Dh)
        g = gates_in[:, t].reshape(b, h, 4 * dh) + rec
        zr, ir, fr, orr = torch.split(g, dh, dim=-1)
        z = torch.tanh(zr)
        o = torch.sigmoid(orr)
        lf = _log_sigmoid(fr)
        m1 = torch.maximum(lf + mp, ir)
        i_g = torch.exp(ir - m1)
        f_g = torch.exp(lf + mp - m1)
        cp = f_g * cp + i_g * z
        np_ = f_g * np_ + i_g
        hp = o * cp / torch.clamp_min(np_, 1e-6)
        mp = m1
        hs.append(hp)
    y = torch.stack(hs, dim=1).reshape(b, s, d)
    ms = (y ** 2).mean(-1, keepdim=True)
    y = (y * torch.rsqrt(ms + 1e-6) * p["out_norm"]).to(x.dtype)
    return (dense(p["w_out"], y, method=mm, impl=impl),
            {"h": hp, "c": cp, "n": np_, "m": mp})


__all__ = ["mlstm_block_apply", "mlstm_init", "slstm_apply", "slstm_init"]
