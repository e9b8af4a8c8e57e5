"""Mamba2 (SSD) mixer -- the zamba2 hybrid's state-space block.

Counterpart of `repro.models.ssm`, on plain PyTorch tensors. The parallel
(prefill) path is the chunked SSD form of Dao & Gu 2024: a within-chunk
attention-like term plus a cross-chunk recurrent state pass, all einsums,
O(S * chunk) not O(S^2). The inter-chunk recurrence is a Python loop over
chunks (the reference's `lax.scan`). Decode is the O(1) recurrence over
(H, P, N) states.

Layout: d_inner = expand * d_model, H = d_inner / head_dim heads, state size
N = cfg.ssm_state, one B/C group. A depthwise causal conv (width
cfg.ssm_conv_width) runs over the xBC stream and is cached at decode. The
state a call hands back follows the reference's dtypes: the SSD state in
float32, the conv state in the activations' dtype.

`in_proj` and `out_proj` go through `layers.dense` with `impl`, so a
quantized `matmul_method` runs them on the Hopper matmul kernels on the
card; the scan itself is float arithmetic, as in the reference.

Tensor parallelism (the reference's rules: `in_proj` column-parallel,
`out_proj` row-parallel, `conv_w` on its channels, `a_log` / `dt_bias` /
`d_skip` on the heads). Inside a meshed step whose "model" axis divides
the heads (`core.collectives.model_split`), each rank computes on its
contiguous block of heads: its z, x and dt columns of `in_proj`, its x
channels of the conv, its SSD scan and state; B and C (one group) are
computed on every rank. The gated RMSNorm's mean over d_inner sums each
rank's squares over "model", and `out_proj`'s partial products are summed
over it (`layers.dense(split="row")`: the int32 sums before the rescale
under a quantized method). `in_proj`'s columns and the conv's channels
rest in contiguous blocks that straddle the [z, x, B, C, dt] segments, so
the per-layer gather selects this rank's part of each segment
(`mamba2_keep`, `core.collectives.fsdp_gather`), and so does the meshed
serve step for the conv cache (`runtime.serve_lib`).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import copy_to_model, model_split, reduce_from_model
from repro_torch.models.layers import _randn, dense, dense_init

Params = dict[str, Any]


def _dims(cfg) -> tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    return d_inner, nheads, cfg.ssm_head_dim, cfg.ssm_state


def mamba2_init(gen: torch.Generator, cfg) -> Params:
    d = cfg.d_model
    d_inner, nheads, _, n = _dims(cfg)
    dev = gen.device
    # Fused input projection: [z (gate), x, B, C, dt] like the reference impl.
    d_in_proj = 2 * d_inner + 2 * n + nheads
    return {
        "in_proj": dense_init(gen, d, d_in_proj),
        "conv_w": _randn(gen, (cfg.ssm_conv_width, d_inner + 2 * n)) * 0.1,
        "conv_b": torch.zeros((d_inner + 2 * n,), dtype=torch.float32, device=dev),
        "a_log": torch.log(torch.linspace(1.0, float(nheads), nheads,
                                          dtype=torch.float32, device=dev)),
        "dt_bias": torch.full((nheads,), -2.0, dtype=torch.float32, device=dev),
        "d_skip": torch.ones((nheads,), dtype=torch.float32, device=dev),
        "norm_scale": torch.ones((d_inner,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, d_inner, d),
    }


def segments(cfg) -> tuple[tuple, tuple]:
    """The layouts of `in_proj`'s columns ([z, x, B, C, dt]) and of the
    conv's channels ([x, B, C]): (length, split over "model") a segment,
    as `core.collectives.segment_index` reads them."""
    d_inner, nheads, _, n = _dims(cfg)
    return (((d_inner, True), (d_inner, True), (n, False), (n, False), (nheads, True)),
            ((d_inner, True), (n, False), (n, False)))


def mamba2_keep(cfg, prefix: str) -> dict:
    """{param path: what its layer keeps of it over "model"} of a Mamba2
    mixer under `prefix` where its heads split (module docstring), {}
    elsewhere: the dim of a contiguous block (the heads' vectors, the
    norm's scale, `out_proj`'s rows), or (dim, segments) for `in_proj`'s
    columns and the conv's channels, whose rank's part is a block of each
    split segment and the whole of the others."""
    _, nheads, _, _ = _dims(cfg)
    if model_split(nheads) is None:
        return {}
    cols, chans = segments(cfg)
    keep: dict = {f"{prefix}/{k}": 0 for k in ("a_log", "dt_bias", "d_skip", "norm_scale")}
    keep.update({f"{prefix}/out_proj/w": 0, f"{prefix}/in_proj/w": (1, cols),
                 f"{prefix}/conv_w": (1, chans), f"{prefix}/conv_b": (0, chans)})
    return keep


def _causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 state: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Depthwise causal conv of width K, then SiLU. x: (B, S, C); state:
    (B, K-1, C) or None (zeros). The taps are summed in the reference's
    order, in x's dtype. -> (out, the last K-1 inputs in x's dtype)."""
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s, :] * w[0].to(x.dtype)
    for i in range(1, k):
        out = out + xp[:, i:i + s, :] * w[i].to(x.dtype)
    new_state = xp[:, xp.shape[1] - (k - 1):, :] if k > 1 else None
    return F.silu(out + bias.to(x.dtype)), new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as `jax.nn.softplus` forms it (logaddexp(x, 0))."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                 bmat: torch.Tensor, cmat: torch.Tensor, chunk: int,
                 h0: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    xh: (B, S, H, P) inputs; dt: (B, S, H) softplus'd steps; bmat / cmat:
    (B, S, N); h0: (B, H, P, N) initial state or None. -> (y (B, S, H, P),
    the last state (B, H, P, N) float32)."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    assert s % chunk == 0, f"S={s} not a multiple of ssm_chunk={chunk}"
    nc = s // chunk
    a = -torch.exp(a_log.to(torch.float32))                       # (H,) negative
    da = dt * a[None, None, :]                                    # (B, S, H)

    # chunk index c, position l in the chunk
    dac = da.reshape(b, nc, chunk, h)
    dtc = dt.reshape(b, nc, chunk, h)
    xc = xh.reshape(b, nc, chunk, h, p)
    bc = bmat.reshape(b, nc, chunk, n)
    cc = cmat.reshape(b, nc, chunk, n)

    cum = torch.cumsum(dac, dim=2)                                # (B,nc,L,H)
    seg_total = cum[:, :, -1, :]                                  # (B,nc,H)

    # intra-chunk (diagonal blocks): causal decay matrix L[l, m], m <= l
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]            # (B,nc,L,M,H)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))
    ldec = torch.where(causal[None, None, :, :, None], torch.exp(li), 0.0)
    scores = torch.einsum("bcln,bcmn->bclm", cc, bc)              # (B,nc,L,M)
    y_diag = torch.einsum("bclm,bclmh,bcmh,bcmhp->bclhp", scores, ldec, dtc, xc)

    # chunk states: each chunk's contribution to the state at its end
    decay_to_end = torch.exp(seg_total[:, :, None, :] - cum)      # (B,nc,L,H)
    states = torch.einsum("bcln,bclh,bclh,bclhp->bchpn", bc, decay_to_end, dtc, xc)

    # inter-chunk recurrence over the nc chunk states; keep each chunk's
    # incoming state
    hcur = (torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
            if h0 is None else h0.to(torch.float32))
    before = []
    for c in range(nc):
        before.append(hcur)
        hcur = hcur * torch.exp(seg_total[:, c])[:, :, None, None] + states[:, c]
    h_before = torch.stack(before, dim=1)                         # (B,nc,H,P,N)

    # inter-chunk output: y_off[l] = C[l] . (decay_from_start[l] * h_before)
    decay_from_start = torch.exp(cum)                             # (B,nc,L,H)
    y_off = torch.einsum("bcln,bclh,bchpn->bclhp", cc, decay_from_start, h_before)

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, hcur


def mamba2_mixer(p: Params, x: torch.Tensor, cfg, *, ssm_state: torch.Tensor | None = None,
                 conv_state: torch.Tensor | None = None, decode: bool = False,
                 impl: str = "auto") -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """x: (B, S, D) -> (y (B, S, D), new SSD state, new conv state); on
    this rank's heads where they split over "model" (module docstring),
    the states too.

    decode=True runs the O(1) recurrence (S small, typically 1)."""
    d_inner, nheads, _, _ = _dims(cfg)
    mm = cfg.matmul_method
    m = model_split(nheads)
    col, row = ("col", "row") if m else (None, None)

    zxbcdt = dense(p["in_proj"], copy_to_model(x, m), method=mm, impl=impl, split=col)
    y, h_last, new_conv = mixer_heads(p, zxbcdt, cfg, nheads // (m.size if m else 1),
                                      ssm_state=ssm_state, conv_state=conv_state, decode=decode)
    # gated RMSNorm (mamba2's norm before the out projection), its mean
    # over the whole d_inner
    yf = y.to(torch.float32)
    if m is None:
        ms = (yf ** 2).mean(-1, keepdim=True)
    else:       # every rank's squares; the sum's cotangent summed back over "model"
        ms = reduce_from_model(copy_to_model((yf ** 2).sum(-1, keepdim=True), m), m) / d_inner
    y = (yf * torch.rsqrt(ms + 1e-6) * p["norm_scale"]).to(x.dtype)
    return dense(p["out_proj"], y, method=mm, impl=impl, split=row), h_last, new_conv


def mixer_heads(p: Params, zxbcdt: torch.Tensor, cfg, heads: int, *,
                ssm_state: torch.Tensor | None = None, conv_state: torch.Tensor | None = None,
                decode: bool = False) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """The mixer between the projections on `heads` heads (all of them, or
    a rank's block): `zxbcdt` their [z, x, B, C, dt] columns, `p`'s conv
    and head params theirs. -> (the gated y (B, S, heads * P) before the
    norm, in zxbcdt's dtype; the new SSD state; the new conv state)."""
    bsz, s, _ = zxbcdt.shape
    _, _, hd, n = _dims(cfg)
    d_loc = heads * hd
    z, xs, bmat, cmat, dt = torch.split(zxbcdt, [d_loc, d_loc, n, n, heads], dim=-1)
    xbc = torch.cat([xs, bmat, cmat], dim=-1)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xs, bmat, cmat = torch.split(xbc, [d_loc, n, n], dim=-1)

    dt = _softplus(dt.to(torch.float32) + p["dt_bias"][None, None, :])
    xh = xs.reshape(bsz, s, heads, hd)

    if decode:
        a = -torch.exp(p["a_log"])                                # (H,)
        h = (torch.zeros((bsz, heads, hd, n), dtype=torch.float32, device=zxbcdt.device)
             if ssm_state is None else ssm_state.to(torch.float32))
        ys = []
        for t in range(s):                                        # decode S is 1
            dat = torch.exp(dt[:, t] * a[None, :])                # (B,H)
            dbx = torch.einsum("bh,bn,bhp->bhpn", dt[:, t], bmat[:, t].to(torch.float32),
                               xh[:, t].to(torch.float32))
            h = h * dat[:, :, None, None] + dbx
            ys.append(torch.einsum("bn,bhpn->bhp", cmat[:, t].to(torch.float32), h))
        y = torch.stack(ys, dim=1)                                # (B,S,H,P)
        h_last = h
    else:
        y, h_last = _ssd_chunked(xh.to(torch.float32), dt, p["a_log"],
                                bmat.to(torch.float32), cmat.to(torch.float32),
                                min(cfg.ssm_chunk, s), ssm_state)

    y = y + p["d_skip"][None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(bsz, s, d_loc).to(zxbcdt.dtype)
    return y * F.silu(z), h_last, new_conv


__all__ = ["mamba2_init", "mamba2_keep", "mamba2_mixer", "mixer_heads", "segments"]
