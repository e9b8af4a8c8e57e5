"""The meshed serve steps with tensor- and expert-parallel layers
(`runtime.serve_lib` with a mesh whose "model" axis is more than one
rank) against the unmeshed steps, on gloo ranks on the CPU.

A prompt of 4 rows x 8 tokens is prefilled, then 3 greedy decode steps
follow (`tests/test_torch_serve_mesh.py::generate`), for reduced configs
that take each path of `models.layers` / `models.moe`:
  * "dense": qwen2-0.5b (4 query heads, 2 kv heads): wq / wk / wv
    column-parallel, wo and the MLP's down projection row-parallel, the
    k / v caches split over "model", the tied head over the vocab;
  * "kv_gathered": the same with 1 kv head: wk / wv gathered, each rank
    taking the kv head its query heads read;
  * "heads_gathered": 3 query heads, 1 kv head: the attention gathered
    whole on every rank (the divisibility fallback), the MLP still split;
  * "mla_moe": deepseek-v3-671b (MLA over 4 heads, 8 experts,
    `moe_seq_chunk` 2): wq_b / wkv_b column-parallel, the experts over
    "model", each rank's partial combine all-reduced, the latent caches
    replicated;
  * "hybrid": zamba2-1.2b: each Mamba2 layer splits its 16 SSM heads
    over "model": in_proj's z / x / dt columns and the conv's x channels
    selected (B and C on every rank), the SSD state split on its heads,
    the conv state's x channels selected from its gathered channels, the
    gated norm's squares summed over "model", out_proj row-parallel.
On (1, 2) and (2, 2) meshes, under mitchell and karatsuba_int16 the logits
of every step are byte-equal to those of the unmeshed steps on the same
rows (the abs-max of a split operand spans "model", the row-parallel int32
sums are summed over "model" before the rescale, K = 128 <= 256 keeps the
plain LNS route's float32 sums exact: R5). On (1, 2) those are the
unmeshed steps themselves. On (2, 2) the rows split over "data", and the
unmeshed steps run on each rank's 2 rows with the quantizer's abs-max over
"data" (`dp_generate`): the float products of 2 rows and of 4 (the head,
the router) take other paths through the CPU's gemm, so the 4-row steps
are held within `tests/test_torch_serve_mesh.py`'s 1e-5 of the largest
logit where no quantization step flips. Two parts of a split layer sum
their float32 products in another order than the unsplit layer, so the
unmeshed steps run them in the ranks' blocks (`blocked_oracle`): a
one-query attention block (decode) in each rank's query heads and the kv
heads they read (the CPU's gemm rounds a product of fewer heads another
way), the MoE combine in each rank's experts, their partial sums added
in rank order, as the all-reduce of two ranks adds them, and the Mamba2
mixer between its projections in each rank's heads (the SSD einsums over
fewer heads round another way), the gated norm's sums of squares added in
rank order. Under exact the
logits are within
rtol 1e-4 / atol 1e-5 of the unmeshed steps' (that file's reference
tolerance). The greedy tokens are equal under all three methods, and the
steps' collectives include the tensor-parallel all-reduces.
"""
import contextlib
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.runtime import sharding as shd
from repro_torch.core.tree import tree_paths
from repro_torch.runtime.serve_lib import make_prefill_step, make_serve_step
from test_torch_serve_mesh import PROMPT, ROWS, S_MAX, STEPS, prompt_of
from test_torch_train_mesh import run_ranks

CASES = {
    "dense": ("qwen2-0.5b", {}),
    "kv_gathered": ("qwen2-0.5b", {"num_kv_heads": 1}),
    "heads_gathered": ("qwen2-0.5b", {"num_heads": 3, "num_kv_heads": 1}),
    "mla_moe": ("deepseek-v3-671b", {"moe_seq_chunk": 2}),
    "hybrid": ("zamba2-1.2b", {}),
}
METHODS = ("exact", "mitchell", "karatsuba_int16")


@contextlib.contextmanager
def blocked_oracle(cfg, mesh):
    """While active, the unmeshed steps run a one-query attention block,
    the MoE combine and the Mamba2 mixer in the blocks of the ranks of
    `mesh`'s "model" axis (module docstring), where the meshed step splits
    them."""
    from repro_torch.core.collectives import Axis, segment_index
    from repro_torch.models import layers, moe, ssm
    size = shd.axis_sizes(mesh)["model"]
    if size == 1 or not shd.model_parallel(cfg, mesh):
        yield
        return
    sdpa, partial, mixer = layers._sdpa, moe._experts_partial, ssm.mamba2_mixer

    def blocked_sdpa(q, k, v, **kw):
        hq, hkv = q.shape[2], k.shape[2]
        if q.shape[1] != 1 or hq % size:
            return sdpa(q, k, v, **kw)
        g, per = hq // hkv, hq // size
        outs = []
        for r in range(size):
            idx = torch.arange(r * per, (r + 1) * per) // g
            sel = idx[::g] if per % g == 0 else idx[:1] if g % per == 0 else idx
            kr, vr = (k, v) if len(sel) == hkv else (k.index_select(2, sel),
                                                      v.index_select(2, sel))
            outs.append(sdpa(q[:, :, r * per:(r + 1) * per].contiguous(), kr, vr, **kw))
        return torch.cat(outs, dim=2)

    def blocked_partial(p, tok, dispatch, combine):
        if dispatch.shape[1] % size:
            return partial(p, tok, dispatch, combine)
        n = dispatch.shape[1] // size
        out = None
        for r in range(size):
            blk = slice(r * n, (r + 1) * n)
            part = partial({**p, **{w: p[w][blk] for w in ("wi", "wg", "wo")}}, tok,
                           dispatch[:, blk], combine[:, blk])
            out = part if out is None else out + part
        return out

    def blocked_mixer(p, x, cfg, *, ssm_state=None, conv_state=None, decode=False,
                      impl="auto"):
        d_inner, nheads, hd, _ = ssm._dims(cfg)
        if nheads % size:
            return mixer(p, x, cfg, ssm_state=ssm_state, conv_state=conv_state,
                         decode=decode, impl=impl)
        mm, per = cfg.matmul_method, nheads // size
        cols, chans = ssm.segments(cfg)
        zxbcdt = layers.dense(p["in_proj"], x, method=mm, impl=impl)
        ys, states, convs = [], [], []
        for r in range(size):
            rank = Axis("model", size, r, None)
            ci, ch = segment_index(cols, rank), segment_index(chans, rank)
            heads = slice(r * per, (r + 1) * per)
            pr = {"conv_w": p["conv_w"][:, ch], "conv_b": p["conv_b"][ch],
                  **{k: p[k][heads] for k in ("a_log", "dt_bias", "d_skip")}}
            y, h, c = ssm.mixer_heads(
                pr, zxbcdt.index_select(-1, ci), cfg, per,
                ssm_state=None if ssm_state is None else ssm_state[:, heads],
                conv_state=None if conv_state is None else conv_state.index_select(-1, ch),
                decode=decode)
            ys.append(y.to(torch.float32))
            states.append(h)
            convs.append(c)
        squares = None
        for y in ys:                    # each rank's squares, added in rank order
            sq = (y ** 2).sum(-1, keepdim=True)
            squares = sq if squares is None else squares + sq
        yf = torch.cat(ys, dim=-1)
        y = (yf * torch.rsqrt(squares / d_inner + 1e-6) * p["norm_scale"]).to(x.dtype)
        conv = torch.cat([c[..., :per * hd] for c in convs] + [convs[0][..., per * hd:]], -1)
        return (layers.dense(p["out_proj"], y, method=mm, impl=impl),
                torch.cat(states, dim=1), conv)

    layers._sdpa, moe._experts_partial, ssm.mamba2_mixer = \
        blocked_sdpa, blocked_partial, blocked_mixer
    try:
        yield
    finally:
        layers._sdpa, moe._experts_partial, ssm.mamba2_mixer = sdpa, partial, mixer


def config(case: str, method: str):
    arch, changes = CASES[case]
    return dataclasses.replace(get_config(arch).reduced(), matmul_method=method, **changes)


def generate(model, params, rows: slice = slice(None), mesh=None) -> dict:
    """`tests/test_torch_serve_mesh.py::generate` on the prompt's `rows`:
    prefill, then STEPS greedy serve steps; the logits of each, the tokens."""
    prompt = torch.from_numpy(prompt_of(model.cfg))[rows]
    caches = model.init_cache(prompt.shape[0], S_MAX)
    if mesh is not None:
        caches = shd.distribute_tree(caches, shd.cache_shardings(caches, model.cfg, mesh,
                                                                 multi_pod=False))
    logits, caches, _ = make_prefill_step(model, mesh)(params, {"tokens": prompt}, caches)
    out = {"logits": [logits]}
    tokens = [torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)]
    for i in range(STEPS):
        logits, caches = make_serve_step(model, seq_len=PROMPT + 1 + i, mesh=mesh)(
            params, tokens[-1], caches)
        tokens.append(torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32))
        out["logits"].append(logits)
    out["tokens"] = torch.cat(tokens, dim=1)
    out["caches"] = {path: shd.gather(t).detach() for path, t in tree_paths(caches)}
    return out


def cat_rows(parts: list[dict]) -> dict:
    return {"logits": [torch.cat(ls) for ls in zip(*(p["logits"] for p in parts))],
            "tokens": torch.cat([p["tokens"] for p in parts])}


def dp_generate(model, params, mesh) -> dict:
    """The unmeshed steps on this rank's rows of "data" with the abs-max of
    each activation over "data" (no "model" split), their logits and
    tokens gathered over "data": the row split alone."""
    from repro_torch.core import collectives as coll
    data = coll.mesh_axes(mesh)["data"]
    per = ROWS // data.size
    with coll.mesh_state(coll.MeshState(rows=(data,))):
        out = generate(model, params, slice(data.index * per, (data.index + 1) * per))
    return {"logits": [coll.all_gather(t, data, 0) for t in out["logits"]],
            "tokens": coll.all_gather(out["tokens"], data, 0)}


def serve_ranks(out_file: str, shape: tuple[int, int]) -> None:
    """Rank worker: every case and method unmeshed and on a `shape` mesh;
    rank 0 saves both and the collectives counted on the mesh."""
    import torch.distributed as dist
    mesh = make_host_mesh(data=shape[0], model=shape[1])
    results = {}
    for case in CASES:
        for method in METHODS:
            cfg = config(case, method)
            model = build_model(cfg, "cpu")
            params = model.init(torch.Generator("cpu").manual_seed(0))
            with blocked_oracle(cfg, mesh):
                want = generate(model, params)
                rows = dp_generate(model, params, mesh)
            p = shd.distribute_tree(params, shd.param_shardings(params, cfg, mesh,
                                                                multi_pod=False))
            shd.reset_collectives()
            got = generate(model, p, mesh=mesh)
            results[(case, method)] = {"want": want, "rows": rows, "got": got,
                                       "collectives": dict(shd.COLLECTIVES)}
    if dist.get_rank() == 0:
        torch.save(results, out_file)


@pytest.mark.parametrize("shape", ((1, 2), (2, 2)), ids=lambda s: f"{s[0]}x{s[1]}")
def test_tp_serve_steps_equal_the_unmeshed_steps(tmp_path, shape):
    out = str(tmp_path / "serve.pt")
    run_ranks(tmp_path, shape[0] * shape[1], f"m.serve_ranks({out!r}, {tuple(shape)!r})",
              timeout=240.0, module="test_torch_serve_tp")
    for (case, method), r in torch.load(out, weights_only=False).items():
        want, rows, got = r["want"], r["rows"], r["got"]
        for i, (g, w, wr) in enumerate(zip(got["logits"], want["logits"], rows["logits"])):
            assert g.shape == w.shape, (case, method, i)
            if method == "exact":
                torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5,
                                           msg=f"{case} {method} step {i}")
            else:
                assert torch.equal(g, wr), (case, method, i, float((g - wr).abs().max()))
                if shape[0] == 1:
                    assert torch.equal(g, w), (case, method, i)
        assert torch.equal(got["tokens"], want["tokens"]), (case, method)
        assert torch.equal(got["tokens"], rows["tokens"]), (case, method)
        coll = r["collectives"]
        # the row-parallel sums (and the embedding's over the vocab, the
        # Mamba2 norm's squares) over "model"
        assert coll.get("all_reduce_sum", 0) > 0, (case, method, coll)
        assert coll["all_gather"] > 0, (case, method, coll)
