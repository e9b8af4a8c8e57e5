"""The meshed serve steps (`runtime.serve_lib.make_prefill_step` /
`make_serve_step` with a `mesh`) against the unmeshed ones, on gloo ranks
on the CPU.

A prompt of 4 rows x 8 tokens is prefilled, then 3 greedy decode steps
follow (`make_serve_step` at seq_len 9, 10, 11: one token against a cache
of that depth), for the reduced qwen2-0.5b (GQA caches split over "model"),
deepseek-v3-671b (MLA latent caches, a MoE layer; `moe_seq_chunk` 2, so
that a rank's rows are whole chunks at decode) and zamba2-1.2b (Mamba2
states with a "tp" dim split over "model"), under exact and mitchell. The
params rest sharded by `param_shardings`, the caches by `cache_shardings`.

  * (1, 1), one rank: the logits of every step, the greedy tokens and the
    caches (gathered whole) byte-equal to the unmeshed steps';
  * (2, 2), four ranks (float32): the logits within 1e-5 of the largest
    |logit|, the greedy tokens equal, the caches within 1e-5 of their
    largest value; the collectives counted (the params' all-gathers);
  * on both meshes, reduced qwen2-0.5b on the reference's params
    (`convert.from_reference_lm_params`) against the reference package's
    own prefill and `make_serve_step` on the same prompt, each decode step
    fed the reference's greedy token: under exact the logits within rtol
    1e-4 / atol 1e-5 (tests/test_torch_lm.py's serve-step tolerance) and
    the greedy tokens equal; under mitchell (the reference's LNS route
    sums in float32, R5) the logits within QUANT_TOL of the largest
    |logit|, the reference's token within that of the port's top logit
    at every step, and at least 3 in 4 greedy tokens equal
    (tests/test_torch_lm.py's teacher-forced check).

The ranks are this module's `serve_ranks` in processes of their own
(`tests/test_torch_train_mesh.py::run_ranks`, a `file://` rendezvous in
the test's tmp_path). The reference runs in the test's own process.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.tree import tree_paths
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.serve_lib import make_prefill_step, make_serve_step
from test_torch_train_mesh import run_ranks

ARCHS = ("qwen2-0.5b", "deepseek-v3-671b", "zamba2-1.2b")
METHODS = ("exact", "mitchell")
ROWS, PROMPT, STEPS, S_MAX = 4, 8, 3, 16
RTOL = 1e-5
#: the arch run on the reference's params, against the reference's steps
REF_ARCH = "qwen2-0.5b"
#: max |port - reference| / max |reference| of mitchell logits (test_torch_lm)
QUANT_TOL = 5e-2


def config(arch: str, method: str):
    changes = {"matmul_method": method}
    if arch == "deepseek-v3-671b":
        changes["moe_seq_chunk"] = 2
    return dataclasses.replace(get_config(arch).reduced(), **changes)


def prompt_of(cfg) -> np.ndarray:
    return np.random.default_rng(7).integers(0, cfg.vocab_size, (ROWS, PROMPT),
                                             dtype=np.int64)


def generate(model, params, caches, mesh=None, feed: torch.Tensor | None = None) -> dict:
    """Prefill, then STEPS serve steps, each fed the greedy token of the
    step before, or with `feed` ((ROWS, STEPS + 1) tokens) its column: the
    logits of each, the greedy tokens and the caches after the last."""
    prompt = torch.from_numpy(prompt_of(model.cfg))
    logits, caches, cache_len = make_prefill_step(model, mesh)(params, {"tokens": prompt},
                                                               caches)
    out = {"logits": [logits], "cache_len": cache_len}
    tokens = [torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)]
    for i in range(STEPS):
        step = make_serve_step(model, seq_len=PROMPT + 1 + i, mesh=mesh)
        tok = tokens[-1] if feed is None else feed[:, i:i + 1]
        logits, caches = step(params, tok, caches)
        tokens.append(torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32))
        out["logits"].append(logits)
    out["tokens"] = torch.cat(tokens, dim=1)
    out["caches"] = {path: shd.gather(t).detach() for path, t in tree_paths(caches)}
    return out


@functools.lru_cache(maxsize=None)
def reference_params():
    """The reference's params of reduced REF_ARCH at PRNGKey(0), drawn once
    a process (the matmul method does not enter the init)."""
    import jax

    from repro.configs import get_config as ref_get_config
    from repro.models.model import build_model as ref_build_model
    return ref_build_model(ref_get_config(REF_ARCH).reduced()).init(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def reference_run(method: str) -> dict:
    """The reference package on reduced REF_ARCH at PRNGKey(0): its params
    carried to the port, and its own prefill and STEPS `make_serve_step`
    steps on `prompt_of`'s prompt, greedy: the logits of each step and the
    (ROWS, STEPS + 1) tokens."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.models.model import build_model as ref_build_model
    from repro.runtime.serve_lib import make_serve_step as ref_make_serve_step
    from repro_torch.convert import from_reference_lm_params

    ref_cfg = dataclasses.replace(ref_get_config(REF_ARCH).reduced(), matmul_method=method)
    ref_model = ref_build_model(ref_cfg)
    ref_params = reference_params()
    cfg = config(REF_ARCH, method)
    logits, caches, _ = ref_model.prefill(
        ref_params, {"tokens": jnp.asarray(prompt_of(cfg), dtype=jnp.int32)},
        ref_model.init_cache(ROWS, S_MAX))
    out_logits, tokens = [np.asarray(logits)], []
    for i in range(STEPS + 1):
        tokens.append(jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32))
        if i < STEPS:
            logits, caches = ref_make_serve_step(ref_model, seq_len=PROMPT + 1 + i)(
                ref_params, tokens[-1], caches)
            out_logits.append(np.asarray(logits))
    return {"params": from_reference_lm_params(jax.tree.map(np.asarray, ref_params), cfg,
                                               "cpu"),
            "logits": out_logits,
            "tokens": torch.from_numpy(np.array(jnp.concatenate(tokens, axis=1)))}


def serve_ranks(out_file: str, shape: tuple[int, int], ref_file: str) -> None:
    """Rank worker: every arch and method unmeshed and on a `shape` mesh,
    then REF_ARCH on the reference's params (`ref_file`, by method) on the
    mesh, fed the reference's tokens; rank 0 saves them all and the
    collectives counted on the mesh."""
    import torch.distributed as dist
    mesh = make_host_mesh(data=shape[0], model=shape[1])
    reference = torch.load(ref_file, weights_only=False)
    results = {}

    def on_mesh(cfg, model, params, feed=None):
        p = shd.distribute_tree(params, shd.param_shardings(params, cfg, mesh,
                                                            multi_pod=False))
        caches = model.init_cache(ROWS, S_MAX)
        c = shd.distribute_tree(caches, shd.cache_shardings(caches, cfg, mesh,
                                                            multi_pod=False))
        shd.reset_collectives()
        got = generate(model, p, c, mesh, feed)
        return got, dict(shd.COLLECTIVES), {path: shd.spec_of(t) for path, t in tree_paths(c)}

    for arch in ARCHS:
        for method in METHODS:
            cfg = config(arch, method)
            model = build_model(cfg, "cpu")
            params = model.init(torch.Generator("cpu").manual_seed(0))
            want = generate(model, params, model.init_cache(ROWS, S_MAX))
            got, coll, split = on_mesh(cfg, model, params)
            results[(arch, method)] = {"want": want, "got": got, "collectives": coll,
                                       "split": split}
    for method in METHODS:
        cfg = config(REF_ARCH, method)
        ref = reference[method]
        got, _, _ = on_mesh(cfg, build_model(cfg, "cpu"), ref["params"], ref["tokens"])
        results[("reference", method)] = got
    if dist.get_rank() == 0:
        torch.save(results, out_file)


def run(tmp_path, shape) -> dict:
    out, ref_file = str(tmp_path / "serve.pt"), str(tmp_path / "reference.pt")
    reference = {method: reference_run(method) for method in METHODS}
    torch.save(reference, ref_file)
    run_ranks(tmp_path, shape[0] * shape[1],
              f"m.serve_ranks({out!r}, {tuple(shape)!r}, {ref_file!r})",
              timeout=240.0, module="test_torch_serve_mesh")
    results = torch.load(out, weights_only=False)
    check_against_the_reference(results, reference)
    return {key: r for key, r in results.items() if key[0] != "reference"}


def check_against_the_reference(results: dict, reference: dict) -> None:
    """REF_ARCH's meshed steps on the reference's params, fed its tokens,
    against the reference's own steps (module docstring)."""
    for method in METHODS:
        got, ref = results[("reference", method)], reference[method]
        want_tokens = ref["tokens"].numpy()
        assert len(got["logits"]) == len(ref["logits"]) == STEPS + 1
        agree = 0
        for i, (g, w) in enumerate(zip(got["logits"], ref["logits"])):
            g = g.numpy()
            assert g.shape == w.shape, (method, i)
            if method == "exact":
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=f"step {i}")
                continue
            assert np.abs(g - w).max() <= QUANT_TOL * np.abs(w).max(), (method, i)
            last = g[:, -1]
            picked = np.take_along_axis(last, want_tokens[:, i:i + 1].astype(np.int64), 1)[:, 0]
            assert (last.max(-1) - picked <= QUANT_TOL * np.abs(last).max()).all(), (method, i)
            agree += int((last.argmax(-1) == want_tokens[:, i]).sum())
        if method == "exact":
            np.testing.assert_array_equal(got["tokens"].numpy(), want_tokens)
        else:
            assert agree >= 0.75 * want_tokens.size, f"{agree} of {want_tokens.size} agree"


def test_serve_steps_on_1x1_equal_the_unmeshed_steps(tmp_path):
    for (arch, method), r in run(tmp_path, (1, 1)).items():
        want, got = r["want"], r["got"]
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            assert torch.equal(g, w), (arch, method, i)
        assert torch.equal(got["tokens"], want["tokens"]), (arch, method)
        assert torch.equal(got["cache_len"], want["cache_len"])
        assert got["caches"].keys() == want["caches"].keys()
        for path in want["caches"]:
            assert torch.equal(got["caches"][path], want["caches"][path]), (arch, path)


def close(got: torch.Tensor, want: torch.Tensor) -> bool:
    scale = float(want.abs().max()) or 1.0
    return float((got - want).abs().max()) <= RTOL * scale


def test_serve_steps_on_2x2_ranks(tmp_path):
    for (arch, method), r in run(tmp_path, (2, 2)).items():
        want, got = r["want"], r["got"]
        assert got["logits"][0].dtype == torch.float32
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            assert g.shape == w.shape and close(g, w), (arch, method, i)
        assert torch.equal(got["tokens"], want["tokens"]), (arch, method)
        for path in want["caches"]:
            assert close(got["caches"][path], want["caches"][path]), (arch, method, path)
        # rows over "data"; a cache with a heads / "tp" dim over "model" too
        splits = set(r["split"].values())
        assert all(spec[0] == "data" for spec in splits), splits
        if arch != "deepseek-v3-671b":
            assert any("model" in spec[1:] for spec in splits), (arch, splits)
        coll = r["collectives"]
        assert coll["all_gather"] > 0
        assert (coll.get("all_reduce_max", 0) > 0) == (method == "mitchell"), coll


def test_moe_decode_refuses_rows_that_split_a_chunk():
    """On the fake (16, 16) mesh: deepseek's decode of 32 rows at
    moe_seq_chunk 16 gives a rank 2 tokens of a 16-token chunk: refused
    before any collective."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import fake_production_mesh
    cfg = dataclasses.replace(get_config("deepseek-v3-671b").reduced(), moe_seq_chunk=16)
    with fake_production_mesh() as mesh, FakeTensorMode():
        model = build_model(cfg, "cpu")
        params = model.init(torch.Generator("cpu"))
        caches = model.init_cache(32, S_MAX)
        with pytest.raises(ValueError, match="MoE chunks"):
            make_serve_step(model, seq_len=S_MAX, mesh=mesh)(
                params, torch.zeros((32, 1), dtype=torch.int32), caches)
