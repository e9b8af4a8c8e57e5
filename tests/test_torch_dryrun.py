"""The port's dry-run (`repro_torch.launch.dryrun`) and roofline runner
(`repro_torch.roofline.runner`), on the CPU: one step of the port's own
program counted on fake tensors over a fake process group of the mesh's
world (`launch.mesh.fake_production_mesh`, entered and left inside each
test, or in a subprocess, so no worker keeps a group).

  * the CLI in a subprocess, qwen2-0.5b decode_32k on both production
    meshes: `ok=2 fail=0`, exit 0, records with the reference's keys
    (`repro.launch.dryrun.run_cell`'s, its report's and its memory
    analysis's);
  * a cell that still fails: deepseek-v3-671b decode_32k on (16, 16),
    whose 8 rows a rank are not whole chunks of the 128-token MoE chunk
    (train_4k on (2, 16, 16), which this test named when every rank took
    its own rows, now splits its rows over ("pod", "data") only and
    plans), an error record with `row_split`'s reason, and exit 1;
  * each rank's train-state bytes at rest on both production meshes, for
    every arch at its full config, from the specs alone (no trace): equal
    to the bytes of the reference's specs over the reference's abstract
    state (`jax.eval_shape`), a split dim holding ceil(dim / n) elements;
    and a traced step's argument bytes equal them plus the batch's;
  * counted flops, bytes and collective bytes of the reduced qwen2 train
    step (exact and mitchell; 256 rows x 16 tokens) on the fake (16, 16)
    mesh at 1, 2 and 8 layers:
    f(8) = f(1) + 7 (f(2) - f(1)) within 1e-9 relative (the reference's
    test_extrapolation_matches_full_unroll);
  * the same affinity for the real counts of the families the runner
    extrapolates, reduced deepseek-v3 (MoE layers) and xlstm-1.3b (sLSTM
    periods), which it picks by structure;
  * the runner's layer extrapolation on every family's layer pattern,
    against a count that is affine in the per-kind layer counts; a whole
    cell's record with the reference's keys.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import dryrun as ref_dryrun
from repro.models.model import build_model as ref_build_model
from repro.roofline import analysis as ref_analysis
from repro.runtime import sharding as ref_shd
from repro.runtime.train_lib import make_train_state as ref_make_train_state
from repro_torch.configs import ShapeConfig, get_config, list_archs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_production_mesh, make_production_mesh
from repro_torch.roofline import runner

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
#: `repro.launch.dryrun.run_cell`'s record keys (an "ok" record)
REF_RECORD_KEYS = {"arch", "shape", "mesh", "chips", "n_params", "model_flops", "tag",
                   "status", "compile_s", "memory_analysis", "fits_hbm", "roofline"}
REF_MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
                   "generated_code_size_in_bytes", "alias_size_in_bytes"}
REF_OPT_KEYS = ("m", "v", "vr", "vc", "mu", "nu", "count", "ef")


def test_reference_record_keys_are_these():
    """The key sets above are the reference's (read from its source)."""
    import inspect
    src = inspect.getsource(ref_dryrun.run_cell)
    assert all(f'"{k}"' in src for k in REF_RECORD_KEYS - {"arch", "shape", "mesh", "chips",
                                                          "n_params", "model_flops"})
    assert all(f'"{k}"' in inspect.getsource(ref_analysis.memory_analysis_dict)
               for k in REF_MEMORY_KEYS)


def test_cli_decode_32k_both_meshes(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen2-0.5b",
         "--shape", "decode_32k", "--mesh", "both", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": SRC})
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    assert "ok=2 fail=0" in out.stdout
    ref_report = {f.name for f in dataclasses.fields(ref_analysis.RooflineReport)}
    for mesh, chips in (("pod16x16", 256), ("pod2x16x16", 512)):
        rec = json.load(open(tmp_path / f"qwen2-0.5b__decode_32k__{mesh}.json"))
        assert REF_RECORD_KEYS <= set(rec) and rec["status"] == "ok"
        assert set(rec["roofline"]) == ref_report
        assert set(rec["memory_analysis"]) == REF_MEMORY_KEYS
        assert rec["chips"] == chips and rec["fits_hbm"] is True
        r = rec["roofline"]
        assert r["flops"] > 0 and r["hbm_bytes"] > 0 and r["coll_breakdown"]["all-gather"] > 0
        assert r["model_flops"] == 2.0 * rec["n_params"] * 128
        assert rec["card"]["hbm_bytes"] > 0


def test_train_4k_on_the_multi_pod_mesh_is_an_error_record(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "deepseek-v3-671b",
                                      "--shape", "decode_32k", "--mesh", "single",
                                      "--out", str(tmp_path)])
    with pytest.raises(SystemExit) as exit_:
        dryrun.main()
    assert exit_.value.code == 1
    assert "ok=0 fail=1" in capsys.readouterr().out
    rec = json.load(open(tmp_path / "deepseek-v3-671b__decode_32k__pod16x16.json"))
    assert rec["status"] == "error" and "MoE chunks" in rec["error"]


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape


def ref_state_bytes(arch: str, multi_pod: bool) -> int:
    """Each rank's bytes of the reference's train state at rest, from its
    specs (its `state_shardings`' rules) over its abstract state."""
    import math
    cfg = ref_get_config(arch)
    model = ref_build_model(cfg)
    state = jax.eval_shape(lambda r: ref_make_train_state(model, r), jax.random.PRNGKey(0))
    mesh = FakeMesh(make_production_mesh(multi_pod=multi_pod).shape)
    rules = ref_shd.logical_rules(cfg, multi_pod)
    total = 0

    def add(strip):
        def one(path, leaf):
            nonlocal total
            names = tuple(n for n in (ref_shd._path_name(p) for p in path) if n not in strip)
            spec = ref_shd._resolve(ref_shd._param_logical(names, len(leaf.shape)),
                                    leaf.shape, rules, mesh)
            n = 1
            for dim, entry in zip(leaf.shape, tuple(spec) + (None,) * leaf.ndim):
                axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
                n *= -(-dim // math.prod(mesh.shape[a] for a in axes))
            total += n * leaf.dtype.itemsize
        return one
    jax.tree_util.tree_map_with_path(add(()), state.params)
    jax.tree_util.tree_map_with_path(add(REF_OPT_KEYS), state.opt)
    if state.ef is not None:
        jax.tree_util.tree_map_with_path(add(()), state.ef)
    return total + state.step.dtype.itemsize


@pytest.mark.parametrize("arch", list_archs())
def test_train_state_bytes_at_rest_equal_the_reference_specs(arch):
    for multi_pod in (False, True):
        got = dryrun.train_state_bytes(get_config(arch), make_production_mesh(multi_pod=multi_pod))
        assert got == ref_state_bytes(arch, multi_pod), (arch, multi_pod)


TRAIN = ShapeConfig("train_small", 16, 256, "train")


def counted(layers: int, method: str, arch: str = "qwen2-0.5b"):
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=layers,
                              matmul_method=method)
    with fake_production_mesh() as mesh:
        counts, _ = dryrun.count_cell(cfg, TRAIN, mesh)
        state_bytes = dryrun.train_state_bytes(cfg, mesh)
    batch_bytes = 2 * TRAIN.global_batch * TRAIN.seq_len * 4          # tokens, labels
    assert counts.argument_bytes == state_bytes + batch_bytes
    return counts


@pytest.mark.parametrize("method", ["exact", "mitchell"])
def test_counts_are_affine_in_the_layers(method):
    f1, f2, f8 = (counted(n, method) for n in (1, 2, 8))
    terms = {"flops": lambda c: c.flops, "hbm_bytes": lambda c: c.hbm_bytes,
             "coll_bytes": lambda c: sum(v for k, v in c.collectives.items()
                                         if k.endswith("_bytes"))}
    for name, term in terms.items():
        want = term(f1) + 7 * (term(f2) - term(f1))
        assert abs(term(f8) - want) <= 1e-9 * term(f8), (name, term(f8), want)
        assert term(f2) > term(f1) > 0, name
    if method == "mitchell":
        assert f8.kernels["mitchell_matmul"]["calls"] == 8 * 7


#: the archs `runner.layer_extrapolated` picks -> (depths d0, d1, d2, k): the
#: kind the runner extrapolates over grows by 1 from d0 to d1 and by k to d2
#: (deepseek-v3: one dense layer, then 1, 2 and 4 MoE layers; xlstm-1.3b: 1, 2
#: and 3 periods of an mLSTM and an sLSTM layer)
EXTRAPOLATED_DEPTHS = {"deepseek-v3-671b": (2, 3, 5, 3), "xlstm-1.3b": (2, 4, 6, 2)}


@pytest.mark.parametrize("arch", sorted(EXTRAPOLATED_DEPTHS))
def test_counts_are_affine_in_the_layers_of_the_extrapolated_families(arch):
    """The real counts of the families the runner extrapolates (MoE,
    sLSTM), on the fake (16, 16) mesh: f(d2) = f(d0) + k (f(d1) - f(d0))
    within 1e-9 relative, as `_layer_extrapolated` assumes."""
    assert runner.layer_extrapolated(get_config(arch))
    *depths, k = EXTRAPOLATED_DEPTHS[arch]
    f0, f1, f2 = (counted(n, "exact", arch) for n in depths)
    for name in ("flops", "hbm_bytes", "coll_bytes"):
        term = (lambda c: sum(v for key, v in c.collectives.items() if key.endswith("_bytes"))) \
            if name == "coll_bytes" else (lambda c: getattr(c, name))
        want = term(f0) + k * (term(f1) - term(f0))
        assert abs(term(f2) - want) <= 1e-9 * term(f2), (name, term(f2), want)
        assert term(f1) > term(f0) > 0, name


def test_layer_extrapolated_is_the_moe_and_slstm_configs():
    picked = {arch for arch in list_archs() if runner.layer_extrapolated(get_config(arch))}
    assert picked == {"deepseek-v3-671b", "kimi-k2-1t-a32b", "xlstm-1.3b"}


@pytest.mark.parametrize("arch", list_archs())
def test_layer_extrapolation_on_each_family(arch, monkeypatch):
    """`_layer_extrapolated` from a count that is affine in the number of
    layers of each kind (with a base) gives the true depth's count."""
    marginal = {"attn": 3.0, "moe": 11.0, "mamba2": 5.0, "mlstm": 7.0, "slstm": 13.0,
                "attn_cross": 17.0}

    def fake_lower(arch_, shape, ov, multi_pod=False, shape_ov=None):
        cfg = dataclasses.replace(get_config(arch_), **ov)
        v = 100.0 + sum(marginal[k] for k in cfg.block_kinds())
        return {"flops": v, "hbm_bytes": 2 * v, "coll_bytes": 3 * v, "compute_s": v / 7}

    monkeypatch.setattr(runner, "_lower_terms", fake_lower)
    got = runner._layer_extrapolated(arch, "train_4k", {})
    want = fake_lower(arch, "train_4k", {})
    assert got == pytest.approx(want, rel=1e-12)


def test_roofline_cell_record(monkeypatch):
    rec = runner.roofline_cell("qwen2-0.5b", "decode_32k")
    ref_keys = {"arch", "shape", "chips", "n_params", "model_flops", "flops_per_dev",
                "hbm_bytes_per_dev", "coll_bytes_per_dev", "compute_s", "memory_s",
                "collective_s", "bottleneck", "useful_ratio", "roofline_fraction"}
    assert ref_keys <= set(rec) and rec["counted"] == "whole"
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert 0 < rec["roofline_fraction"] < 1 and rec["flops_per_dev"] > 0
    assert rec["n_params"] == 494_032_768
