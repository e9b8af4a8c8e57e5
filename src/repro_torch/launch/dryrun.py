"""Multi-pod dry-run: count one step of the port's own program for every
(arch x shape x mesh) cell on the production meshes, under fake tensors;
dump memory / cost / collective records.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all          # every runnable cell

Counterpart of `repro.launch.dryrun`, which lowers and compiles each cell
for 256 or 512 virtual devices and reads XLA's analyses. Here the cell's
step -- `make_train_step`, `make_prefill_step` or `make_serve_step` with
the mesh -- runs once as rank 0 of a "fake" process group of the
production mesh's world (`launch.mesh.fake_production_mesh`), on tensors
of a `FakeTensorMode`, under `roofline.analysis.StepCounter`: per-device
flops, bytes, collective bytes and the peak of live bytes, with nothing
allocated and nothing launched. The tensors are fake CUDA tensors where a
card is present, fake CPU tensors elsewhere; the quantized methods reach
the kernel wrappers either way (`impl='kernel'`), whose fake calls record
the kernels' work.

Every step computes on the reference's shards: the params stay sharded,
each layer gathers only its FSDP blocks ("data", and "pod" under
`fsdp_pod`) just before its forward, and computes on its "model" shard
where the rules split it in whole heads (attention's, Mamba2's), experts
or vocab columns (the record's `tensor_parallel` says, a layer kind at a
time, which did and which gathered a part whole:
`models.transformer.tp_report`; "none" where no layer kind has a rule, or
where the train step splits its rows over "model":
`runtime.sharding.batch_axes`). A layer's gathered block is freed after
it (under remat the recompute gathers again), so a rank's peak is its
blocks at rest plus about one layer gathered. The update runs on each
rank's blocks under either optimizer and with grad_compress
(`train_lib`): no grad, param or optimizer statistic is gathered whole.

A cell the port cannot run is an error record with the reason: the rows do
not split over the mesh (`train_lib.row_split`: a MoE layer's chunks), or
the rank's counted peak does not fit the card's memory (`fits_hbm`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import SHAPES, get_config, list_archs, supported_shapes
from repro_torch.launch.mesh import fake_production_mesh, make_production_mesh
from repro_torch.roofline.analysis import (StepCounter, analyze_step, memory_analysis_dict,
                                           model_flops)

#: the memory of an NVIDIA H100 80GB HBM3 as `torch.cuda.get_device_properties`
#: read it there (79.18 GiB), for a machine without a card
HBM_PER_CHIP = int(79.18 * 2**30)
CARD = "NVIDIA H100 80GB HBM3"


def card() -> dict:
    """The card the records are planned for: this machine's, else the H100's."""
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return {"name": props.name, "hbm_bytes": props.total_memory}
    return {"name": CARD, "hbm_bytes": HBM_PER_CHIP}


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def count_cell(cfg, shape, mesh=None, device: str | None = None):
    """(StepCounts, n_params) of one step of `cfg` at `shape`: the train,
    prefill or decode step on `mesh` (a `DeviceMesh` over a fake process
    group; unmeshed for None) under `FakeTensorMode`. `device` defaults to
    the mesh's type, else "cuda" where a card is present, else "cpu"."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.model import build_model, input_specs
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.serve_lib import make_prefill_step, make_serve_step
    from repro_torch.runtime.train_lib import make_train_state, make_train_step, multi_pod

    if device is None:
        device = mesh.device_type if mesh is not None else (
            "cuda" if torch.cuda.is_available() else "cpu")
    with FakeTensorMode():
        model = build_model(cfg, device, impl="kernel")
        gen = torch.Generator(device).manual_seed(0)
        if shape.kind == "train":
            state = make_train_state(model, gen, mesh)
            n_params = model.count_params(state.params)
            args = (state, input_specs(cfg, shape, device))
            step = make_train_step(model, mesh=mesh)
        else:
            params = model.init(gen)
            n_params = model.count_params(params)
            caches = model.init_cache(shape.global_batch, shape.seq_len)
            if mesh is not None:
                mp = multi_pod(mesh)
                params = shd.distribute_tree(
                    params, shd.param_shardings(params, cfg, mesh, multi_pod=mp))
                caches = shd.distribute_tree(
                    caches, shd.cache_shardings(caches, cfg, mesh, multi_pod=mp))
            batch = input_specs(cfg, shape, device)
            if shape.kind == "prefill":
                args = (params, batch, caches)
                step = make_prefill_step(model, mesh=mesh)
            else:
                args = (params, batch["tokens"], caches)
                step = make_serve_step(model, seq_len=shape.seq_len, mesh=mesh)
        counter = StepCounter()
        counter.track_inputs(args)
        with counter:
            out = step(*args)
        counter.track_outputs(out)
    return counter.counts(), n_params


def param_bytes(cfg) -> int:
    """The bytes of `cfg`'s params whole (float32), from a fake init."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.tree import tree_paths
    from repro_torch.models.model import build_model
    with FakeTensorMode():
        params = build_model(cfg, "cpu").init(torch.Generator("cpu"))
        return sum(t.numel() * t.element_size() for _, t in tree_paths(params))


def train_state_bytes(cfg, mesh) -> int:
    """Each rank's bytes of `cfg`'s train state at rest on `mesh` (a
    shape-only production mesh or a `DeviceMesh`), from its specs alone,
    with no trace: a dim split over axes of n ranks in all holds
    ceil(dim / n) of its elements, as XLA pads."""
    import math

    from repro_torch.core.tree import tree_paths
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.elastic import abstract_train_state, state_shardings
    state = abstract_train_state(cfg)
    specs = dict(tree_paths(state_shardings(state, cfg, mesh,
                                            multi_pod="pod" in mesh.mesh_dim_names)))
    sizes = shd.axis_sizes(mesh)
    total = 0
    for path, t in tree_paths(state):
        spec = specs[path].spec
        n = 1
        for d, dim in enumerate(t.shape):
            split = math.prod(sizes[a] for a in shd.spec_axes(spec[d]))
            n *= -(-dim // split)
        total += n * t.element_size()
    return total


def cell_config(arch: str, shape_name: str, overrides: dict | None = None,
                shape_overrides: dict | None = None):
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    if shape_overrides:
        shape = dataclasses.replace(shape, **shape_overrides)
    return cfg, shape


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               overrides: dict | None = None,
               shape_overrides: dict | None = None):
    """Returns (counts, report, meta) for one dry-run cell."""
    from repro_torch.models.transformer import tp_report
    from repro_torch.runtime.sharding import activation_sharding_ctx, batch_axes
    cfg, shape = cell_config(arch, shape_name, overrides, shape_overrides)
    with fake_production_mesh(multi_pod) as mesh:
        counts, n_params = count_cell(cfg, shape, mesh)
        chips = mesh.size()
        rows = (batch_axes(cfg, mesh, shape.global_batch // cfg.microbatches,
                           multi_pod=multi_pod) if shape.kind == "train" else None)
        with activation_sharding_ctx(mesh, cfg, multi_pod=multi_pod, rows=rows):
            tp = tp_report(cfg) or "none"
    meta = {"arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod),
            "chips": chips, "n_params": n_params, "tensor_parallel": tp,
            "model_flops": model_flops(cfg, n_params, shape), "card": card()}
    if shape.kind == "train":
        meta["state_bytes"] = train_state_bytes(cfg, make_production_mesh(multi_pod=multi_pod))
    report = analyze_step(counts, model_flops_val=meta["model_flops"], chips=chips)
    return counts, report, meta


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, out_dir: str,
             overrides: dict | None = None, tag: str = "") -> dict:
    """One cell's record, written to `out_dir`. `compile_s` is the host
    seconds of the count (building the fake state and tracing the step),
    not a compile: nothing is compiled."""
    t0 = time.perf_counter()
    try:
        counts, report, meta = lower_cell(arch, shape_name, multi_pod=multi_pod,
                                          overrides=overrides)
        mem = memory_analysis_dict(counts)
        per_dev_bytes = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        fits = per_dev_bytes <= meta["card"]["hbm_bytes"]
        rec = {
            **meta, "tag": tag, "status": "ok" if fits else "error",
            "compile_s": round(time.perf_counter() - t0, 1),
            "memory_analysis": mem,
            "fits_hbm": fits,
            "roofline": report.to_json(),
            "counts": counts.to_json(),
        }
        if not fits:
            rec["error"] = (f"fits_hbm: a rank's peak {per_dev_bytes / 2**30:.2f} GiB > the "
                            f"card's {meta['card']['hbm_bytes'] / 2**30:.2f} GiB")
    except Exception as e:                         # noqa: BLE001 - report, don't die
        rec = {"arch": arch, "shape": shape_name,
               "mesh": mesh_name(multi_pod),
               "tag": tag, "status": "error",
               "compile_s": round(time.perf_counter() - t0, 1),
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(out_dir,
                        f"{arch}__{shape_name}__{rec['mesh']}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/torch_dryrun")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args()

    archs = list_archs() if args.arch in ("all",) else [args.arch]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    n_ok = n_err = n_skip = 0
    for arch in archs:
        cfg = get_config(arch)
        support = supported_shapes(cfg)
        shapes = list(SHAPES) if args.shape == "all" else [args.shape]
        for shape_name in shapes:
            if support[shape_name] != "ok":
                print(f"SKIP {arch} {shape_name}: {support[shape_name]}")
                n_skip += 1
                continue
            for mp in meshes:
                rec = run_cell(arch, shape_name, multi_pod=mp, out_dir=args.out)
                if rec["status"] == "ok":
                    n_ok += 1
                    r = rec["roofline"]
                    print(f"OK   {arch} {shape_name} {rec['mesh']} "
                          f"compile={rec['compile_s']}s "
                          f"flops/dev={r['flops']:.3e} "
                          f"coll={r['coll_bytes']:.3e}B "
                          f"bottleneck={r['bottleneck']}")
                    ma = rec.get("memory_analysis") or {}
                    if ma.get("argument_size_in_bytes"):
                        print(f"     memory: args={ma['argument_size_in_bytes']:.3e} "
                              f"temp={ma.get('temp_size_in_bytes', 0):.3e} "
                              f"fits_hbm={rec['fits_hbm']}")
                else:
                    n_err += 1
                    print(f"FAIL {arch} {shape_name} {rec['mesh']}: {rec['error']}")
    print(f"\ndry-run summary: ok={n_ok} fail={n_err} skipped-cells={n_skip}")
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
