"""Logical-axis sharding rules -> per-leaf specs and DTensor placements for
params, optimizer state, caches and batches; the context that splits the
meshed steps' compute.

Counterpart of `repro.runtime.sharding`, with its rules copied as plain
Python (DESIGN.md §6): batch over ("pod", "data"), parameters FSDP-sharded
over "data" (and "pod" for the 340B+ configs) on their "embed"-like dim and
over "model" on their heads / mlp / vocab / expert dim. Logical axes come
from the parameter's tree path and resolve to mesh axes with the
reference's divisibility fallback: a dim that does not divide by its
mesh-axis product drops trailing axes until it does, and a mesh axis is
never used twice in one spec.

A spec is a tuple with one entry a dim: None, a mesh-axis name, or a tuple
of names (the dim split over their product, the first axis major), the
counterpart of a `PartitionSpec`. It resolves against anything whose
`.shape` maps axis names to sizes (`repro_torch.launch.mesh`'s shape-only
production meshes) or against a named `DeviceMesh`; `placements` turns it
into the DTensor placements of a `DeviceMesh`.

The trees are the port's. Keys and shapes are the reference's: a
per-layer parameter takes the spec of its stacked leaf (`optimizers.Group`
key and shape) less the leading "layers" entry, which is never sharded; the
optimizer state and the error-feedback residual keep the stacked shapes and
take the spec as it is. A per-layer cache the same, from the reference's
stacked cache.

The collectives (`all_reduce`, `gather`, and `core.collectives`' axis
collectives) are counted in `core.collectives.COLLECTIVES` by kind: calls
and bytes, where a gather's bytes are the whole tensor it assembles and an
all-reduce's the tensor it reduces.

`activation_sharding_ctx(mesh, cfg, multi_pod=...)` is what the reference
plants its activation constraints under, and here it does the work of its
`shard_hint`s: it tells the layers how the step is split
(`core.collectives.MeshState`): the axes the batch rows split over (the
rules' "batch" axes by default), the "model" axis the layers compute on
their shard of (tensor parallel over heads, MLP and vocab, expert parallel
over the experts; none under `prefer_dp`, whose rules fold "model" into
batch and FSDP), and the layouts of the params' local blocks, which each
layer gathers just before its forward (`core.collectives.fsdp_gather`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import collectives as coll
from repro_torch.core.collectives import (
    COLLECTIVES,
    all_reduce,
    count_collective,
    reset_collectives,
)

Spec = tuple


# logical-name -> candidate mesh-axis tuples, tried in order (first divisible
# prefix wins; empty tuple = replicate).
def logical_rules(cfg, multi_pod: bool) -> dict[str | None, tuple[str, ...]]:
    if multi_pod:
        fsdp = (("pod", "data") if cfg.fsdp_pod else ("data",)) if cfg.fsdp else ()
        batch = ("pod", "data")
    else:
        fsdp = ("data",) if cfg.fsdp else ()
        batch = ("data",)
    vocab = ("model",) if cfg.emb_vocab_sharded else ()
    if cfg.prefer_dp:
        # archs whose head counts do not divide the model axis (xlstm H=4):
        # batch and params shard over (data, model); no tensor parallelism
        batch = batch + ("model",)
        fsdp = (fsdp + ("model",)) if cfg.fsdp else ()
        return {"embed": fsdp, "tp": (), "expert": (), "vocab": (),
                "batch": batch, "seq": (), "layers": (), None: ()}
    return {
        "embed": fsdp,          # FSDP dim
        "tp": ("model",),       # tensor-parallel dim (heads/mlp/vocab)
        "expert": ("model",),   # expert-parallel dim
        "vocab": vocab,         # embedding-table row dim
        "batch": batch,
        "seq": (),              # sequence stays unsharded
        "layers": (),           # stacked leading axis
        None: (),
    }


# --------------------------------------------------------- logical specs ----
_TP_OUT = ("wq", "wk", "wv", "wq_a", "wq_b", "wkv_a", "wkv_b", "up_proj",
           "in_proj", "w_in", "w_if", "wi", "wg", "head", "frame_proj",
           "img_proj")
_TP_IN = ("wo", "down_proj", "out_proj", "w_out")

#: optimizer-state wrapper keys, stripped from a path before its logical axes
_OPT_KEYS = ("m", "v", "vr", "vc", "mu", "nu", "count", "ef")


def _param_logical(path: tuple[str, ...], ndim: int) -> tuple[str | None, ...]:
    """Logical axes for one parameter leaf, from its tree path."""
    names = [p for p in path if not p.isdigit()]
    if not names:                        # e.g. optimizer "count" scalar
        return tuple(None for _ in range(ndim))
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    inside_layers = "segments" in names
    key = parent if leaf in ("w", "b") else leaf   # nearest named ancestor
    if key == "emb":
        base: tuple[str | None, ...] = ("vocab", "embed")
    elif key == "router":
        base = ("embed", None)
    elif key in ("wi", "wg") and ndim - (2 if not inside_layers else 3) >= 1:
        base = ("expert", "embed", None)         # stacked experts (E, D, F)
    elif key == "wo" and ndim - (2 if not inside_layers else 3) >= 1:
        base = ("expert", None, "embed")
    elif key in _TP_OUT:
        base = ("embed", "tp") if leaf != "b" else ("tp",)
    elif key in _TP_IN:
        base = ("tp", "embed") if leaf != "b" else (None,)
    elif key == "conv_w":
        base = (None, "tp")
    elif key in ("a_log", "dt_bias", "d_skip"):
        base = ("tp",)
    elif key == "r_rec":
        base = ("tp", None, None)
    else:
        base = tuple(None for _ in range(ndim))
    if inside_layers:
        base = ("layers", *base)
    if len(base) < ndim:
        base = base + tuple(None for _ in range(ndim - len(base)))
    return base[:ndim]


_CACHE_LOGICAL = {
    "k": ("batch", "seq", "tp", None),
    "v": ("batch", "seq", "tp", None),
    "k_img": ("batch", "seq", "tp", None),
    "v_img": ("batch", "seq", "tp", None),
    "c_kv": ("batch", "seq", None),
    "k_rope": ("batch", "seq", None, None),
    "ssm": ("batch", "tp", None, None),
    "conv": ("batch", None, "tp"),
    "c": ("batch", "tp", None, None),
    "n": ("batch", "tp", None),
    "m": ("batch", "tp"),
    "h": ("batch", "tp", None),
}


def _cache_logical(path: tuple[str, ...], ndim: int) -> tuple[str | None, ...]:
    leaf = path[-1] if path else ""
    base = _CACHE_LOGICAL.get(leaf, tuple(None for _ in range(ndim - 1)))
    base = ("layers", *base)                     # stacked per-segment axis
    if len(base) < ndim:
        base = base + tuple(None for _ in range(ndim - len(base)))
    return base[:ndim]


# ------------------------------------------------------------- resolver -----
def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a named `DeviceMesh` or a shape-only mesh."""
    if hasattr(mesh, "mesh_dim_names") and not isinstance(mesh.shape, dict):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def _resolve(logical: tuple[str | None, ...], shape: tuple[int, ...],
             rules: dict, mesh) -> Spec:
    sizes = axis_sizes(mesh)
    used: set[str] = set()
    out: list = []
    for name, dim in zip(logical, shape):
        pick: list[str] = []
        prod = 1
        for ax in rules.get(name, ()):
            if ax in used:
                break
            if dim % (prod * sizes[ax]) == 0:
                pick.append(ax)
                prod *= sizes[ax]
            else:
                break
        used.update(pick)
        out.append(tuple(pick) if len(pick) > 1 else (pick[0] if pick else None))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's spec on a mesh: the `NamedSharding` counterpart (a leaf of
    the trees below, not a node)."""
    mesh: Any
    spec: Spec


def spec_axes(entry) -> tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def placements(spec: Spec, mesh) -> list:
    """The DTensor placements of `spec` on a named `DeviceMesh`: Shard(d) on
    every mesh dim that splits tensor dim d (a dim on two axes, such as
    ("pod", "data"), is Shard(d) on both, in mesh order: the first axis
    major, as in JAX), Replicate() on the others."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        pos = [names.index(ax) for ax in spec_axes(entry)]
        if pos != sorted(pos):
            raise ValueError(f"spec {spec}: dim {d}'s axes are not in the mesh's order {names}")
        for p in pos:
            out[p] = Shard(d)
    return out


def spec_of(t) -> Spec:
    """The spec of a DTensor, from its placements (the inverse of
    `placements`)."""
    from torch.distributed.tensor import Shard
    entries: list[list[str]] = [[] for _ in range(t.ndim)]
    for name, p in zip(t.device_mesh.mesh_dim_names, t.placements):
        if isinstance(p, Shard):
            entries[p.dim].append(name)
    return tuple(None if not e else (e[0] if len(e) == 1 else tuple(e)) for e in entries)


def mesh_device(mesh) -> torch.device:
    """The device this rank's blocks live on: its current card for a
    "cuda" mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# ---------------------------------------------------------- port's trees ----
def _path(key: str) -> tuple[str, ...]:
    return tuple(key.split("/")) if key else ()


def _map(tree, fn):
    from repro_torch.core.tree import tree_map_with_path
    return tree_map_with_path(fn, tree)


def param_shardings(params, cfg, mesh, *, multi_pod: bool):
    """A `Sharding` for each leaf of the port's LM params (one dict per
    layer), from its stacked leaf's path and shape."""
    from repro_torch.optim.optimizers import param_groups
    rules = logical_rules(cfg, multi_pod)
    by_id = {}
    for g in param_groups(params, cfg):
        spec = _resolve(_param_logical(_path(g.key), len(g.shape)), g.shape, rules, mesh)
        for t in g.params:
            by_id[id(t)] = spec[1:] if g.stacked else spec
    return _map(params, lambda _, t: Sharding(mesh, by_id[id(t)]))


def _stacked_shardings(tree, cfg, mesh, multi_pod: bool, strip: tuple[str, ...]):
    rules = logical_rules(cfg, multi_pod)

    def one(path: str, t):
        names = tuple(n for n in _path(path) if n not in strip)
        return Sharding(mesh, _resolve(_param_logical(names, t.ndim), tuple(t.shape),
                                       rules, mesh))
    return _map(tree, one)


def opt_shardings(opt, cfg, mesh, *, multi_pod: bool):
    """The optimizer state {"count", "state": {path: {"m", "v"} ...}} in its
    stacked shapes: the param's path with the wrapper keys stripped; the
    factored Adafactor statistics have fewer dims, and the divisibility
    fallback takes what is left."""
    return _stacked_shardings(opt, cfg, mesh, multi_pod, _OPT_KEYS)


def ef_shardings(ef, cfg, mesh, *, multi_pod: bool):
    """The error-feedback residual {path: stacked array}, as its params."""
    return None if ef is None else _stacked_shardings(ef, cfg, mesh, multi_pod, ())


def cache_shardings(caches, cfg, mesh, *, multi_pod: bool):
    """The port's caches (a list of per-layer dicts): each leaf the spec of
    the reference's stacked cache less its "layers" entry."""
    rules = logical_rules(cfg, multi_pod)

    def one(path: str, t):
        logical = _cache_logical(_path(path)[-1:], t.ndim + 1)[1:]
        return Sharding(mesh, _resolve(logical, tuple(t.shape), rules, mesh))
    return _map(caches, one)


def batch_shardings(batch, cfg, mesh, *, multi_pod: bool):
    rules = logical_rules(cfg, multi_pod)
    return _map(batch, lambda _, x: Sharding(mesh, _resolve(
        ("batch",) + (None,) * (len(x.shape) - 1), tuple(x.shape), rules, mesh)))


def batch_axes(cfg, mesh, rows: int, *, multi_pod: bool) -> tuple[str, ...]:
    """The mesh axes a train step's batch of `rows` rows splits over: the
    rules' "batch" axes, and "model" after them where not every layer
    splits its heads over it: no tensor-parallel rule (`model_parallel`,
    the xLSTM stack), or heads that do not divide it (qwen2-0.5b's 14
    query heads on 16), whose layers every rank of "model" would run whole
    on the same rows. An axis the rows do not divide drops out with those
    after it; where "model" drops out so, a config with a rule keeps its
    tensor parallelism, the attention whole on every rank (the
    reference's divisibility fallback)."""
    from repro_torch.models.transformer import TP_KINDS, split_heads
    rules = logical_rules(cfg, multi_pod)
    sizes = axis_sizes(mesh)
    split = model_parallel(cfg, mesh) and all(
        split_heads(kind, cfg) % sizes["model"] == 0
        for kind in dict.fromkeys(cfg.block_kinds()) if kind in TP_KINDS)
    if "model" in sizes and "model" not in rules["batch"] and not split:
        rules = {**rules, "batch": rules["batch"] + ("model",)}
    return spec_axes(_resolve(("batch",), (rows,), rules, mesh)[0])


def scalar_sharding(mesh) -> Sharding:
    return Sharding(mesh, ())


# ------------------------------------------------------ sharded tensors -----
def shard_of(full: torch.Tensor, mesh, placements_) -> torch.Tensor:
    """This rank's block of `full` under `placements_` (no communication):
    mesh dims in order, so the first of two on one tensor dim is major."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    t = full
    for i, p in enumerate(placements_):
        if isinstance(p, Shard):
            n = mesh.size(i)
            size = t.shape[p.dim] // n
            t = t.narrow(p.dim, coord[i] * size, size)
    return t


def distribute(full: torch.Tensor, sharding: Sharding):
    """`full` (whole on every rank) as a DTensor holding this rank's block
    (a copy); a 0-d leaf stays a plain tensor, whole on every rank."""
    from torch.distributed.tensor import DTensor
    if full.ndim == 0:
        return full.detach()
    pl = placements(sharding.spec, sharding.mesh)
    local = shard_of(full.detach(), sharding.mesh, pl).clone()
    return DTensor.from_local(local, sharding.mesh, pl, run_check=False)


def distribute_tree(tree, shardings):
    """`distribute` of every leaf of `tree` (whole on every rank) by its
    `Sharding` in `shardings` (a tree of the same structure)."""
    from repro_torch.core.tree import tree_map_with_path, tree_paths
    specs = dict(tree_paths(shardings))
    return tree_map_with_path(lambda path, t: distribute(t, specs[path]), tree)


def is_sharded(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def gather(t, keep_dim: int | tuple[int, ...] | None = None, *,
           copy: bool = True) -> torch.Tensor:
    """The whole tensor of a DTensor: an all-gather over each mesh dim of
    more than one rank that shards it, innermost first; with `keep_dim`
    (a dim or a tuple of dims), not over the mesh dims that shard those
    tensor dims (they stay this rank's block). Every rank of the mesh calls
    it, in the same order. A plain tensor comes back as it is; a DTensor
    with nothing to gather as a copy of its block (its block itself
    without `copy`)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard
    if not is_sharded(t):
        return t
    mesh, pl = t.device_mesh, t.placements
    keep = _dims(keep_dim)
    local = out = t.to_local()
    for i in reversed(range(len(pl))):
        if not isinstance(pl[i], Shard) or mesh.size(i) == 1 or pl[i].dim in keep:
            continue
        n, d = mesh.size(i), pl[i].dim
        src = out.movedim(d, 0).contiguous()
        buf = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        dist.all_gather_into_tensor(buf, src, group=mesh.get_group(i))
        count_collective("all_gather", buf)
        out = buf.movedim(0, d)
    return out.clone() if out is local and copy else out


def _dims(keep_dim) -> tuple[int, ...]:
    return () if keep_dim is None else (keep_dim,) if isinstance(keep_dim, int) else keep_dim


def block_of(full: torch.Tensor, t, keep_dim: int | tuple[int, ...] | None = None) -> torch.Tensor:
    """This rank's block of `full`, as the leaf `t` holds it (a plain leaf:
    all of it); with `keep_dim`, `full` already holds this rank's block of
    that dim (as `gather(t, keep_dim)` leaves it)."""
    from torch.distributed.tensor import Replicate, Shard
    if not is_sharded(t):
        return full
    keep = _dims(keep_dim)
    pl = [Replicate() if isinstance(p, Shard) and p.dim in keep else p
          for p in t.placements]
    return shard_of(full, t.device_mesh, pl)


@torch.no_grad()
def keep_blocks(tree, full, keep_dim=None):
    """Write this rank's blocks (`block_of`) of the leaves of `full` into
    the leaves of `tree`, a tree of the same structure: a DTensor's local
    block, a plain leaf whole; `keep_dim` a dim, a tuple of dims, or a
    function of (path, leaf) giving either. -> `tree`."""
    from repro_torch.core.tree import tree_map_with_path, tree_paths
    wholes = dict(tree_paths(full))

    def keep(path: str, t) -> None:
        local = t.to_local() if is_sharded(t) else t
        dims = keep_dim(path, t) if callable(keep_dim) else keep_dim
        local.copy_(block_of(wholes[path], t, dims))
    tree_map_with_path(keep, tree)
    return tree


# ------------------------------------------------------- local blocks ------
def layout_of(t, axes: dict) -> tuple:
    """((Axis, tensor dim), ...) of the mesh dims that shard the DTensor
    `t`, in mesh order (empty for a plain leaf): its `core.collectives`
    layout."""
    from torch.distributed.tensor import Shard
    if not is_sharded(t):
        return ()
    return tuple((axes[name], p.dim) for name, p in zip(t.device_mesh.mesh_dim_names,
                                                        t.placements) if isinstance(p, Shard))


def local_blocks(tree, mesh, *, grad: bool = False):
    """(the tree of this rank's blocks -- a DTensor's local tensor, a plain
    leaf as it is, each an alias that shares its storage and, with `grad`,
    requires grad --, their layouts by id) for `activation_sharding_ctx`."""
    from repro_torch.core.tree import tree_map_with_path
    axes = coll.mesh_axes(mesh)
    layouts = {}

    def one(_, t):
        local = (t.to_local() if is_sharded(t) else t).detach()
        if grad:
            local.requires_grad_(True)
        layouts[id(local)] = layout_of(t, axes)
        return local
    return tree_map_with_path(one, tree), layouts


# ------------------------------------------------ activation context --------
def model_parallel(cfg, mesh) -> bool:
    """Whether layers compute on their "model" shard on `mesh`, decided
    from the config's structure: a "model" axis that is not folded into
    batch and FSDP (`prefer_dp`), and a layer kind with a tensor-parallel
    rule (attention, MoE, cross-attention, Mamba2: `transformer.TP_KINDS`;
    not the xLSTM blocks). A step whose rows split over "model"
    (`batch_axes`) computes on no "model" shard all the same
    (`activation_sharding_ctx`)."""
    from repro_torch.models.transformer import TP_KINDS
    return ("model" in mesh.mesh_dim_names and not cfg.prefer_dp
            and any(kind in TP_KINDS for kind in cfg.block_kinds()))


def activation_sharding_ctx(mesh, cfg, *, multi_pod: bool = False,
                            rows: tuple[str, ...] | None = None, layouts: dict | None = None):
    """While active, the step is split on `mesh` (module docstring): the
    rows over `rows` (the rules' "batch" axes for None), tensor- and
    expert-parallel layers over "model" (`model_parallel`, where the rows
    do not split over it), and the
    params' local blocks of `layouts` (`local_blocks`) gathered a layer at
    a time."""
    axes = coll.mesh_axes(mesh)
    if rows is None:
        rows = logical_rules(cfg, multi_pod)["batch"]
    model = axes["model"] if model_parallel(cfg, mesh) and "model" not in rows else None
    return coll.mesh_state(coll.MeshState(rows=tuple(axes[a] for a in rows), model=model,
                                          layouts=dict(layouts or {})))


__all__ = ["COLLECTIVES", "Sharding", "activation_sharding_ctx", "all_reduce", "axis_sizes",
           "batch_axes", "batch_shardings", "block_of", "cache_shardings", "distribute",
           "distribute_tree", "ef_shardings", "gather", "is_sharded",
           "keep_blocks", "layout_of", "local_blocks", "logical_rules", "mesh_device",
           "model_parallel", "opt_shardings", "param_shardings", "placements",
           "reset_collectives", "scalar_sharding", "shard_of", "spec_of"]
