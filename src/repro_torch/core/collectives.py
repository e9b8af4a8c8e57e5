"""The meshed steps' collectives, counted, over the axes of a mesh; the
autograd functions of sharded compute; the state that tells a layer how
its step is split.

Counting. Every collective adds to `COLLECTIVES` by kind, under the
reference's five (`all_gather`, `reduce_scatter`, `all_reduce_sum` /
`all_reduce_max`; the roofline maps them onto its names): calls, and
bytes, which are the whole tensor an all-gather assembles, the tensor a
reduce-scatter or an all-reduce reduces. A collective over an axis of
one rank is skipped: it moves nothing.

Axes. `mesh_axes(mesh)` gives each named mesh dim as an `Axis`: its
size, this rank's index along it and its process group. `all_gather`,
`reduce_scatter` and `all_reduce` take an axis's group.

The split state (`mesh_state`, set by `runtime.sharding.
activation_sharding_ctx`, a module global: the autograd engine runs the
backward and the remat recompute on its own thread, and they read it too):
  * `rows`: the axes the batch rows split over. A reduction that spans
    rows is global over them: the quantizer's abs-max of an activation
    (`operand_max`, inside `batch_rows()`), the loss's counts
    (`models.model`, `row_groups()`);
  * `model`: the "model" axis where layers compute on their model shard
    (tensor- and expert-parallel), else None;
  * `layouts`: id(a param's local block) -> the mesh axes that shard it
    and on which of its dims. `fsdp_gather` reads it.

Autograd functions:
  * `fsdp_gather(t, keep)`: a param's local block -> what its layer
    computes on: all-gathered over every axis that shards it except
    "model" on the dim `keep` (tensor parallel: this rank's block), and
    narrowed to this rank's "model" block of `keep` when the param rests
    whole on that dim. Backward: the grad of the gathered tensor is a
    share of the global grad along the row axes (each rank's rows) and
    the same on the others (replicated compute), so it is reduce-scattered
    over a row axis, cut to this rank's block over another, and all-reduced
    over the row axes the param rests whole on. So each rank's grad is its
    block of the global grad, and the step all-reduces no grad whole.
    The selection mode, `keep` = (dim, segments) (Mamba2's `in_proj`
    columns [z, x, B, C, dt] and conv channels, whose at-rest blocks
    straddle the segments): gathered over every axis, "model" included,
    then this rank's part of `dim` taken (`segment_index`: its block of
    each split segment, all of each whole one). Backward: the grad
    scattered into zeros of the gathered shape, then reduce-scattered over
    "model" (all-reduced where the param rests whole on it), which sums
    the ranks' shares of the whole segments' grads.
  * `copy_to_model` (identity forward, all-reduce backward) and
    `reduce_from_model` (all-reduce forward, identity backward): the
    tensor-parallel pair over "model", Megatron's f and g;
    `gather_from_model` (all-gather forward, this rank's block backward)
    and `split_to_model` (this rank's block forward, all-gather backward).
  * `operand_max`: the max of an operand over the axes that split it
    (module docstring of `core.quant`).
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import Counter
from typing import Any

import torch

COLLECTIVES: Counter = Counter()


def reset_collectives() -> None:
    COLLECTIVES.clear()


def count_collective(kind: str, t: torch.Tensor) -> None:
    COLLECTIVES[kind] += 1
    COLLECTIVES[f"{kind}_bytes"] += t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """`t` reduced in place over `group` (a process group, an `Axis`, or
    the world for None) and returned; an axis of one rank leaves it."""
    import torch.distributed as dist
    if isinstance(group, Axis):
        if group.size == 1:
            return t
        group = group.group
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=group)
    count_collective(f"all_reduce_{op}", t)
    return t


# ------------------------------------------------------------- mesh axes ----
@dataclasses.dataclass(frozen=True)
class Axis:
    name: str
    size: int
    index: int          # this rank's coordinate along the axis
    group: Any          # its process group (None: the world)


def mesh_axes(mesh) -> dict[str, Axis]:
    """Each named dim of a `DeviceMesh` as an `Axis`, in mesh order."""
    coord = mesh.get_coordinate()
    return {name: Axis(name, mesh.size(i), coord[i], mesh.get_group(i))
            for i, name in enumerate(mesh.mesh_dim_names)}


def all_gather(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The blocks of `t` along `dim` of every rank of `axis`, in order,
    contiguous: a product reads a gathered weight in the strides of the
    unsplit one, and so sums in its order."""
    import torch.distributed as dist
    if axis.size == 1:
        return t
    src = t.movedim(dim, 0).contiguous()
    buf = torch.empty((axis.size * src.shape[0], *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.all_gather_into_tensor(buf, src, group=axis.group)
    count_collective("all_gather", buf)
    return buf.movedim(0, dim).contiguous()


def reduce_scatter(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """This rank's block along `dim` of the sum of `t` over `axis`."""
    import torch.distributed as dist
    if axis.size == 1:
        return t
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // axis.size, *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.reduce_scatter_tensor(out, src, group=axis.group)
    count_collective("reduce_scatter", src)
    return out.movedim(0, dim)


def block(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """This rank's block of `t` along `dim` over `axis` (no communication)."""
    if axis.size == 1:
        return t
    n = t.shape[dim] // axis.size
    return t.narrow(dim, axis.index * n, n)


# ----------------------------------------------------------- split state ----
@dataclasses.dataclass
class MeshState:
    rows: tuple[Axis, ...]                  # the axes the batch rows split over
    model: Axis | None = None               # tensor / expert parallel axis
    layouts: dict = dataclasses.field(default_factory=dict)   # id -> ((Axis, dim), ...)


_MESH: MeshState | None = None
_OPERAND: tuple | None = None               # (max axes, cotangent-sum axes) of an operand


@contextlib.contextmanager
def mesh_state(state: MeshState):
    """While active, the step is split as `state` says (module docstring)."""
    global _MESH
    prev, _MESH = _MESH, state
    try:
        yield
    finally:
        _MESH = prev


def _split(axes) -> tuple[Axis, ...]:
    return tuple(a for a in axes if a.size > 1)


def row_axes() -> tuple[Axis, ...]:
    """The axes of more than one rank that the rows split over."""
    return () if _MESH is None else _split(_MESH.rows)


def row_groups() -> int:
    """The number of row blocks (1 without a split)."""
    n = 1
    for a in row_axes():
        n *= a.size
    return n


def rows_are_split() -> bool:
    return row_groups() > 1


def all_reduce_rows(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """`t` reduced in place over every row axis."""
    for a in row_axes():
        all_reduce(t, op, a)
    return t


def model_axis() -> Axis | None:
    """The "model" axis when layers compute on their model shard."""
    m = None if _MESH is None else _MESH.model
    return m if m is not None and m.size > 1 else None


def model_split(n: int) -> Axis | None:
    """The "model" axis where `n` (heads, experts, columns) splits evenly
    over it, else None: the layer computes on whole `n` (the reference's
    divisibility fallback)."""
    m = model_axis()
    return m if m is not None and n % m.size == 0 else None


# --------------------------------------------------------- the max -----------
@contextlib.contextmanager
def _operand(max_axes: tuple[Axis, ...], sum_axes: tuple[Axis, ...]):
    global _OPERAND
    prev, _OPERAND = _OPERAND, (_split(max_axes), _split(sum_axes))
    try:
        yield
    finally:
        _OPERAND = prev


def batch_rows(split: str | None = None):
    """Marks the operand quantized inside as batch rows (an activation):
    its abs-max spans the row axes, and with `split` "row" (a row-parallel
    dense: the activation split on K) "model" too. Its cotangent is each
    row block's share: summed over the row axes (under "model" it is the
    same on every rank, the output being reduced)."""
    rows = row_axes()
    m = model_axis() if split == "row" else None
    return _operand(rows + ((m,) if m else ()), rows)


def weight_block(split: str | None = None):
    """Marks the operand quantized inside as a weight block: split on N
    ("col") or K ("row") over "model", its abs-max spans "model"; a column
    block's cotangent is that block's share (summed over "model"), a row
    block's the same on every rank. Whole (None), its own."""
    m = model_axis() if split else None
    if m is None:
        return _operand((), ())
    return _operand((m,), (m,) if split == "col" else ())


class _OperandMax(torch.autograd.Function):
    """The max of `x` over the ranks of `max_axes`: all_reduce(MAX). Its
    gradient is JAX's of `max` on the global operand: the cotangent of the
    global max (summed over `sum_axes`, where each rank's is a share) split
    equally among the elements equal to it, counted over `max_axes`. Where
    both are the same axes the backward is one all-reduce of (cotangent,
    tie count)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, max_axes, sum_axes) -> torch.Tensor:
        m = x.max().detach().clone()
        for a in max_axes:
            all_reduce(m, "max", a)
        ctx.save_for_backward(x, m)
        ctx.axes = (max_axes, sum_axes)
        return m

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, m = ctx.saved_tensors
        max_axes, sum_axes = ctx.axes
        hit = x == m
        both = torch.stack([g.to(torch.float32), hit.sum().to(torch.float32)])
        if max_axes == sum_axes:
            for a in max_axes:
                all_reduce(both, "sum", a)
        else:
            g_tot, n = both[:1].clone(), both[1:].clone()
            for a in sum_axes:
                all_reduce(g_tot, "sum", a)
            for a in max_axes:
                all_reduce(n, "sum", a)
            both = torch.cat([g_tot, n])
        return hit.to(x.dtype) * (both[0] / both[1]).to(x.dtype), None, None


def operand_max(x: torch.Tensor) -> torch.Tensor:
    """max(x) over the ranks that split the operand being quantized
    (`batch_rows` / `weight_block`); else this tensor's. Either way its
    gradient is `_OperandMax`'s, the mask times the cotangent, so a NaN
    cotangent reaches every element as it does through `jnp.max` (the
    CPU backward of `torch.max` fills the max's position alone: R14)."""
    if _OPERAND is None or not _OPERAND[0]:
        return _OperandMax.apply(x, (), ())
    return _OperandMax.apply(x, *_OPERAND)


# ----------------------------------------------------------- FSDP gather ----
def segment_index(segments, axis: Axis, device=None) -> torch.Tensor:
    """The indices, along a dim laid out as `segments` ((length, split
    over `axis`) each, in order), of this rank's part: its block of each
    split segment, all of each whole one."""
    parts, start = [], 0
    for n, split in segments:
        lo, k = (start + axis.index * (n // axis.size), n // axis.size) if split else (start, n)
        parts.append(torch.arange(lo, lo + k, device=device))
        start += n
    return torch.cat(parts)


def gather_segments(x: torch.Tensor, axis: Axis, dim: int, segments) -> torch.Tensor:
    """The whole dim laid out as `segments` from each rank's part of it
    (`segment_index`): the split segments all-gathered over `axis`, the
    whole ones (the same on every rank) as they are."""
    sizes = [n // axis.size if split else n for n, split in segments]
    parts = torch.split(x, sizes, dim)
    return torch.cat([all_gather(part, axis, dim) if split else part
                      for part, (_, split) in zip(parts, segments)], dim)


class _Gather(torch.autograd.Function):
    """`fsdp_gather`'s collectives (module docstring). `gathers`: (axis,
    dim, summed?) innermost mesh dim first, summed where the backward
    reduce-scatters (a row axis, or "model" under a selection); `narrow`:
    (axis, dim, segments or None) or None; `replicated`: the axes whose
    shares the backward all-reduces (the row axes the block rests whole
    on, and "model" for a selection on a block whole on it)."""

    @staticmethod
    def forward(ctx, local: torch.Tensor, gathers, narrow, replicated) -> torch.Tensor:
        ctx.plan = (gathers, narrow, replicated)
        out = local
        for axis, dim, _ in gathers:
            out = all_gather(out, axis, dim)
        if narrow is not None:
            axis, dim, segs = narrow
            if segs is not None:
                ctx.whole = out.shape
                return out.index_select(dim, segment_index(segs, axis, out.device))
            out = block(out, axis, dim)
            if not gathers:
                out = out.clone()
        return out.view_as(out) if out is local else out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        gathers, narrow, replicated = ctx.plan
        if narrow is not None:
            axis, dim, segs = narrow
            if segs is None:
                g = all_gather(g, axis, dim)
            else:
                g = g.new_zeros(ctx.whole).index_copy_(
                    dim, segment_index(segs, axis, g.device), g)
        for axis, dim, is_row in reversed(gathers):
            g = reduce_scatter(g, axis, dim) if is_row else block(g, axis, dim).contiguous()
        if replicated:
            g = g.contiguous().clone()
            for a in replicated:
                all_reduce(g, "sum", a)
        return g, None, None, None


def fsdp_gather(t: torch.Tensor, keep: int | tuple | None = None) -> torch.Tensor:
    """A param's local block -> the tensor its layer computes on (module
    docstring): `keep` the dim whose "model" block the layer keeps, or
    (dim, segments) for a selection; `t` itself where no layout is
    registered for it."""
    layout = None if _MESH is None else _MESH.layouts.get(id(t))
    if layout is None:
        return t
    model = model_axis()
    rows = {a.name for a in row_axes()}
    select = isinstance(keep, tuple) and model is not None
    dim = keep[0] if isinstance(keep, tuple) else keep
    gathers, on_keep = [], False
    for axis, d in reversed(layout):
        if axis.size == 1:
            continue
        is_model = model is not None and axis.name == model.name
        if is_model and d == dim and not select:
            on_keep = True
            continue
        gathers.append((axis, d, axis.name in rows or (select and is_model)))
    narrow = None
    if model is not None and dim is not None and not on_keep:
        narrow = (model, dim, keep[1] if select else None)
    sharded = {axis.name for axis, _ in layout}
    replicated = tuple(a for a in row_axes() if a.name not in sharded)
    if select and model.name not in sharded:
        replicated += (model,)
    if not (gathers or narrow or replicated):
        return t
    return _Gather.apply(t, tuple(gathers), narrow, replicated)


def gather_params(tree, keep: dict | None = None, prefix: str = ""):
    """`fsdp_gather` of every leaf of a param tree (nested dicts), with
    `keep[path]` what its layer keeps of it over "model" (a dim, or a
    selection)."""
    if isinstance(tree, torch.Tensor):
        return fsdp_gather(tree, (keep or {}).get(prefix))
    return {k: gather_params(v, keep, f"{prefix}/{k}" if prefix else k) for k, v in tree.items()}


# ------------------------------------------------------- the TP pair --------
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), "sum", ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x.contiguous().clone(), "sum", axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.args = (axis, dim)
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return block(g, *ctx.args).contiguous(), None, None


class _SplitToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.args = (axis, dim)
        return block(x, axis, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, *ctx.args), None, None


def copy_to_model(x: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """The input of tensor-parallel compute: the same on every rank of
    `axis`, its cotangent the sum of theirs. `x` itself for None."""
    return x if axis is None else _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """The sum over `axis` of each rank's partial `x`."""
    return x if axis is None else _ReduceFromModel.apply(x, axis)


def gather_from_model(x: torch.Tensor, axis: Axis | None, dim: int) -> torch.Tensor:
    return x if axis is None else _GatherFromModel.apply(x, axis, dim)


def split_to_model(x: torch.Tensor, axis: Axis | None, dim: int) -> torch.Tensor:
    return x if axis is None else _SplitToModel.apply(x, axis, dim)


__all__ = ["Axis", "COLLECTIVES", "MeshState", "all_gather", "all_reduce", "all_reduce_rows",
           "batch_rows", "block", "copy_to_model", "count_collective", "fsdp_gather",
           "gather_from_model", "gather_params", "gather_segments", "mesh_axes", "mesh_state",
           "model_axis", "model_split", "operand_max", "reduce_from_model", "reduce_scatter",
           "reset_collectives", "row_axes", "row_groups", "rows_are_split", "segment_index",
           "split_to_model", "weight_block"]
