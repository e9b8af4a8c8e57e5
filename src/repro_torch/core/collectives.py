"""The data-parallel train step's collectives, counted, and the flag that
says its batch rows are split over the ranks.

`all_reduce` reduces a tensor in place over a process group (the world by
default) and counts the call in `COLLECTIVES` by kind: calls, and bytes
of the tensor it reduces. `runtime.sharding`'s gathers count there too.

While `rows_split()` is active (`runtime.sharding.activation_sharding_ctx`,
which the data-parallel train step enters), each rank holds its rows of
the global batch, and a reduction that spans rows is made global over the
world: the abs-max of an operand that `core.approx_matmul` quantizes
inside `batch_rows()` (`rows_max`, which `core.quant` takes) and the
loss's counts (`models.model.loss_fn` asks `rows_are_split()`). Both
flags are module globals, not context variables: the autograd engine runs
the backward and the remat recompute of a CUDA graph on its own thread,
and they need them too.
"""
from __future__ import annotations

import contextlib
from collections import Counter

import torch

COLLECTIVES: Counter = Counter()


def reset_collectives() -> None:
    COLLECTIVES.clear()


def count_collective(kind: str, t: torch.Tensor) -> None:
    COLLECTIVES[kind] += 1
    COLLECTIVES[f"{kind}_bytes"] += t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """`t` reduced in place over `group` (the world for None) and returned."""
    import torch.distributed as dist
    dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=group)
    count_collective(f"all_reduce_{op}", t)
    return t


_ROWS_SPLIT = False                 # inside rows_split()
_ROWS_OPERAND = False               # inside batch_rows()


@contextlib.contextmanager
def rows_split():
    """While active, the batch rows are split over every rank of the world."""
    global _ROWS_SPLIT
    prev, _ROWS_SPLIT = _ROWS_SPLIT, True
    try:
        yield
    finally:
        _ROWS_SPLIT = prev


def rows_are_split() -> bool:
    return _ROWS_SPLIT


@contextlib.contextmanager
def batch_rows():
    """Marks the operand quantized inside as batch rows (an activation,
    not a weight): its abs-max is `rows_max`'s."""
    global _ROWS_OPERAND
    prev, _ROWS_OPERAND = _ROWS_OPERAND, True
    try:
        yield
    finally:
        _ROWS_OPERAND = prev


class _RowsMax(torch.autograd.Function):
    """The max of `x` over every rank's rows: all_reduce(MAX). Its gradient
    is JAX's of `max` on the global operand: the cotangent of the global
    max is the sum of every rank's (each rank's loss share reads the same
    max), split equally among the elements equal to the max, counted over
    every rank. So the backward all-reduces (cotangent, tie count), one
    SUM of two floats."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        m = all_reduce(x.max().detach().clone(), "max")
        ctx.save_for_backward(x, m)
        return m

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, m = ctx.saved_tensors
        hit = x == m
        both = all_reduce(torch.stack([g.to(torch.float32), hit.sum().to(torch.float32)]))
        return hit.to(x.dtype) * (both[0] / both[1]).to(x.dtype)


def rows_max(x: torch.Tensor) -> torch.Tensor:
    """max(x): inside `batch_rows()` while the rows are split, over every
    rank's rows; else this tensor's."""
    if not (_ROWS_SPLIT and _ROWS_OPERAND):
        return x.max()
    return _RowsMax.apply(x)


__all__ = ["COLLECTIVES", "all_reduce", "batch_rows", "count_collective", "reset_collectives",
           "rows_are_split", "rows_max", "rows_split"]
