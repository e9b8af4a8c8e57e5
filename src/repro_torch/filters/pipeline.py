"""Batched multi-filter image pipeline over the REFMLM datapath.

Counterpart of `repro.filters.pipeline`:

    apply_filter(imgs, "sobel_x", method="refmlm")        one filter
    filter_bank_apply(imgs, method="refmlm")              the whole bank
    apply_filter_batch([img, ...], "gaussian3")           the serving hook

Accepts a single (H, W) image, an (N, H, W) batch, or NHWC with a trailing
unit channel, as numpy arrays or torch tensors, and returns uint8 tensors
on the device it ran on: the CUDA card by default, the CPU only when
`device="cpu"` is asked for. Only `exec='local'` is ported; the reference's
'sharded' and 'streamed' modes raise `NotImplementedError`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.platform import resolve_device
from repro_torch.filters.bank import (
    FILTER_NAMES,
    FilterSpec,
    get_filter,
    max_intermediate,
)
from repro_torch.filters.conv import (
    ROUTE_TILES,
    _resolve_mult_impl,
    conv2d_pass,
    fused_separable_pass,
    kernel_route,
    second_pass_nbits,
)
from repro_torch.tuning.plans import PlanConfig, PlanTile, resolve_plan

EXEC_MODES = ("local", "sharded", "streamed")


def _normalize(imgs, device: torch.device) -> tuple[torch.Tensor, tuple[int, ...]]:
    """-> ((N, H, W) int32 on `device`, original shape)."""
    x = torch.as_tensor(imgs)
    orig = tuple(x.shape)
    if x.dim() == 4:
        if orig[-1] != 1:
            raise ValueError(f"NHWC input must have C=1, got {orig}")
        x = x[..., 0]
    elif x.dim() == 2:
        x = x[None]
    elif x.dim() != 3:
        raise ValueError(f"expected (H,W), (N,H,W) or (N,H,W,1), got {orig}")
    return x.to(device=device, dtype=torch.int32), orig


def _restore(out: torch.Tensor, orig: tuple[int, ...]) -> torch.Tensor:
    if len(orig) == 4:
        return out[..., None]
    if len(orig) == 2:
        return out[0]
    return out


def _apply(x: torch.Tensor, spec: FilterSpec, method: str, nbits: int,
           plan: PlanConfig) -> torch.Tensor:
    if plan.dataflow == "direct":
        out = conv2d_pass(x, spec.taps, method=method, nbits=nbits,
                          shift=spec.shift, post=spec.post,
                          mult_impl=plan.mult_impl)
        return out.to(torch.uint8)
    nb2 = second_pass_nbits(max_intermediate(spec),
                            int(np.abs(spec.sep_col).max()))
    if plan.dataflow == "fused":
        out = fused_separable_pass(x, spec.sep_row, spec.sep_col,
                                   method=method, nbits=nbits, nbits2=nb2,
                                   shift=spec.shift, post=spec.post,
                                   mult_impl=plan.mult_impl)
    else:
        tmp = conv2d_pass(x, spec.sep_row[None, :], method=method, nbits=nbits,
                          shift=0, post="none", mult_impl=plan.mult_impl)
        out = conv2d_pass(tmp, spec.sep_col[:, None], method=method, nbits=nb2,
                          shift=spec.shift, post=spec.post,
                          mult_impl=plan.mult_impl)
    return out.to(torch.uint8)


def apply_filter(imgs, filt: FilterSpec | str, *, method: str = "refmlm",
                 nbits: int = 8, separable: bool | None = None,
                 fused: bool | None = None, mult_impl: str = "auto",
                 exec: str = "local",
                 device: str | torch.device | None = None) -> torch.Tensor:
    """Run one bank filter over an image batch through the selected
    multiplier; -> uint8 tensor of the input's layout on `device`.

    `separable=False` forces the direct KxK window; `separable=True` admits
    only the two 1-D pass dataflows, of which `fused=True` runs both passes
    in one kernel and `fused=False` the two-kernel dataflow with its int32
    intermediate. `mult_impl` pins the tap products ('kcm' | 'recurse' |
    'auto'). Every plan gives the same bytes for exact multipliers, and
    for every multiplier across mult_impl."""
    if exec not in EXEC_MODES:
        raise ValueError(f"exec must be one of {EXEC_MODES}, got {exec!r}")
    if exec != "local":
        raise NotImplementedError(
            f"exec={exec!r} is not ported yet (ROADMAP Queue 1 item 8, "
            "`distribute`); use exec='local'")
    spec = get_filter(filt) if isinstance(filt, str) else filt
    if separable and not spec.separable:
        raise ValueError(f"filter {spec.name!r} has no separable decomposition")
    if fused and (separable is False or not spec.separable):
        raise ValueError("fused=True requires the separable dataflow")
    x, orig = _normalize(imgs, resolve_device(device))
    plan = resolve_filter_plan(spec, mult_impl=mult_impl, separable=separable,
                               fused=fused)
    return _restore(_apply(x, spec, method, nbits, plan), orig)


def resolve_filter_plan(filt: FilterSpec | str, n: int | None = None,
                        h: int | None = None, w: int | None = None, *,
                        method: str = "refmlm", mult_impl: str = "auto",
                        separable: bool | None = None,
                        fused: bool | None = None) -> PlanConfig:
    """The concrete plan `apply_filter` runs for an (n, h, w) batch of
    `filt`: dataflow and the resolved tap-product implementation. The
    signature is the reference's, the serving layer's per-bucket memo
    hook. The port's plan depends on neither the shape nor `method`: with
    no plan cache the default is the reference's cache-miss plan, and the
    tile each plan launches is fixed by its kernel route (`plan_tile`)."""
    spec = get_filter(filt) if isinstance(filt, str) else filt
    for dim in (n, h, w):
        if dim is not None and int(dim) < 1:
            raise ValueError(f"batch and image sizes must be positive, got "
                             f"{(n, h, w)}")
    plan = resolve_plan(separable_ok=spec.separable, mult_impl=mult_impl,
                        separable=separable, fused=fused)
    return plan._replace(mult_impl=_resolve_mult_impl(plan.mult_impl))


def plan_tile(filt: FilterSpec | str, plan: PlanConfig) -> PlanTile:
    """The tile `plan` launches for `filt`: the route (`conv.kernel_route`)
    of its last pass -- the fused kernel, the direct pass, or the two-pass
    column pass -- and that route's block (`conv.ROUTE_TILES`)."""
    spec = get_filter(filt) if isinstance(filt, str) else filt
    if plan.dataflow == "fused":
        route = kernel_route(len(spec.sep_col), len(spec.sep_row), fused=True)
    elif plan.dataflow == "two_pass":
        route = kernel_route(len(spec.sep_col), 1)
    else:
        route = kernel_route(*spec.ksize)
    return PlanTile(route, *ROUTE_TILES[route])


def apply_filter_batch(imgs: list, filt: FilterSpec | str, *,
                       pad_to: int | None = None, **kw) -> list[torch.Tensor]:
    """Coalesce same-shape (H, W) images into one (N, H, W) `apply_filter`
    call and split the output back per image (the serving layer's batch
    hook). `pad_to` zero-pads the batch up to a fixed size; pad images are
    dropped. Each output equals the single-image call, since every image
    gets its own zero padding."""
    if not imgs:
        return []
    shape = tuple(np.shape(imgs[0]))
    for im in imgs[1:]:
        if tuple(np.shape(im)) != shape:
            raise ValueError(f"apply_filter_batch needs uniform shapes; got "
                             f"{tuple(np.shape(im))} alongside {shape}")
    if len(shape) != 2:
        raise ValueError(f"expected (H, W) images, got shape {shape}")
    n = len(imgs)
    batch = torch.stack([torch.as_tensor(im).to(torch.int32) for im in imgs])
    if pad_to is not None and pad_to > n:
        batch = torch.cat([batch, batch.new_zeros((pad_to - n, *shape))])
    return list(apply_filter(batch, filt, **kw)[:n].unbind(0))


def filter_bank_apply(imgs, filters: tuple[str, ...] | None = None, *,
                      method: str = "refmlm", **kw) -> dict[str, torch.Tensor]:
    """Run many filters over one batch: name -> uint8 output batch."""
    names = FILTER_NAMES if filters is None else tuple(filters)
    return {name: apply_filter(imgs, name, method=method, **kw)
            for name in names}


__all__ = ["EXEC_MODES", "apply_filter", "apply_filter_batch",
           "filter_bank_apply", "plan_tile", "resolve_filter_plan"]
