"""Batched multi-filter image pipeline over the REFMLM datapath.

Counterpart of `repro.filters.pipeline`:

    apply_filter(imgs, "sobel_x", method="refmlm")        one filter
    filter_bank_apply(imgs, method="refmlm")              the whole bank
    apply_filter_batch([img, ...], "gaussian3")           the serving hook

Accepts a single (H, W) image, an (N, H, W) batch, or NHWC with a trailing
unit channel, as numpy arrays or torch tensors, and returns uint8 tensors
on the device it ran on: the CUDA card by default, the CPU only when
`device="cpu"` is asked for.

The execution plan -- dataflow, tap-product implementation and the tile
-- resolves through the per-backend plan cache (`repro_torch.tuning`):
explicit arguments win, then a tuned plan for this (filter, n, h, w), then
the reference's cache-miss plan. Execution modes: `exec='local'` runs on
one device; `exec='sharded'` splits the batch over a (batch, rows) grid of
devices with halo'd row bands and `exec='streamed'` walks an out-of-core
source in overlapping tiles (`repro_torch.distribute`). Every plan and
mode gives the same bytes.
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
    _resolve_mult_impl,
    conv2d_pass,
    fused_separable_pass,
    second_pass_nbits,
)
from repro_torch.tuning.blocks import TILE_MENU, BlockConfig, kernel_route
from repro_torch.tuning.cache import backend_key, resolve_blocks_cached
from repro_torch.tuning.plans import (
    PlanConfig,
    PlanTile,
    allowed_dataflows,
    resolve_plan,
)

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
    blocks = dict(mult_impl=plan.mult_impl, block_rows=plan.block_rows,
                  block_cols=plan.block_cols, batch_fold=plan.batch_fold)
    if plan.dataflow == "direct":
        out = conv2d_pass(x, spec.taps, method=method, nbits=nbits,
                          shift=spec.shift, post=spec.post, **blocks)
        return out.to(torch.uint8)
    nb2 = second_pass_nbits(max_intermediate(spec),
                            int(np.abs(spec.sep_col).max()))
    if plan.dataflow == "fused":
        out = fused_separable_pass(x, spec.sep_row, spec.sep_col,
                                   method=method, nbits=nbits, nbits2=nb2,
                                   shift=spec.shift, post=spec.post, **blocks)
    else:
        tmp = conv2d_pass(x, spec.sep_row[None, :], method=method, nbits=nbits,
                          shift=0, post="none", **blocks)
        out = conv2d_pass(tmp, spec.sep_col[:, None], method=method, nbits=nb2,
                          shift=spec.shift, post=spec.post, **blocks)
    return out.to(torch.uint8)


def apply_filter(imgs, filt: FilterSpec | str, *, method: str = "refmlm",
                 nbits: int = 8, separable: bool | None = None,
                 fused: bool | None = None, mult_impl: str = "auto",
                 block_rows: int | None = None, block_cols: int | None = None,
                 batch_fold: bool | None = None, exec: str = "local",
                 devices=None, mesh_shape: tuple[int, int] | None = None,
                 halo: str = "exchange", tile: tuple[int, int] | None = None,
                 tile_batch: int = 8, out=None, journal=None,
                 resume: bool = False,
                 device: str | torch.device | None = None):
    """Run one bank filter over an image batch through the selected
    multiplier.

    `separable=False` forces the direct KxK window; `separable=True` admits
    only the two 1-D pass dataflows, of which `fused=True` runs both passes
    in one kernel and `fused=False` the two-kernel dataflow with its int32
    intermediate. `mult_impl` pins the tap products ('kcm' | 'recurse' |
    'auto'). `block_rows` / `block_cols` / `batch_fold` pin the grid: on the
    card a tile of the kernels' menu (`repro_torch.tuning.blocks`; another
    raises), on the CPU the reference's vocabulary. Unset, all of these
    resolve through the plan cache of the device's backend for this
    (n, h, w). Every plan gives the same bytes for exact multipliers, and
    for every multiplier across mult_impl and the grid.

    `exec`: 'local' (default) runs on `device` and returns a uint8 tensor
    of the input's layout there; 'sharded' runs over a (batch, rows) grid of
    devices of `device`'s type (`devices` / `mesh_shape` size it, `halo`
    picks 'exchange' or 'embedded' row halos) and returns the same tensor;
    'streamed' walks the source in overlapping `tile`-shaped batches of
    `tile_batch`, each run locally on `device`, and returns a NumPy uint8
    array (writing into `out` -- an ndarray or memmap -- when given;
    `journal` / `resume` are the crash-resume surface). All three modes
    give the same bytes."""
    if exec not in EXEC_MODES:
        raise ValueError(f"exec must be one of {EXEC_MODES}, got {exec!r}")
    filter_kw = dict(method=method, nbits=nbits, separable=separable,
                     fused=fused, mult_impl=mult_impl, block_rows=block_rows,
                     block_cols=block_cols, batch_fold=batch_fold)
    if exec == "sharded":
        from repro_torch.distribute.sharded import sharded_apply_filter
        if (tile is not None or out is not None or tile_batch != 8
                or journal is not None or resume):
            raise ValueError("tile/tile_batch/out/journal/resume are "
                             "streamed-mode arguments")
        return sharded_apply_filter(imgs, filt, devices=devices,
                                    mesh_shape=mesh_shape, halo=halo,
                                    device=device, **filter_kw)
    if exec == "streamed":
        from repro_torch.distribute.streamed import stream_filter
        if devices is not None or mesh_shape is not None or halo != "exchange":
            raise ValueError("devices/mesh_shape/halo are sharded-mode "
                             "arguments")
        src = imgs.cpu().numpy() if isinstance(imgs, torch.Tensor) else imgs
        return stream_filter(src, filt,
                             tile=tile if tile is not None else (256, 256),
                             tile_batch=tile_batch, out=out, journal=journal,
                             resume=resume, device=device, **filter_kw)
    if ((devices, mesh_shape, tile, out, journal) != (None,) * 5
            or halo != "exchange" or tile_batch != 8 or resume):
        raise ValueError("devices/mesh_shape/halo/tile/tile_batch/out/"
                         "journal/resume require exec='sharded' or "
                         "exec='streamed'")
    spec = get_filter(filt) if isinstance(filt, str) else filt
    if separable and not spec.separable:
        raise ValueError(f"filter {spec.name!r} has no separable decomposition")
    if fused and (separable is False or not spec.separable):
        raise ValueError("fused=True requires the separable dataflow")
    x, orig = _normalize(imgs, resolve_device(device))
    n, h, w = x.shape
    kh, kw = spec.ksize
    plan = resolve_plan(spec.name, n, h, w, kh, kw,
                        separable_ok=spec.separable, mult_impl=mult_impl,
                        separable=separable, fused=fused,
                        block_rows=block_rows, block_cols=block_cols,
                        batch_fold=batch_fold, backend=x.device.type)
    plan = plan._replace(mult_impl=_resolve_mult_impl(plan.mult_impl))
    return _restore(_apply(x, spec, method, nbits, plan), orig)


def _pass_kind(spec: FilterSpec, dataflow: str) -> tuple[str, int, int]:
    """(kind, kh, kw) of the pass whose block entry sizes a plan's grid: the
    fused pass, the direct pass, or the two-pass column pass (which carries
    the row halo), as the reference picks it."""
    if dataflow == "fused":
        return "fused", len(spec.sep_col), len(spec.sep_row)
    if dataflow == "two_pass":
        return "direct", len(spec.sep_col), 1
    return ("direct", *spec.ksize)


def _backend(device, backend: str | None) -> str:
    return backend or backend_key(device)


def resolve_filter_blocks(filt: FilterSpec | str, n: int, h: int, w: int, *,
                          method: str = "refmlm", mult_impl: str = "auto",
                          separable: bool | None = None,
                          fused: bool | None = None,
                          device: str | torch.device | None = None,
                          backend: str | None = None) -> BlockConfig:
    """The grid `apply_filter`'s pass resolves for an (n, h, w) batch of
    `filt` on `backend` (default: `device`'s): dataflow kind, tap extents
    and resolved mult_impl included, one `resolve_blocks` consult. The
    serving layer's per-bucket memo hook; `block_cols` is in the cache's
    vocabulary (None is full width on the CPU)."""
    spec = get_filter(filt) if isinstance(filt, str) else filt
    separable = spec.separable if separable is None else separable
    fused = separable if fused is None else fused
    dataflow = "fused" if fused and separable else "direct"
    kind, kh, kw = _pass_kind(spec, dataflow)
    return resolve_blocks_cached(kind, n, h, w, kh, kw,
                                 _resolve_mult_impl(mult_impl),
                                 _backend(device, backend))


def resolve_filter_plan(filt: FilterSpec | str, n: int | None = None,
                        h: int | None = None, w: int | None = None, *,
                        method: str = "refmlm", mult_impl: str = "auto",
                        separable: bool | None = None,
                        fused: bool | None = None,
                        device: str | torch.device | None = None,
                        backend: str | None = None) -> PlanConfig:
    """The fully concrete plan `apply_filter` runs for an (n, h, w) batch of
    `filt` on `backend` (default: `device`'s; the card's for None): the
    dataflow, the resolved mult_impl and the grid, one plan-cache consult.
    Fields the plan defers are concretized through the block cache of the
    matching pass (a full-width CPU tile pins as `block_cols=w`). The
    serving layer's per-bucket memo hook. With no shape, only the dataflow
    and mult_impl resolve (the cache is keyed on the shape): the grid stays
    None."""
    spec = get_filter(filt) if isinstance(filt, str) else filt
    for dim in (n, h, w):
        if dim is not None and int(dim) < 1:
            raise ValueError(f"batch and image sizes must be positive, got "
                             f"{(n, h, w)}")
    if None in (n, h, w):
        return PlanConfig(allowed_dataflows(spec.separable, separable, fused)[0],
                          _resolve_mult_impl(mult_impl))
    backend = _backend(device, backend)
    plan = resolve_plan(spec.name, n, h, w, *spec.ksize,
                        separable_ok=spec.separable, mult_impl=mult_impl,
                        separable=separable, fused=fused, backend=backend)
    impl = _resolve_mult_impl(plan.mult_impl)
    if None in (plan.block_rows, plan.block_cols, plan.batch_fold):
        kind, kh, kw = _pass_kind(spec, plan.dataflow)
        base = resolve_blocks_cached(kind, n, h, w, kh, kw, impl, backend)
        return PlanConfig(
            plan.dataflow, impl,
            base.block_rows if plan.block_rows is None else plan.block_rows,
            (plan.block_cols if plan.block_cols is not None
             else w if base.block_cols is None else base.block_cols),
            base.batch_fold if plan.batch_fold is None else plan.batch_fold)
    return plan._replace(mult_impl=impl)


def plan_tile(filt: FilterSpec | str, plan: PlanConfig) -> PlanTile:
    """The tile `plan` launches for `filt` on the card: the route
    (`kernel_route`) of its last pass -- the fused kernel, the direct pass,
    or the two-pass column pass -- and the plan's grid where it is a tile
    of that route's menu, else the route's first tile (a CPU-vocabulary
    grid, or none)."""
    spec = get_filter(filt) if isinstance(filt, str) else filt
    _, kh, kw = _pass_kind(spec, plan.dataflow)
    route = kernel_route(kh, kw, fused=plan.dataflow == "fused")
    tile = (plan.block_rows, plan.block_cols)
    if tile not in TILE_MENU[route]:
        tile = TILE_MENU[route][0]
    return PlanTile(route, *tile)


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
           "filter_bank_apply", "plan_tile", "resolve_filter_blocks",
           "resolve_filter_plan"]
