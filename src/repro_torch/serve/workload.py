"""Pluggable serving workload classes (DESIGN.md §14).

Counterpart of `repro.serve.workload`. A `Workload` is everything the
serving machinery does NOT need to know about the work it coalesces:
payload validation, the device dispatch of a flushed bucket, deploy-time
warmup, and the cost-model hook the adaptive controller prices flushes
with. Admission, weighted quotas, shape-bucketed batching, priorities,
SLO-adaptive flushes and bisection fault isolation operate on
`FilterRequest`/`MicroBatch` alone.

Two instances ship:

  * `FilterWorkload` ('filter') -- the image-filter path: one
    `apply_filter` call on the executor's device under the executor's plan
    memo;
  * `repro_torch.infer.serving.InferWorkload` ('infer') -- quantized
    network inference on the approximate-multiplier stack.

Where the reference passes `interpret=`, the port passes the executor's
torch device. A dispatch ends in one synchronizing copy of the whole batch
to host memory: a device error is raised in the dispatch it belongs to
(inside the executor's bisection), and the executor's timing covers the
device work, not only the launches. Outputs are CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.filters.bank import get_filter
from repro_torch.filters.conv import MULT_IMPLS
from repro_torch.filters.pipeline import apply_filter
from repro_torch.serve.request import FilterRequest, request_weight


class Workload:
    """One serving workload class. Subclasses define the five hooks; the
    server, executor and controller call them through the `workloads`
    registry keyed by `FilterRequest.workload`."""

    name = "base"

    def validate(self, payload, *, target: str, method: str, mult_impl: str,
                 exec_mode: str, nbits: int) -> np.ndarray:
        """Client-thread validation: raise on a bad request, return the
        canonical 2-D payload array the request will carry."""
        raise NotImplementedError

    def weight(self, arr: np.ndarray) -> int:
        """Weighted admission slots this payload occupies (§13)."""
        return request_weight(*arr.shape[:2])

    def execute(self, executor, requests: tuple[FilterRequest, ...],
                traced_n: int, exec_mode: str) -> list[torch.Tensor]:
        """One dispatch of a coalesced bucket slice on `executor.device`;
        one CPU output per request, no retry (the §12 ladder wraps this)."""
        raise NotImplementedError

    def warm(self, executor, shape: tuple[int, int], target: str, *,
             method: str, mult_impl: str, exec_mode: str, nbits: int,
             traced_n: int) -> None:
        """Run one (bucket, traced batch size) point with dummy data."""
        raise NotImplementedError

    def model_bound(self, req: FilterRequest, n: int, *,
                    backend: str | None = None) -> float | None:
        """Analytic lower bound (seconds) of one `n`-sized dispatch, for
        the §13 controller's cold-start prediction. None = no model."""
        return None


_NARROW = (np.uint8, np.int8, np.uint16, np.int16, np.int32)


def _host_batch(imgs: list[np.ndarray], traced_n: int) -> torch.Tensor:
    """(traced_n, H, W) batch in host memory: the images, then zero
    images, in the images' own dtype when they share a narrow integer one
    (a uint8 frame crosses to the device in a quarter of int32's bytes);
    `apply_filter` widens it to int32 there, as the reference casts."""
    dtype = imgs[0].dtype
    if dtype not in _NARROW or any(im.dtype != dtype for im in imgs):
        dtype = np.int32
    batch = np.zeros((traced_n, *imgs[0].shape), dtype)
    for i, im in enumerate(imgs):
        batch[i] = im
    return torch.from_numpy(batch)


class FilterWorkload(Workload):
    """The image-filter path: one micro-batch becomes one `apply_filter`
    call on the executor's device, planned by the executor's plan memo."""

    name = "filter"

    def validate(self, payload, *, target: str, method: str, mult_impl: str,
                 exec_mode: str, nbits: int) -> np.ndarray:
        if mult_impl not in MULT_IMPLS:
            raise ValueError(f"mult_impl must be one of {MULT_IMPLS}, got "
                             f"{mult_impl!r}")
        get_filter(target)                   # unknown names fail fast
        if isinstance(payload, torch.Tensor):
            payload = payload.cpu().numpy()
        arr = np.asarray(payload)
        if arr.ndim == 3 and arr.shape[-1] == 1:
            arr = arr[..., 0]
        if arr.ndim != 2:
            raise ValueError(f"expected one (H, W) image per request, got "
                             f"shape {arr.shape}")
        return arr

    def _run(self, executor, imgs: list[np.ndarray], target: str, *,
             method: str, mult_impl: str, exec_mode: str, nbits: int,
             traced_n: int) -> torch.Tensor:
        """One `apply_filter` over the padded batch -> the first len(imgs)
        outputs in host memory: copied back at the end (the dispatch's one
        sync), or, streamed, assembled there tile batch by tile batch."""
        h, w = imgs[0].shape
        kw = executor._exec_kw(exec_mode, target, method, mult_impl,
                               traced_n, h, w)
        if exec_mode == "streamed":
            batch = _host_batch(imgs, traced_n)
            out = apply_filter(batch, target, method=method, nbits=nbits,
                               device=executor.device, **kw)
            return torch.from_numpy(out[:len(imgs)])
        out = apply_filter(_host_batch(imgs, traced_n).to(executor.device),
                           target, method=method, nbits=nbits,
                           device=executor.device, **kw)
        return out[:len(imgs)].cpu()

    def execute(self, executor, requests: tuple[FilterRequest, ...],
                traced_n: int, exec_mode: str) -> list[torch.Tensor]:
        r0 = requests[0]
        out = self._run(executor, [r.img for r in requests], r0.filt,
                        method=r0.method, mult_impl=r0.mult_impl,
                        exec_mode=exec_mode, nbits=r0.nbits,
                        traced_n=traced_n)
        return list(out.unbind(0))

    def warm(self, executor, shape: tuple[int, int], target: str, *,
             method: str, mult_impl: str, exec_mode: str, nbits: int,
             traced_n: int) -> None:
        self._run(executor, [np.zeros(shape, np.int32)] * traced_n, target,
                  method=method, mult_impl=mult_impl, exec_mode=exec_mode,
                  nbits=nbits, traced_n=traced_n)

    def model_bound(self, req: FilterRequest, n: int, *,
                    backend: str | None = None) -> float | None:
        """Roofline lower bound of the bucket's plan, resolved for
        `backend` (the card's for None), on the tile it launches there."""
        from repro_torch.filters.pipeline import plan_tile, resolve_filter_plan
        from repro_torch.roofline.conv_model import plan_cost
        from repro_torch.tuning.cache import backend_key
        h, w = req.img.shape
        spec = get_filter(req.filt)
        backend = backend or backend_key()
        plan = resolve_filter_plan(spec, n, h, w, method=req.method,
                                   mult_impl=req.mult_impl, backend=backend)
        tile = plan_tile(spec, plan)
        kh, kw = ((len(spec.sep_col), len(spec.sep_row))
                  if plan.dataflow == "fused" else spec.ksize)
        cost = plan_cost(plan.dataflow, plan.mult_impl, n, h, w, kh, kw,
                         block_rows=tile.block_rows,
                         block_cols=tile.block_cols,
                         batch_fold=tile.batch_fold, backend=backend)
        return cost.lower_bound_s


def resolve_workloads(extra: dict[str, Workload] | None = None
                      ) -> dict[str, Workload]:
    """The serving registry: the built-in filter workload plus any extra
    classes (e.g. `InferWorkload`). 'filter' is always present so the
    default submit path never misses."""
    registry: dict[str, Workload] = {"filter": FilterWorkload()}
    registry.update(extra or {})
    return registry


__all__ = ["FilterWorkload", "Workload", "resolve_workloads"]
