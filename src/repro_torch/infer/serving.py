"""`InferWorkload` -- quantized network inference as a second serving
workload class (DESIGN.md §14).

Counterpart of `repro.infer.serving`. In place of the reference's
jit memo the port keeps its own `forward` per (model, method,
nbits), which runs the Mitchell-family methods on `mitchell_matmul` and
the limb methods on `karatsuba_matmul_i8` on the card. A dispatch ends
in one synchronizing copy of the logits to host memory; served logits are
CPU float32 rows equal to the direct `forward`'s.

Registered under `ServerConfig(workloads={"infer": InferWorkload(models)})`,
it rides every piece of the §10-§13 machinery unchanged: requests coalesce
by `bucket_key` (model name x method x shape x priority, suffixed
'/infer' so they can never share a batch with filter traffic), admission
charges the same weighted slots, the §12 bisection ladder isolates
poisoned requests, and the §13 controller prices flushes with this
workload's MAC-count model until real observations land.

Byte-equality of served vs direct inference is structural, not luck:

  * scales are *static* (calibrate.py) -- a batcher's zero-pad rows cannot
    perturb them;
  * every op in the quantized forward is row-independent (per-sample conv,
    per-row matmul, elementwise requantization) with exact int32
    accumulators;

so `forward(cal, x[None])[0]` and any coalesced batch containing row `x`
produce the same bytes, for every quantized method and flush size
(tests/test_infer.py, `scripts/check.sh --smoke-infer`).

One forward per (model, method, nbits) is kept in a small memo -- the
infer analogue of the executor's plan memo; pow-2 batch rounding (§10)
bounds the batch sizes it runs at exactly like the filter path's. The
models live on one device (calibrated there); the executor's device must
be theirs.
"""
from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from repro_torch.infer.calibrate import CalibratedModel
from repro_torch.infer.graph import Conv, Dense
from repro_torch.infer.runner import INFER_METHODS, forward
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.request import FilterRequest
from repro_torch.serve.workload import Workload

#: rough sustained MAC rate (MAC/s) for the cold-start cost model -- only
#: the *ratios* between batch sizes matter to the controller's ladder
#: walk, and observations replace this after the first real dispatch.
_MACS_PER_S = 5e7


def _model_macs(cal: CalibratedModel) -> int:
    """Multiply-accumulates of one sample's forward pass."""
    h, w = cal.graph.input_hw
    macs = 0
    for layer in cal.graph.layers:
        if isinstance(layer, Dense):
            macs += layer.d_in * layer.d_out
        elif isinstance(layer, Conv):
            macs += h * w * layer.ksize * layer.ksize * layer.c_in * layer.c_out
            if layer.pool > 1:
                h, w = h // layer.pool, w // layer.pool
    return macs


class InferWorkload(Workload):
    """Serving adapter for a registry of calibrated models."""

    name = "infer"

    def __init__(self, models: dict[str, CalibratedModel]) -> None:
        if not models:
            raise ValueError("InferWorkload needs at least one model")
        self.models = dict(models)
        self._lock = threading.Lock()
        self._fns: dict[tuple[str, str, int], object] = {}
        self.compiles = 0

    # ------------------------------------------------------------ validation
    def validate(self, payload, *, target: str, method: str, mult_impl: str,
                 exec_mode: str, nbits: int) -> np.ndarray:
        cal = self.models.get(target)
        if cal is None:
            raise ValueError(f"unknown infer model {target!r}; registered: "
                             f"{tuple(self.models)}")
        if method not in INFER_METHODS or method == "exact":
            quantized = tuple(m for m in INFER_METHODS if m != "exact")
            raise ValueError(f"infer method must be one of {quantized}, "
                             f"got {method!r}")
        if exec_mode != "local":
            raise ValueError("infer workload serves exec='local' only "
                             f"(got {exec_mode!r}); scale-out modes are "
                             "filter-specific (DESIGN.md §9)")
        if mult_impl != "auto":
            raise ValueError("infer routes multipliers per scalar product; "
                             f"mult_impl must stay 'auto', got {mult_impl!r}")
        if nbits != cal.nbits:
            raise ValueError(f"model {target!r} is calibrated for "
                             f"nbits={cal.nbits}, got {nbits}")
        if isinstance(payload, torch.Tensor):
            payload = payload.cpu().numpy()
        arr = np.asarray(payload, dtype=np.float32)
        if arr.ndim == 3 and arr.shape[-1] == 1:
            arr = arr[..., 0]
        if arr.ndim != 2 or arr.shape != cal.graph.input_hw:
            raise ValueError(f"model {target!r} expects one "
                             f"{cal.graph.input_hw} image, got {arr.shape}")
        return arr

    # -------------------------------------------------------------- dispatch
    def _fn(self, target: str, method: str, nbits: int):
        """The (model, method)-pinned batched forward -- this workload's
        plan memo."""
        memo = (target, method, nbits)
        with self._lock:
            fn = self._fns.get(memo)
            if fn is None:
                cal = self.models[target]
                fn = functools.partial(forward, cal, method=method)
                self._fns[memo] = fn
                self.compiles += 1
                if obs_trace.tracing():
                    # §15: infer plan-memo misses are the first dispatch
                    # of a (model, method), worth seeing on the trace
                    obs_trace.emit("infer", model=target, method=method,
                                   nbits=nbits, compiles=self.compiles)
        return fn

    def _check_device(self, executor, target: str) -> None:
        if self.models[target].device != executor.device:
            raise ValueError(f"model {target!r} lives on "
                             f"{self.models[target].device}, the executor "
                             f"on {executor.device}")

    def execute(self, executor, requests: tuple[FilterRequest, ...],
                traced_n: int, exec_mode: str) -> list[torch.Tensor]:
        r0 = requests[0]
        self._check_device(executor, r0.filt)
        h, w = r0.img.shape
        x = np.zeros((traced_n, h, w), dtype=np.float32)
        for i, r in enumerate(requests):
            x[i] = r.img
        logits = self._fn(r0.filt, r0.method, r0.nbits)(x)
        return list(logits[:len(requests)].cpu().unbind(0))

    def warm(self, executor, shape: tuple[int, int], target: str, *,
             method: str, mult_impl: str, exec_mode: str, nbits: int,
             traced_n: int) -> None:
        cal = self.models.get(target)
        if cal is None:
            raise ValueError(f"unknown infer model {target!r}")
        self._check_device(executor, target)
        h, w = cal.graph.input_hw
        zeros = np.zeros((traced_n, h, w), dtype=np.float32)
        self._fn(target, method, nbits)(zeros).cpu()

    # ------------------------------------------------------------ cost model
    def model_bound(self, req: FilterRequest, n: int, *,
                    backend: str | None = None) -> float | None:
        cal = self.models.get(req.filt)
        if cal is None:
            return None
        return n * _model_macs(cal) / _MACS_PER_S


__all__ = ["InferWorkload"]
