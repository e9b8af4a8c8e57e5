"""`repro_torch.serve` -- online image-filter serving on the port's
REFMLM datapath (DESIGN.md §10-§15), on the CUDA card by default.

Counterpart of `repro.serve`: a request queue with weighted admission
control, a shape-bucketed micro-batcher coalescing concurrent same-shape
requests into one batched `apply_filter` call on the Hopper kernels, the
§13 SLO-adaptive flush controller, priorities and per-tenant quotas, the
§12 bisection fault isolation, and the §15 metrics, traces and dispatch
profile.

Layers:
  request.py    -- `FilterRequest` / `FilterFuture`, `bucket_key`,
                   `serve_key`, priorities and weighted admission slots;
  admission.py  -- `AdmissionGate`, `ServerOverloaded`, `TenantOverQuota`;
  batcher.py    -- `ShapeBucketedBatcher`, the pure flush state machine;
  controller.py -- `AdaptiveBatchController`, per-bucket flush size and
                   deadline from the roofline-priced plan ledger;
  workload.py   -- the pluggable `Workload` classes ('filter' built in;
                   `repro_torch.infer.serving.InferWorkload` adds 'infer');
  executor.py   -- micro-batch -> one device dispatch ending in one copy
                   to host memory, the plan memo, pow-2 batch rounding,
                   bisection;
  pool.py       -- `ExecutorPool`, rendezvous-routed executors over
                   explicit device subsets, probed and rebuilt or retired
                   on device loss (`repro_torch.runtime.elastic`);
  server.py     -- `ImageFilterServer` / `ServerConfig`;
  warmup.py     -- `python -m repro_torch.serve.warmup`.

    from repro_torch.serve import ImageFilterServer, ServerConfig
    with ImageFilterServer(ServerConfig(max_batch=8)) as srv:  # device='cpu'
        fut = srv.submit(img, "gaussian5", method="refmlm")    # for the CPU
        out = fut.result()   # CPU uint8 == apply_filter(img, ...).cpu()

Buckets of the scale-out exec modes ('sharded', 'streamed') dispatch
through `repro_torch.distribute`; `ServerConfig(pool=...)` serves through
the elastic executor pool (pool.py).
"""
from __future__ import annotations

from repro_torch.serve.admission import (
    AdmissionGate,
    ServerClosed,
    ServerDegraded,
    ServerOverloaded,
    TenantOverQuota,
)
from repro_torch.serve.batcher import (
    FLUSH_REASONS,
    SHED_CAUSES,
    FlushPolicy,
    MicroBatch,
    ShapeBucketedBatcher,
    ShedRequest,
)
from repro_torch.serve.controller import AdaptiveBatchController
from repro_torch.serve.executor import SCALE_OUT_MODES, BatchExecutor, next_pow2
from repro_torch.serve.pool import ExecutorPool, PoolMember
from repro_torch.serve.request import (
    PRIORITIES,
    DeadlineExceeded,
    FilterFuture,
    FilterRequest,
    bucket_key,
    request_weight,
    serve_key,
)
from repro_torch.serve.server import ImageFilterServer, ServerConfig
from repro_torch.serve.workload import FilterWorkload, Workload, resolve_workloads

__all__ = [
    "FLUSH_REASONS",
    "PRIORITIES",
    "SCALE_OUT_MODES",
    "SHED_CAUSES",
    "AdaptiveBatchController",
    "AdmissionGate",
    "BatchExecutor",
    "DeadlineExceeded",
    "ExecutorPool",
    "FilterFuture",
    "FilterRequest",
    "FilterWorkload",
    "FlushPolicy",
    "ImageFilterServer",
    "MicroBatch",
    "PoolMember",
    "ServerClosed",
    "ServerConfig",
    "ServerDegraded",
    "ServerOverloaded",
    "ShapeBucketedBatcher",
    "ShedRequest",
    "TenantOverQuota",
    "Workload",
    "bucket_key",
    "next_pow2",
    "request_weight",
    "resolve_workloads",
    "serve_key",
]
