"""Three-term roofline of one step of the port's own program, counted on
fake tensors.

    compute    = sum over dtypes of flops_per_device[dtype] / peak[dtype]
    memory     = bytes_per_device / HBM rate
    collective = collective bytes_per_device / interconnect rate

Counterpart of `repro.roofline.analysis`. There XLA compiles the
partitioned program and `cost_analysis()` reads it. Here one step of the
port's program runs on fake tensors (`FakeTensorMode`) over a fake process
group the size of the mesh (`repro_torch.launch.mesh.fake_production_mesh`):
this process is rank 0, its program is every rank's, and what it counts is
per device. Nothing is allocated and nothing is launched. `StepCounter`, a
`TorchDispatchMode`, sees every aten op of the step (forward, remat
recompute and backward alike); `core.collectives.COLLECTIVES` sees every
collective.

How the counts differ from XLA's:
  * flops are those of matmul-class aten ops only (mm, addmm, bmm, baddbmm,
    convolution, attention), by `torch.utils.flop_counter`'s formulas (two
    a multiply-add), kept by the dtype of the op's first operand, plus what
    a hand-written kernel's wrapper records for a fake call
    (`record_kernel`: `mitchell_matmul`'s int32 operations, the limb
    product's int8 multiply-adds). XLA counts element-wise flops too; here
    element-wise work enters through bytes only;
  * bytes are each aten op's tensor inputs read once and outputs written
    once. View ops, empty allocations, collectives (c10d ops) and other
    namespaces' ops (`prim.device`) move none. XLA counts
    the operands of its fused kernels, so an eager program, which
    materializes every intermediate, counts more;
  * collective bytes follow the reference's convention, the result's size:
    the whole tensor an all-gather assembles, the tensor an all-reduce
    reduces;
  * the peak is of live storages: the step's arguments (`track_inputs`)
    and every storage an op makes, freed when its last tensor dies (weak
    references), the allocator's rounding and caching not counted.

The card's rates are NVIDIA's data sheet for the H100 SXM at its 700 W
limit: dense tensor-core bf16 and int8, float32 outside the tensor cores
(the port runs float32 matmuls with TF32 off), the int32 rate that
`conv_model.HW_PRESETS["cuda"]` and chip_smoke.py's bounds use.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import Counter
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
#: `core.collectives` kind prefix -> the reference's collective name
_KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
          "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
          "collective_permute": "collective-permute"}

#: bytes a second between the cards of the production meshes (32 or 64
#: hosts of 8): one 400 Gb/s NDR port a card, the DGX H100 layout. A mesh
#: of up to 8 ranks stays on one host, where NVLink moves 450e9 bytes a
#: second each way; no planned mesh is that small, so no term uses it.
NDR_BW = 50e9


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 989e12          # bf16 FLOP/s per card (dense tensor cores)
    f32_flops: float = 67e12            # float32 FLOP/s per card (no tensor cores)
    int8_ops: float = 1979e12           # int8 OP/s per card (dense tensor cores)
    int32_ops: float = 1.6727e13        # int32 OP/s per card (CUDA cores)
    hbm_bw: float = 3.35e12             # bytes/s per card
    ici_bw: float = NDR_BW              # bytes/s per card between hosts

    def peak(self, dtype: str) -> float:
        """The card's rate for ops of `dtype` (a `torch.dtype` name)."""
        if dtype in ("bfloat16", "float16"):
            return self.peak_flops
        if dtype == "int8":
            return self.int8_ops
        if dtype in ("int32", "int64", "int16"):
            return self.int32_ops
        return self.f32_flops


@dataclasses.dataclass
class RooflineReport:
    flops: float                        # per-device flops, every dtype
    hbm_bytes: float                    # per-device bytes accessed
    coll_bytes: float                   # per-device collective bytes
    coll_breakdown: dict[str, float]
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float = 0.0            # 6*N*D useful flops (global)
    useful_ratio: float = 0.0           # model_flops / (flops * chips)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class StepCounts:
    """What `StepCounter` counted over one step, per device."""
    flops_by_dtype: dict[str, float]
    hbm_bytes: float
    collectives: dict[str, float]       # core.collectives' kinds: calls and _bytes
    kernels: dict[str, dict[str, float]]   # name -> calls, ops, bytes
    aten_ops: int
    argument_bytes: int
    output_bytes: int
    alias_bytes: int
    peak_bytes: int

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - self.argument_bytes

    def to_json(self) -> dict:
        return {**dataclasses.asdict(self), "flops": self.flops, "temp_bytes": self.temp_bytes}


def collective_bytes(counts: dict | None = None) -> tuple[float, dict[str, float]]:
    """(total, breakdown under the reference's five names) of the bytes in
    `counts`, a `core.collectives.COLLECTIVES`-like mapping (that counter
    for None)."""
    if counts is None:
        from repro_torch.core.collectives import COLLECTIVES as counts
    breakdown = dict.fromkeys(_COLLECTIVES, 0.0)
    for key, value in counts.items():
        if not key.endswith("_bytes"):
            continue
        kind = next((name for prefix, name in _KINDS.items() if key.startswith(prefix)), None)
        if kind is None:
            raise KeyError(f"collective kind {key!r} has no roofline name")
        breakdown[kind] += float(value)
    return float(sum(breakdown.values())), breakdown


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local block (what this rank holds), else `t`."""
    return getattr(t, "_local_tensor", t)


def _tensors(tree) -> list[torch.Tensor]:
    from torch.utils._pytree import tree_leaves
    return [_local(x) for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


#: aten ops that move no bytes: allocations without a fill, aliases, metadata
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "detach", "alias", "lift_fresh", "_unsafe_view", "_local_scalar_dense", "set_",
               "resize_", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset"}


def record_kernel(name: str, *, ops: float, dtype: str, nbytes: float) -> None:
    """A hand-written kernel's work for one fake call (`ops` operations of
    `dtype`, `nbytes` moved), added to every `StepCounter` on the dispatch
    mode stack."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    for counter in _get_current_dispatch_mode_stack():
        if not isinstance(counter, StepCounter):
            continue
        counter.flops[dtype] += ops
        counter.hbm_bytes += nbytes
        k = counter.kernels.setdefault(name, {"calls": 0, "ops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["ops"] += ops
        k["bytes"] += nbytes


class StepCounter(TorchDispatchMode):
    """Counts flops by dtype, bytes and the peak of live storage bytes of
    the aten ops run under it (module docstring); with the collectives
    counted meanwhile and the kernels' `record_kernel` calls, `counts()`
    gives a `StepCounts`. Enter it inside the `FakeTensorMode`."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._formulas = flop_registry
        self.flops: Counter = Counter()
        self.hbm_bytes = 0.0
        self.kernels: dict[str, dict[str, float]] = {}
        self.aten_ops = 0
        self._live: dict[int, int] = {}
        self.live_bytes = self.peak_bytes = 0
        self._arguments: set[int] = set()
        self.argument_bytes = self.output_bytes = self.alias_bytes = 0
        self._coll0: Counter = Counter()
        self._coll: dict = {}

    # ------------------------------------------------------------ storages
    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._live:
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)
        return key

    def track_inputs(self, tree) -> None:
        """The step's arguments: live from the start, `argument_bytes`."""
        for t in _tensors(tree):
            self._arguments.add(self._track(t))
        self.argument_bytes = sum(self._live[k] for k in self._arguments)

    def track_outputs(self, tree) -> None:
        """The step's results: `output_bytes` (new storages) and
        `alias_bytes` (storages of the arguments, updated in place)."""
        seen: set[int] = set()
        for t in _tensors(tree):
            st = t.untyped_storage()
            if st._cdata in seen:
                continue
            seen.add(st._cdata)
            if st._cdata in self._arguments:
                self.alias_bytes += st.nbytes()
            else:
                self.output_bytes += st.nbytes()

    # ------------------------------------------------------------ dispatch
    def __enter__(self):
        from repro_torch.core.collectives import COLLECTIVES
        self._coll0 = Counter(COLLECTIVES)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.core.collectives import COLLECTIVES
        self._coll = {k: v - self._coll0.get(k, 0) for k, v in COLLECTIVES.items()
                      if v != self._coll0.get(k, 0)}
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        aten = func.namespace == "aten"
        self.aten_ops += aten
        packet = func._overloadpacket
        if packet in self._formulas:
            first = next(t for t in _tensors((args, kwargs)))
            self.flops[str(first.dtype).removeprefix("torch.")] += float(
                self._formulas[packet](*args, **kwargs, out_val=out))
        if aten and not (func.is_view or packet.__name__ in _NO_TRAFFIC):
            self.hbm_bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.hbm_bytes += sum(_nbytes(t) for t in _tensors(out))
        for t in _tensors(out):
            self._track(t)
        return out

    def counts(self) -> StepCounts:
        return StepCounts(
            flops_by_dtype=dict(self.flops), hbm_bytes=float(self.hbm_bytes),
            collectives=dict(self._coll), kernels={k: dict(v) for k, v in self.kernels.items()},
            aten_ops=self.aten_ops, argument_bytes=self.argument_bytes,
            output_bytes=self.output_bytes, alias_bytes=self.alias_bytes,
            peak_bytes=self.peak_bytes)


def analyze_step(counts: StepCounts, *, hw: HW = HW(), model_flops_val: float = 0.0,
                 chips: int = 1) -> RooflineReport:
    """The roofline of one counted step: `analyze_compiled`'s counterpart."""
    flops = counts.flops
    coll, breakdown = collective_bytes(counts.collectives)
    compute_s = sum(f / hw.peak(dtype) for dtype, f in counts.flops_by_dtype.items())
    memory_s = counts.hbm_bytes / hw.hbm_bw
    collective_s = coll / hw.ici_bw
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    return RooflineReport(
        flops=flops, hbm_bytes=counts.hbm_bytes, coll_bytes=coll, coll_breakdown=breakdown,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck, model_flops=model_flops_val,
        useful_ratio=(model_flops_val / (flops * chips)) if flops else 0.0,
    )


def model_flops(cfg, n_params: int, shape) -> float:
    """6*N*D with N = active params (MoE: total minus inactive experts).

    For decode shapes D = global_batch tokens (one step); for train/prefill
    D = global_batch * seq_len. Backward pass (train) is the standard 3x
    forward -> the 6 factor; prefill/decode use 2*N*D (forward only).
    """
    n_active = n_params - cfg.inactive_expert_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch          # one new token per row
    return 2.0 * n_active * tokens


def memory_analysis_dict(counts: StepCounts) -> dict[str, Any]:
    """The reference's memory_analysis() fields from a counted step: the
    arguments at rest, the new outputs, the peak above the arguments, the
    outputs written into the arguments; no generated code."""
    return {"argument_size_in_bytes": counts.argument_bytes,
            "output_size_in_bytes": counts.output_bytes,
            "temp_size_in_bytes": counts.temp_bytes,
            "generated_code_size_in_bytes": None,
            "alias_size_in_bytes": counts.alias_bytes}


__all__ = ["HW", "NDR_BW", "RooflineReport", "StepCounter", "StepCounts",
           "analyze_step", "collective_bytes", "memory_analysis_dict", "model_flops",
           "record_kernel"]
