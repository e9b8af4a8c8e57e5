#!/usr/bin/env python3
"""Run the PyTorch / CUDA port of the REFMLM datapaths on one CUDA card.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each fatal on failure:
  1. card   -- the device name, and nvidia-smi's name and power limit;
  2. build  -- nvcc builds every kernel of `src/repro_torch/csrc` for sm_90a;
               the SASS of `karatsuba_matmul_i8` must hold IMMA instructions;
  3. parity -- each of the seven kernels against its plain PyTorch version
               on the same CUDA tensors (torch.equal). The four conv kernels:
               every bank filter and the paper's Fig. 9 table x six
               multipliers x two shapes, plus the 16-bit signed second pass
               of the two-pass dataflow, and every measurement variant of
               `conv_pass_kcm`. The two recurse kernels besides: every
               method (mitchell_ecc1..3 too) at nbits 2, 4, 8 and 16 on
               signed operands, coefficients with four non-zero digits
               (+-255, +-170), zero and negative taps, every compiled tap
               shape and the tiled ones, the persistent kernels equal to
               the tiled kernels of the first design (variant 0, the C
               entry given no plan). Every conv kernel again on operands at
               or past the ROMs (+-2**nbits, +-300 at 8 bits, +-70000 at
               16) and at the Mitchell lane's int32 extremes (+-2**30 up to
               2**31 - 1 and -2**31), both carry widths, and the fused kcm kernel against its tiled kernel of
               the first design (variant 0). The three matmul kernels: every
               (num_ecc, case_split) of `mitchell_matmul`; both limb modes of
               `karatsuba_matmul_i8` (int8 limbs, their edges -128 / 127 and
               hi + lo = -128 included) and of the wide `karatsuba_matmul`
               (limbs past int8, up to 2**20) on ragged shapes and on the
               full-width shape below with M cut to 256 rows; each limb call
               must take the kernel the wrapper's rule names; `mitchell_matmul`
               again at the shapes of each route of its launch plan (the LM
               decode calls at M = 1 and 4, ragged thin calls, a prefill
               call, a tiled call), 8-bit and full-range int32 operands,
               every variant:
               each call must launch the route its plan names, and both
               routes must run K splits > 1;
  4. main   -- the filter path: the port's entry points on N=8 480x640
               noisy fingerprint frames (the FVC2004 DB1 frame size): the
               filter bank for every multiplier through the default plans
               and through 'recurse', REFMLM bytes == exact bytes, a forced
               two-pass run, the serving batch hook with padding, the port's
               oracle on a small batch, the paper's Table 10 assertions;
               every conv kernel must have been launched, and every fused
               kcm and recurse launch must have taken its persistent kernel;
  5. matmul -- the quantized-matmul path at full width: `core.matmul(impl=
               'auto')` for the six kernel methods and `kernels.ops.
               lns_matmul` / `limb_matmul` on the Qwen2-0.5B MLP up-projection
               (d_model 896 -> d_ff 4864, M = 2048 tokens); `mitchell_matmul`
               and `karatsuba_matmul_i8` must have been launched, the wide
               `karatsuba_matmul` never;
  6. infer  -- `infer.forward` of cnn and mlp over a 256-image 64x64 batch,
               calibrated on the card: the Table-10-style report, the §14
               contract (refmlm, refmlm_kom3, schoolbook_int16 and
               karatsuba_int16 accumulators byte-equal to the int8 oracle),
               and the card's bytes equal to the port's CPU path on the first
               images for every quantized method; the same launches as 5;
  7. wide   -- `infer.forward` of both models calibrated at 14 bits with
               karatsuba_int16, whose limbs pass int8 (w = 7, |hi| up to 128):
               accumulators equal to the int8 oracle, and the wide
               `karatsuba_matmul` must have been launched;
  8. scale  -- apply_filter(gaussian5, refmlm) on N=16 2048x2048 frames;
  9. tiles  -- each persistent conv kernel at each tile of the menu
               (`repro_torch.tuning.blocks.TILE_MENU`; every tap shape it is
               compiled for, every chunk of the recurse kernels' menu)
               byte-equal to its plain version on the main-path and scale
               frames and on them with operands past the ROMs and at the
               int32 extremes; every multiplier at 8x480x640, refmlm at
               16x2048x2048; [tile] lines: device ms and shared memory,
               blocks an SM and registers of each kernel at each tile;
 10. tune   -- `python -m repro_torch.tuning.autotune --quick` into an empty
               cache directory; `resolve_filter_plan` returns the stored
               winner, and default-argument `apply_filter` gives the same
               bytes as with an empty cache;
 11. sharded -- 16x2048x2048 gaussian5 through exec='sharded' on this card
               (a 1x1 mesh), both halos, byte-equal to the local pass;
 12. streamed -- a 1x10980x10980 uint8 scene (a Sentinel-2 L1C 10 m granule's
               grid) on a memmap streamed into a memmap at (2048, 2048) x 4
               and (256, 256) x 8 tiles, byte-equal to one local pass of the
               scene; a run killed at a tile and resumed, byte-identical and
               recomputing only the unjournaled tiles; [stream] lines;
 13. serve  -- `repro_torch.serve.ImageFilterServer` on the card, after 8
               (the times phase follows it): both buckets warmed (480x640
               fingerprint frames: gaussian3, gaussian5, sobel_x, sharpen3,
               laplacian x kcm / recurse; 2048x2048 satellite frames:
               gaussian5 kcm on a second server with max_batch 16), then 4
               client threads submit 96 fingerprint frames at mixed
               priorities, 16 satellite frames and 8 cnn infer requests
               (mitchell and karatsuba_int16, 64x64 patches); every served
               output byte-equal to the direct call on the card; launches by
               kernel equal to dispatches x launches a call; one poisoned
               round fails its seq alone. [serve] lines: frames a second and
               p50 / p99 latency per bucket and per kind (from the server's
               trace), the hit/miss and plan-memo counters, the profiler's
               measured / plan_cost drift; then one streamed bucket and one
               sharded bucket (8 frames each) served byte-equal to the
               direct call, neither falling back to the local path.
 14. pool   -- `ImageFilterServer(pool=((0,), (0,)), drain_after=2)`: two
               members on this card, and a solo server, serve the same 96
               frames of two local and two sharded buckets, byte-equal to
               the direct call; [pool] lines: frames/s, p50 / p99 (the
               servers' traces), routes and dispatches per member; then
               device 0 lost to sharded work (`SITE_SHARD` `dev0`): the
               routed member probes and is retired, the survivor serves the
               rest byte-equal and refuses its own drain (the last member);
 15. lm     -- Qwen2-0.5B at full published width (24 layers, d_model 896,
               14 / 2 heads x 64, d_ff 4864, vocab 151936, tied, bf16,
               random weights from a seeded generator): first cut to 2
               layers, karatsuba_int16's logits on the kernels byte-equal
               to the plain route (`impl='reference'`), every
               `mitchell_matmul` call's accumulators equal to
               `mitchell_matmul_plain`'s, and mitchell's logits against the
               float32-summing reference route (R5); then `greedy_generate`
               at the reference CLI's traffic (batch 4, prompt 32, 32 tokens)
               for exact, mitchell and karatsuba_int16; [lm] lines: prefill
               ms, decode ms a token, tokens/s, launches and host syncs a
               decode step (the CUDA sync debug mode), peak memory, and
               `mitchell_matmul`'s device ms in one mitchell decode step;
 16. times  -- each kernel with CUDA events (median after warm-up) beside
               its plain version, its bound and, where PyTorch has one call
               that computes the same sums, that call; the matmul kernels at
               the full-width shape; `conv_pass_kcm`'s measurement variants
               (the tiled kernel it replaced, ROM per tile or once, cp.async
               or stage_window window) at both shapes, on [variant] lines;
               `fused_separable_kcm` beside its tiled kernel of the first
               design (variant 0) for gaussian3 and gaussian5 at both shapes,
               with the persistent instance's column prefix, shared memory a
               block, resident blocks an SM, registers and spills;
               the recurse kernels for every method beside the tiled kernel
               of the first design (variant 0), on [variant] lines too;
               `mitchell_matmul` at the LM path's decode (M = 4) and prefill
               (M = 128) shapes beside their bounds, summed to the ms of a
               decode step; [route] lines: both routes at (M, 896, 4864)
               for M = 4 .. 2048, the timings behind the plan's route cut;
The line before the last is a JSON object naming the seven kernels with
their numbers (and `serve_launches`, their launches in phase 13; for the
matmul kernels `lm_launches`, their launches in phase 15's three
`greedy_generate` runs, and for `mitchell_matmul` `decode_step_ms` and
`decode_step_bound_ms`, phase 16's sum over a decode step's shapes, and
`lm_decode_step_device_ms`, phase 15's profiler reading; for the
conv kernels `tile_launches`, the main path's launches by tile, and
`tile_device_ms`, phase 9's device ms at 16x2048x2048 by tile); the last
line is the run's result and device.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate (NVIDIA data sheet)
INT8_OPS_PER_S = 1.979e15      # H100 SXM dense int8 tensor-core rate
INT32_LANES = 132 * 64         # SMs x INT32 lanes per SM (Hopper)
METHODS = ("exact", "refmlm", "refmlm_nc", "mitchell", "mitchell_ecc2", "odma")
MAIN_SHAPE = (8, 480, 640)
SCALE_SHAPE = (16, 2048, 2048)
PARITY_SHAPES = ((3, 37, 53), (2, 480, 640))
SOURCES = {"conv_pass_kcm": "conv_pass.cu", "conv_pass_recurse": "conv_pass.cu",
           "fused_separable_kcm": "fused_separable.cu",
           "fused_separable_recurse": "fused_separable.cu"}
REPLACES = {"conv_pass": "src/repro/filters/conv.py:263",
            "fused_separable": "src/repro/filters/conv.py:446",
            "mitchell_matmul": "src/repro/kernels/mitchell_matmul.py:141",
            "karatsuba_matmul": "src/repro/kernels/karatsuba_matmul.py:122",
            "karatsuba_matmul_i8": "src/repro/kernels/karatsuba_matmul.py:122"}
MATMUL_KERNELS = ("mitchell_matmul", "karatsuba_matmul", "karatsuba_matmul_i8")
# conv_pass_kcm_variant codes (csrc/conv_pass.cu) -> what each switches
KCM_VARIANTS = {0: "tiled kernel (ROM and window per 32x16 tile)",
                1: "persistent, ROM per tile, stage_window",
                2: "persistent, ROM per tile, cp.async window",
                3: "persistent, ROM once, stage_window",
                4: "persistent, ROM once, cp.async window (= conv_pass_kcm)"}
RECURSE_METHODS = METHODS + ("mitchell_ecc1", "mitchell_ecc3")
RECURSE_PARITY = (((3, 37, 53), (2, 4, 8, 16)), ((2, 480, 640), (8, 16)))  # (shape, widths)
# 5: as 4 without the tap products (the window's centre pixel out): the time
# of the staging and the stores alone. Timed, not compared: its bytes differ.
KCM_COPY_VARIANT = 5
# The Qwen2-0.5B MLP up-projection (src/repro/configs/qwen2_0_5b.py:
# d_model 896 -> d_ff 4864) over 2048 tokens.
MM_SHAPE = (2048, 896, 4864)
MM_PLAIN_ROWS = 256
MM_PARITY_SHAPES = ((5, 19, 11), (37, 300, 129))
# shapes that take each route of `mitchell_matmul`'s launch plan with K splits:
# the LM path's decode calls (M = 1 and 4) and a prefill call (M = 128, 8
# row tiles), ragged thin ones (3 row tiles at M = 40), a tiled one whose
# last split ends in a part tile
MM_ROUTE_SHAPES = ((1, 4864, 896), (4, 4864, 896), (4, 896, 4864), (4, 896, 128),
                   (7, 1000, 77), (40, 300, 129), (128, 896, 896), (1100, 300, 70))
# Qwen2-0.5B's dense calls and their launches a decode step (24 layers): wq
# and attention wo, wk and wv, wg and wi, the MLP's wo; at M = 4 (batch 4
# decode) and M = 128 (batch 4 x prompt 32 prefill)
LM_DENSE = (((896, 896), 48), ((896, 128), 48), ((896, 4864), 48), ((4864, 896), 24))
LM_DECODE_M, LM_PREFILL_M = 4, 128
ROUTE_CUT_M = (4, 16, 64, 128, 512, 1024, 2048)   # M at which both routes are timed
LNS_VARIANTS = ((0, True), (1, False), (2, False), (3, False))   # (num_ecc, case_split)
KERNEL_METHODS = ("mitchell", "mitchell_ecc1", "mitchell_ecc2", "mitchell_ecc3",
                  "schoolbook_int16", "karatsuba_int16")
INFER_HW = (64, 64)
INFER_BATCH = 256
INFER_CPU_BATCH = 4
WIDE_NBITS = 14


def log(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def phase_card() -> tuple[str, str, float]:
    """-> (device name, nvidia-smi's name and power limit, the card's INT32
    operation rate: INT32_LANES x its maximum SM clock)."""
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    log(f"[card] {name}")
    log(smi)
    log(f"[card] max SM clock {mhz} MHz; INT32 rate {INT32_LANES * mhz * 1e6:.6g} ops/s")
    return name, smi, INT32_LANES * mhz * 1e6


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build()
    log(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} s "
        f"({build.NVCC_FLAGS[1]})")
    for name, lib in libs.items():
        log_file = lib.parent / f"{name}.log"
        text = log_file.read_text() if log_file.exists() else ""
        names = demangle(text)
        entry, spill = "", ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else ""
            elif "spill stores" in line:
                stack = line.split("bytes stack frame")[0].strip()
                stores = line.split("bytes spill stores")[0].split(",")[-1].strip()
                spill = (", no spills" if stores == "0" else f", {stores} bytes of spill stores") \
                    + ("" if stack == "0" else f", {stack} bytes stack frame")
            elif "Used" in line and "registers" in line:
                regs = line.split("Used")[1].split("registers")[0].strip()
                log(f"[build] {name}: {names.get(entry, entry)}: {regs} registers{spill}")
    # the int8 limb kernel must run on the tensor cores: IMMA in its SASS
    cuobjdump = Path(build.find_nvcc()).with_name("cuobjdump")
    if cuobjdump.is_file():
        sass = subprocess.run([str(cuobjdump), "-sass", str(libs["karatsuba_matmul_i8"])],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        imma = sum("IMMA" in line for line in sass.splitlines())
        log(f"[build] karatsuba_matmul_i8: {imma} IMMA (int8 tensor-core) instructions "
            "in its SASS")
        assert imma > 0, "karatsuba_matmul_i8 has no tensor-core instruction"
    else:
        log(f"[build] no {cuobjdump}: the SASS of karatsuba_matmul_i8 is not checked")


def demangle(ptxas_log: str) -> dict[str, str]:
    """Mangled entry names in a ptxas log -> c++filt's names (identity where
    c++filt is missing)."""
    names = sorted({line.split("'")[1] for line in ptxas_log.splitlines()
                    if "Compiling entry function" in line and "'" in line})
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60, check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    return {m: d.split("(")[0].removeprefix("void ").replace("repro::", "")
            for m, d in zip(names, out)}


def noisy_frames(n: int, hw: tuple[int, int], percent: int, seed: int) -> np.ndarray:
    from repro_torch.data.images import add_salt_pepper, fingerprint
    return np.stack([add_salt_pepper(fingerprint(hw, seed=seed + i), percent,
                                     seed=seed + 100 + i)
                     for i in range(n)]).astype(np.int32)


def kcm_variant(x: torch.Tensor, rom, kh: int, kw: int, shift: int,
                post: str, variant: int) -> torch.Tensor:
    """conv_pass_kcm through measurement variant `variant` (KCM_VARIANTS)
    from a `RomStack`; not counted as a launch of the port."""
    import ctypes

    from repro_torch.filters.conv import POSTS
    from repro_torch.kernels.build import launch
    argtypes = (ctypes.c_void_p, ctypes.c_void_p) + (ctypes.c_int,) * 3 \
        + (ctypes.c_void_p,) + (ctypes.c_int,) * 8
    out = torch.empty_like(x)
    launch("conv_pass", "conv_pass_kcm_variant", argtypes, x.device, x.data_ptr(),
           rom.table.data_ptr(), rom.table.shape[1], rom.fill, rom.carry_bits,
           out.data_ptr(), *x.shape, kh, kw, shift, POSTS.index(post), variant)
    return out


TILED = (16, 32)                # the tiled kernels' tile (kTileH x kTileW)


def fused_kcm_tiled(x: torch.Tensor, row, col, shift: int, post: str) -> torch.Tensor:
    """fused_separable_kcm through the tiled kernel of the first design (the
    C entry given a zero prefix length): measurement variant 0, not counted
    as a launch of the port."""
    from repro_torch.filters.conv import POSTS, _SIGNATURES
    from repro_torch.kernels.build import launch
    source, argtypes = _SIGNATURES["fused_separable_kcm"]
    out = torch.empty_like(x)
    launch(source, "fused_separable_kcm", argtypes, x.device, x.data_ptr(),
           row.table.data_ptr(), row.table.shape[1], row.fill, col.table.data_ptr(),
           col.table.shape[1], col.fill, 0, 0, out.data_ptr(), *x.shape, col.table.shape[0],
           row.table.shape[0], shift, POSTS.index(post), *TILED)
    return out


def _info(source: str, entry: str, tile, *args) -> dict[str, int]:
    """An info entry (csrc `persistent_info`) of `source`'s library for
    `tile`: shared memory a block, blocks an SM, registers, local bytes."""
    import ctypes

    from repro_torch.kernels.build import launch, library_name
    info = (ctypes.c_int * 4)()
    launch(library_name(source, tile), entry, (ctypes.c_int,) * len(args) + (ctypes.c_void_p,),
           torch.device("cuda"), *args, ctypes.addressof(info))
    return {"smem_bytes": info[0], "blocks_per_sm": info[1], "registers": info[2],
            "local_bytes": info[3]}


def fused_kcm_info(row, col, tile=None) -> dict[str, int]:
    """What the persistent fused_separable_kcm instance for these ROM stacks
    takes on this card at `tile` (None: the menu's first): its column
    prefix (`column_prefix`), dynamic shared memory a block, resident
    blocks an SM, registers and local (spill) bytes a thread."""
    from repro_torch.filters.conv import column_prefix
    prefix, int16 = column_prefix(row, col)
    return {"prefix": prefix, "prefix_int16": int16,
            **_info("fused_separable", "fused_separable_kcm_info", tile, row.table.shape[1],
                    col.table.shape[1], prefix, int(int16), col.table.shape[0],
                    row.table.shape[0])}


def tile_info(kernel: str, tile, taps_shape, *, rom_len: int = 256, method: str = "refmlm",
              nbits: int = 8, nbits2: int = 16, chunk: int = -1) -> dict[str, int]:
    """What a persistent conv kernel instance takes on this card at `tile`:
    conv_pass_kcm (a rom_len ROM stack), conv_pass_recurse or
    fused_separable_recurse (the policies of method at nbits / nbits2)."""
    code, _ = _method_args(method)
    kh, kw = taps_shape
    if kernel == "fused_separable_recurse":
        return _info("fused_separable", "fused_separable_recurse_info", tile, kh, kw, code,
                     nbits, nbits2, chunk)
    return _info("conv_pass", "conv_pass_info", tile, int(kernel == "conv_pass_recurse"), kh,
                 kw, rom_len, code, nbits, chunk)


def _method_args(method: str) -> tuple[int, int]:
    from repro_torch.core.kcm import parse_method
    from repro_torch.filters.conv import _METHOD_CODES
    family, num_ecc = parse_method(method)
    return _METHOD_CODES[family], num_ecc


def recurse_tiled(x: torch.Tensor, taps, method: str, nbits: int, shift: int,
                  post: str) -> torch.Tensor:
    """conv_pass_recurse through the tiled kernel of the first design (the
    C entry given no plan): measurement variant 0, not counted as a launch
    of the port."""
    import ctypes

    from repro_torch.filters.conv import POSTS, _SIGNATURES
    from repro_torch.kernels.build import launch
    taps = np.asarray(taps, np.int64)
    kh, kw = taps.shape
    coeffs = np.ascontiguousarray(taps.astype(np.int32))
    source, argtypes = _SIGNATURES["conv_pass_recurse"]
    out = torch.empty_like(x)
    launch(source, "conv_pass_recurse", argtypes, x.device, x.data_ptr(), coeffs.ctypes.data,
           None, *_method_args(method), nbits, out.data_ptr(), *x.shape, kh, kw, shift,
           POSTS.index(post), -1, *TILED)
    return out


def fused_tiled(x: torch.Tensor, row, col, method: str, nbits: int, nbits2: int,
                shift: int, post: str) -> torch.Tensor:
    """fused_separable_recurse through the tiled kernel of the first design
    (the C entry given no plans): measurement variant 0, not counted as a
    launch of the port."""
    from repro_torch.filters.conv import POSTS, _SIGNATURES
    from repro_torch.kernels.build import launch
    row, col = (np.asarray(v, np.int64).reshape(-1) for v in (row, col))
    rc, cc = (np.ascontiguousarray(v.astype(np.int32)) for v in (row, col))
    source, argtypes = _SIGNATURES["fused_separable_recurse"]
    out = torch.empty_like(x)
    launch(source, "fused_separable_recurse", argtypes, x.device, x.data_ptr(),
           rc.ctypes.data, cc.ctypes.data, None, None, *_method_args(method), nbits, nbits2,
           out.data_ptr(), *x.shape, col.size, row.size, shift, POSTS.index(post), -1, *TILED)
    return out


def phase_recurse_parity(max_err: dict[str, int]) -> None:
    """Both recurse kernels against their plain versions, and the persistent
    design against the tiled kernels of the first design (variant 0), byte
    for byte: every method,
    mitchell_ecc1..3 included, at nbits 2, 4, 8 and 16 on signed operands
    of the width; coefficients with four non-zero 2-bit digits (+-255,
    +-170), zero and negative taps; every compiled tap shape and tiled ones
    (2x3, 7x5; a 5-tap row with a 3-tap column for the fused kernel)."""
    from repro_torch.filters import conv

    failures: list[str] = []
    checked = 0

    def check(kernel: str, got: torch.Tensor, want: torch.Tensor, what: str) -> None:
        nonlocal checked
        checked += 1
        check_equal(max_err, failures, kernel, got, want, what)

    rng = np.random.default_rng(21)
    edge = np.array([[255, -170, 0], [-255, 170, 1], [0, -1, 85]])
    for shape, widths in RECURSE_PARITY:
        for nbits in widths:
            top = (1 << nbits) - 1
            x = torch.from_numpy(rng.integers(-top, top + 1, shape).astype(np.int32)).cuda()
            tapsets = {"edge": np.sign(edge) * (np.abs(edge) % (top + 1)),
                       "5x5": rng.integers(-top, top + 1, (5, 5)) * (rng.random((5, 5)) < 0.8),
                       "1x3": rng.integers(-top, top + 1, (1, 3)),
                       "3x1": rng.integers(-top, top + 1, (3, 1)),
                       "1x5": rng.integers(-top, top + 1, (1, 5)),
                       "5x1": rng.integers(-top, top + 1, (5, 1)),
                       "2x3": rng.integers(-top, top + 1, (2, 3)),
                       "7x5": rng.integers(-top, top + 1, (7, 5))}
            for method in RECURSE_METHODS:
                if method.startswith("refmlm") and nbits not in (2, 4, 8, 16):
                    continue
                for name, taps in tapsets.items():
                    kw_ = dict(shift=nbits // 2, post="clip")
                    what = f"{name} {method} nbits={nbits} {shape}"
                    got = conv.conv_pass_recurse(x, taps, method=method, nbits=nbits, **kw_)
                    check("conv_pass_recurse", got,
                          conv.conv_pass_recurse_plain(x, taps, method=method, nbits=nbits,
                                                       **kw_), what)
                    if conv.kernel_route(*taps.shape) == "persistent":
                        check("conv_pass_recurse", recurse_tiled(x, taps, method, nbits, **kw_),
                              got, f"variant 0 {what}")
                # fused: rows at nbits, columns at nbits2, with pixels and
                # row taps small enough that every row sum is below 2**nbits2
                # (the column pass's operand contract)
                for kh, kw in ((3, 3), (5, 5), (3, 5)):
                    for nbits2 in sorted({nbits, 16}):
                        pb = top if nbits2 > nbits else max(1, top // (2 * kw))
                        rb = min(top, ((1 << nbits2) - 1) // (kw * pb))
                        if rb < 1:
                            continue
                        xf = x.clamp(-pb, pb)
                        row = rng.integers(-rb, rb + 1, kw)
                        row[0] = rb                    # 85 = four non-zero digits at 8 bits
                        col = np.array([255, -170, 0, 1, -85][:kh])
                        col = np.sign(col) * (np.abs(col) % (1 << nbits2))
                        kw_ = dict(shift=4, post="abs")
                        what = f"{kh}x{kw} {method} nbits={nbits}/{nbits2} {shape}"
                        rk = dict(method=method, nbits=nbits, nbits2=nbits2, **kw_)
                        got = conv.fused_separable_recurse(xf, row, col, **rk)
                        check("fused_separable_recurse", got,
                              conv.fused_separable_recurse_plain(xf, row, col, **rk), what)
                        if conv.kernel_route(kh, kw, fused=True) == "persistent":
                            check("fused_separable_recurse",
                                  fused_tiled(xf, row, col, method, nbits, nbits2, **kw_), got,
                                  f"variant 0 {what}")
    torch.cuda.synchronize()
    log(f"[parity] {checked} recurse comparisons (plain, variant 0), max |err| "
        f"{ {k: max_err[k] for k in ('conv_pass_recurse', 'fused_separable_recurse')} }")
    if failures:
        raise AssertionError("recurse kernels disagree:\n" + "\n".join(failures[:20]))


def phase_parity(max_err: dict[str, int]) -> None:
    """Every kernel against its plain version on the same CUDA tensors."""
    from repro_torch.filters import conv
    from repro_torch.filters.bank import FILTER_BANK, max_intermediate
    from repro_torch.kernels.gaussian_conv import gaussian_kernel_3x3

    direct = [(name, spec.taps, spec.shift, spec.post)
              for name, spec in FILTER_BANK.items()]
    direct.append(("fig9", gaussian_kernel_3x3(1.0, 256), 8, "clip"))
    # tap shapes outside the bank's run conv_pass_kcm's tiled kernel, with the
    # ROM stack in shared memory (2x3) or, past 32 KB, in global memory (7x5)
    odd = np.random.default_rng(3)
    direct += [("odd2x3", odd.integers(-20, 21, (2, 3)), 4, "abs"),
               ("odd7x5", odd.integers(-20, 21, (7, 5)), 6, "clip")]
    separable = [(name, spec) for name, spec in FILTER_BANK.items()
                 if spec.separable]
    checked = 0
    failures = []

    def check(kernel: str, got: torch.Tensor, want: torch.Tensor, what: str):
        nonlocal checked
        checked += 1
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
            if got.numel() else 0
        max_err[kernel] = max(max_err[kernel], err)
        if not torch.equal(got, want):
            failures.append(f"{kernel} {what}: max |err| {err}")

    for shape in PARITY_SHAPES:
        x = torch.from_numpy(noisy_frames(shape[0], shape[1:], 20, 1)).cuda()
        rng = np.random.default_rng(2)
        signed = torch.from_numpy(
            rng.integers(-4080, 4081, shape).astype(np.int32)).cuda()
        for method in METHODS:
            for name, taps, shift, post in direct:
                kh, kw = taps.shape
                rom = conv.rom_stack(method, taps, 8, x.device)
                kw_ = dict(shift=shift, post=post)
                want = conv.conv_pass_kcm_plain(x, rom, kh, kw, **kw_)
                check("conv_pass_kcm", conv.conv_pass_kcm(x, rom, kh, kw, **kw_),
                      want, f"{name} {method} {shape}")
                if method in ("refmlm", "mitchell"):
                    for v in KCM_VARIANTS if (kh, kw) == (3, 3) else ():
                        check("conv_pass_kcm", kcm_variant(x, rom, kh, kw, shift, post, v),
                              want, f"variant {v} {name} {method} {shape}")
                t64 = np.asarray(taps, np.int64)
                check("conv_pass_recurse",
                      conv.conv_pass_recurse(x, t64, method=method, nbits=8, **kw_),
                      conv.conv_pass_recurse_plain(x, t64, method=method,
                                                   nbits=8, **kw_),
                      f"{name} {method} {shape}")
            for name, spec in separable:
                row = spec.sep_row.astype(np.int64)
                col = spec.sep_col.astype(np.int64)
                nb2 = conv.second_pass_nbits(max_intermediate(spec),
                                             int(np.abs(col).max()))
                rr = conv.rom_stack(method, row, 8, x.device)
                cr = conv.rom_stack(method, col, nb2, x.device)
                kw_ = dict(shift=spec.shift, post=spec.post)
                want = conv.fused_separable_kcm_plain(x, rr, cr, **kw_)
                check("fused_separable_kcm", conv.fused_separable_kcm(x, rr, cr, **kw_),
                      want, f"{name} {method} {shape}")
                check("fused_separable_kcm", fused_kcm_tiled(x, rr, cr, **kw_), want,
                      f"variant 0 {name} {method} {shape}")
                rk = dict(method=method, nbits=8, nbits2=nb2, **kw_)
                check("fused_separable_recurse",
                      conv.fused_separable_recurse(x, row, col, **rk),
                      conv.fused_separable_recurse_plain(x, row, col, **rk),
                      f"{name} {method} {shape}")
                # the two-pass second pass: conv2d_pass at nbits=16 on signed
                # row-pass-sized inputs
                colt = col[:, None]
                for impl in ("kcm", "recurse"):
                    got = conv.conv2d_pass(signed, colt, method=method, nbits=16,
                                           shift=spec.shift, post=spec.post,
                                           mult_impl=impl)
                    if impl == "kcm":
                        want = conv.conv_pass_kcm_plain(
                            signed, conv.rom_stack(method, colt, 16, x.device),
                            len(col), 1, **kw_)
                    else:
                        want = conv.conv_pass_recurse_plain(
                            signed, colt, method=method, nbits=16, **kw_)
                    check(f"conv_pass_{impl}", got, want,
                          f"{name} col nbits=16 signed {method} {shape}")
        # every ROM placement of the fused kernel (shared or global memory
        # for each pass): the bank alone uses only 8-bit rows, 16-bit columns
        small = x % 128                        # row sums over [1, 0, 1] < 256
        row, col = np.array([1, 0, 1]), np.array([1, 2, 1])
        for method in METHODS:
            for nbits, nbits2 in ((8, 8), (16, 8), (16, 16)):
                rr = conv.rom_stack(method, row, nbits, x.device)
                cr = conv.rom_stack(method, col, nbits2, x.device)
                kw_ = dict(shift=4, post="clip")
                want = conv.fused_separable_kcm_plain(small, rr, cr, **kw_)
                check("fused_separable_kcm", conv.fused_separable_kcm(small, rr, cr, **kw_),
                      want, f"rows {nbits} cols {nbits2} {method} {shape}")
                check("fused_separable_kcm", fused_kcm_tiled(small, rr, cr, **kw_), want,
                      f"variant 0 rows {nbits} cols {nbits2} {method} {shape}")
                rk = dict(method=method, nbits=nbits, nbits2=nbits2, **kw_)
                check("fused_separable_recurse",
                      conv.fused_separable_recurse(small, row, col, **rk),
                      conv.fused_separable_recurse_plain(small, row, col, **rk),
                      f"rows {nbits} cols {nbits2} {method} {shape}")
    torch.cuda.synchronize()
    log(f"[parity] {checked} kernel/plain comparisons, max |err| {max_err}")
    if failures:
        raise AssertionError("kernels disagree with their plain versions:\n"
                             + "\n".join(failures[:20]))


def with_out_of_range(x: torch.Tensor, nbits: int, seed: int) -> torch.Tensor:
    """x with about one pixel in 50 replaced by an operand at or past the
    2**nbits ROMs: +-2**nbits, +-(2**nbits + 1), +-300 at 8 bits, +-70000
    at 16, and the int32 extremes of the Mitchell family's lane (ROADMAP
    F2): +-2**30, 2**30 + 777777, 2**31 - 1 and -2**31."""
    extra = (300, -300) if nbits == 8 else (70000, -70000)
    extra += (1 << 30, -(1 << 30), (1 << 30) + 777777, (1 << 31) - 1, -(1 << 31))
    values = torch.tensor([1 << nbits, -(1 << nbits), (1 << nbits) + 1, -(1 << nbits) - 1,
                           *extra], dtype=torch.int32)
    g = torch.Generator().manual_seed(seed)
    pick = torch.rand(x.shape, generator=g) < 0.02
    which = torch.randint(len(values), x.shape, generator=g)
    return torch.where(pick.to(x.device), values[which].to(x.device), x)


def phase_range_parity(max_err: dict[str, int]) -> None:
    """The four conv kernels against their plain versions on operands at or
    past the ROMs (`with_out_of_range`; F1 in ROADMAP), byte for byte, and
    the persistent designs against the tiled kernels of the first design
    (variant 0): every multiplier, the bank at 8 bits (int16 and int32
    carries: sobel and laplacian have ROM bounds below 2**15, the others
    not), the F1 taps, the 16-bit column pass of the two-pass dataflow
    (int32 ROMs, fill -2**31), and the fused passes, whose out-of-range row
    sums reach the column ROMs' global-memory entries and their fill. The
    operands include +-2**30 up to -2**31 for every kernel: the recurse
    kernels' Mitchell family takes the reference's int32 lane (F2)."""
    from repro_torch.filters import conv
    from repro_torch.filters.bank import FILTER_BANK, max_intermediate

    failures: list[str] = []
    checked = 0
    carries = set()

    def check(kernel: str, got: torch.Tensor, want: torch.Tensor, what: str) -> None:
        nonlocal checked
        checked += 1
        check_equal(max_err, failures, kernel, got, want, what)

    f1 = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]])
    direct = [(name, spec.taps, spec.shift, spec.post) for name, spec in FILTER_BANK.items()]
    direct.append(("f1", f1, 0, "none"))
    for i, shape in enumerate(PARITY_SHAPES):
        frames = torch.from_numpy(noisy_frames(shape[0], shape[1:], 20, 30 + i)).cuda()
        x8 = with_out_of_range(frames, 8, 40 + i)
        rng = np.random.default_rng(50 + i)
        wide = torch.from_numpy(rng.integers(-(1 << 16) + 1, 1 << 16, shape).astype(np.int32))
        x16 = with_out_of_range(wide.cuda(), 16, 60 + i)
        for method in METHODS:
            for name, taps, shift, post in direct:
                kh, kw = taps.shape
                rom = conv.rom_stack(method, taps, 8, x8.device)
                carries.add(rom.carry_bits)
                kw_ = dict(shift=shift, post=post)
                what = f"{name} {method} nbits=8 carry={rom.carry_bits} {shape}"
                want = conv.conv_pass_kcm_plain(x8, rom, kh, kw, **kw_)
                check("conv_pass_kcm", conv.conv_pass_kcm(x8, rom, kh, kw, **kw_), want, what)
                if (kh, kw) == (3, 3) and method in ("refmlm", "mitchell"):
                    for v in KCM_VARIANTS:
                        check("conv_pass_kcm", kcm_variant(x8, rom, kh, kw, shift, post, v),
                              want, f"variant {v} {what}")
                t64 = np.asarray(taps, np.int64)
                rk = dict(method=method, nbits=8, **kw_)
                got = conv.conv_pass_recurse(x8, t64, **rk)
                check("conv_pass_recurse", got, conv.conv_pass_recurse_plain(x8, t64, **rk), what)
                check("conv_pass_recurse", recurse_tiled(x8, t64, method, 8, **kw_), got,
                      f"variant 0 {what}")
            for name, spec in FILTER_BANK.items():
                if not spec.separable:
                    continue
                row = spec.sep_row.astype(np.int64)
                col = spec.sep_col.astype(np.int64)
                nb2 = conv.second_pass_nbits(max_intermediate(spec), int(np.abs(col).max()))
                kw_ = dict(shift=spec.shift, post=spec.post)
                rr = conv.rom_stack(method, row, 8, x8.device)
                cr = conv.rom_stack(method, col, nb2, x8.device)
                what = f"{name} {method} {shape}"
                want = conv.fused_separable_kcm_plain(x8, rr, cr, **kw_)
                check("fused_separable_kcm", conv.fused_separable_kcm(x8, rr, cr, **kw_), want,
                      what)
                check("fused_separable_kcm", fused_kcm_tiled(x8, rr, cr, **kw_), want,
                      f"variant 0 {what}")
                rk = dict(method=method, nbits=8, nbits2=nb2, **kw_)
                got = conv.fused_separable_recurse(x8, row, col, **rk)
                check("fused_separable_recurse", got,
                      conv.fused_separable_recurse_plain(x8, row, col, **rk), what)
                check("fused_separable_recurse",
                      fused_tiled(x8, row, col, method, 8, nb2, **kw_), got, f"variant 0 {what}")
                # the two-pass column pass at 16 bits: int32 ROMs, fill -2**31
                colt = col[:, None]
                crom = conv.rom_stack(method, colt, 16, x16.device)
                carries.add(crom.carry_bits)
                what = f"{name} col nbits=16 {method} {shape}"
                check("conv_pass_kcm", conv.conv_pass_kcm(x16, crom, len(col), 1, **kw_),
                      conv.conv_pass_kcm_plain(x16, crom, len(col), 1, **kw_), what)
                rk = dict(method=method, nbits=16, **kw_)
                got = conv.conv_pass_recurse(x16, colt, **rk)
                check("conv_pass_recurse", got, conv.conv_pass_recurse_plain(x16, colt, **rk),
                      what)
                check("conv_pass_recurse", recurse_tiled(x16, colt, method, 16, **kw_), got,
                      f"variant 0 {what}")
    torch.cuda.synchronize()
    assert carries == {16, 32}, f"both carry widths must be covered, got {carries}"
    log(f"[parity] {checked} comparisons on operands past the ROMs (plain, variant 0), "
        f"max |err| { {k: max_err[k] for k in conv.KERNELS} }")
    if failures:
        raise AssertionError("kernels disagree on operands past the ROMs:\n"
                             + "\n".join(failures[:20]))


def phase_main(device: torch.device) -> tuple[dict[str, int], torch.Tensor]:
    """The port's main path through its entry points; -> (launches by
    kernel, the frames as an int32 tensor on the card)."""
    from repro_torch.data.images import add_salt_pepper, fingerprint, psnr
    from repro_torch.filters import (FILTER_BANK, FILTER_NAMES, apply_filter,
                                     apply_filter_batch, filter_bank_apply)
    from repro_torch.filters import conv
    from repro_torch.filters.ref import apply_filter_ref
    from repro_torch.kernels.ops import gaussian_filter, gaussian_kernel_3x3

    frames = noisy_frames(MAIN_SHAPE[0], MAIN_SHAPE[1:], 20, 7)
    small = torch.from_numpy(noisy_frames(3, (37, 53), 20, 3)).to(device)
    conv.reset_launches()
    t0 = time.perf_counter()
    outs = {}
    for method in METHODS:
        outs[method] = filter_bank_apply(frames, method=method)
        rec = filter_bank_apply(frames, method=method, mult_impl="recurse")
        for name in FILTER_NAMES:
            assert outs[method][name].shape == MAIN_SHAPE, name
            assert outs[method][name].dtype == torch.uint8, name
            assert torch.equal(rec[name], outs[method][name]), \
                f"recurse != kcm on {name} {method}"
    for name in FILTER_NAMES:
        assert torch.equal(outs["refmlm"][name], outs["exact"][name]), \
            f"refmlm != exact on {name}"
    # the default plans come from the tuning cache (blocks_cuda.json): the
    # fused and two-pass dataflows are also run by name
    separable = [n for n in FILTER_NAMES if FILTER_BANK[n].separable]
    for impl in ("kcm", "recurse"):
        fused = filter_bank_apply(frames, separable, method="refmlm", fused=True,
                                  mult_impl=impl)
        for name, out in fused.items():
            assert torch.equal(out, outs["refmlm"][name]), f"fused != default {name} {impl}"
    two_pass = filter_bank_apply(
        frames, [n for n in FILTER_NAMES if FILTER_BANK[n].separable],
        method="refmlm", fused=False)
    for name, out in two_pass.items():
        assert torch.equal(out, outs["refmlm"][name]), f"two_pass != fused {name}"
    served = apply_filter_batch(list(frames[:3]), "gaussian3", pad_to=4)
    for i, out in enumerate(served):
        assert torch.equal(out, outs["refmlm"]["gaussian3"][i]), f"batch hook {i}"
    for method in ("refmlm", "mitchell", "odma"):
        for name in FILTER_NAMES:
            got = apply_filter(small, name, method=method)
            want = apply_filter_ref(small, name, method=method)
            assert torch.equal(got, want), f"oracle disagrees: {name} {method}"

    # The paper's Table 10 as benchmarks/table10_psnr.py runs it.
    base = fingerprint((256, 256), seed=7)
    kern = gaussian_kernel_3x3(sigma=1.0, scale=256)
    table = {}
    for pct in (10, 20, 30, 40):
        noisy = add_salt_pepper(base, pct, seed=11)
        for mult in ("exact", "refmlm", "mitchell", "odma", "mitchell_ecc3"):
            sm = gaussian_filter(noisy.astype(np.int32), kern, method=mult)
            table[(pct, mult)] = psnr(base, sm.cpu().numpy())
        assert table[(pct, "refmlm")] == table[(pct, "exact")]
        assert table[(pct, "refmlm")] >= table[(pct, "mitchell")]
        assert table[(pct, "refmlm")] >= table[(pct, "odma")]
        log(f"[main] table10 noise={pct}% psnr_corrupted="
            f"{psnr(base, noisy):.2f} " + " ".join(
                f"{m}={table[(pct, m)]:.2f}" for m in
                ("exact", "refmlm", "mitchell", "odma", "mitchell_ecc3")))
    torch.cuda.synchronize()
    launches = dict(conv.LAUNCHES)
    log(f"[main] {MAIN_SHAPE} bank x {len(METHODS)} methods x (kcm, recurse) + "
        f"two_pass + batch hook + oracle + Table 10 in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"launches {launches}")
    missing = [k for k, v in launches.items() if v == 0]
    assert not missing, f"kernels never launched on the main path: {missing}"
    # every launch of the main path (the bank's shapes) took a persistent
    # kernel, none the tiled one
    routes = route_launches()
    log(f"[main] launches by route and tile {routes}")
    for name in conv.ROUTED:
        assert routes[name].get("tiled", 0) == 0 \
            and sum(routes[name].values()) == launches[name], \
            f"{name}: a main-path launch took the tiled kernel: {routes}"
    return launches, torch.from_numpy(frames).to(device)


def route_launches() -> dict[str, dict[str, int]]:
    """conv.ROUTE_LAUNCHES by kernel: {'32x64': n, ...} for the persistent
    tiles and {'tiled': n}."""
    from repro_torch.filters import conv
    out: dict[str, dict[str, int]] = {name: {} for name in conv.ROUTED}
    for (name, route, tile), count in conv.ROUTE_LAUNCHES.items():
        key = "tiled" if route == "tiled" else f"{tile[0]}x{tile[1]}"
        out[name][key] = out[name].get(key, 0) + count
    return out


def phase_scale(device: torch.device) -> torch.Tensor:
    """apply_filter at N=16 x 2048x2048; -> the input frames."""
    from repro_torch.data.images import fingerprint
    from repro_torch.filters import apply_filter
    from repro_torch.filters import conv
    from repro_torch.filters.bank import get_filter

    n, h, w = SCALE_SHAPE
    g = torch.Generator(device=device).manual_seed(5)
    base = torch.from_numpy(fingerprint((h, w), seed=5).astype(np.int32)).to(device)
    noise = torch.rand((n, h, w), generator=g, device=device)
    salt = torch.rand((n, h, w), generator=g, device=device) < 0.5
    x = torch.where(noise < 0.2, torch.where(salt, 255, 0), base).to(torch.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = apply_filter(x, "gaussian5", method="refmlm")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    assert out.shape == SCALE_SHAPE and out.dtype == torch.uint8
    assert torch.equal(out, apply_filter(x, "gaussian5", method="exact"))
    spec = get_filter("gaussian5")
    plain = conv.fused_separable_kcm_plain(
        x[:1], conv.rom_stack("refmlm", spec.sep_row, 8, device),
        conv.rom_stack("refmlm", spec.sep_col, 16, device), shift=spec.shift,
        post=spec.post).to(torch.uint8)
    assert torch.equal(out[:1], plain)
    log(f"[scale] apply_filter gaussian5 refmlm {SCALE_SHAPE} "
        f"({x.numel() * 4 / 1e6:.0f} MB int32 in) first call {secs:.3f} s "
        f"(host clock, with ROM setup); max pixel {int(out.max())}")
    return x


SERVE_FRAME = MAIN_SHAPE[1:]          # fingerprint frames, the main path's
SERVE_SAT = (2048, 2048)              # satellite / medical frames
SERVE_FILTERS = ("gaussian3", "gaussian5", "sobel_x", "sharpen3", "laplacian")
SERVE_IMPLS = ("kcm", "recurse")
SERVE_ROUNDS = 12                     # rounds of 8 same-bucket fingerprint frames
SERVE_CLIENTS = 4
SERVE_SATS = 16
SERVE_INFER = (("mitchell", 4), ("karatsuba_int16", 4))   # (method, requests)
PRIORITY_CYCLE = ("high", "normal", "low")


def _kernel_of(plan_tag: str) -> str | None:
    """conv kernel a filter dispatch's plan tag launches ('fused/kcm/...')."""
    dataflow, impl = plan_tag.split("/")[:2]
    if dataflow == "fused":
        return f"fused_separable_{impl}"
    if dataflow == "direct":
        return f"conv_pass_{impl}"
    return None


def _pcts(values: list[float]) -> tuple[float, float]:
    v = np.asarray(values, np.float64)
    return float(np.percentile(v, 50)), float(np.percentile(v, 99))


SERVE_BREAKDOWN_RUNS = 7


def dispatch_breakdown(srv, imgs: np.ndarray, filt: str) -> dict[str, float]:
    """Median ms of the parts of one served dispatch of `imgs` on an idle
    server, each part ended by a sync: the host batch, the copy to the
    card, `apply_filter` there (its casts and kernel), the copy back; and
    the whole round trip through the server (submit all, wait for all)."""
    from repro_torch.filters import apply_filter

    parts: dict[str, list[float]] = {k: [] for k in
                                     ("host_batch", "h2d", "apply_filter", "d2h", "served")}
    for _ in range(SERVE_BREAKDOWN_RUNS):
        t0 = time.perf_counter()
        batch = np.zeros(imgs.shape, imgs.dtype)
        batch[:] = imgs
        t1 = time.perf_counter()
        x = torch.from_numpy(batch).cuda()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = apply_filter(x, filt, method="refmlm", mult_impl="kcm")
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        out.cpu()
        t4 = time.perf_counter()
        futs = [srv.submit(im, filt, method="refmlm", mult_impl="kcm") for im in imgs]
        for fut in futs:
            fut.result(60)
        t5 = time.perf_counter()
        for name, a, b in (("host_batch", t0, t1), ("h2d", t1, t2), ("apply_filter", t2, t3),
                           ("d2h", t3, t4), ("served", t4, t5)):
            parts[name].append((b - a) * 1e3)
    return {name: statistics.median(v) for name, v in parts.items()}


SCALE_OUT_JOBS = (("streamed", "gaussian5", "kcm"), ("sharded", "sharpen3", "recurse"))


def scale_out_round(srv, frames: np.ndarray) -> None:
    """One streamed bucket and one sharded bucket on a running server: 8
    frames each, submitted together; every served byte equal to the direct
    call, and neither bucket falls back to the local path."""
    from repro_torch.filters import apply_filter, conv

    torch.cuda.synchronize()
    conv.reset_launches()
    t0 = time.perf_counter()
    futs = [(mode, filt, impl, j, time.perf_counter(),
             srv.submit(frames[j], filt, method="refmlm", mult_impl=impl, exec=mode))
            for mode, filt, impl in SCALE_OUT_JOBS for j in range(len(frames))]
    lat: dict[str, list[float]] = {}
    for mode, filt, impl, j, t_sub, fut in futs:
        out = fut.result(120)
        lat.setdefault(mode, []).append((time.perf_counter() - t_sub) * 1e3)
        assert torch.equal(out, apply_filter(frames[j], filt, method="refmlm",
                                             mult_impl=impl).cpu()), \
            f"served {mode} != direct: {filt} {impl} frame {j}"
    wall = time.perf_counter() - t0
    st = srv.stats()
    assert st["degraded"] == {}, f"a scale-out bucket fell back to local: {st['degraded']}"
    launched = {k: v for k, v in conv.LAUNCHES.items() if v}
    assert launched, "the scale-out round launched no conv kernel"
    for mode, values in lat.items():
        p50, p99 = _pcts(values)
        log(f"[serve] exec={mode}: {len(values)} frames served byte-equal to the direct call; "
            f"p50 {p50:.4f} ms p99 {p99:.4f} ms (submit to result, host clock)")
    log(f"[serve] scale-out round {wall:.3f} s; launches {launched}; degraded {st['degraded']}")


def phase_serve(device: torch.device) -> dict[str, int]:
    """`ImageFilterServer` on the card: warm both buckets, then 4 client
    threads submit 96 fingerprint frames (12 rounds of 8 same-bucket frames
    at mixed priorities, 5 filters x kcm / recurse), 16 satellite frames
    (a second server, max_batch 16) and 8 cnn infer requests; every served
    output byte-equal to the direct call on the card, launches equal to
    dispatches x launches a call, then one poisoned round. -> launches by
    kernel during the served load."""
    import threading

    from repro_torch.data.images import add_salt_pepper, fingerprint, inference_batch
    from repro_torch.filters import apply_filter, conv
    from repro_torch.infer import MODELS, calibrate, forward, init_params
    from repro_torch.infer.graph import Conv, Dense
    from repro_torch.infer.serving import InferWorkload
    from repro_torch.runtime.fault import SITE_EXECUTE, FaultInjector, fault_scope
    from repro_torch.serve import ImageFilterServer, ServerConfig

    t_phase = time.perf_counter()
    frames = noisy_frames(8, SERVE_FRAME, 20, 300).astype(np.uint8)
    base = fingerprint(SERVE_SAT, seed=9)
    sats = np.stack([add_salt_pepper(base, 10, seed=400 + i)
                     for i in range(SERVE_SATS)]).astype(np.uint8)
    graph = MODELS["cnn"](INFER_HW)
    cal = calibrate(graph, init_params(graph, seed=0),
                    inference_batch(4, INFER_HW, seed=100), device=device)
    patches = inference_batch(sum(n for _, n in SERVE_INFER), INFER_HW, seed=7)
    layers_a_call = sum(isinstance(l, (Conv, Dense)) for l in graph.layers)

    frame_srv = ImageFilterServer(ServerConfig(
        max_batch=8, max_delay_ms=5.0, max_pending=4096, trace=True,
        workloads={"infer": InferWorkload({"cnn": cal})}))
    sat_srv = ImageFilterServer(ServerConfig(
        max_batch=16, max_delay_ms=50.0, max_pending=SERVE_SATS * 256, trace=True))
    try:
        t0 = time.perf_counter()
        warmed = frame_srv.warmup([SERVE_FRAME], SERVE_FILTERS, methods=("refmlm",),
                                  mult_impls=SERVE_IMPLS, batches=(1, 2, 4, 8),
                                  priorities=PRIORITY_CYCLE)
        warmed += frame_srv.warmup([INFER_HW], ("cnn",),
                                   methods=tuple(m for m, _ in SERVE_INFER),
                                   batches=(1, 2, 4), priorities=("high",),
                                   workload="infer")
        warmed += sat_srv.warmup([SERVE_SAT], ("gaussian5",), mult_impls=("kcm",),
                                 batches=(8, 16), priorities=("low",))
        torch.cuda.synchronize()
        log(f"[serve] warmup: {len(warmed)} serve keys in "
            f"{time.perf_counter() - t0:.3f} s (host clock)")

        combos = [(f, i) for f in SERVE_FILTERS for i in SERVE_IMPLS]
        jobs: list[list[tuple]] = [[] for _ in range(SERVE_CLIENTS)]
        for r in range(SERVE_ROUNDS):
            filt, impl = combos[r % len(combos)]
            pri = PRIORITY_CYCLE[r % 3]
            jobs[r % SERVE_CLIENTS].extend(
                ("frame", (r * 8 + j) % len(frames), filt, impl, pri) for j in range(8))
        for i in range(SERVE_SATS):
            jobs[i % SERVE_CLIENTS].append(("sat", i, "gaussian5", "kcm", "low"))
        i = 0
        for method, count in SERVE_INFER:
            for _ in range(count):
                jobs[i % SERVE_CLIENTS].append(("infer", i, "cnn", method, "high"))
                i += 1
        futures: list[list[tuple]] = [[] for _ in range(SERVE_CLIENTS)]

        def client(k: int) -> None:
            for job in jobs[k]:
                kind, idx, target, impl, pri = job
                if kind == "frame":
                    fut = frame_srv.submit(frames[idx], target, method="refmlm",
                                           mult_impl=impl, priority=pri)
                elif kind == "sat":
                    fut = sat_srv.submit(sats[idx], target, method="refmlm",
                                         mult_impl=impl, priority=pri)
                else:
                    fut = frame_srv.submit(patches[idx], target, method=impl,
                                           priority=pri, workload="infer")
                futures[k].append((job, fut))
            for _, fut in futures[k]:
                fut.result(120)

        torch.cuda.synchronize()
        conv.reset_launches()
        reset_matmul_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,)) for k in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        launches = {**conv.LAUNCHES, **matmul_launches()}
        routes = route_launches()
        stats = {"frames": frame_srv.stats(), "sats": sat_srv.stats()}
        for name, st in stats.items():
            assert st["failed"] == 0 and st["served"] == st["submitted"], (name, st)
        log(f"[serve] {sum(len(j) for j in jobs)} requests from {SERVE_CLIENTS} "
            f"clients in {wall:.3f} s (host clock); launches {launches}; "
            f"by route {routes}")

        # launches == dispatches x launches a call, from the profilers' rows
        want = dict.fromkeys(launches, 0)
        for st in stats.values():
            for row in st["profile"].values():
                kernel = _kernel_of(row["plan"])
                if kernel is not None:
                    want[kernel] += row["n_obs"]
                elif row["plan"] == "local/infer":
                    method = row["bucket"].split("/")[1]
                    want["mitchell_matmul" if method == "mitchell"
                         else "karatsuba_matmul_i8"] += row["n_obs"] * layers_a_call
        log(f"[serve] dispatches x launches a call {want}")
        assert launches == want, f"launches {launches} != dispatches x per call {want}"
        for name in conv.ROUTED:
            assert routes[name].get("tiled", 0) == 0, f"{name}: a served launch was tiled"
        # the served plans come from the tuning cache, which picks each
        # bucket's dataflow: every tap-product implementation served must
        # have launched a conv kernel of its own (which ones, the
        # dispatches x launches check above holds), and both infer kernels
        missing = [k for k in ("mitchell_matmul", "karatsuba_matmul_i8") if launches[k] == 0]
        missing += [impl for impl in SERVE_IMPLS
                    if launches[f"conv_pass_{impl}"] + launches[f"fused_separable_{impl}"] == 0]
        assert not missing, f"kernels never launched by the server: {missing}"

        # served bytes == the direct call on the card
        checked = 0
        for k in range(SERVE_CLIENTS):
            for (kind, idx, target, impl, _), fut in futures[k]:
                out = fut.result(0)
                if kind == "infer":
                    want_out = forward(cal, patches[idx:idx + 1], impl)[0].cpu()
                else:
                    img = frames[idx] if kind == "frame" else sats[idx]
                    want_out = apply_filter(img, target, method="refmlm",
                                            mult_impl=impl).cpu()
                assert out.device.type == "cpu", (kind, target)
                assert torch.equal(out, want_out), f"served != direct: {kind} {target} {impl}"
                checked += 1
        log(f"[serve] {checked} served outputs byte-equal to the direct call on the card")

        # frames/s and p50 / p99 latency (submit -> fulfil, the server's trace)
        kinds = {"frame": [], "sat": [], "infer": []}
        for name, srv in (("frames", frame_srv), ("sats", sat_srv)):
            by_bucket: dict[str, list[float]] = {}
            spans = srv.trace.spans()
            for evs in spans.values():
                ev = {e["event"]: e for e in evs}
                if "submit" not in ev or "fulfil" not in ev:
                    continue
                bucket = ev["submit"]["bucket"]
                by_bucket.setdefault(bucket, []).append(
                    (ev["submit"]["ts"], ev["fulfil"]["ts"]))
            for bucket, pairs in sorted(by_bucket.items()):
                lat = [(b - a) * 1e3 for a, b in pairs]
                p50, p99 = _pcts(lat)
                log(f"[serve] bucket {bucket}: n={len(lat)} p50 {p50:.4f} ms "
                    f"p99 {p99:.4f} ms")
                kind = ("infer" if bucket.endswith("/infer")
                        else "sat" if name == "sats" else "frame")
                kinds[kind].extend(pairs)
        summary = {}
        for kind, pairs in kinds.items():
            lat = [(b - a) * 1e3 for a, b in pairs]
            span = max(b for _, b in pairs) - min(a for a, _ in pairs)
            p50, p99 = _pcts(lat)
            summary[kind] = {"requests": len(pairs), "per_s": len(pairs) / span,
                             "p50_ms": p50, "p99_ms": p99}
            log(f"[serve] {kind}: {len(pairs)} served, {len(pairs) / span:.1f} a second "
                f"(first submit to last fulfil, {span:.4f} s), p50 {p50:.4f} ms, "
                f"p99 {p99:.4f} ms")
        for name, st in stats.items():
            log(f"[serve] {name} stats: compile {st['compile']} plan_memo "
                f"{st['plan_memo']} batches {st['batches']} occupancy "
                f"{st['occupancy']} flush_reasons {st['flush_reasons']}")
            for row in st["profile"].values():
                log(f"[serve] drift {row['bucket']} | {row['plan']}: n={row['n_obs']} "
                    f"observed {row['observed_mean_s'] * 1e3:.4f} ms, "
                    f"drift (observed / plan_cost) {row.get('drift_mean', float('nan')):.3f}")

        # one poisoned round: only seq k fails, its neighbours are re-served
        k = stats["frames"]["submitted"] + 4
        inj = FaultInjector().poison(SITE_EXECUTE, k)
        with fault_scope(inj):
            futs = [frame_srv.submit(frames[j], "gaussian3", method="refmlm",
                                     mult_impl="kcm") for j in range(8)]
            outcomes = []
            for fut in futs:
                try:
                    outcomes.append(fut.result(60))
                except Exception as err:              # noqa: BLE001
                    outcomes.append(err)
        failed = [j for j, o in enumerate(outcomes) if not isinstance(o, torch.Tensor)]
        assert failed == [3], f"the poisoned round failed {failed}, not seq {k} alone"
        for j, out in enumerate(outcomes):
            if j != 3:
                assert torch.equal(out, apply_filter(frames[j], "gaussian3", method="refmlm",
                                                     mult_impl="kcm").cpu())
        st = frame_srv.stats()
        log(f"[serve] poison seq {k}: failed {[k]}, 7 neighbours re-served byte-equal; "
            f"retries {st['retries']} isolated {st['isolated']}")
        scale_out_round(frame_srv, frames)
        for srv, imgs, filt in ((frame_srv, frames, "gaussian3"), (sat_srv, sats, "gaussian5")):
            parts = dispatch_breakdown(srv, imgs, filt)
            log(f"[serve] one idle dispatch of {len(imgs)}x{imgs.shape[1]}x{imgs.shape[2]} "
                f"{filt} refmlm kcm, median ms of {SERVE_BREAKDOWN_RUNS}: "
                + " ".join(f"{name}={ms:.4f}" for name, ms in parts.items()))
    finally:
        frame_srv.close()
        sat_srv.close()
    torch.cuda.synchronize()
    log(f"[serve] summary {json.dumps(summary)}")
    log(f"[serve] phase {time.perf_counter() - t_phase:.1f} s (host clock)")
    return launches


POOL_JOBS = (("gaussian3", "kcm", "local"), ("sobel_x", "recurse", "local"),
             ("gaussian5", "kcm", "sharded"), ("sharpen3", "recurse", "sharded"))
POOL_ROUNDS = 3                       # rounds of 8 frames per job
POOL_LOSS_ROUNDS = 4                  # rounds of the sharded bucket under device loss


def _span_latencies_ms(srv, since: float) -> list[float]:
    """submit -> fulfil of every request the server's trace saw submitted
    at or after `since` (its clock, `time.monotonic`), in ms."""
    out = []
    for evs in srv.trace.spans().values():
        ev = {e["event"]: e for e in evs}
        if "submit" in ev and "fulfil" in ev and ev["submit"]["ts"] >= since:
            out.append((ev["fulfil"]["ts"] - ev["submit"]["ts"]) * 1e3)
    return out


def phase_pool(device: torch.device) -> None:
    """The elastic executor pool on the card: `pool=((0,), (0,))`, two
    members on device 0. The same mixed load of local and sharded buckets
    through the pool and through a solo server, every served byte equal to
    the direct call; then a `SITE_SHARD` `dev0` loss: the routed member of
    the sharded bucket probes, is retired, the survivor serves the rest
    byte-equal and, the last member, refuses its own drain."""
    from repro_torch.filters import apply_filter
    from repro_torch.runtime.fault import SITE_SHARD, FaultInjector, fault_scope
    from repro_torch.serve import ImageFilterServer, ServerConfig
    from repro_torch.serve.pool import rendezvous_score
    from repro_torch.serve.request import bucket_key

    t_phase = time.perf_counter()
    frames = noisy_frames(8, SERVE_FRAME, 20, 500).astype(np.uint8)
    want = {(f, impl): [apply_filter(fr, f, method="refmlm", mult_impl=impl).cpu()
                        for fr in frames] for f, impl, _ in POOL_JOBS}
    common = dict(max_batch=8, max_delay_ms=5.0, max_pending=4096, degrade_after=1,
                  trace=True)
    servers = {"solo": ImageFilterServer(ServerConfig(**common)),
               "pool": ImageFilterServer(ServerConfig(pool=((0,), (0,)), drain_after=2,
                                                      **common))}
    try:
        for srv in servers.values():
            for filt, impl, mode in POOL_JOBS:
                srv.warmup([SERVE_FRAME], (filt,), mult_impls=(impl,), execs=(mode,),
                           batches=(8,))
        runs: dict[str, list[tuple[float, float, float]]] = {"solo": [], "pool": []}
        for name in ("solo", "pool", "pool", "solo"):       # in turns
            srv = servers[name]
            torch.cuda.synchronize()
            since = time.monotonic()
            t0 = time.perf_counter()
            futs = [(filt, impl, j, srv.submit(frames[j], filt, method="refmlm",
                                               mult_impl=impl, exec=mode))
                    for _ in range(POOL_ROUNDS) for filt, impl, mode in POOL_JOBS
                    for j in range(len(frames))]
            for filt, impl, j, fut in futs:
                assert torch.equal(fut.result(120), want[(filt, impl)][j]), \
                    f"{name} served != direct: {filt} {impl} frame {j}"
            wall = time.perf_counter() - t0
            p50, p99 = _pcts(_span_latencies_ms(srv, since))
            runs[name].append((len(futs) / wall, p50, p99))
            log(f"[pool] {name}: {len(futs)} frames ({len(POOL_JOBS)} buckets, local and "
                f"sharded) served byte-equal to the direct call in {wall:.3f} s, "
                f"{len(futs) / wall:.1f} frames/s; p50 {p50:.4f} ms p99 {p99:.4f} ms "
                f"(submit to fulfil, the server's trace)")
        for name, srv in servers.items():
            st = srv.stats()
            assert st["served"] == st["submitted"] and st["failed"] == 0, (name, st)
            assert st["degraded"] == {}, f"{name}: a bucket fell back to local"
            log(f"[pool] {name}, median of {len(runs[name])} runs in turns (solo, pool, "
                f"pool, solo): " + ", ".join(
                    f"{label} {statistics.median(r[i] for r in runs[name]):.4f}"
                    for i, label in enumerate(("frames/s", "p50 ms", "p99 ms"))))
        pool = servers["pool"]
        members = pool.stats()["pool"]["members"]
        for m, row in members.items():
            log(f"[pool] member {m} devices {row['devices']}: routes {row['routes']} "
                f"dispatches {row['dispatches']} failed {row['failed']}")

        # device 0 dies for sharded work: the routed member drains, the survivor serves
        filt, impl, mode = POOL_JOBS[2]
        key = bucket_key(filt, "refmlm", impl, mode, 8, *SERVE_FRAME)
        target = max(members, key=lambda m: rendezvous_score(m, key))
        survivor = next(m for m in members if m != target)
        with fault_scope(FaultInjector().on_key(SITE_SHARD, "dev0")) as inj:
            for r in range(POOL_LOSS_ROUNDS):
                futs = [pool.submit(frames[j], filt, method="refmlm", mult_impl=impl,
                                    exec=mode) for j in range(len(frames))]
                for j, fut in enumerate(futs):
                    assert torch.equal(fut.result(120), want[(filt, impl)][j]), \
                        f"served under device loss != direct: round {r} frame {j}"
        st = pool.stats()
        rows = st["pool"]["members"]
        log(f"[pool] dev0 lost to sharded work ({len(inj.events)} injected shard faults): "
            f"{POOL_LOSS_ROUNDS * len(frames)} frames of {key} served byte-equal; member "
            f"{target} {rows[target]['state']}, {survivor} {rows[survivor]['state']} "
            f"(routes {rows[survivor]['routes']}); drains {st['pool']['drains']} rebuilds "
            f"{st['pool']['rebuilds']} drain_refused {st['pool']['drain_refused']}; "
            f"degraded {st['degraded']}")
        assert rows[target]["state"] == "dead" and rows[survivor]["state"] == "active"
        assert st["pool"]["drains"] == 1 and st["pool"]["rebuilds"] == 0
        assert st["pool"]["drain_refused"] >= 1, "the last member was not asked to drain"
        assert st["failed"] == 0
    finally:
        for srv in servers.values():
            srv.close()
    torch.cuda.synchronize()
    log(f"[pool] phase {time.perf_counter() - t_phase:.1f} s (host clock)")


LM_ARCH = "qwen2-0.5b"
LM_TRAFFIC = (4, 32, 32)            # batch, prompt, generated tokens: the reference CLI's
LM_METHODS = ("exact", "mitchell", "karatsuba_int16")
LM_PARITY_LAYERS = 2
LM_DECODE_RUNS = 5


@contextlib.contextmanager
def checked_mitchell(stats: dict):
    """Every `mitchell_matmul_kernel` call inside also runs
    `mitchell_matmul_plain` on the same operands; `stats` counts the calls
    and keeps the largest |kernel - plain| of the int32 accumulators."""
    from repro_torch.kernels import mitchell_matmul as mm
    kernel = mm.mitchell_matmul_kernel

    def checked(a, b, **kw):
        out = kernel(a, b, **kw)
        plain = mm.mitchell_matmul_plain(a, b, **kw)
        stats["calls"] += 1
        stats["max_err"] = max(stats["max_err"],
                               int((out.long() - plain.long()).abs().max()))
        return out

    mm.mitchell_matmul_kernel = checked
    try:
        yield
    finally:
        mm.mitchell_matmul_kernel = kernel


def count_syncs(fn) -> tuple[object, dict[str, int]]:
    """fn() with the CUDA sync debug mode on: -> (its result, the
    synchronizing CUDA operations it made, by the source line that made
    them)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites: dict[str, int] = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            site = f"{Path(w.filename).name}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    return out, sites


def device_busy_ms(fn) -> tuple[float, float, dict[str, float]] | None:
    """(wall ms, summed CUDA kernel ms, device ms by kernel name (60
    characters), most first) of fn() ended by a sync, under torch.profiler;
    None when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    ranked = dict(sorted(by_name.items(), key=lambda kv: -kv[1]))
    return (wall, busy, ranked) if busy > 0 else None


def lm_steps(model, params, prompt, steps: int) -> list[torch.Tensor]:
    """Prefill `prompt`, then `steps` greedy decode steps; -> the logits
    of every step (the path `greedy_generate` takes, logits kept)."""
    caches = model.init_cache(prompt.shape[0], prompt.shape[1] + steps)
    logits, caches, clen = model.prefill(params, {"tokens": prompt}, caches)
    outs = [logits]
    for _ in range(steps):
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        logits, caches, clen = model.decode_step(params, tok, caches, clen)
        outs.append(logits)
    return outs


def phase_lm_parity(cfg, prompt: torch.Tensor, max_err: dict) -> None:
    """The LM path at full width with the depth cut to 2 layers, prefill
    and 2 decode steps: karatsuba_int16's logits on the kernels byte-equal
    to the plain route's (`impl='reference'`: the plain limb products);
    every mitchell_matmul call's accumulators equal to
    mitchell_matmul_plain's; the mitchell logits' max |diff| against the
    reference's float32-summing route (R5)."""
    import dataclasses

    from repro_torch.models import build_model

    cut = dataclasses.replace(cfg, num_layers=LM_PARITY_LAYERS)
    params = build_model(cut).init(torch.Generator(prompt.device).manual_seed(1))
    t0 = time.perf_counter()
    lim = dataclasses.replace(cut, matmul_method="karatsuba_int16")
    got = lm_steps(build_model(lim), params, prompt, 2)
    plain = lm_steps(build_model(lim, impl="reference"), params, prompt, 2)
    for i, (g, p) in enumerate(zip(got, plain)):
        assert torch.equal(g, p), f"karatsuba_int16 logits differ from the plain route, step {i}"
    log(f"[lm] parity {LM_PARITY_LAYERS} layers, full width: karatsuba_int16 logits of "
        f"prefill + 2 decode steps byte-equal to the plain route (impl='reference')")
    lns = dataclasses.replace(cut, matmul_method="mitchell")
    stats = {"calls": 0, "max_err": 0}
    with checked_mitchell(stats):
        got = lm_steps(build_model(lns), params, prompt, 2)
    max_err["mitchell_matmul"] = max(max_err["mitchell_matmul"], stats["max_err"])
    assert stats["calls"] == 7 * LM_PARITY_LAYERS * 3 and stats["max_err"] == 0, stats
    ref = lm_steps(build_model(lns, impl="reference"), params, prompt, 2)
    r5 = max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref))
    scale = max(float(r.float().abs().max()) for r in ref)
    log(f"[lm] parity: mitchell_matmul accumulators == mitchell_matmul_plain on all "
        f"{stats['calls']} calls (max |err| {stats['max_err']}); mitchell logits against "
        f"the float32-summing reference route (R5, K = {cfg.d_model} and {cfg.d_ff}): max |diff| "
        f"{r5:.6g} of max |logit| {scale:.6g}; {time.perf_counter() - t0:.1f} s")


def phase_lm(device: torch.device, max_err: dict) -> tuple[dict[str, int], float | None]:
    """Qwen2-0.5B at full published width (24 layers, bf16, random weights
    from a seeded generator): `greedy_generate` at the reference CLI's
    traffic (batch 4, prompt 32, 32 tokens) for exact, mitchell and
    karatsuba_int16 on the kernels; [lm] lines with prefill ms, decode ms a
    token, tokens/s, launches and host syncs a decode step, peak memory.
    -> (the matmul kernels' launches over the three main-path runs,
    mitchell_matmul's device ms in one mitchell decode step under
    torch.profiler, None if it saw no device time)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_lib import greedy_generate

    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    batch, plen, gen = LM_TRAFFIC
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, plen))).to(device)
    phase_lm_parity(cfg, prompt, max_err)

    params = build_model(cfg).init(torch.Generator(device).manual_seed(0))
    n_params = build_model(cfg).count_params(params)
    log(f"[lm] {LM_ARCH}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} / {cfg.num_kv_heads} heads x {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}; {n_params} parameters "
        f"(float32 master weights)")
    lm_launches = dict.fromkeys(MATMUL_KERNELS, 0)
    mitchell_step_ms = None          # mitchell_matmul's device ms in one decode step
    for method in LM_METHODS:
        model = build_model(dataclasses.replace(cfg, matmul_method=method))
        greedy_generate(model, params, prompt, steps=2, s_max=plen + gen)   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_matmul_launches()
        t0 = time.perf_counter()
        tokens = greedy_generate(model, params, prompt, steps=gen, s_max=plen + gen)
        tokens = tokens.cpu()
        wall = time.perf_counter() - t0
        launches = matmul_launches()
        peak = torch.cuda.max_memory_allocated()
        assert tokens.shape == (batch, gen) and tokens.dtype == torch.int32, tokens.shape
        assert 0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab_size
        for name in MATMUL_KERNELS:
            lm_launches[name] += launches[name]
        if method == "exact":
            assert not any(launches.values()), f"exact launched a matmul kernel: {launches}"
        else:
            kernel = "mitchell_matmul" if method == "mitchell" else "karatsuba_matmul_i8"
            assert launches[kernel] > 0, f"{method}: {kernel} never launched"
            assert launches["karatsuba_matmul"] == 0, "the wide limb kernel ran on the LM path"

        # the split: prefill, then decode steps, each ended by a sync
        caches = model.init_cache(batch, plen + gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches, clen = model.prefill(params, {"tokens": prompt}, caches)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        assert bool(torch.isfinite(logits).all()), f"{method}: non-finite prefill logits"
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        step_ms = []
        for _ in range(LM_DECODE_RUNS):
            t0 = time.perf_counter()
            logits, caches, clen = model.decode_step(params, tok, caches, clen)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        reset_matmul_launches()
        (logits, caches, clen), sync_sites = count_syncs(
            lambda: model.decode_step(params, tok, caches, clen))
        syncs = sum(sync_sites.values())
        step_launches = {k: v for k, v in matmul_launches().items() if v}
        assert bool(torch.isfinite(logits).all()), f"{method}: non-finite decode logits"
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        try:
            busy = device_busy_ms(lambda: model.decode_step(params, tok, caches, clen))
        except Exception as err:                         # noqa: BLE001
            busy = None
            log(f"[lm] {method}: torch.profiler failed ({err!r})")
        log(f"[lm] {method}: greedy_generate {batch}x{plen} + {gen} tokens in {wall:.4f} s "
            f"(host clock), {batch * gen / wall:.2f} tokens/s; prefill {prefill_ms:.4f} ms; "
            f"decode {statistics.median(step_ms):.4f} ms a token (median of "
            f"{LM_DECODE_RUNS}); a decode step launches {step_launches or 'no matmul kernel'}"
            f" and makes {syncs} host syncs; peak {peak / 2**30:.3f} GiB; "
            f"main-path launches {{{', '.join(f'{k}: {v}' for k, v in launches.items())}}}; "
            f"tokens[0][:8] {tokens[0, :8].tolist()}")
        if busy is not None and method == "mitchell":
            mitchell_step_ms = sum(v for name, v in busy[2].items() if "mitchell_matmul" in name)
        log(f"[lm] {method}: host syncs of a decode step by site {sync_sites}; one decode "
            + ("step under torch.profiler: not measured (no device time seen)" if busy is None
               else f"step under torch.profiler: wall {busy[0]:.4f} ms, CUDA kernels "
                    f"{busy[1]:.4f} ms, device busy {busy[1] / busy[0]:.4f}"
                    + (f", mitchell_matmul {mitchell_step_ms:.4f} ms"
                       if method == "mitchell" else "") + "; most device ms "
                    + ", ".join(f"{k} {v:.4f}" for k, v in list(busy[2].items())[:3])))
    log(f"[lm] phase {time.perf_counter() - t_phase:.1f} s (host clock)")
    return lm_launches, mitchell_step_ms


def tile_cases(shape) -> dict[str, list]:
    """The persistent conv kernels' cases of `phase_tiles` at `shape`: at the
    main-path shape every persistent tap shape of each kernel (direct 3x3 and
    5x5, the 1-D passes at 8 bits and the 16-bit column passes of the
    two-pass dataflow; fused gaussian3 and gaussian5); at the scale shape
    the Fig. 9 table and gaussian3 / gaussian5."""
    from repro_torch.filters.bank import get_filter
    from repro_torch.kernels.gaussian_conv import gaussian_kernel_3x3

    fig9 = gaussian_kernel_3x3(1.0, 256).astype(np.int64)
    g3, g5 = get_filter("gaussian3"), get_filter("gaussian5")
    direct = [("fig9", fig9, 8, 8, "clip")]
    if shape == MAIN_SHAPE:
        direct += [("gaussian5", g5.taps.astype(np.int64), 8, g5.shift, g5.post)]
        for spec in (g3, g5):
            row, col = spec.sep_row.astype(np.int64), spec.sep_col.astype(np.int64)
            direct += [(f"{spec.name} row", row[None, :], 8, 0, "none"),
                       (f"{spec.name} col", col[:, None], 8, spec.shift, spec.post),
                       (f"{spec.name} col nbits=16", col[:, None], 16, spec.shift, spec.post)]
    return {"direct": direct, "fused": [g3, g5]}


TILE_TIMED = ("fig9", "gaussian3", "gaussian5")


def phase_tiles(inputs: dict[tuple, torch.Tensor], max_err: dict) -> dict[tuple, dict]:
    """Each persistent conv kernel at each tile of the menu, byte-equal to its
    plain version (and so to the menu's first tile) on the main-path and
    scale frames and on them with `with_out_of_range`'s operands (the F1 /
    F2 inputs); every multiplier at the main-path shape, refmlm at the scale
    shape; the recurse kernels at every chunk of their menu. Then [tile]
    lines: device ms of each kernel at each tile (fig9, gaussian3,
    gaussian5; kcm and recurse refmlm) and what each instance takes on this
    card (shared memory, blocks an SM, registers). -> {(kernel, filter,
    shape, tile): numbers}."""
    from repro_torch.filters import conv
    from repro_torch.filters.bank import max_intermediate
    from repro_torch.tuning.blocks import TILE_MENU

    tiles = TILE_MENU["persistent"]
    failures: list[str] = []
    checked = 0
    t0 = time.perf_counter()

    def check(kernel: str, got, want, what: str) -> None:
        nonlocal checked
        checked += 1
        check_equal(max_err, failures, kernel, got, want, what)

    for si, shape in enumerate((MAIN_SHAPE, SCALE_SHAPE)):
        frames = inputs[shape]
        methods = METHODS if shape == MAIN_SHAPE else ("refmlm",)
        cases = tile_cases(shape)
        rng = np.random.default_rng(80 + si)
        signed = torch.from_numpy(rng.integers(-4080, 4081, shape).astype(np.int32)).cuda() \
            if shape == MAIN_SHAPE else None
        for label, x in (("frames", frames), ("out-of-range", with_out_of_range(frames, 8, 90 + si))):
            for method in methods:
                for name, taps, nbits, shift, post in cases["direct"]:
                    xin = signed if nbits == 16 and label == "frames" else x
                    if nbits == 16 and label != "frames":
                        xin = with_out_of_range(signed, 16, 95)
                    kh, kw = taps.shape
                    what = f"{name} {method} {label} {shape}"
                    rom = conv.rom_stack(method, taps, nbits, xin.device)
                    kw_ = dict(shift=shift, post=post)
                    want = conv.conv_pass_kcm_plain(xin, rom, kh, kw, **kw_)
                    for tile in tiles:
                        check("conv_pass_kcm", conv.conv_pass_kcm(xin, rom, kh, kw, tile=tile, **kw_),
                              want, f"{tile} {what}")
                    rk = dict(method=method, nbits=nbits, **kw_)
                    want = conv.conv_pass_recurse_plain(xin, taps, **rk)
                    chunks = (None,) + conv.chunk_menu("conv_pass_recurse", method, nbits, kh, kw)
                    for tile in tiles:
                        for chunk in chunks:
                            check("conv_pass_recurse",
                                  conv.conv_pass_recurse(xin, taps, tile=tile, chunk=chunk, **rk),
                                  want, f"{tile} chunk {chunk} {what}")
                for spec in cases["fused"]:
                    row, col = spec.sep_row.astype(np.int64), spec.sep_col.astype(np.int64)
                    nb2 = conv.second_pass_nbits(max_intermediate(spec), int(np.abs(col).max()))
                    kw_ = dict(shift=spec.shift, post=spec.post)
                    what = f"{spec.name} {method} {label} {shape}"
                    rr = conv.rom_stack(method, row, 8, x.device)
                    cr = conv.rom_stack(method, col, nb2, x.device)
                    want = conv.fused_separable_kcm_plain(x, rr, cr, **kw_)
                    for tile in tiles:
                        check("fused_separable_kcm",
                              conv.fused_separable_kcm(x, rr, cr, tile=tile, **kw_), want,
                              f"{tile} {what}")
                    rk = dict(method=method, nbits=8, nbits2=nb2, **kw_)
                    want = conv.fused_separable_recurse_plain(x, row, col, **rk)
                    chunks = (None,) + conv.chunk_menu("fused_separable_recurse", method, 8,
                                                       col.size, row.size, nb2)
                    for tile in tiles:
                        for chunk in chunks:
                            check("fused_separable_recurse",
                                  conv.fused_separable_recurse(x, row, col, tile=tile,
                                                               chunk=chunk, **rk),
                                  want, f"{tile} chunk {chunk} {what}")
        torch.cuda.synchronize()
    log(f"[tile] {checked} comparisons of every persistent kernel at tiles {list(tiles)} "
        f"(and every chunk of the menu) with its plain version, frames and out-of-range "
        f"operands, in {time.perf_counter() - t0:.1f} s; max |err| "
        f"{ {k: max_err[k] for k in conv.KERNELS} }")
    if failures:
        raise AssertionError("a tile disagrees with the plain version:\n"
                             + "\n".join(failures[:20]))

    results: dict[tuple, dict] = {}
    for shape in (MAIN_SHAPE, SCALE_SHAPE):
        x = inputs[shape]
        cases = tile_cases(shape)
        fig9 = cases["direct"][0][1]
        rom9 = conv.rom_stack("refmlm", fig9, 8, x.device)
        for tile in tiles:
            calls = {("conv_pass_kcm", "fig9"): (
                         lambda t=tile: conv.conv_pass_kcm(x, rom9, 3, 3, shift=8, post="clip",
                                                           tile=t),
                         tile_info("conv_pass_kcm", tile, (3, 3))),
                     ("conv_pass_recurse", "fig9"): (
                         lambda t=tile: conv.conv_pass_recurse(x, fig9, method="refmlm", nbits=8,
                                                               shift=8, post="clip", tile=t),
                         tile_info("conv_pass_recurse", tile, (3, 3)))}
            for spec in cases["fused"]:
                row, col = spec.sep_row.astype(np.int64), spec.sep_col.astype(np.int64)
                rr = conv.rom_stack("refmlm", row, 8, x.device)
                cr = conv.rom_stack("refmlm", col, 16, x.device)
                kw_ = dict(shift=spec.shift, post=spec.post)
                calls[("fused_separable_kcm", spec.name)] = (
                    lambda t=tile, rr=rr, cr=cr, kw_=kw_: conv.fused_separable_kcm(
                        x, rr, cr, tile=t, **kw_),
                    fused_kcm_info(rr, cr, tile))
                calls[("fused_separable_recurse", spec.name)] = (
                    lambda t=tile, row=row, col=col, kw_=kw_: conv.fused_separable_recurse(
                        x, row, col, method="refmlm", nbits=8, nbits2=16, tile=t, **kw_),
                    tile_info("fused_separable_recurse", tile, (col.size, row.size)))
            for (kernel, filt), (fn, info) in calls.items():
                row_ = {"kernel": kernel, "filter": filt, "method": "refmlm",
                        "shape": list(shape), "tile": f"{tile[0]}x{tile[1]}",
                        "ms": time_ms(fn, 20), "device_ms": time_ms_batched(fn), **info}
                results[(kernel, filt, tuple(shape), tile)] = row_
                log(f"[tile] {json.dumps(row_)}")
        torch.cuda.empty_cache()
    return results


TUNE_TIMEOUT_S = 600


def phase_tune(inputs: dict[tuple, torch.Tensor]) -> None:
    """`python -m repro_torch.tuning.autotune --quick` on the card into an
    empty temporary cache directory; then `resolve_filter_plan` returns the
    stored winner and `apply_filter` on default arguments gives the same
    bytes as with an empty cache. The committed cache (blocks_cuda.json) is
    restored after."""
    import os
    import tempfile

    from repro_torch.filters import apply_filter, resolve_filter_plan
    from repro_torch.tuning import invalidate_cache, load_plans, plan_key
    from repro_torch.tuning.autotune import PLAN_QUICK
    from repro_torch.tuning.cache import CACHE_ENV, load_meta

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as tuned, tempfile.TemporaryDirectory() as empty:
        env[CACHE_ENV] = tuned
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "repro_torch.tuning.autotune", "--quick"],
                              env=env, capture_output=True, text=True, timeout=TUNE_TIMEOUT_S)
        secs = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            if "winner" in line or "wrote" in line:
                log(f"[tune] {line}")
        assert proc.returncode == 0, f"autotune --quick failed:\n{proc.stdout}\n{proc.stderr}"
        prior = os.environ.get(CACHE_ENV)
        try:
            os.environ[CACHE_ENV] = tuned
            invalidate_cache()
            plans = load_plans("cuda")
            log(f"[tune] autotune --quick in {secs:.1f} s (host clock, its own process); "
                f"{len(plans)} plans; chunk rows "
                f"{json.dumps({k: v['winner'] for k, v in load_meta('cuda').get('chunks', {}).items()})}")
            x = inputs[MAIN_SHAPE]
            outs = {}
            for name, n, h, w in PLAN_QUICK:
                entry = plans[plan_key(name, n, h, w)]
                got = resolve_filter_plan(name, n, h, w, device="cuda")
                assert tuple(got) == tuple(entry[k] for k in (
                    "dataflow", "mult_impl", "block_rows", "block_cols", "batch_fold")), \
                    f"{name}: resolve_filter_plan {got} is not the stored winner {entry}"
                log(f"[tune] {name} n{n}x{h}x{w}: resolve_filter_plan -> {tuple(got)} "
                    f"(the stored winner, {entry['us_per_call']} us)")
                outs[name] = apply_filter(x, name)
            os.environ[CACHE_ENV] = empty
            invalidate_cache()
            for name, out in outs.items():
                assert torch.equal(out, apply_filter(x, name)), \
                    f"{name}: the tuned plan's bytes differ from the cache-miss plan's"
            log(f"[tune] apply_filter on default arguments: tuned bytes == empty-cache bytes "
                f"for {list(outs)}")
        finally:
            if prior is None:
                os.environ.pop(CACHE_ENV, None)
            else:
                os.environ[CACHE_ENV] = prior
            invalidate_cache()


SCENE = (10980, 10980)          # a Sentinel-2 L1C 10 m granule's pixel grid
STREAM_RUNS = (((2048, 2048), 4), ((256, 256), 8))   # (tile, tile_batch)
STREAM_KILL_AT = 20             # the tile index a fault kills the first run at


def phase_streamed() -> None:
    """A 1 x 10980 x 10980 uint8 scene from the seed on an np.memmap,
    streamed (gaussian5, refmlm, kcm) into a memmap `out` at (2048, 2048) x 4
    and (256, 256) x 8 tiles, each byte-equal to one local `apply_filter` of
    the whole scene on the card; then a `FaultInjector` at SITE_TILE kills a
    run midway and `resume=True` finishes it byte-identical, recomputing only
    the unjournaled tiles. [stream] lines: Mpx/s, tiles, batches, host ms
    against device ms."""
    import tempfile

    from repro_torch.distribute import journal_fingerprint, load_journal, stream_filter
    from repro_torch.filters import apply_filter
    from repro_torch.runtime.fault import SITE_TILE, FaultInjector, InjectedFault, fault_scope

    h, w = SCENE
    kw = dict(method="refmlm", mult_impl="kcm")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        g = torch.Generator(device="cuda").manual_seed(17)
        yy = torch.arange(h, device="cuda", dtype=torch.float32)[:, None]
        xx = torch.arange(w, device="cuda", dtype=torch.float32)[None, :]
        field = 128 + 90 * torch.sin(xx / 37.0) * torch.cos(yy / 53.0)
        noise = torch.randint(-30, 31, (h, w), generator=g, device="cuda")
        scene = (field + noise).clamp(0, 255).to(torch.uint8)
        src = np.memmap(tmp / "scene.u8", np.uint8, "w+", shape=(1, h, w))
        src[0] = scene.cpu().numpy()
        src.flush()
        src = np.memmap(tmp / "scene.u8", np.uint8, "r", shape=(1, h, w))
        t1 = time.perf_counter()
        local = apply_filter(scene[None], "gaussian5", **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        local = local.cpu().numpy()
        log(f"[stream] scene 1x{h}x{w} uint8 ({h * w / 1e6:.1f} MB) made on the card and "
            f"written to a memmap in {t1 - t0:.3f} s; one local apply_filter of the whole "
            f"scene {(t2 - t1) * 1e3:.3f} ms (host clock, the scene already on the card)")
        del scene
        torch.cuda.empty_cache()
        for tile, tile_batch in STREAM_RUNS:
            out = np.memmap(tmp / f"out{tile[0]}.u8", np.uint8, "w+", shape=(1, h, w))
            stats: dict = {}
            t0 = time.perf_counter()
            stream_filter(src, "gaussian5", tile=tile, tile_batch=tile_batch, out=out,
                          stats=stats, **kw)
            secs = time.perf_counter() - t0
            assert np.array_equal(np.asarray(out), local), \
                f"streamed {tile} x {tile_batch} != the local pass"
            log(f"[stream] tile {tile} x {tile_batch}: byte-equal to the local pass; "
                f"{h * w / secs / 1e6:.3f} Mpx/s ({secs:.3f} s host clock); "
                f"{stats['tiles']} tiles in {stats['batches']} batches; host "
                f"{stats['host_s'] * 1e3:.3f} ms (gather, write, journal) against device "
                f"{stats['device_s'] * 1e3:.3f} ms (copy in, filter, copy back)")
        tile, tile_batch = STREAM_RUNS[0]
        out = np.memmap(tmp / "resumed.u8", np.uint8, "w+", shape=(1, h, w))
        inj = FaultInjector().at_index(SITE_TILE, STREAM_KILL_AT)
        try:
            with fault_scope(inj):
                stream_filter(src, "gaussian5", tile=tile, tile_batch=tile_batch, out=out, **kw)
        except InjectedFault:
            pass
        else:
            raise AssertionError("the injected tile fault did not stop the run")
        fp = journal_fingerprint((1, h, w), "gaussian5", *tile, kw)
        done = load_journal(f"{out.filename}.journal", fp)
        total = -(-h // tile[0]) * -(-w // tile[1])
        counter = FaultInjector()
        with fault_scope(counter):
            stream_filter(src, "gaussian5", tile=tile, tile_batch=tile_batch, out=out,
                          resume=True, **kw)
        recomputed = counter.calls.get(SITE_TILE, 0)
        assert recomputed == total - len(done), (recomputed, total, len(done))
        assert np.array_equal(np.asarray(out), local), "the resumed run differs"
        log(f"[stream] killed at tile {STREAM_KILL_AT} of {total} ({len(done)} journaled); "
            f"resume=True recomputed {recomputed} tiles; byte-identical to the uninterrupted "
            f"run")


def phase_sharded(inputs: dict[tuple, torch.Tensor]) -> None:
    """16x2048x2048 gaussian5 through `exec='sharded'` on this card
    (devices=1, a 1x1 mesh), halo='exchange' and 'embedded', byte-equal to
    the local pass."""
    from repro_torch.distribute import filter_mesh
    from repro_torch.filters import apply_filter

    x = inputs[SCALE_SHAPE]
    local = apply_filter(x, "gaussian5", method="refmlm")
    mesh = filter_mesh(1, n=x.shape[0])
    for halo in ("exchange", "embedded"):
        fn = lambda halo=halo: apply_filter(x, "gaussian5", method="refmlm", exec="sharded",
                                            devices=1, halo=halo)
        got = fn()
        assert torch.equal(got, local), f"sharded {halo} != local"
        log(f"[sharded] {SCALE_SHAPE} gaussian5 refmlm on mesh {mesh.shape} "
            f"{mesh.devices.flat[0]}: halo={halo} byte-equal to local; "
            f"{time_ms(fn, 5)} ms a call (CUDA events)")
    log(f"[sharded] local {time_ms(lambda: apply_filter(x, 'gaussian5', method='refmlm'), 5)} "
        f"ms a call (CUDA events)")


def time_ms(fn, runs: int, warmup: int = 2) -> float:
    """Median of `runs` CUDA-event-timed calls after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


SM_CLOCK_HZ = 1.98e9            # the H100's highest SM clock


def time_ms_batched(fn, calls: int = 10, runs: int = 5) -> float:
    """Median over `runs` of the CUDA-event time of `calls` back-to-back
    calls, divided by `calls`: the device time of one call. Before each run
    the card spins (torch.cuda._sleep) for at least twice the host time of
    enqueueing the calls, measured on a first unheld batch, and at least
    5 ms, so the start event and every call are queued before the card
    reaches them and no host gap falls between the events."""
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    hold_s = max(0.005, 2 * host_s)
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold_s * SM_CLOCK_HZ))
        t0 = time.perf_counter()
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        if time.perf_counter() - t0 > hold_s:
            log(f"[warn] a timed batch took longer to enqueue than the card's "
                f"{hold_s * 1e3:.3f} ms hold: its time may hold host gaps")
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


# Integer operations counted on the INT32 lanes. A kcm tap: |x|, the
# gather, the sign and the accumulate.
KCM_TAP_OPS = 4
# What the persistent recurse kernels must do for a tap with a non-zero
# product (csrc/multipliers.cuh's tap policies), the pixel-side split shared
# by a tap column aside: 3 for the sign and the accumulate, plus the product
# from the plan: exact one multiply; REFMLM 2 a non-zero 2x2 leaf (a byte
# permute, a shifted add); Mitchell 10 (m, the leading power, the case split,
# the zero mask); a Babic stage 7 (and the sign and accumulate per stage);
# ODMA 41 (two Mitchell products whose four operands, leading ones and
# mantissas are found per tap).
RECURSE_OPS = {"exact": 1, "mitchell": 10, "stage": 7, "odma": 41, "leaf": 2}
SIGN_ACC_OPS = 3


def recurse_pixel_ops(method: str, taps, nbits: int) -> int:
    """Operations a pixel of the recurse kernels does for these taps at
    nbits: RECURSE_OPS from the taps' own plan (zero taps and zero digits
    need nothing)."""
    from repro_torch.filters.recurse_plan import recurse_plan
    plan = recurse_plan(method, taps, nbits)
    ops = 0
    for tap in plan.taps:
        if plan.family == "exact":
            ops += (RECURSE_OPS["exact"] + SIGN_ACC_OPS) * (tap.coeff != 0)
        elif tap.leaves:                                         # REFMLM, nbits >= 4
            ops += RECURSE_OPS["leaf"] * len(tap.leaves) * (nbits // 2) + SIGN_ACC_OPS
        elif plan.family == "mitchell_ecc":
            ops += (RECURSE_OPS["stage"] + SIGN_ACC_OPS) * len(tap.stages)
        elif plan.family == "odma":
            ops += (RECURSE_OPS["odma"] + SIGN_ACC_OPS) * (tap.masks[0] != 0)
        elif tap.stages:                                 # Mitchell; the nbits-2 base
            ops += RECURSE_OPS["mitchell"] + SIGN_ACC_OPS
    return ops


def earlier_tap_ops(nbits: int) -> int:
    """The first design's count of a REFMLM tap, kept for comparison:
    3 + (nbits/2)**2 leaves of about 15 operations each (243 at 8 bits, 963
    at 16)."""
    return 3 + (nbits // 2) ** 2 * 15


def phase_times(inputs: dict[tuple, torch.Tensor],
                int32_ops_per_s: float) -> dict[tuple, dict]:
    """{(kernel, method, shape): numbers} on the main-path and scale-phase
    frames. The direct kernels run the Fig. 9 table (Table 10's filter), the
    fused kernels gaussian3 at the main-path shape and gaussian5 at the
    scale shape. kcm: refmlm (its ROMs are the same table for every exact
    method). recurse: every method, beside the tiled kernel of the first
    design (variant 0), all in this run; at the scale shape the plain
    versions of the methods other than refmlm and exact run once."""
    import torch.nn.functional as F

    from repro_torch.filters import conv
    from repro_torch.filters.bank import get_filter
    from repro_torch.kernels.gaussian_conv import gaussian_kernel_3x3

    results = {}
    fig9 = gaussian_kernel_3x3(1.0, 256).astype(np.int64)
    library = ("torch.nn.functional.conv2d float32, TF32 off (the same integer sums, "
               "all below 2**24)")
    for shape, fused_name in ((MAIN_SHAPE, "gaussian3"), (SCALE_SHAPE, "gaussian5")):
        x = inputs[shape]
        device = x.device
        xf = x.to(torch.float32)[:, None]
        big = shape == SCALE_SHAPE
        spec = get_filter(fused_name)
        row, col = spec.sep_row.astype(np.int64), spec.sep_col.astype(np.int64)
        rom9 = conv.rom_stack("refmlm", fig9, 8, device)
        rrom = conv.rom_stack("refmlm", row, 8, device)
        crom = conv.rom_stack("refmlm", col, 16, device)
        w9 = torch.from_numpy(fig9.astype(np.float32))[None, None].to(device)
        wsep = torch.from_numpy(np.outer(col, row).astype(np.float32))[None, None].to(device)
        direct_kw = dict(shift=8, post="clip")
        sep_kw = dict(shift=spec.shift, post=spec.post)
        lib_ms = {"direct": time_ms(lambda: F.conv2d(xf, w9, padding=1), 20),
                  "sep": time_ms(lambda: F.conv2d(xf, wsep, padding=(col.size // 2,
                                                                     row.size // 2)), 20)}
        pixels = x.numel()

        def bound(coef_bytes: int, pixel_ops: int) -> dict:
            bytes_ms = (pixels * 4 * 2 + coef_bytes) / HBM_BYTES_PER_S * 1e3
            ops_ms = pixel_ops * pixels / int32_ops_per_s * 1e3
            return {"bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                    "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}

        def record(row_: dict) -> None:
            results[(row_["kernel"], row_["method"], tuple(shape))] = row_
            log(json.dumps(row_))

        plain_runs = 3 if big else 5
        for name, kernel, plain, coef_bytes, pixel_ops, lib, filt in (
                ("conv_pass_kcm", lambda: conv.conv_pass_kcm(x, rom9, 3, 3, **direct_kw),
                 lambda: conv.conv_pass_kcm_plain(x, rom9, 3, 3, **direct_kw),
                 rom9.table.numel() * 4, 9 * KCM_TAP_OPS, "direct", "fig9"),
                ("fused_separable_kcm", lambda: conv.fused_separable_kcm(x, rrom, crom, **sep_kw),
                 lambda: conv.fused_separable_kcm_plain(x, rrom, crom, **sep_kw),
                 (rrom.table.numel() + crom.table.numel()) * 4,
                 (row.size + col.size) * KCM_TAP_OPS,
                 "sep", fused_name)):
            record({"kernel": name, "shape": list(shape), "filter": filt, "method": "refmlm",
                    "kernel_ms": time_ms(kernel, 20),
                    "kernel_device_ms": time_ms_batched(kernel),
                    "plain_ms": time_ms(plain, plain_runs, warmup=1), "plain_runs": plain_runs,
                    **bound(coef_bytes, pixel_ops),
                    "library_ms": lib_ms[lib], "library": library})
        for method in METHODS:
            main_method = method in ("refmlm", "exact")
            runs = plain_runs if not big else 1
            warm = 1 if main_method or not big else 0
            rk = dict(method=method, nbits=8, **direct_kw)
            fk = dict(method=method, nbits=8, nbits2=16, **sep_kw)
            ops_direct = recurse_pixel_ops(method, fig9, 8)
            ops_fused = recurse_pixel_ops(method, row, 8) + recurse_pixel_ops(method, col, 16)
            cases = (
                ("conv_pass_recurse", "fig9",
                 lambda: conv.conv_pass_recurse(x, fig9, **rk),
                 lambda: conv.conv_pass_recurse_plain(x, fig9, **rk),
                 lambda: recurse_tiled(x, fig9, method, 8, **direct_kw),
                 fig9.size * 4, ops_direct, 9 * earlier_tap_ops(8), "direct"),
                ("fused_separable_recurse", fused_name,
                 lambda: conv.fused_separable_recurse(x, row, col, **fk),
                 lambda: conv.fused_separable_recurse_plain(x, row, col, **fk),
                 lambda: fused_tiled(x, row, col, method, 8, 16, **sep_kw),
                 (row.size + col.size) * 4, ops_fused,
                 row.size * earlier_tap_ops(8) + col.size * earlier_tap_ops(16), "sep"))
            for name, filt, kernel, plain, tiled, coef_bytes, pixel_ops, earlier, lib in cases:
                row_ = {"kernel": name, "shape": list(shape), "filter": filt, "method": method,
                        "kernel_ms": time_ms(kernel, 20),
                        "kernel_device_ms": time_ms_batched(kernel),
                        "variant0_ms": time_ms(tiled, 20),
                        "variant0_device_ms": time_ms_batched(tiled)}
                if method in ("refmlm", "refmlm_nc"):
                    row_["earlier_ops_per_pixel"] = earlier
                row_.update({"plain_ms": time_ms(plain, runs, warmup=warm), "plain_runs": runs,
                             "ops_per_pixel": pixel_ops, **bound(coef_bytes, pixel_ops),
                             "library_ms": lib_ms[lib],
                             "library": library + ("" if method in ("exact", "refmlm") else
                                                   "; exact products, not this method's")})
                record(row_)
                log(f"[variant] {name} 0 (tiled kernel, the first design) {filt} {method} "
                    f"{shape}: {row_['variant0_ms']} ms a call, {row_['variant0_device_ms']} "
                    f"ms device time; the entry point {row_['kernel_ms']} / "
                    f"{row_['kernel_device_ms']} ms")
        # the fused kcm kernel (persistent) beside the tiled kernel of the first design
        # (variant 0), gaussian3 and gaussian5, with the persistent
        # instance's resources on this card
        for filt in ("gaussian3", "gaussian5"):
            fspec = get_filter(filt)
            frow = conv.rom_stack("refmlm", fspec.sep_row, 8, device)
            fcol = conv.rom_stack("refmlm", fspec.sep_col, 16, device)
            fkw = dict(shift=fspec.shift, post=fspec.post)
            new = lambda: conv.fused_separable_kcm(x, frow, fcol, **fkw)
            tiled = lambda: fused_kcm_tiled(x, frow, fcol, **fkw)
            ms, device_ms = time_ms(new, 20), time_ms_batched(new)
            v0_ms, v0_device_ms = time_ms(tiled, 20), time_ms_batched(tiled)
            info = fused_kcm_info(frow, fcol)
            if filt == fused_name:
                results[("fused_separable_kcm", "refmlm", tuple(shape))].update(
                    variant0_ms=v0_ms, variant0_device_ms=v0_device_ms, **info)
            log(f"[variant] fused_separable_kcm {filt} refmlm {shape}: persistent {ms} ms a "
                f"call, {device_ms} ms device time; 0 (tiled kernel, the first design) "
                f"{v0_ms} ms a call, {v0_device_ms} ms device time; persistent "
                f"{fspec.sep_col.size}x{fspec.sep_row.size}: column prefix {info['prefix']} "
                f"entries a tap as {'int16' if info['prefix_int16'] else 'int32'}, "
                f"{info['smem_bytes']} bytes shared memory a block, {info['blocks_per_sm']} "
                f"blocks an SM, {info['registers']} registers, {info['local_bytes']} bytes "
                f"local memory (spills) a thread")
        for v, what in KCM_VARIANTS.items():
            call = lambda v=v: kcm_variant(x, rom9, 3, 3, 8, "clip", v)
            ms, device_ms = time_ms(call, 20), time_ms_batched(call)
            log(f"[variant] conv_pass_kcm {v} ({what}) fig9 refmlm {shape}: {ms} ms "
                f"a call, {device_ms} ms device time (10 calls, queued while the card is held)")
        call = lambda: kcm_variant(x, rom9, 3, 3, 0, "none", KCM_COPY_VARIANT)
        assert torch.equal(call(), x), "the staging variant does not copy its input"
        log(f"[variant] conv_pass_kcm {KCM_COPY_VARIANT} (as 4, window centre out, no "
            f"taps) {shape}: {time_ms_batched(call)} ms device time; x.clone() "
            f"{time_ms_batched(lambda: x.clone())} ms")
        del xf
        torch.cuda.empty_cache()
    return results


def check_equal(max_err: dict, failures: list, kernel: str, got, want,
                what: str) -> None:
    """Record |got - want| for `kernel`; a failure unless torch.equal."""
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0
    max_err[kernel] = max(max_err[kernel], err)
    if got.shape != want.shape or not torch.equal(got, want):
        failures.append(f"{kernel} {what}: max |err| {err}")


def mm_operands(shape: tuple[int, int, int], lo: int, hi: int, seed: int,
                device: torch.device) -> tuple[torch.Tensor, ...]:
    """Seeded int32 operands a (M, K), b (K, N) and limbs a_lo, b_lo in
    [lo, hi), on the card."""
    m, k, n = shape
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.integers(lo, hi, s).astype(np.int32)).to(device)
                 for s in ((m, k), (k, n), (m, k), (k, n)))


def int8_limbs(shape: tuple[int, int, int], karatsuba: bool, seed: int,
               device: torch.device, edge: tuple[int, int] | None = None):
    """Seeded limbs a_hi, a_lo (M, K), b_hi, b_lo (K, N) that fit the int8
    kernel (hi + lo too for Karatsuba), with the range's edges written into
    the first row of A and column of B; `edge` = (hi, lo) overwrites one
    pair of each operand."""
    m, k, n = shape
    rng = np.random.default_rng(seed)
    lim = 64 if karatsuba else 128
    ah, al = (rng.integers(-lim, lim, (m, k)) for _ in range(2))
    bh, bl = (rng.integers(-lim, lim, (k, n)) for _ in range(2))
    if karatsuba:               # hi + lo = -128, -128, 127, and single limbs at the edges
        edges = ((-64, -64), (-128, 0), (127, 0), (0, -128))
    else:
        edges = ((-128, 127), (127, -128), (-128, -128), (127, 127))
    for j, (hi, lo) in enumerate(edges[:k]):
        ah[0, j], al[0, j], bh[j, 0], bl[j, 0] = hi, lo, hi, lo
    if edge is not None:
        ah[m - 1, k - 1], al[m - 1, k - 1] = edge
        bh[k - 1, n - 1], bl[k - 1, n - 1] = edge
    return tuple(torch.from_numpy(v.astype(np.int32)).to(device) for v in (ah, al, bh, bl))


def mitchell_route_parity(max_err: dict, failures: list, device: torch.device) -> int:
    """`mitchell_matmul` at MM_ROUTE_SHAPES against its plain version, on
    8-bit and full-range int32 operands (INT_MIN, INT_MAX, 0 and 2**16
    placed in), for every variant; each call must launch the route that
    `launch_plan` names, and both routes must run K splits > 1.
    -> the number of comparisons."""
    from repro_torch.kernels import mitchell_matmul as mm

    checked = 0
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    split_routes = set()
    for i, shape in enumerate(MM_ROUTE_SHAPES):
        sm, sk, sn = shape
        plan = mm.launch_plan(sm, sk, sn, sms)
        if plan.splits > 1:
            split_routes.add(plan.route)
        log(f"[parity] mitchell_matmul {shape}: {plan}, grid {plan.grid(sm, sn)}")
        rng = np.random.default_rng(80 + i)
        for lo, hi in ((-255, 256), (-(1 << 31), 1 << 31)):
            a = rng.integers(lo, hi, (sm, sk), dtype=np.int64)
            b = rng.integers(lo, hi, (sk, sn), dtype=np.int64)
            if lo < -256:
                a[0, :4] = (-(1 << 31), (1 << 31) - 1, 0, 1 << 16)
                b[:4, 0] = ((1 << 31) - 1, -(1 << 31), 1 << 16, 0)
            a, b = (torch.from_numpy(v.astype(np.int32)).to(device) for v in (a, b))
            for num_ecc, split in LNS_VARIANTS + ((2, True),):
                kw = dict(num_ecc=num_ecc, case_split=split)
                before = dict(mm.ROUTE_LAUNCHES)
                got = mm.mitchell_matmul_kernel(a, b, **kw)
                ran = {r: c - before[r] for r, c in mm.ROUTE_LAUNCHES.items() if c != before[r]}
                if ran != {plan.route: 1}:
                    failures.append(f"mitchell_matmul {shape}: launched {ran}, the plan "
                                    f"names {plan.route}")
                check_equal(max_err, failures, "mitchell_matmul", got,
                            mm.mitchell_matmul_plain(a, b, **kw),
                            f"{kw} {shape} in [{lo}, {hi}) ({plan})")
                checked += 1
    if split_routes != {"thin", "tiled"}:
        failures.append(f"mitchell_matmul: K splits > 1 ran only on {split_routes}")
    return checked


def phase_matmul_parity(max_err: dict, device: torch.device) -> None:
    """The matmul kernels against their plain versions on the same CUDA
    tensors: every LNS variant; both limb modes on int8 limbs (the int8
    kernel), on limbs just past int8 and on limbs up to 2**20 (the wide
    kernel), on ragged shapes and at the full-width shape with M cut to
    MM_PLAIN_ROWS. Each limb call must launch the kernel that the wrapper's
    rule (`select_route`) names for its limbs."""
    from repro_torch.kernels import karatsuba_matmul as km
    from repro_torch.kernels import karatsuba_matmul_i8 as i8
    from repro_torch.kernels import mitchell_matmul as mm

    failures: list[str] = []
    checked = 0
    m, k, n = MM_SHAPE

    def limb_check(limbs, kar: bool, what: str, route: str) -> None:
        nonlocal checked
        if i8.select_route(*limbs, karatsuba=kar) != route:
            failures.append(f"{what}: the rule does not pick {route}")
        before = matmul_launches()
        got = km.karatsuba_matmul_kernel(*limbs, karatsuba=kar)
        want = km.karatsuba_matmul_plain(*limbs, karatsuba=kar)
        ran = [name for name, count in matmul_launches().items() if count != before[name]]
        if ran != [route]:
            failures.append(f"{what}: launched {ran}, expected [{route}]")
        for part, g, w in zip(("hh", "mid", "ll"), got, want):
            check_equal(max_err, failures, route, g, w, f"karatsuba={kar} {part} {what}")
        checked += 1

    cases = [(shape, lo, hi, f"{shape} in [{lo}, {hi})")
             for shape in MM_PARITY_SHAPES
             for lo, hi in ((-255, 256), (-(1 << 20), 1 << 20))]
    cases.append(((MM_PLAIN_ROWS, k, n), -255, 256, f"{(MM_PLAIN_ROWS, k, n)}"))
    for i, (shape, lo, hi, what) in enumerate(cases):
        a, b, a_lo, b_lo = mm_operands(shape, lo, hi, 40 + i, device)
        for num_ecc, split in LNS_VARIANTS:
            kw = dict(num_ecc=num_ecc, case_split=split)
            check_equal(max_err, failures, "mitchell_matmul",
                        mm.mitchell_matmul_kernel(a, b, **kw),
                        mm.mitchell_matmul_plain(a, b, **kw), f"{kw} {what}")
            checked += 1
        for kar in (True, False):
            limb_check((a, a_lo, b, b_lo), kar, what, "karatsuba_matmul")
    for i, shape in enumerate(MM_PARITY_SHAPES + ((MM_PLAIN_ROWS, k, n),)):
        for kar in (True, False):
            limb_check(int8_limbs(shape, kar, 60 + i, device), kar,
                       f"{shape} int8 limbs", "karatsuba_matmul_i8")
    for i, shape in enumerate(MM_PARITY_SHAPES):     # one pair just past the rule
        for kar, edge in ((True, (64, 64)), (True, (-65, -64)), (False, (128, 0)),
                          (False, (0, -129))):
            limb_check(int8_limbs(shape, kar, 70 + i, device, edge), kar,
                       f"{shape} limbs {edge}", "karatsuba_matmul")
    # every int32 operand, the edge values included, through the LNS kernel
    rng = np.random.default_rng(49)
    for shape in MM_PARITY_SHAPES:
        sm, sk, sn = shape
        a = rng.integers(-(1 << 31), 1 << 31, (sm, sk), dtype=np.int64)
        a[0, :4] = (-(1 << 31), (1 << 31) - 1, 0, 1 << 16)
        b = rng.integers(-(1 << 31), 1 << 31, (sk, sn), dtype=np.int64)
        a, b = (torch.from_numpy(v.astype(np.int32)).to(device) for v in (a, b))
        for num_ecc, split in LNS_VARIANTS + ((2, True),):
            kw = dict(num_ecc=num_ecc, case_split=split)
            check_equal(max_err, failures, "mitchell_matmul",
                        mm.mitchell_matmul_kernel(a, b, **kw),
                        mm.mitchell_matmul_plain(a, b, **kw),
                        f"{kw} {shape} full int32 range")
            checked += 1
    checked += mitchell_route_parity(max_err, failures, device)
    torch.cuda.synchronize()
    log(f"[parity] {checked} matmul kernel/plain comparisons, max |err| "
        f"{ {name: max_err[name] for name in MATMUL_KERNELS} }")
    if failures:
        raise AssertionError("matmul kernels disagree with their plain "
                             "versions:\n" + "\n".join(failures[:20]))


def matmul_launches() -> dict[str, int]:
    from repro_torch.kernels import karatsuba_matmul as km
    from repro_torch.kernels import karatsuba_matmul_i8 as i8
    from repro_torch.kernels import mitchell_matmul as mm
    return {**mm.LAUNCHES, **km.LAUNCHES, **i8.LAUNCHES}


def reset_matmul_launches() -> None:
    from repro_torch.kernels import karatsuba_matmul as km
    from repro_torch.kernels import karatsuba_matmul_i8 as i8
    from repro_torch.kernels import mitchell_matmul as mm
    mm.reset_launches()
    km.reset_launches()
    i8.reset_launches()


def check_quantized_launches(launches: dict[str, int], path: str) -> None:
    """The quantized paths run `mitchell_matmul` and the int8 limb kernel,
    never the wide one: their limbs always fit int8."""
    missing = [name for name in ("mitchell_matmul", "karatsuba_matmul_i8")
               if launches[name] == 0]
    assert not missing, f"kernels never launched on the {path} path: {missing}"
    assert launches["karatsuba_matmul"] == 0, \
        f"the wide limb kernel ran on the {path} path: {launches}"


def phase_matmul_main(device: torch.device) -> tuple[dict[str, int], tuple]:
    """The quantized-matmul path at full width through its entry points;
    -> (launches by kernel, the float operands on the card)."""
    from repro_torch.core import matmul
    from repro_torch.kernels.ops import limb_matmul, lns_matmul

    m, k, n = MM_SHAPE
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(device)
    w = torch.from_numpy((rng.standard_normal((k, n)) / np.sqrt(k))
                         .astype(np.float32)).to(device)
    exact = x @ w
    scale = float(exact.abs().max())
    torch.cuda.synchronize()
    reset_matmul_launches()
    t0 = time.perf_counter()
    outs = {method: matmul(x, w, method, impl="auto") for method in KERNEL_METHODS}
    outs["lns_matmul"] = lns_matmul(x, w, num_ecc=2, case_split=False)
    outs["limb_matmul"] = limb_matmul(x, w, karatsuba=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = matmul_launches()
    log(f"[matmul] {MM_SHAPE} x {len(outs)} calls in {secs:.3f} s (host clock, "
        f"first calls); launches {launches}")
    errs = {}
    for name, out in outs.items():
        assert out.shape == (m, n) and out.dtype == torch.float32, name
        assert bool(torch.isfinite(out).all()), f"{name}: non-finite output"
        errs[name] = float((out - exact).abs().max()) / scale
    assert torch.equal(outs["lns_matmul"], outs["mitchell_ecc2"])
    assert torch.equal(outs["limb_matmul"], outs["karatsuba_int16"])
    # Against the reference route: the limb methods at full K (exact integer
    # sums both ways), the LNS methods at K = 256, where the reference's
    # float32 sums are exact.
    rows = slice(0, MM_PLAIN_ROWS)
    for method in KERNEL_METHODS:
        kk = k if method.endswith("int16") else 256
        got = matmul(x[rows, :kk], w[:kk], method, impl="kernel")
        want = matmul(x[rows, :kk], w[:kk], method, impl="reference")
        assert torch.equal(got, want), f"{method}: kernel route != reference"
    log("[matmul] max |out - float32 x @ w| / max|x @ w|: "
        + " ".join(f"{name}={err:.6g}" for name, err in errs.items()))
    for name in ("schoolbook_int16", "karatsuba_int16", "limb_matmul"):
        assert errs[name] < 1e-3, f"{name} drifted from the float product"
    for name in ("mitchell", "mitchell_ecc1", "mitchell_ecc2", "mitchell_ecc3"):
        assert errs[name] < 0.25, f"{name} drifted from the float product"
    check_quantized_launches(launches, "matmul")
    return launches, (x, w)


def phase_infer_main(device: torch.device) -> dict[str, int]:
    """`infer.forward` on the card for both models; -> launches by kernel."""
    from repro_torch.data.images import inference_batch
    from repro_torch.infer import (INFER_METHODS, MODELS, calibrate,
                                   error_report, export_scales, format_report,
                                   forward, init_params, with_scales)

    x_cal = inference_batch(4, INFER_HW, seed=100)
    x = inference_batch(INFER_BATCH, INFER_HW, seed=0)
    torch.cuda.synchronize()
    reset_matmul_launches()
    t0 = time.perf_counter()
    for model in ("cnn", "mlp"):
        graph = MODELS[model](INFER_HW)
        params = init_params(graph, seed=0)
        cal = calibrate(graph, params, x_cal, device=device)
        report = error_report(cal, x, INFER_METHODS)
        log(format_report(report, title=f"[infer] {model} {INFER_HW} x "
                                         f"{INFER_BATCH} images, nbits={cal.nbits}"))
        o_logits, o_accs = forward(cal, x, "int8", collect=True)
        for method in ("refmlm", "refmlm_kom3", "schoolbook_int16", "karatsuba_int16"):
            logits, accs = forward(cal, x, method, collect=True)
            assert all(torch.equal(a, o) for a, o in zip(accs, o_accs)), \
                f"{model} {method}: accumulators != int8 oracle"
            assert torch.equal(logits, o_logits), f"{model} {method}: logits"
            assert report[method]["top1_vs_oracle"] == 1.0
        assert report["mitchell_ecc2"]["top1_vs_oracle"] >= 0.75
        # the card's bytes == the port's CPU path on the first images
        cpu = with_scales(graph, params, export_scales(cal), device="cpu")
        xs = x[:INFER_CPU_BATCH]
        for method in INFER_METHODS[1:]:
            logits, accs = forward(cal, xs, method, collect=True)
            c_logits, c_accs = forward(cpu, xs, method, collect=True)
            assert torch.equal(logits.cpu(), c_logits), f"{model} {method}: card != cpu"
            assert all(torch.equal(a.cpu(), c) for a, c in zip(accs, c_accs)), \
                f"{model} {method}: card accumulators != cpu"
    torch.cuda.synchronize()
    launches = matmul_launches()
    log(f"[infer] cnn + mlp: report, §14 contract and card == cpu in "
        f"{time.perf_counter() - t0:.1f} s; launches {launches}")
    check_quantized_launches(launches, "infer")
    return launches


def phase_wide_main(device: torch.device) -> dict[str, int]:
    """`infer.forward` with karatsuba_int16 on both models calibrated at
    WIDE_NBITS bits, where the w = 7 limbs pass int8; -> launches by kernel."""
    from repro_torch.data.images import inference_batch
    from repro_torch.infer import MODELS, calibrate, forward, init_params

    x_cal = inference_batch(4, INFER_HW, seed=100)
    x = inference_batch(INFER_BATCH, INFER_HW, seed=0)
    torch.cuda.synchronize()
    reset_matmul_launches()
    t0 = time.perf_counter()
    for model in ("cnn", "mlp"):
        graph = MODELS[model](INFER_HW)
        cal = calibrate(graph, init_params(graph, seed=0), x_cal, nbits=WIDE_NBITS,
                        device=device)
        o_logits, o_accs = forward(cal, x, "int8", collect=True)
        logits, accs = forward(cal, x, "karatsuba_int16", collect=True)
        assert all(torch.equal(a, o) for a, o in zip(accs, o_accs)), \
            f"{model} nbits={WIDE_NBITS}: karatsuba_int16 accumulators != int8 oracle"
        assert torch.equal(logits, o_logits), f"{model} nbits={WIDE_NBITS}: logits"
    torch.cuda.synchronize()
    launches = matmul_launches()
    log(f"[wide] cnn + mlp at nbits={WIDE_NBITS}, karatsuba_int16 == int8 oracle in "
        f"{time.perf_counter() - t0:.1f} s; launches {launches}")
    assert launches["karatsuba_matmul"] > 0, \
        f"the wide limb kernel never launched on the wide path: {launches}"
    return launches


def lns_ops_per_product(num_ecc: int, case_split: bool) -> int:
    """Integer operations of one Mitchell-family product as the kernel forms
    it (csrc/mitchell_matmul.cu): per stage the exponent add, three shifts
    and two adds; the case split's compare, select and shift; the sign and
    the accumulate."""
    return 6 * (num_ecc + 1) + (3 if case_split else 0) + 2


def mitchell_bound(shape: tuple[int, int, int], int32_ops_per_s: float,
                   num_ecc: int = 0, case_split: bool = True) -> tuple[float, str]:
    """(bound ms, what bounds it) of one `mitchell_matmul` call: its
    operations over the INT32 rate against its int32 bytes (A and B read
    once, the output written once) over the memory rate."""
    m, k, n = shape
    ops_ms = lns_ops_per_product(num_ecc, case_split) * m * k * n / int32_ops_per_s * 1e3
    bytes_ms = 4 * (m * k + k * n + m * n) / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def mitchell_lm_times(int32_ops_per_s: float, device: torch.device) -> dict[tuple, dict]:
    """`mitchell_matmul` (0, True) on 8-bit operands at the LM path's dense
    shapes, decode (M = 4) and prefill (M = 128): device ms of one call (10
    queued while the card is held) and ms of one call alone (CUDA events),
    beside its bound and its plan; the decode step's sum (device ms x
    launches a step). Then [route] lines: both routes, each with its own
    split rule (`route_plan`), at (M, 896, 4864) for M in ROUTE_CUT_M: the
    timings behind the plan's thin-route cut (`THIN_MAX_M`)."""
    from repro_torch.kernels import mitchell_matmul as mm

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rng = np.random.default_rng(90)

    def operands(m, k, n):
        return tuple(torch.from_numpy(rng.integers(-255, 256, s).astype(np.int32)).to(device)
                     for s in ((m, k), (k, n)))

    results = {}
    step_ms = step_bound = 0.0
    for m in (LM_DECODE_M, LM_PREFILL_M):
        for (k, n), per_step in LM_DENSE:
            a, b = operands(m, k, n)
            bound, by = mitchell_bound((m, k, n), int32_ops_per_s)
            row = {"kernel": "mitchell_matmul", "shape": [m, k, n], "num_ecc": 0,
                   "case_split": True, "plan": str(mm.launch_plan(m, k, n, sms)),
                   "device_ms": time_ms_batched(lambda: mm.mitchell_matmul_kernel(a, b)),
                   "call_ms": time_ms(lambda: mm.mitchell_matmul_kernel(a, b), 10),
                   "bound_ms": bound, "bound_by": by}
            if m == LM_DECODE_M:
                row["launches_a_decode_step"] = per_step
                step_ms += row["device_ms"] * per_step
                step_bound += bound * per_step
            results[("mitchell_lm", m, k, n)] = row
            log(json.dumps(row))
    results["mitchell_decode_step"] = {"ms": step_ms, "bound_ms": step_bound}
    log(f"[times] mitchell_matmul a Qwen2-0.5B decode step (batch 4, 168 calls): "
        f"{step_ms:.6f} ms summed (device ms a call x launches), bound {step_bound:.6f} ms")
    k, n = 896, 4864
    for m in ROUTE_CUT_M:
        a, b = operands(m, k, n)
        row = {"shape": [m, k, n], "chosen": mm.launch_plan(m, k, n, sms).route}
        outs = []
        for route in ("thin", "tiled"):
            plan = mm.route_plan(route, m, k, n, sms)
            run = lambda: mm.run_plan(a, b, plan, num_ecc=0, case_split=True)  # noqa: E731
            outs.append(run())
            row[route] = {"plan": str(plan), "device_ms": time_ms_batched(run)}
        assert torch.equal(*outs), f"the two routes differ at {(m, k, n)}"
        log("[route] " + json.dumps(row))
    return results


def phase_matmul_times(x: torch.Tensor, w: torch.Tensor,
                       int32_ops_per_s: float) -> dict[tuple, dict]:
    """Each matmul kernel at the full-width shape on the operands the main
    path quantized, beside its plain version, its bound and, for the limb
    kernels, torch._int_mm on the int8 limbs (B row-major as the limbs lie,
    and column-major, cuBLAS's faster layout). The int8 kernel is timed
    through the wrapper (pack, range-check sync, product) and its two steps
    apart; the wide kernel on the same limbs."""
    from repro_torch.core.quant import quantize_limbs, quantize_magnitude
    from repro_torch.kernels import karatsuba_matmul as km
    from repro_torch.kernels import karatsuba_matmul_i8 as km8
    from repro_torch.kernels import mitchell_matmul as mm

    m, k, n = MM_SHAPE
    results = {}
    qa, qb = quantize_magnitude(x, 8), quantize_magnitude(w, 8)
    a, b = qa.magnitude * qa.sign, qb.magnitude * qb.sign
    for num_ecc, split in LNS_VARIANTS:
        kw = dict(num_ecc=num_ecc, case_split=split)
        bound, by = mitchell_bound(MM_SHAPE, int32_ops_per_s, num_ecc, split)
        row = {"kernel": "mitchell_matmul", "shape": list(MM_SHAPE), **kw,
               "kernel_ms": time_ms(lambda: mm.mitchell_matmul_kernel(a, b, **kw), 10),
               "plain_ms": time_ms(lambda: mm.mitchell_matmul_plain(a, b, **kw), 1,
                                   warmup=0),
               "plain_runs": 1,
               "ops_per_product": lns_ops_per_product(num_ecc, split),
               "bound_ms": bound, "bound_by": by,
               "library_ms": None,
               "library": "none: no PyTorch call computes Mitchell products"}
        results[("mitchell_matmul", num_ecc, split)] = row
        log(json.dumps(row))
    results.update(mitchell_lm_times(int32_ops_per_s, x.device))
    for kar in (True, False):
        da, _ = quantize_limbs(x, karatsuba=kar)
        db, _ = quantize_limbs(w, karatsuba=kar)
        limbs = (da.hi, da.lo, db.hi, db.lo)
        int8 = [t.to(torch.int8) for t in limbs]
        assert all(torch.equal(t8.to(torch.int32), t) for t8, t in zip(int8, limbs))
        ah, al, bh, bl = int8
        bh_c, bl_c = (t.t().contiguous().t() for t in (bh, bl))   # column-major B
        if kar:
            asum = (ah.to(torch.int32) + al).to(torch.int8)
            bsum = (bh.to(torch.int32) + bl).to(torch.int8)
            bsum_c = bsum.t().contiguous().t()
            library = lambda: (torch._int_mm(ah, bh), torch._int_mm(al, bl),
                               torch._int_mm(asum, bsum))
            library_c = lambda: (torch._int_mm(ah, bh_c), torch._int_mm(al, bl_c),
                                 torch._int_mm(asum, bsum_c))
        else:
            library = lambda: (torch._int_mm(ah, bh), torch._int_mm(al, bl),
                               torch._int_mm(ah, bl), torch._int_mm(al, bh))
            library_c = lambda: (torch._int_mm(ah, bh_c), torch._int_mm(al, bl_c),
                                 torch._int_mm(ah, bl_c), torch._int_mm(al, bh_c))
        passes = 3 if kar else 4
        ops_ms = passes * 2 * m * k * n / INT8_OPS_PER_S * 1e3
        bytes_ms = 4 * (2 * m * k + 2 * k * n + 3 * m * n) / HBM_BYTES_PER_S * 1e3
        common = {"shape": list(MM_SHAPE), "karatsuba": kar,
                  "plain_ms": time_ms(lambda: km.karatsuba_matmul_plain(*limbs, karatsuba=kar),
                                      3, warmup=1),
                  "plain_runs": 3,
                  "bound_ms": max(ops_ms, bytes_ms),
                  "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                  "library_ms": time_ms(library, 10),
                  "library": f"{passes} torch._int_mm calls on the int8 limbs "
                             "(the same partial sums), B row-major as the limbs lie",
                  "library_colmajor_ms": time_ms(library_c, 10)}
        packed = km8.pack(*limbs, karatsuba=kar)
        assert packed is not None
        row = {"kernel_ms": time_ms(lambda: km.karatsuba_matmul_kernel(*limbs, karatsuba=kar), 10),
               "kernel": "karatsuba_matmul_i8 (pack + range-check sync + product)",
               "pack_ms": time_ms(lambda: km8.pack(*limbs, karatsuba=kar), 10),
               "pack_device_ms": time_ms_batched(
                   lambda: km8.pack_async(*limbs, karatsuba=kar)),
               "product_ms": time_ms(lambda: km8.product(packed), 10),
               "product_device_ms": time_ms_batched(lambda: km8.product(packed)),
               **common}
        results[("karatsuba_matmul_i8", kar)] = row
        log(json.dumps(row))
        row = {"kernel": "karatsuba_matmul (wide, on the same int8-valued limbs)",
               "kernel_ms": time_ms(lambda: km.karatsuba_matmul_wide(*limbs, karatsuba=kar), 10),
               **common}
        results[("karatsuba_matmul", kar)] = row
        log(json.dumps(row))
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401 -- fails here when run without the repository
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    kind, smi, int32_ops_per_s = phase_card()
    phase_build()
    from repro_torch.filters.conv import KERNELS
    max_err = dict.fromkeys(KERNELS + MATMUL_KERNELS, 0)
    phase_parity(max_err)
    phase_recurse_parity(max_err)
    phase_range_parity(max_err)
    phase_matmul_parity(max_err, device)
    launches, main_frames = phase_main(device)
    main_routes = route_launches()
    mm_launches, (x, w) = phase_matmul_main(device)
    infer_launches = phase_infer_main(device)
    for name in ("mitchell_matmul", "karatsuba_matmul_i8"):
        launches[name] = mm_launches[name] + infer_launches[name]
    launches["karatsuba_matmul"] = phase_wide_main(device)["karatsuba_matmul"]
    scale_frames = phase_scale(device)
    inputs = {MAIN_SHAPE: main_frames, SCALE_SHAPE: scale_frames}
    tile_times = phase_tiles(inputs, max_err)
    phase_tune(inputs)
    phase_sharded(inputs)
    phase_streamed()
    serve_launches = phase_serve(device)
    phase_pool(device)
    lm_launches, lm_mitchell_ms = phase_lm(device, max_err)
    times = phase_times({MAIN_SHAPE: main_frames, SCALE_SHAPE: scale_frames},
                        int32_ops_per_s)
    mm_times = phase_matmul_times(x, w, int32_ops_per_s)
    step = mm_times["mitchell_decode_step"]
    log(f"[times] mitchell_matmul a decode step: {step['ms']:.6f} ms summed at the LM "
        f"shapes, " + ("not measured" if lm_mitchell_ms is None else f"{lm_mitchell_ms:.6f} ms")
        + f" under the [lm] profiler; bound {step['bound_ms']:.6f} ms")
    kernels = []
    for name in KERNELS:
        t = times[(name, "refmlm", MAIN_SHAPE)]
        source = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": REPLACES[source.removesuffix(".cu")],
            "launches": launches[name], "max_abs_err": max_err[name],
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "serve_launches": serve_launches[name],
            "tile_launches": main_routes[name],
            "tile_device_ms": {row["tile"]: row["device_ms"] for (k, _, shape, _), row
                               in tile_times.items() if k == name and shape == SCALE_SHAPE
                               and row["filter"] in ("fig9", "gaussian5")},
        })
    for name, key in (("mitchell_matmul", ("mitchell_matmul", 0, True)),
                      ("karatsuba_matmul", ("karatsuba_matmul", True)),
                      ("karatsuba_matmul_i8", ("karatsuba_matmul_i8", True))):
        t = mm_times[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": max_err[name],
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "serve_launches": serve_launches[name],
            "lm_launches": lm_launches[name],
            **({"decode_step_ms": step["ms"], "decode_step_bound_ms": step["bound_ms"],
                "lm_decode_step_device_ms": lm_mitchell_ms}
               if name == "mitchell_matmul" else {}),
        })
    log(smi)                    # the card's name and power limit, again at the end
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
