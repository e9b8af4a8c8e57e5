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
               full-width shape below with M cut to 256 rows; the wide
               kernel's two routes (thin: a span of whole rows, 16- and
               4-byte row chunks, K splits; digits: forced at 2, 3 and 4
               int8 digits, beside `digit_product_plain` too) on ragged
               shapes, limbs needing 2, 3 and 4 digits with -2**31,
               2**31 - 1, +-128 and +-32768 placed in, against
               `karatsuba_matmul_plain` on CPU copies, each call launching
               the route `launch_plan` names; and at the
               hybrid and xLSTM families' edges (4 x 4096 x 8, 4 x 2048 x
               8384, 128 x 2048 x 8384) and the MoE and VLM families' (4 x
               28672 x 8192, 4 x 1536 x 24576, the tiled-route image
               projection 6400 x 8192 x 1024, 128 x 18432 x 7168; these four
               through `mitchell_matmul` once each, 8-bit operands, the
               route its plan names); each limb call must take the kernel
               the wrapper's rule names; `mitchell_matmul` again at the
               shapes of each route of its launch plan (the LM decode calls
               at M = 1 and 4, ragged thin calls, a prefill call, a tiled
               call, the same three edges: N = 8, a half-full last column
               block), 8-bit and full-range int32 operands, every variant:
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
  7. wide   -- `infer.forward` of both models calibrated at 14 and 16 bits
               with karatsuba_int16 and schoolbook_int16, whose limbs pass
               int8 (w = 7: |hi| up to 128 / 512; w = 8 at 16 bits: up to
               256): accumulators and logits equal to the int8 oracle; each
               limb call must launch the route the wrapper's rule and
               `launch_plan` name for its limbs (the wide kernel's thin
               route at all five calls, `ROUTE_LAUNCHES`), and the wide
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
 15. lm     -- six LMs at full published width, bf16 activations over
               float32 master weights, random weights from a seeded
               generator: at full depth Qwen2-0.5B (24 attn
               layers, d_model 896, 14 / 2 heads x 64, d_ff 4864, vocab
               151936, tied), zamba2-1.2b (38 mamba2 layers, d_model 2048,
               d_inner 4096, 64 heads x 64, state 64; its weight-shared
               attention block is built and never applied, R7) and
               xlstm-1.3b (42 mLSTM and 6 sLSTM layers, d_model 2048, 4
               heads, proj factor 2, vocab 50304); with the depth cut that
               one card holds (LM_CUTS) deepseek-v3-671b (one dense MLA
               layer and one MoE layer of all 256 experts, d_model 7168),
               kimi-k2-1t-a32b (one dense GQA layer and one MoE layer of
               all 384 experts, d_model 7168, 74.4 GiB of weights) and
               llama-3.2-vision-90b (four attn layers and one attn_cross
               layer, d_model 8192, 1600 image tokens: seeded (4, 1600,
               8192) embeddings through prefill, then decode_step, which
               `greedy_generate` cannot do, R8; every xgate set to 1.0).
               Each first cut to 2 layers (xLSTM: one mLSTM, one sLSTM; the
               VLM: attn and attn_cross; the MoE family: its dense layer and
               a moe layer, deepseek's run itself, kimi's with 32 of its 384
               experts, LM_PARITY_CUTS): karatsuba_int16's logits on the
               kernels byte-equal to the plain route (`impl='reference'`),
               every `mitchell_matmul` call's accumulators equal to
               `mitchell_matmul_plain`'s (2 calls a mamba2 layer, 3 an
               mLSTM, 2 an sLSTM, 7 an attn or moe layer, 9 an attn_cross
               layer, a step; 2 more an attn_cross layer at prefill), and,
               but for the MoE models and the VLM (LM_R5_SKIP), mitchell's logits
               against the float32-summing reference route (R5); then
               `greedy_generate` at the reference CLI's traffic (batch 4,
               prompt 32, 32 tokens) for exact, mitchell and karatsuba_int16;
               [lm] lines: prefill ms, decode ms a token, tokens/s, launches
               (asserted: one a quantized dense call) and host syncs a decode
               step (the CUDA sync debug mode), peak memory, the device busy
               share and `mitchell_matmul`'s device ms in one mitchell decode
               step beside its bound;
 16. train  -- LM training: Qwen2-0.5B at full width (bf16 over float32
               master weights, remat, AdamW). First a 2-layer parity step
               (batch 2 x seq 64): every `mitchell_matmul` call of the
               forward and the remat recompute (28) equal to its plain
               version, and karatsuba_int16's loss and grads on the kernels
               against the plain route (`impl='reference'`): byte-equal,
               or a leaf that differs also differs between two plain runs
               (a non-deterministic CUDA op, named on the line). Then 4
               steps at full depth, batch 8 x seq 128 (the reference
               training CLI's), through `run_training` under exact,
               mitchell and karatsuba_int16: [train] lines with the loss by
               step, step ms (median of steps 2-4), tokens/s, launches
               (asserted: 336 a quantized step, forward + recompute) and
               host syncs a step, the device busy share, peak memory and
               `mitchell_matmul`'s device ms a step beside its bound
               (481.9 ms at 11 INT32 operations a product); one batch
               overfitted at 2 layers (exact, lr 1e-3, 10 steps: the loss
               below 0.9x its first); a fault injected at step 3 and a
               restart from the step-2 checkpoint against a clean run, with
               one checkpoint's save and restore ms;
 17. mesh   -- the same training over an NCCL process group of one rank
               (in-process, a `file://` rendezvous) on a (1, 1)
               `make_host_mesh()`: first a 2-layer mesh step (batch 2 x
               seq 64) with every `mitchell_matmul` and every limb kernel
               call (forward and recompute, 28 each) equal to its plain
               version, and `shard_map_allreduce_i8` equal to its plain
               version; then per method at full width and depth 3 steps
               through the mesh `run_training` with a (blocking, timed)
               sharded checkpoint at step 2: the first step against the
               [train] phase's unmeshed first step (the loss and every
               param byte-equal: at world size 1 each collective is the
               identity), the launches
               (336 a quantized step), `remesh_restore` of the checkpoint
               onto a fresh (1, 1) mesh and its step 3 against the run's;
               [mesh] lines: step ms (median of steps 2-3), tokens/s, the
               collectives a step by kind with their bytes, host syncs,
               busy share, peak GiB, save / restore ms, beside the [train]
               phase's unmeshed numbers. With two cards or more, 4 (or 2)
               NCCL ranks of their own processes take one step on an
               (n, 1) mesh against the unmeshed step; on one card a line
               says it was not run. Two gloo ranks sharing the one card
               (where a probe says they can) run (1, 2) tensor-parallel
               prefill + 3 serve steps of Qwen2-0.5B and zamba2-1.2b (its
               Mamba2 heads split) at 2 layers, full width, mitchell:
               logits byte-equal to the unmeshed steps' and rank 0's
               mitchell_matmul calls (56 / 16) equal to plain, asserted;
 18. dryrun -- the port's dry-run and roofline on the card: `python -m
               repro_torch.launch.dryrun` for Qwen2-0.5B decode_32k on both
               production meshes and train_4k on (16, 16), fake CUDA
               tensors over a fake process group of 256 / 512 ranks, in
               processes started after the build that run beside the
               earlier phases (each must exit 0, every cell ok), each
               record's terms on a [dryrun] line; the [train] phase's exact step counted the
               same way (world 1) beside its measurements from this run:
               the predicted step bound over the measured step ms
               (roofline_fraction), model flops / (step s x 989e12) (MFU),
               the predicted peak beside `max_memory_allocated`, with the
               card's name and power limit; the meshed serve steps on a
               (1, 1) NCCL mesh (in-process): prefill of 4 x 32 and 3 decode
               steps of Qwen2-0.5B at 2 layers, full width, under exact and
               mitchell, logits and caches byte-equal to the unmeshed
               steps, every `mitchell_matmul` call equal to its plain
               version;
 19. times  -- each kernel with CUDA events (median after warm-up) beside
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
               `mitchell_matmul` at the six LMs' decode (M = 4) and
               prefill (M = 128) shapes beside their bounds (and, at M = 4,
               its plain version), summed to the ms of each LM's decode step; [route] lines: both routes at (M, 896, 4864)
               for M = 4 .. 2048, the timings behind the plan's route cut;
               both matmul kernels at the train step's shapes (M = 1024)
               beside their plain versions, the limb kernel beside 3
               `torch._int_mm` calls there; the wide limb kernel at the five
               [wide] calls on the limbs that path made and at 2048 x 896 x
               4864 on 16-bit quantized limbs (2 digits) and full-range ones
               (4 digits), beside its bound, its plain version and 3 / 4
               float64 `torch.matmul` calls where those are exact, with the
               other route, the pack step alone and, on int8 limbs at the
               five calls, the int8 route beside the thin one ([wide-time]
               lines); and
               `mitchell_matmul` at the VLM's tiled image projection
               (6400 x 8192 x 1024), [train] lines;
The line before the last is a JSON object naming the seven kernels with
their numbers (and `serve_launches`, their launches in phase 13;
`train_launches`, their launches in phase 16's twelve full-width steps,
`mesh_train_launches` their launches in phase 17's nine,
`serve_mesh_launches` their launches in phase 18's meshed serve runs,
with `train_step_ms`, `train_step_bound_ms` and `train_step_device_ms`
for `mitchell_matmul`, a step's calls summed at their shapes, the bound
and the profiler's reading; for the
matmul kernels `lm_launches`, their launches in phase 15's eighteen
greedy runs (six LMs x three methods); for `karatsuba_matmul` its
numbers summed over the five [wide] calls of a karatsuba_int16 forward at
14 bits, `route_launches` by route in phase 7 and `wide_calls`, the
per-call rows; and for
`mitchell_matmul` `decode_step_ms` and `decode_step_bound_ms`, phase 19's
sum over a Qwen2-0.5B decode step's shapes, `lm_decode_step_device_ms`,
phase 15's profiler reading, and `decode_step_by_arch`, the three for each
LM; for the
conv kernels `tile_launches`, the main path's launches by tile, and
`tile_device_ms`, phase 9's device ms at 16x2048x2048 by tile); the last
line is the run's result and device.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# one growing segment a stream, whose free pages go back to the card: the
# [lm] runs free and reload 25-75 GiB of weights, and kimi-k2's cut leaves
# ~4 GiB beside its 74.39 GiB, too little for the default allocator's
# cached fragments
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
import torch  # noqa: E402 -- after the allocator setting it reads

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
# The hybrid and xLSTM families' new edges on the matmul kernels: xLSTM's
# w_if (N = 8, one sixteenth of a thin column block, an eighth of the int8
# kernel's 64-column tile) and zamba2's in_proj (N = 8384 = 65.5 column
# blocks of 128) at decode (M = 4) and prefill (M = 128)
HYBRID_EDGE_SHAPES = ((4, 4096, 8), (4, 2048, 8384), (128, 2048, 8384))
# The MoE and VLM families' new edges: the largest K (the VLM's MLP down
# projection, 28672 -> 8192) and the widest N (MLA's wq_b, 1536 -> 24576)
# at decode, the first LM call on the tiled route (the VLM's image K / V
# projection: 4 x 1600 image tokens, 8192 -> 1024) and a prefill call
# (deepseek-v3's dense MLP down projection, 18432 -> 7168). Held against the
# plain versions once each (mitchell_matmul: the LM's variant on 8-bit
# operands): the plain LNS version forms every element product, 5.4e10 at
# the tiled-route call
MOE_VLM_EDGE_SHAPES = ((4, 28672, 8192), (4, 1536, 24576), (6400, 8192, 1024),
                       (128, 18432, 7168))
LM_EDGE_SHAPES = HYBRID_EDGE_SHAPES + MOE_VLM_EDGE_SHAPES
# shapes that take each route of `mitchell_matmul`'s launch plan with K splits:
# the LM path's decode calls (M = 1 and 4) and a prefill call (M = 128, 8
# row tiles), ragged thin ones (3 row tiles at M = 40), a tiled one whose
# last split ends in a part tile, and the hybrid and xLSTM edges
MM_ROUTE_SHAPES = ((1, 4864, 896), (4, 4864, 896), (4, 896, 4864), (4, 896, 128),
                   (7, 1000, 77), (40, 300, 129), (128, 896, 896),
                   (1100, 300, 70)) + HYBRID_EDGE_SHAPES
# Each LM's quantized dense calls (K, N) and their launches a decode step,
# at M = 4 (batch 4 decode) and M = 128 (batch 4 x prompt 32 prefill).
# Qwen2-0.5B (24 layers): wq and attention wo, wk and wv, wg and wi, the
# MLP's wo. zamba2-1.2b (38 mamba2 layers): in_proj, out_proj. xlstm-1.3b
# (42 mLSTM, 6 sLSTM layers): mLSTM up_proj and sLSTM w_in, w_if,
# down_proj, sLSTM w_out. deepseek-v3-671b at its [lm] cut (one MLA attn,
# one moe layer): MLA wq_a, wq_b, wkv_a, wo; the dense MLP's wi and wg, wo;
# the shared expert's wi and wg, wo. llama-3.2-vision-90b at its cut (four
# attn, one attn_cross layer): wq and wo of five self-attentions and of the
# cross-attention, wk and wv, the MLPs' wi and wg, wo (a decode step reads
# the image K / V from the cache). kimi-k2-1t-a32b at its cut (one GQA attn,
# one moe layer): wq and wo, wk and wv; the dense MLP's wi and wg, wo; the
# shared expert's wi and wg, wo.
LM_DENSE = {
    "qwen2-0.5b": (((896, 896), 48), ((896, 128), 48), ((896, 4864), 48), ((4864, 896), 24)),
    "zamba2-1.2b": (((2048, 8384), 38), ((4096, 2048), 38)),
    "xlstm-1.3b": (((2048, 8192), 48), ((4096, 8), 42), ((4096, 2048), 42), ((2048, 2048), 6)),
    "deepseek-v3-671b": (((7168, 1536), 2), ((1536, 24576), 2), ((7168, 576), 2),
                         ((16384, 7168), 2), ((7168, 18432), 2), ((18432, 7168), 1),
                         ((7168, 2048), 2), ((2048, 7168), 1)),
    "llama-3.2-vision-90b": (((8192, 8192), 12), ((8192, 1024), 10), ((8192, 28672), 10),
                             ((28672, 8192), 5)),
    "kimi-k2-1t-a32b": (((7168, 8192), 2), ((8192, 7168), 2), ((7168, 1024), 4),
                        ((7168, 18432), 2), ((18432, 7168), 1), ((7168, 2048), 2),
                        ((2048, 7168), 1)),
}
LM_DECODE_M, LM_PREFILL_M = 4, 128
ROUTE_CUT_M = (4, 16, 64, 128, 512, 1024, 2048)   # M at which both routes are timed
LNS_VARIANTS = ((0, True), (1, False), (2, False), (3, False))   # (num_ecc, case_split)
KERNEL_METHODS = ("mitchell", "mitchell_ecc1", "mitchell_ecc2", "mitchell_ecc3",
                  "schoolbook_int16", "karatsuba_int16")
INFER_HW = (64, 64)
INFER_BATCH = 256
INFER_CPU_BATCH = 4
WIDE_NBITS = (14, 16)          # the [wide] path's calibrations: limbs past int8
WIDE_METHODS = ("karatsuba_int16", "schoolbook_int16")
# the [wide] path's limb calls of one forward, in order, by model
WIDE_CALLS = {"cnn": ("cnn conv1", "cnn conv2", "cnn dense"),
              "mlp": ("mlp dense1", "mlp dense2")}
# the wide kernel's ragged parity shapes: the thin route (one span of whole
# rows; 16-byte and 4-byte row chunks; K splits at few row tiles) and the
# digit route
WIDE_THIN_SHAPES = ((5, 19, 11), (1000, 9, 4), (333, 36, 8), (513, 18, 3), (37, 1001, 5),
                    (256, 2048, 4), (300, 2100, 32))
WIDE_DIGIT_SHAPES = ((37, 300, 129), (5, 19, 40), (70, 130, 65))
# limb bounds that need 2, 3 and 4 balanced int8 digits in both modes, and
# the values placed in where they fit
WIDE_DIGIT_BOUNDS = ((2, 16000), (3, 4_000_000), (4, 1 << 31))
WIDE_EDGES = (-(1 << 31), (1 << 31) - 1, 128, -128, 32768, -32768)
WIDE_Q16 = (1 << 16) - 1        # MM_SHAPE's 2-digit limbs: q in +-WIDE_Q16


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


FOLD_TAPS = {"3x3": np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]])}      # gaussian3, shift 4
FOLD_SEPARABLE = np.array([1, 4, 6, 4, 1])                          # gaussian5's row = col


def phase_batch_fold(frames: torch.Tensor) -> None:
    """`batch_fold=True` on the card: the batch folded on the host into
    one tall image (each frame with its kh//2 zero rows), the same kernel
    pass, cropped; byte-equal to the unfolded pass at MAIN_SHAPE, kcm and
    recurse, a direct 3x3 pass and a fused 5x5 separable pass."""
    from repro_torch.filters import conv
    for impl in ("kcm", "recurse"):
        outs = {}
        for fold in (False, True):
            outs[fold] = (conv.conv2d_pass(frames, FOLD_TAPS["3x3"], method="refmlm", shift=4,
                                           mult_impl=impl, batch_fold=fold),
                          conv.fused_separable_pass(frames, FOLD_SEPARABLE, FOLD_SEPARABLE,
                                                    method="refmlm", nbits2=16, shift=8,
                                                    mult_impl=impl, batch_fold=fold))
        equal = all(torch.equal(a, b) for a, b in zip(outs[False], outs[True]))
        assert equal, f"batch_fold=True != unfolded ({impl})"
        log(f"[fold] {tuple(frames.shape)} {impl}: a 3x3 direct and a 5x5 fused pass with "
            f"batch_fold=True byte-equal to the unfolded passes")


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


# the LMs at full published width: Qwen2-0.5B (dense), zamba2-1.2b (hybrid
# Mamba2), xlstm-1.3b (mLSTM / sLSTM) at full depth; deepseek-v3-671b (MoE
# with MLA), llama-3.2-vision-90b (VLM) and kimi-k2-1t-a32b (MoE with GQA)
# with their depth cut (LM_CUTS)
LM_ARCHS = ("qwen2-0.5b", "zamba2-1.2b", "xlstm-1.3b", "deepseek-v3-671b",
            "llama-3.2-vision-90b", "kimi-k2-1t-a32b")
#: arch -> (the [lm] run's config changes, and why); float32 master
#: weights, as the reference keeps them
LM_CUTS = {
    "deepseek-v3-671b": (
        dict(num_layers=2, first_dense_layers=1),
        "61 layers do not fit one 80 GB card: 2 layers, one dense MLA layer and one MoE layer "
        "with all 256 experts (13,944,134,656 parameters, 51.95 GiB)"),
    "llama-3.2-vision-90b": (
        dict(num_layers=5),
        "100 layers do not fit one card: 5 layers, one period of four attn layers and one "
        "attn_cross layer, 1600 image tokens (6,597,738,497 parameters, 24.6 GiB)"),
    "kimi-k2-1t-a32b": (
        dict(num_layers=2, first_dense_layers=1),
        "61 layers do not fit one 80 GB card: 2 layers, one dense GQA layer and one MoE layer "
        "with all 384 experts (19,967,675,392 parameters, 74.39 GiB: 63 GiB of routed experts, "
        "8.75 GiB of untied embedding and head)"),
}
#: arch -> (its parity cut's further config changes, and why)
LM_PARITY_CUTS = {
    "kimi-k2-1t-a32b": (
        dict(num_experts=32),
        "32 of 384 experts: the plain routes' transients (~10 GB at K x N = 7168 x 18432) do "
        "not fit beside the run's 74.39 GiB; the routed experts are float einsums, so every "
        "kernel shape is the run's"),
}
#: archs whose parity does not read R5: the float32-summing LNS route forms
#: every element product, ~1e11 at deepseek-v3's and kimi-k2's cuts and
#: ~3.4e11 at the VLM's (the image K / V at M = 6400 included), minutes on
#: the card
LM_R5_SKIP = ("deepseek-v3-671b", "llama-3.2-vision-90b", "kimi-k2-1t-a32b")
LM_XGATE = 1.0                      # every cross-attention gate on the card (tanh 0.76)
LM_TRAFFIC = (4, 32, 32)            # batch, prompt, generated tokens: the reference CLI's
LM_METHODS = ("exact", "mitchell", "karatsuba_int16")
LM_PARITY_LAYERS = 2
LM_DECODE_RUNS = 5
# quantized dense calls a layer makes in a decode step, by block kind: q, k,
# v, o (MLA: wq_a, wq_b, wkv_a, wo) and the SwiGLU MLP's wi, wg, wo (a moe
# layer: the shared experts'; the router and the routed experts are float
# einsums); attn_cross adds the cross-attention's q and o; in_proj,
# out_proj; up_proj, w_if, down_proj; w_in, w_out
DENSE_CALLS = {"attn": 7, "moe": 7, "attn_cross": 9, "mamba2": 2, "mlstm": 3, "slstm": 2}


def dense_calls(cfg) -> int:
    """Quantized `dense` calls of one decode step."""
    return sum(DENSE_CALLS[kind] for kind in cfg.block_kinds())


def prefill_calls(cfg) -> int:
    """Quantized `dense` calls of one forward or prefill: a decode step's,
    and the image K / V projections (xattn wk, wv) of each attn_cross layer."""
    return dense_calls(cfg) + 2 * cfg.block_kinds().count("attn_cross")


def lm_config(arch: str):
    """The config of an [lm] run: the published one, bf16, or its LM_CUTS
    cut."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), **LM_CUTS.get(arch, ({}, ""))[0])


def open_gates(params: dict) -> int:
    """Set every cross-attention gate (`xgate`, zero at init: tanh(0) would
    erase the cross path) to LM_XGATE; -> how many."""
    gates = [layer["xgate"] for layer in params["backbone"]["layers"] if "xgate" in layer]
    for gate in gates:
        gate.fill_(LM_XGATE)
    return len(gates)


def lm_image(cfg, batch: int, device: torch.device) -> torch.Tensor | None:
    """Seeded (batch, image_tokens, d_model) float32 image embeddings for a
    VLM, None for the other configs."""
    if cfg.input_kind != "tokens+image":
        return None
    rng = np.random.default_rng(3)
    return torch.from_numpy(rng.standard_normal(
        (batch, cfg.image_tokens, cfg.d_model), dtype=np.float32)).to(device)


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


def lm_steps(model, params, prompt, steps: int,
             image=None) -> tuple[list[torch.Tensor], torch.Tensor]:
    """The path `greedy_generate` takes, with `image` in the prefill batch
    (which `greedy_generate` cannot serve, R8): prefill `prompt`, then
    greedy decode steps until `steps` tokens are chosen; -> (the logits of
    the prefill and of each decode step, the (B, steps) int32 tokens)."""
    caches = model.init_cache(prompt.shape[0], prompt.shape[1] + steps)
    batch = {"tokens": prompt} if image is None else {"tokens": prompt, "image_embeds": image}
    logits, caches, clen = model.prefill(params, batch, caches)
    outs, toks = [logits], []
    for _ in range(steps):
        toks.append(torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32))
        if len(toks) < steps:
            logits, caches, clen = model.decode_step(params, toks[-1], caches, clen,
                                                     image_embeds=image)
            outs.append(logits)
    return outs, torch.cat(toks, dim=1)


def parity_config(cfg):
    """An [lm] run's parity cut: LM_PARITY_LAYERS layers at full width, one
    of each kind the model mixes (xLSTM: an mLSTM and an sLSTM layer; the
    VLM: an attn and an attn_cross layer; the MoE family: its first, dense
    layer and a moe layer), with the arch's LM_PARITY_CUTS."""
    import dataclasses
    return dataclasses.replace(
        cfg, num_layers=LM_PARITY_LAYERS,
        slstm_period=2 if cfg.slstm_period else 0,
        cross_attn_period=2 if cfg.cross_attn_period else 0,
        first_dense_layers=min(1, cfg.first_dense_layers),
        **LM_PARITY_CUTS.get(cfg.name, ({}, ""))[0])


def phase_lm_parity(cut, params, prompt: torch.Tensor, image, max_err: dict) -> None:
    """An LM's parity cut (`parity_config`) on `params`, prefill and 2
    decode steps: karatsuba_int16's logits on the kernels byte-equal to the
    plain route's (`impl='reference'`: the plain limb products); every
    mitchell_matmul call's accumulators equal to mitchell_matmul_plain's;
    unless the arch is in LM_R5_SKIP, the mitchell logits' max |diff|
    against the reference's float32-summing route (R5)."""
    import dataclasses

    from repro_torch.models import build_model

    t0 = time.perf_counter()
    lim = dataclasses.replace(cut, matmul_method="karatsuba_int16")
    got, _ = lm_steps(build_model(lim), params, prompt, 3, image)
    plain, _ = lm_steps(build_model(lim, impl="reference"), params, prompt, 3, image)
    for i, (g, p) in enumerate(zip(got, plain)):
        assert torch.equal(g, p), f"{cut.name}: karatsuba_int16 logits differ from the " \
                                  f"plain route, step {i}"
    note = LM_PARITY_CUTS.get(cut.name, (None, ""))[1]
    log(f"[lm] {cut.name} parity, {LM_PARITY_LAYERS} layers {cut.block_kinds()}, full width"
        + (f" ({note})" if note else "") + ": karatsuba_int16 logits of prefill + 2 decode steps byte-equal to the plain route "
        f"(impl='reference')")
    lns = dataclasses.replace(cut, matmul_method="mitchell")
    stats = {"calls": 0, "max_err": 0}
    with checked_mitchell(stats):
        got, _ = lm_steps(build_model(lns), params, prompt, 3, image)
    max_err["mitchell_matmul"] = max(max_err["mitchell_matmul"], stats["max_err"])
    want_calls = prefill_calls(cut) + 2 * dense_calls(cut)
    assert stats["calls"] == want_calls and stats["max_err"] == 0, (cut.name, stats)
    ks = sorted({k for (k, _), _ in LM_DENSE[cut.name]})
    if cut.name in LM_R5_SKIP:
        r5 = "R5 not measured at this width (LM_R5_SKIP)"
    else:
        ref, _ = lm_steps(build_model(lns, impl="reference"), params, prompt, 3, image)
        diff = max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref))
        scale = max(float(r.float().abs().max()) for r in ref)
        r5 = (f"mitchell logits against the float32-summing reference route (R5, K = {ks}): "
              f"max |diff| {diff:.6g} of max |logit| {scale:.6g}")
    log(f"[lm] {cut.name} parity: mitchell_matmul accumulators == mitchell_matmul_plain on "
        f"all {stats['calls']} calls (max |err| {stats['max_err']}); {r5}; "
        f"{time.perf_counter() - t0:.1f} s")


def lm_step_bound(arch: str, int32_ops_per_s: float) -> float:
    """Least ms of `mitchell_matmul`'s calls in one decode step of `arch`
    (M = LM_DECODE_M): each call's bound x its launches a step."""
    return sum(mitchell_bound((LM_DECODE_M, k, n), int32_ops_per_s)[0] * per_step
               for (k, n), per_step in LM_DENSE[arch])


def phase_lm_arch(arch: str, device: torch.device, max_err: dict,
                  int32_ops_per_s: float) -> tuple[dict[str, int], float | None]:
    """One LM at full published width (bf16, random weights from a seeded
    generator; the depth of `lm_config`, the VLM's gates open): its 2-layer
    parity, then `greedy_generate` at the reference CLI's traffic (batch 4,
    prompt 32, 32 tokens; the VLM with a seeded image through prefill and
    decode_step, `lm_steps`) for exact, mitchell and karatsuba_int16
    on the kernels; [lm] lines with prefill ms, decode ms a token,
    tokens/s, launches and host syncs a decode step, the device busy share,
    peak memory. -> (the matmul kernels' launches over the three main-path
    runs, mitchell_matmul's device ms in one mitchell decode step under
    torch.profiler, None if it saw no device time)."""
    import dataclasses

    from repro_torch.models import build_model
    from repro_torch.runtime.serve_lib import greedy_generate

    t_phase = time.perf_counter()
    cfg = lm_config(arch)
    batch, plen, gen = LM_TRAFFIC
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, plen))).to(device)
    image = lm_image(cfg, batch, device)
    cut = parity_config(cfg)
    params = build_model(cut).init(torch.Generator(device).manual_seed(1))
    open_gates(params)
    phase_lm_parity(cut, params, prompt, image, max_err)
    if cut != cfg:                   # else the run reuses the parity's params
        del params
        torch.cuda.empty_cache()
        params = build_model(cfg).init(torch.Generator(device).manual_seed(0))
        torch.cuda.empty_cache()
    gates = open_gates(params)
    n_params = build_model(cfg).count_params(params)
    free, total = torch.cuda.mem_get_info()
    kinds = cfg.block_kinds()
    cut_note = LM_CUTS.get(arch, (None, "full published depth"))[1]
    log(f"[lm] {arch}: {cfg.num_layers} layers "
        f"({', '.join(f'{kinds.count(k)} {k}' for k in dict.fromkeys(kinds))}), d_model "
        f"{cfg.d_model}, {cfg.num_heads} / {cfg.num_kv_heads} heads x "
        f"{cfg.resolved_head_dim}, attention {cfg.attention}, d_ff {cfg.d_ff}"
        + (f", {cfg.num_experts} experts top {cfg.top_k} (+{cfg.num_shared_experts} shared) x "
           f"{cfg.moe_d_ff}" if cfg.moe else "")
        + (f", {cfg.image_tokens} image tokens" if image is not None else "")
        + f", vocab {cfg.vocab_size}, {cfg.dtype}; {n_params} parameters (float32 master "
        f"weights, {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated, "
        f"{free / 2**30:.3f} GiB of {total / 2**30:.3f} GiB free); depth: {cut_note}"
        + (f"; {gates} xgate set to {LM_XGATE} (zero init would erase the cross path)"
           if gates else ""))
    step_calls = sum(per_step for _, per_step in LM_DENSE[arch])
    assert step_calls == dense_calls(cfg), (arch, step_calls, dense_calls(cfg))
    bound = lm_step_bound(arch, int32_ops_per_s)
    launches_sum = dict.fromkeys(MATMUL_KERNELS, 0)
    mitchell_step_ms = None          # mitchell_matmul's device ms in one decode step
    for method in LM_METHODS:
        model = build_model(dataclasses.replace(cfg, matmul_method=method))

        def generate(steps: int) -> torch.Tensor:
            if image is None:
                return greedy_generate(model, params, prompt, steps=steps, s_max=plen + gen)
            return lm_steps(model, params, prompt, steps, image)[1]

        generate(2)                                                          # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_matmul_launches()
        t0 = time.perf_counter()
        tokens = generate(gen)
        tokens = tokens.cpu()
        wall = time.perf_counter() - t0
        launches = matmul_launches()
        peak = torch.cuda.max_memory_allocated()
        assert tokens.shape == (batch, gen) and tokens.dtype == torch.int32, tokens.shape
        assert 0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab_size
        for name in MATMUL_KERNELS:
            launches_sum[name] += launches[name]
        if method == "exact":
            assert not any(launches.values()), f"exact launched a matmul kernel: {launches}"
        else:
            kernel = "mitchell_matmul" if method == "mitchell" else "karatsuba_matmul_i8"
            assert launches[kernel] > 0, f"{arch} {method}: {kernel} never launched"
            assert launches["karatsuba_matmul"] == 0, "the wide limb kernel ran on the LM path"

        # the split: prefill, then decode steps, each ended by a sync
        caches = model.init_cache(batch, plen + gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches, clen = model.prefill(
            params, {"tokens": prompt} if image is None
            else {"tokens": prompt, "image_embeds": image}, caches)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        assert bool(torch.isfinite(logits).all()), f"{arch} {method}: non-finite prefill logits"
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
        if method != "exact":
            assert step_launches == {kernel: step_calls}, (arch, method, step_launches)
        assert bool(torch.isfinite(logits).all()), f"{arch} {method}: non-finite decode logits"
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        try:
            busy = device_busy_ms(lambda: model.decode_step(params, tok, caches, clen))
        except Exception as err:                         # noqa: BLE001
            busy = None
            log(f"[lm] {arch} {method}: torch.profiler failed ({err!r})")
        how = "greedy_generate" if image is None else "prefill (image) + decode_step"
        log(f"[lm] {arch} {method}: {how} {batch}x{plen} + {gen} tokens in "
            f"{wall:.4f} s (host clock), {batch * gen / wall:.2f} tokens/s; prefill "
            f"{prefill_ms:.4f} ms; decode {statistics.median(step_ms):.4f} ms a token (median "
            f"of {LM_DECODE_RUNS}); a decode step launches "
            f"{step_launches or 'no matmul kernel'} and makes {syncs} host syncs; peak "
            f"{peak / 2**30:.3f} GiB; main-path launches "
            f"{{{', '.join(f'{k}: {v}' for k, v in launches.items())}}}; "
            f"tokens[0][:8] {tokens[0, :8].tolist()}")
        if busy is not None and method == "mitchell":
            mitchell_step_ms = sum(v for name, v in busy[2].items() if "mitchell_matmul" in name)
        log(f"[lm] {arch} {method}: host syncs of a decode step by site {sync_sites}; one "
            + ("decode step under torch.profiler: not measured (no device time seen)"
               if busy is None
               else f"decode step under torch.profiler: wall {busy[0]:.4f} ms, CUDA kernels "
                    f"{busy[1]:.4f} ms, device busy {busy[1] / busy[0]:.4f}"
                    + (f", mitchell_matmul {mitchell_step_ms:.4f} ms (bound {bound:.6f} ms)"
                       if method == "mitchell" else "") + "; most device ms "
                    + ", ".join(f"{k} {v:.4f}" for k, v in list(busy[2].items())[:3])))
        del model, caches, logits
    del params
    torch.cuda.empty_cache()
    log(f"[lm] {arch} phase {time.perf_counter() - t_phase:.1f} s (host clock)")
    return launches_sum, mitchell_step_ms


def phase_lm(device: torch.device, max_err: dict,
             int32_ops_per_s: float) -> tuple[dict[str, int], dict[str, float | None]]:
    """`phase_lm_arch` for each of LM_ARCHS. -> (the matmul kernels'
    launches over every main-path run, mitchell_matmul's device ms in one
    mitchell decode step by arch)."""
    t_phase = time.perf_counter()
    lm_launches = dict.fromkeys(MATMUL_KERNELS, 0)
    step_ms = {}
    for arch in LM_ARCHS:
        launches, step_ms[arch] = phase_lm_arch(arch, device, max_err, int32_ops_per_s)
        for name in MATMUL_KERNELS:
            lm_launches[name] += launches[name]
    log(f"[lm] phase {time.perf_counter() - t_phase:.1f} s (host clock); main-path launches "
        f"of the {len(LM_ARCHS)} LMs {lm_launches}")
    return lm_launches, step_ms


# ----------------------------------------------------------------- [train] --
# LM training on one card: Qwen2-0.5B at full width (24 attn layers, d_model
# 896, vocab 151936, bf16 over float32 master weights, remat on, AdamW) at the
# reference training CLI's defaults (src/repro/launch/train.py: batch 8, seq
# 128), a few steps a method through `run_training`.
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_SHAPE = (8, 128)              # batch, seq
TRAIN_STEPS = 4
TRAIN_TIMED = slice(1, TRAIN_STEPS)  # steps 2-4: the first builds and warms
TRAIN_PARITY_SHAPE = (2, 64)
TRAIN_CUT_LAYERS = 2                # the parity, overfit and fault runs' depth
TRAIN_OVERFIT = dict(steps=10, peak_lr=1e-3, warmup=2, total_steps=30)
# lr at its peak from step 2 on, so a restart that restored the optimizer
# state wrongly moves the steps after it well past rounding
TRAIN_FAULT = dict(steps=4, ckpt_every=2, fail_at=3,
                   lr=dict(peak_lr=1e-3, warmup=2, total_steps=30))


def train_dense_calls(cfg) -> int:
    """Quantized `dense` calls of one train step: the forward's, and as many
    again in the remat recompute (the integer products carry no gradient,
    so the backward launches none)."""
    return prefill_calls(cfg) * (2 if cfg.remat else 1)


def train_step_bound(int32_ops_per_s: float) -> float:
    """Least ms of `mitchell_matmul`'s calls in one Qwen2-0.5B train step:
    M = batch x seq rows against each (K, N), forward and recompute."""
    m = TRAIN_SHAPE[0] * TRAIN_SHAPE[1]
    return 2 * sum(mitchell_bound((m, k, n), int32_ops_per_s)[0] * per_step
                   for (k, n), per_step in LM_DENSE[TRAIN_ARCH])


def train_cut(method: str = "exact"):
    """TRAIN_ARCH at TRAIN_CUT_LAYERS layers, full width, `method`."""
    import dataclasses
    return dataclasses.replace(lm_config(TRAIN_ARCH), num_layers=TRAIN_CUT_LAYERS,
                               matmul_method=method)


def leaf_grads(model, params, batch) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(loss, {path: grad}) of `model.loss_fn`, a None grad as zeros."""
    from repro_torch.optim import param_groups
    from repro_torch.runtime.train_lib import grads_of
    pairs = [(f"{g.key}/{i}", t) for g in param_groups(params, model.cfg)
             for i, t in enumerate(g.params)]
    loss, _, grads = grads_of(model, params, batch, [t for _, t in pairs])
    return loss, {k: g for (k, _), g in zip(pairs, grads)}


def phase_train_parity(device: torch.device, max_err: dict) -> None:
    """At TRAIN_CUT_LAYERS layers, full width, batch 2 x seq 64: one mitchell
    train step with every `mitchell_matmul` call (forward and remat
    recompute) held against `mitchell_matmul_plain`; karatsuba_int16's loss
    and grads on the kernels against the plain route (`impl='reference'`):
    byte-equal, or, for a leaf that differs, two plain runs differ there too
    (a non-deterministic CUDA op in the backward, named on the line)."""
    from repro_torch.data.tokens import lm_batch
    from repro_torch.models import build_model
    from repro_torch.runtime.train_lib import make_train_state, make_train_step

    t0 = time.perf_counter()
    batch = lm_batch(train_cut(), batch=TRAIN_PARITY_SHAPE[0], seq=TRAIN_PARITY_SHAPE[1])
    lns = train_cut("mitchell")
    model = build_model(lns)
    state = make_train_state(model, torch.Generator(device).manual_seed(1))
    stats = {"calls": 0, "max_err": 0}
    with checked_mitchell(stats):
        state, metrics = make_train_step(model)(state, batch)
    max_err["mitchell_matmul"] = max(max_err["mitchell_matmul"], stats["max_err"])
    assert stats["calls"] == train_dense_calls(lns) and stats["max_err"] == 0, stats
    assert bool(torch.isfinite(metrics["loss"])), metrics
    log(f"[train] parity, {TRAIN_ARCH} {TRAIN_CUT_LAYERS} layers full width, batch "
        f"{TRAIN_PARITY_SHAPE[0]} x seq {TRAIN_PARITY_SHAPE[1]}, remat: mitchell_matmul == "
        f"mitchell_matmul_plain on all {stats['calls']} calls of a train step (forward + "
        f"recompute; max |err| {stats['max_err']}); loss {float(metrics['loss']):.6f}")
    del model, state
    lim = train_cut("karatsuba_int16")
    params = make_train_state(build_model(lim), torch.Generator(device).manual_seed(1)).params
    got = leaf_grads(build_model(lim), params, batch)
    plain = leaf_grads(build_model(lim, impl="reference"), params, batch)
    assert torch.equal(got[0], plain[0]), (float(got[0]), float(plain[0]))
    differ = [k for k in plain[1] if not torch.equal(got[1][k], plain[1][k])]
    unstable = []
    if differ:                       # does the plain route itself vary there?
        plain2 = leaf_grads(build_model(lim, impl="reference"), params, batch)
        unstable = [k for k in plain[1] if not torch.equal(plain[1][k], plain2[1][k])]
    assert set(differ) <= set(unstable), f"kernel grads differ where the plain route is stable: " \
                                         f"{sorted(set(differ) - set(unstable))[:6]}"
    gap = max((float((got[1][k] - plain[1][k]).abs().max()) for k in differ), default=0.0)
    log(f"[train] parity: karatsuba_int16 loss on the kernels byte-equal to the plain route "
        f"(impl='reference', {float(got[0]):.6f}); grads of {len(plain[1]) - len(differ)} of "
        f"{len(plain[1])} leaves byte-equal"
        + (f"; {differ} differ by at most {gap:.6g}, and two plain runs differ there too "
           f"({unstable}: an op of their backward sums in a run-dependent order)"
           if differ else "")
        + f"; {time.perf_counter() - t0:.1f} s")


def phase_train_method(method: str, device: torch.device,
                       int32_ops_per_s: float) -> tuple[dict[str, int], float | None, dict]:
    """TRAIN_ARCH at full width and depth, `method`: TRAIN_STEPS steps of
    batch 8 x seq 128 through `run_training` (no checkpoint falls in them),
    then one step under the CUDA sync debug mode and one under
    torch.profiler. -> (the matmul kernels' launches in the run_training
    steps, mitchell_matmul's device ms in the profiled step or None, the
    step's numbers for the [mesh] phase's comparison)."""
    import dataclasses
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.tokens import lm_batch
    from repro_torch.models import build_model
    from repro_torch.runtime.fault import StragglerMonitor, run_training
    from repro_torch.runtime.train_lib import make_train_state, make_train_step

    cfg = dataclasses.replace(lm_config(TRAIN_ARCH), matmul_method=method)
    model = build_model(cfg)
    step = make_train_step(model)
    batch_of = lambda s: lm_batch(cfg, batch=TRAIN_SHAPE[0], seq=TRAIN_SHAPE[1], step=s)  # noqa: E731
    monitor, losses, first = StragglerMonitor(), [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        reset_matmul_launches()
        state = run_training(
            train_step=first_step_kept(step, cfg, first), init_state=lambda: make_train_state(
                model, torch.Generator(device).manual_seed(0)),
            batch_fn=batch_of, num_steps=TRAIN_STEPS,
            ckpt=CheckpointManager(ckpt_dir, interval=10 * TRAIN_STEPS),
            straggler=monitor, on_metrics=lambda s, m: losses.append(m["loss"]))
        launches = matmul_launches()
    losses = [float(x) for x in losses]
    assert len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), losses
    per_step = train_dense_calls(cfg)
    kernel = {"mitchell": "mitchell_matmul", "karatsuba_int16": "karatsuba_matmul_i8"}.get(method)
    want = {kernel: TRAIN_STEPS * per_step} if kernel else {}
    assert {k: v for k, v in launches.items() if v} == want, (method, launches)
    times = list(monitor.times)[TRAIN_TIMED]
    step_s = statistics.median(times)
    batch = batch_of(TRAIN_STEPS)
    reset_matmul_launches()
    (state, metrics), sync_sites = count_syncs(lambda: step(state, batch))
    syncs = sum(sync_sites.values())
    step_launches = {k: v for k, v in matmul_launches().items() if v}
    assert step_launches == ({kernel: per_step} if kernel else {}), (method, step_launches)
    assert bool(torch.isfinite(metrics["loss"])), metrics
    try:
        busy = device_busy_ms(lambda: step(state, batch_of(TRAIN_STEPS + 1)))
    except Exception as err:                             # noqa: BLE001
        busy = None
        log(f"[train] {method}: torch.profiler failed ({err!r})")
    peak = torch.cuda.max_memory_allocated()
    mitchell_ms = None
    if busy is not None and method == "mitchell":
        mitchell_ms = sum(v for name, v in busy[2].items() if "mitchell_matmul" in name)
    n_params = model.count_params(state.params)
    tokens = TRAIN_SHAPE[0] * TRAIN_SHAPE[1]
    log(f"[train] {TRAIN_ARCH} {method}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{n_params} parameters, {cfg.dtype} over float32, remat {cfg.remat}, "
        f"{cfg.optimizer}; batch {TRAIN_SHAPE[0]} x seq {TRAIN_SHAPE[1]}; loss by step "
        f"{[round(x, 6) for x in losses]}; step {step_s * 1e3:.4f} ms (median of steps 2-"
        f"{TRAIN_STEPS}: {[round(t * 1e3, 4) for t in times]}), {tokens / step_s:.2f} tokens/s; "
        f"a step launches {step_launches or 'no matmul kernel'} and makes {syncs} host "
        f"syncs; peak {peak / 2**30:.3f} GiB")
    log(f"[train] {method}: host syncs of a step by site {sync_sites}; one step under "
        f"torch.profiler: " + (
            "not measured (no device time seen)" if busy is None else
            f"wall {busy[0]:.4f} ms, CUDA kernels {busy[1]:.4f} ms, device busy "
            f"{busy[1] / busy[0]:.4f}"
            + (f", mitchell_matmul {mitchell_ms:.4f} ms (bound "
               f"{train_step_bound(int32_ops_per_s):.4f} ms)" if method == "mitchell" else "")
            + "; most device ms " + ", ".join(f"{k} {v:.4f}" for k, v in list(busy[2].items())[:4])))
    del state, model, metrics
    torch.cuda.empty_cache()
    numbers = {"step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s, "syncs": syncs,
               "busy": None if busy is None else busy[1] / busy[0],
               "peak_gib": peak / 2**30, "first": first}
    return launches, mitchell_ms, numbers


def phase_train_overfit(device: torch.device) -> None:
    """TRAIN_CUT_LAYERS layers, exact, one batch for TRAIN_OVERFIT['steps']
    steps at peak lr 1e-3: the loss must fall below 0.9x its first value
    (the reference's tests/test_models_smoke.py::test_loss_decreases_over_steps)."""
    from repro_torch.data.tokens import lm_batch
    from repro_torch.models import build_model
    from repro_torch.runtime.train_lib import make_train_state, make_train_step

    cfg = train_cut()
    model = build_model(cfg)
    state = make_train_state(model, torch.Generator(device).manual_seed(0))
    kw = {k: v for k, v in TRAIN_OVERFIT.items() if k != "steps"}
    step = make_train_step(model, **kw)
    batch = lm_batch(cfg, batch=TRAIN_SHAPE[0], seq=TRAIN_SHAPE[1])
    losses = []
    for _ in range(TRAIN_OVERFIT["steps"]):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
    losses = [float(x) for x in losses]
    assert losses[-1] < 0.9 * losses[0], losses
    log(f"[train] overfit one batch, {TRAIN_CUT_LAYERS} layers, exact, {kw}: loss "
        f"{[round(x, 4) for x in losses]} ({losses[-1] / losses[0]:.4f} of the first)")


def phase_train_fault(device: torch.device) -> None:
    """TRAIN_CUT_LAYERS layers, exact: `run_training` with a checkpoint every
    2 steps and a fault injected at step 3 (restored from step 2) against a
    clean run: the losses and the final params must be bit-identical; the
    save and restore ms of one checkpoint of the state."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager, restore, save
    from repro_torch.data.tokens import lm_batch
    from repro_torch.models import build_model
    from repro_torch.optim import param_groups
    from repro_torch.runtime.fault import FaultInjector, run_training
    from repro_torch.runtime.train_lib import make_train_state, make_train_step

    cfg = train_cut()
    model = build_model(cfg)
    step = make_train_step(model, **TRAIN_FAULT["lr"])

    def run(ckpt_dir: str, fail_at: tuple) -> tuple[object, list[float]]:
        losses = {}
        inj = FaultInjector(fail_at)
        state = run_training(
            train_step=step, init_state=lambda: make_train_state(
                model, torch.Generator(device).manual_seed(0)),
            batch_fn=lambda s: lm_batch(cfg, batch=TRAIN_SHAPE[0], seq=TRAIN_SHAPE[1], step=s),
            num_steps=TRAIN_FAULT["steps"],
            ckpt=CheckpointManager(ckpt_dir, interval=TRAIN_FAULT["ckpt_every"]),
            mesh_shape=(1, 1), injector=inj,
            on_metrics=lambda s, m: losses.__setitem__(s, float(m["loss"])))
        assert inj.fired == set(fail_at), inj.fired
        return state, [losses[s] for s in sorted(losses)]

    with tempfile.TemporaryDirectory() as d:
        clean, l_clean = run(os.path.join(d, "clean"), ())
        fault, l_fault = run(os.path.join(d, "fault"), (TRAIN_FAULT["fail_at"],))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(os.path.join(d, "timed"), 1, fault)
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        back = restore(os.path.join(d, "timed"), 1, fault)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        size = sum(os.path.getsize(os.path.join(d, "timed", "step_00000001", f))
                   for f in os.listdir(os.path.join(d, "timed", "step_00000001")))
    def leaves(state) -> list[torch.Tensor]:
        return [t.detach() for g in param_groups(state.params, cfg) for t in g.params]

    pairs = list(zip(leaves(clean), leaves(fault)))
    gap = max(float((a - b).abs().max()) for a, b in pairs)
    assert all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(fault)))
    assert all(torch.equal(a, b) for a, b in pairs), f"restart not bit-identical: {gap}"
    assert l_fault == l_clean, (l_fault, l_clean)
    log(f"[train] fault at step {TRAIN_FAULT['fail_at']}, restart from the step-"
        f"{TRAIN_FAULT['ckpt_every']} checkpoint ({TRAIN_CUT_LAYERS} layers, exact, "
        f"{TRAIN_FAULT['lr']}): losses {[round(x, 6) for x in l_fault]}, equal to a clean "
        f"run's; final params bit-identical; one checkpoint ({size / 2**20:.1f} MiB) save "
        f"{save_ms:.1f} ms, restore {restore_ms:.1f} ms (host clock)")


def adafactor_groups() -> list[tuple[str, str, int, int]]:
    """(arch, largest stacked group's path, its layers, its float32 bytes)
    for each Adafactor config at full width (shapes only, FakeTensorMode):
    Adafactor updates a stacked group on `torch.stack` of its grads and
    params, so it copies that group twice and makes temporaries of its
    size; AdamW updates each layer's rows in place and copies nothing."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.convert import _param_shapes
    from repro_torch.optim import param_groups
    out = []
    for arch in list_archs():
        cfg = get_config(arch)
        if cfg.optimizer != "adafactor":
            continue
        groups = [g for g in param_groups(_param_shapes(cfg), cfg) if g.stacked]
        big = max(groups, key=lambda g: len(g.params) * g.params[0].numel())
        out.append((arch, big.key, len(big.params), 4 * len(big.params) * big.params[0].numel()))
    return out


def phase_train(device: torch.device, max_err: dict,
                int32_ops_per_s: float) -> tuple[dict[str, int], float | None, dict]:
    """The [train] phase: parity at 2 layers, Qwen2-0.5B at full width and
    depth under LM_METHODS, the overfit check and the fault restart. ->
    (the matmul kernels' launches in the full-width runs' run_training
    steps, mitchell_matmul's device ms in one profiled mitchell step, each
    method's step numbers)."""
    t0 = time.perf_counter()
    phase_train_parity(device, max_err)
    launches = dict.fromkeys(MATMUL_KERNELS, 0)
    mitchell_ms = None
    numbers = {}
    for method in LM_METHODS:
        got, ms, numbers[method] = phase_train_method(method, device, int32_ops_per_s)
        mitchell_ms = ms if method == "mitchell" else mitchell_ms
        for name in MATMUL_KERNELS:
            launches[name] += got[name]
    phase_train_overfit(device)
    phase_train_fault(device)
    log("[train] Adafactor's stacked-group copies at full width (the largest group, "
        "copied twice, with temporaries of its size; AdamW copies none): " + "; ".join(
            f"{arch} {key} ({layers} layers) {size / 2**30:.3f} GiB"
            for arch, key, layers, size in adafactor_groups()))
    log(f"[train] phase {time.perf_counter() - t0:.1f} s (host clock); main-path launches "
        f"{launches}")
    return launches, mitchell_ms, numbers


MESH_STEPS = 3                      # run_training steps a method on the mesh
MESH_CKPT_EVERY = 2                 # the checkpoint the remesh restore reads
MESH_TIMED = slice(1, MESH_STEPS)   # steps 2-3
MESH_RANKS = (4, 2)                 # ranks of the multi-card check, the most that fit
MESH_LOSS_RTOL = 2e-5              # the reference's own (test_distribution.py)
#: the multi-card first step against the unmeshed one: each param's change
#: within MESH_DELTA_TOL of its leaf's largest change (+ 2 ulps of the
#: param) where AdamW's first step, g / (|g| + 1e-8), is the grad's sign
#: to 1% (|g| >= 100 x 1e-8) and that sign is sure (|g| above MESH_EXEMPT
#: of the model's largest |grad|); below, the step follows the grad's
#: summation noise. A grad exactly 0 in the unmeshed step is no sign: the
#: other order may leave 2e-9 there, a step of 0.17 (four cards, float32)
MESH_DELTA_TOL = 1e-2
MESH_EXEMPT = 1e-4
MESH_SATURATED = 100 * 1e-8


@contextlib.contextmanager
def checked_limbs(stats: dict):
    """Every `karatsuba_matmul_kernel` call inside also runs
    `karatsuba_matmul_plain` on the same limbs; `stats` counts the calls and
    keeps the largest |kernel - plain| of the hh, mid and ll sums."""
    from repro_torch.kernels import karatsuba_matmul as km
    kernel = km.karatsuba_matmul_kernel

    def checked(*limbs, **kw):
        out = kernel(*limbs, **kw)
        plain = km.karatsuba_matmul_plain(*limbs, **kw)
        stats["calls"] += 1
        stats["max_err"] = max(stats["max_err"], *(int((o.long() - p.long()).abs().max())
                                                   for o, p in zip(out, plain)))
        return out

    km.karatsuba_matmul_kernel = checked
    try:
        yield
    finally:
        km.karatsuba_matmul_kernel = kernel


@contextlib.contextmanager
def nccl_world(rank: int, world: int, rdzv: str, device_type: str = "cuda"):
    """An NCCL process group of `world` ranks meeting at the file `rdzv`,
    this process rank `rank` on card `rank`, destroyed on exit; gloo on
    the CPU for `device_type` "cpu" (a rehearsal without a card)."""
    import torch.distributed as dist
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method=f"file://{rdzv}", rank=rank,
                                world_size=world, device_id=device)
    else:
        dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                                world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def whole_params(state, cfg) -> list[torch.Tensor]:
    """The params of a state, whole (a sharded leaf gathered), in group order."""
    from repro_torch.optim import param_groups
    from repro_torch.runtime import sharding as shd
    return [shd.gather(t).detach() for g in param_groups(state.params, cfg) for t in g.params]


def first_step_kept(step, cfg, into: dict):
    """`step`, which after its first call keeps that step's loss and whole
    params (in host memory) in `into`: the step from the seed-0 state on
    batch 0, in the [train] runs and the [mesh] runs alike."""
    def wrapped(state, batch):
        state, metrics = step(state, batch)
        if not into:
            into["loss"] = metrics["loss"].detach().to("cpu", copy=True)
            into["params"] = [t.to("cpu", copy=True) for t in whole_params(state, cfg)]
        return state, metrics
    return wrapped


def first_step_gap(got: dict, want: dict) -> dict:
    """The (1, 1) mesh run's first step against the unmeshed one's (both
    kept by `first_step_kept`): byte-equal, loss and every param. At world
    size 1 every collective is the identity and the step computes what the
    unmeshed step computes, in its order; -> the gaps (zero)."""
    gap = {"loss_equal": bool(torch.equal(got["loss"], want["loss"])),
           "params_equal": all(torch.equal(a, b) for a, b in zip(got["params"], want["params"])),
           "loss_rel": float((got["loss"] - want["loss"]).abs() / want["loss"].abs()),
           "params_max_abs": max(float((a - b).abs().max())
                                 for a, b in zip(got["params"], want["params"]))}
    assert gap["loss_equal"] and gap["params_equal"], gap
    return gap


class TimedCheckpoints:
    """A `CheckpointManager` whose saves block and are timed: the [mesh]
    phase's save ms, with no writer thread beside the timed steps."""

    def __init__(self, ckpt_dir: str, interval: int):
        from repro_torch.checkpoint import CheckpointManager
        self.manager = CheckpointManager(ckpt_dir, interval=interval)
        self.save_ms = None

    def maybe_save(self, step: int, tree, mesh_shape=None) -> bool:
        from repro_torch.checkpoint import save
        if step % self.manager.interval:
            return False
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(self.manager.dir, step, tree, mesh_shape=mesh_shape)
        self.save_ms = (time.perf_counter() - t0) * 1e3
        return True

    def wait(self) -> None:
        self.manager.wait()

    def restore_latest(self, like, device=None):
        return self.manager.restore_latest(like, device)


def phase_mesh_parity(mesh, device: torch.device, max_err: dict) -> None:
    """At TRAIN_CUT_LAYERS layers, full width, batch 2 x seq 64, on `mesh`:
    one mitchell and one karatsuba_int16 mesh step, every call of
    `mitchell_matmul` / the limb kernel (forward and recompute) held
    against its plain version; the int8 all-reduce against its plain
    version on a stacked wq-sized tensor."""
    from repro_torch.data.tokens import lm_batch
    from repro_torch.models import build_model
    from repro_torch.optim.grad_compress import shard_map_allreduce_i8
    from repro_torch.runtime.train_lib import make_train_state, make_train_step

    batch = lm_batch(train_cut(), batch=TRAIN_PARITY_SHAPE[0], seq=TRAIN_PARITY_SHAPE[1])
    for method, checked, kernel in (("mitchell", checked_mitchell, "mitchell_matmul"),
                                    ("karatsuba_int16", checked_limbs, "karatsuba_matmul_i8")):
        cfg = train_cut(method)
        model = build_model(cfg)
        state = make_train_state(model, torch.Generator(device).manual_seed(1), mesh)
        stats = {"calls": 0, "max_err": 0}
        reset_matmul_launches()
        with checked(stats):
            state, metrics = make_train_step(model, mesh=mesh)(state, batch)
        launches = {k: v for k, v in matmul_launches().items() if v}
        max_err[kernel] = max(max_err[kernel], stats["max_err"])
        assert stats["calls"] == train_dense_calls(cfg) and stats["max_err"] == 0, stats
        assert launches == {kernel: stats["calls"]}, launches
        assert bool(torch.isfinite(metrics["loss"])), metrics
        log(f"[mesh] parity, {TRAIN_ARCH} {TRAIN_CUT_LAYERS} layers full width, batch "
            f"{TRAIN_PARITY_SHAPE[0]} x seq {TRAIN_PARITY_SHAPE[1]}, remat, mesh "
            f"{tuple(mesh.shape)}: {kernel} == its plain version on all {stats['calls']} "
            f"calls of a {method} mesh step (max |err| {stats['max_err']}); loss "
            f"{float(metrics['loss']):.6f}")
        del model, state
    x = torch.randn((TRAIN_CUT_LAYERS * 896, 896), generator=torch.Generator(device)
                    .manual_seed(5), device=device)
    t0 = time.perf_counter()
    got = shard_map_allreduce_i8(x, mesh, "data")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    scale = torch.maximum(x.abs().max(), torch.tensor(1e-30, device=device)) / \
        torch.tensor(127.0, device=device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    want = q.to(torch.int32).to(torch.float32) * scale / torch.tensor(1.0, device=device)
    err = float((got - want).abs().max())
    assert err == 0, err
    log(f"[mesh] shard_map_allreduce_i8 on {tuple(x.shape)} float32 over the mesh's data "
        f"axis == its plain version (max |err| {err}); {ms:.4f} ms (host clock, first call)")


def phase_mesh_method(method: str, mesh, device: torch.device,
                      unmeshed_first: dict | None,
                      restore: bool) -> tuple[dict, dict[str, int]]:
    """TRAIN_ARCH at full width and depth, `method`, on `mesh`: MESH_STEPS
    steps through `run_training`, the first against the [train] phase's
    unmeshed first step (`unmeshed_first`); with `restore`, a (blocking,
    timed) checkpoint at MESH_CKPT_EVERY, the remesh restore of it onto a
    fresh mesh and its next step against the run's (the checkpoint path
    does not depend on the method: one method's run takes it); one step
    under the sync debug mode and one under torch.profiler. -> (the step's
    numbers, the matmul kernels' launches in the run_training steps)."""
    import dataclasses
    import tempfile

    from repro_torch.data.tokens import lm_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.elastic import abstract_train_state, remesh_restore
    from repro_torch.runtime.fault import StragglerMonitor, run_training
    from repro_torch.runtime.train_lib import make_train_state, make_train_step

    cfg = dataclasses.replace(lm_config(TRAIN_ARCH), matmul_method=method)
    model = build_model(cfg)
    batch_of = lambda s: lm_batch(cfg, batch=TRAIN_SHAPE[0], seq=TRAIN_SHAPE[1], step=s)  # noqa: E731
    step = make_train_step(model, mesh=mesh)
    monitor, losses, first = StragglerMonitor(), [], {}
    size = restore_ms = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        ckpt = TimedCheckpoints(ckpt_dir, MESH_CKPT_EVERY if restore else MESH_STEPS + 1)
        reset_matmul_launches()
        state = run_training(
            train_step=first_step_kept(step, cfg, first), init_state=lambda: make_train_state(
                model, torch.Generator(device).manual_seed(0), mesh),
            batch_fn=batch_of, num_steps=MESH_STEPS, ckpt=ckpt, mesh_shape=tuple(mesh.shape),
            straggler=monitor, on_metrics=lambda s, m: losses.append(m["loss"]))
        launches = matmul_launches()
        peak = torch.cuda.max_memory_allocated()
        if restore:
            size = sum(f.stat().st_size for f in Path(ckpt_dir, f"step_{MESH_CKPT_EVERY:08d}")
                       .iterdir())
            fresh = make_host_mesh()
            t0 = time.perf_counter()
            at, restored = remesh_restore(ckpt_dir, abstract_train_state(cfg), cfg, fresh,
                                          multi_pod=False)
            torch.cuda.synchronize()
            restore_ms = (time.perf_counter() - t0) * 1e3
    gap = None if unmeshed_first is None else first_step_gap(first, unmeshed_first)
    del first
    losses = [float(x) for x in losses]
    assert len(losses) == MESH_STEPS and all(np.isfinite(losses)), losses
    resumed = None
    if restore:
        assert at == MESH_CKPT_EVERY and int(restored.step) == at, at
        _, again = make_train_step(model, mesh=fresh)(restored, batch_of(at))
        del restored
        resumed = float(again["loss"])
        assert abs(resumed - losses[at]) <= MESH_LOSS_RTOL * abs(losses[at]), (resumed, losses)
    per_step = train_dense_calls(cfg)
    kernel = {"mitchell": "mitchell_matmul", "karatsuba_int16": "karatsuba_matmul_i8"}.get(method)
    want = {kernel: MESH_STEPS * per_step} if kernel else {}
    assert {k: v for k, v in launches.items() if v} == want, (method, launches)
    times = list(monitor.times)[MESH_TIMED]
    step_s = statistics.median(times)
    batch = batch_of(MESH_STEPS)
    shd.reset_collectives()
    (state, metrics), sync_sites = count_syncs(lambda: step(state, batch))
    collectives = dict(shd.COLLECTIVES)
    syncs = sum(sync_sites.values())
    try:
        busy = device_busy_ms(lambda: step(state, batch_of(MESH_STEPS + 1)))
    except Exception as err:                             # noqa: BLE001
        busy = None
        log(f"[mesh] {method}: torch.profiler failed ({err!r})")
    tokens = TRAIN_SHAPE[0] * TRAIN_SHAPE[1]
    numbers = {"step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s, "syncs": syncs,
               "busy": None if busy is None else busy[1] / busy[0],
               "peak_gib": peak / 2**30, "save_ms": ckpt.save_ms, "restore_ms": restore_ms,
               "ckpt_mib": None if size is None else size / 2**20, "collectives": collectives,
               "first_step": gap,
               "losses": losses, "resumed_loss": resumed}
    first_line = "not compared (no [train] phase ran)" if gap is None else (
        f"loss {'byte-equal' if gap['loss_equal'] else 'rel gap %.3g' % gap['loss_rel']}, "
        f"params {'byte-equal' if gap['params_equal'] else 'max |gap| %.3g' % gap['params_max_abs']}")
    log(f"[mesh] {TRAIN_ARCH} {method} on mesh {tuple(mesh.shape)} (NCCL): {cfg.num_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.dtype} over float32, remat {cfg.remat}, "
        f"{cfg.optimizer}; batch {TRAIN_SHAPE[0]} x seq {TRAIN_SHAPE[1]}; first step vs the "
        f"[train] phase's unmeshed first step: {first_line}; loss by step "
        f"{[round(x, 6) for x in losses]}; step {step_s * 1e3:.4f} ms (median of steps "
        f"2-{MESH_STEPS}: {[round(t * 1e3, 4) for t in times]}), {tokens / step_s:.2f} "
        f"tokens/s; launches {want or 'no matmul kernel'}")
    log(f"[mesh] {method}: a step's collectives {collectives}; host syncs {syncs} by site "
        f"{sync_sites}; " + ("busy not measured (no device time seen)" if busy is None else
                             f"one step under torch.profiler: wall {busy[0]:.4f} ms, CUDA "
                             f"kernels {busy[1]:.4f} ms, busy {busy[1] / busy[0]:.4f}")
        + f"; peak {peak / 2**30:.3f} GiB; " + (
            "no checkpoint (the exact run takes the checkpoint path)" if not restore else
            f"sharded checkpoint ({size / 2**20:.1f} MiB) save {ckpt.save_ms:.1f} ms, remesh "
            f"restore onto a fresh {tuple(fresh.shape)} mesh {restore_ms:.1f} ms (host clock); "
            f"step {at + 1} after the restore: loss {resumed:.6f} "
            f"({'byte-equal to' if resumed == losses[at] else 'within rtol 2e-5 of'} the "
            f"run's {losses[at]:.6f})"))
    del state, model, metrics
    torch.cuda.empty_cache()
    return numbers, launches


def delta_gap(p0: list, got: list, want: list, grads: list, names: list) -> dict:
    """Each param's change in the mesh step (`got` - `p0`) against the
    unmeshed step's (`want` - `p0`), leaf by leaf (`names`): the largest
    |gap| over MESH_DELTA_TOL x the leaf's largest |change| + 2 ulps of
    the param, on the elements whose unmeshed grad is above MESH_SATURATED
    and MESH_EXEMPT x the model's largest |grad| (`held`); above 1 fails.
    -> that ratio and its leaf, the largest |grad|, the share of the
    elements held."""
    eps = torch.finfo(torch.float32).eps
    gmax = max(float(g.float().abs().max()) for g in grads)
    floor = max(MESH_SATURATED, MESH_EXEMPT * gmax)
    worst, leaf, held, total = 0.0, None, 0, 0
    for a, g, w, gr, name in zip(p0, got, want, grads, names):
        d_got, d_want = g.float() - a.float(), w.float() - a.float()
        gr = gr.float().abs()
        keep = gr > floor
        atol = MESH_DELTA_TOL * d_want.abs().max() + 2 * eps * w.float().abs()
        ratio = float(((d_got - d_want).abs() / atol)[keep].max()) if keep.any() else 0.0
        if ratio > worst:
            worst, leaf = ratio, name
        held, total = held + int(keep.sum()), total + keep.numel()
    return {"worst": worst, "worst_leaf": leaf, "grad_max": gmax, "held": held / total}


def mesh_rank(rank: int, world: int, rdzv: str, out: str, device_type: str = "cuda",
              model_ranks: int = 1) -> None:
    """(a spawned rank) one full-width Qwen2-0.5B step in float32 (the
    reference's tolerances are float32's) on a (world / model_ranks,
    model_ranks) NCCL mesh from the seed-0 state (tensor parallel over
    "model" where model_ranks > 1); rank 0 also takes the unmeshed step
    (and its grads) and writes the loss and the params' `delta_gap`."""
    import dataclasses

    from repro_torch.data.tokens import lm_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import param_groups
    from repro_torch.runtime.train_lib import grads_of, make_train_state, make_train_step
    with nccl_world(rank, world, rdzv, device_type):
        device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
        cfg = dataclasses.replace(lm_config(TRAIN_ARCH), dtype="float32")
        model = build_model(cfg, device)
        mesh = make_host_mesh(model=model_ranks)
        batch = lm_batch(cfg, batch=TRAIN_SHAPE[0], seq=TRAIN_SHAPE[1])
        state = make_train_state(model, torch.Generator(device).manual_seed(0), mesh)
        state, metrics = make_train_step(model, mesh=mesh)(state, batch)
        got = [t.to("cpu") for t in whole_params(state, cfg)]
        del state
        if rank == 0:
            plain = make_train_state(model, torch.Generator(device).manual_seed(0))
            p0 = [t.to("cpu", copy=True) for t in whole_params(plain, cfg)]
            groups = param_groups(plain.params, cfg)
            leaves = [t for g in groups for t in g.params]
            names = [f"{g.key}[{i}]" for g in groups for i in range(len(g.params))]
            grads = [g.to("cpu") for g in grads_of(model, plain.params, batch, leaves)[2]]
            plain, pm = make_train_step(model)(plain, batch)
            want = [t.to("cpu") for t in whole_params(plain, cfg)]
            Path(out).write_text(json.dumps({
                "loss": float(metrics["loss"]), "unmeshed_loss": float(pm["loss"]),
                "params_max_abs": max(float((a - b).abs().max()) for a, b in zip(got, want)),
                **delta_gap(p0, got, want, grads, names)}))


def phase_mesh_ranks() -> None:
    """Where the machine has two cards or more: MESH_RANKS' largest that
    fits, as NCCL ranks of their own processes, one step each on an (n, 1)
    mesh, then one on a (1, 2) mesh (tensor parallel over "model"); the
    loss against the unmeshed step's within MESH_LOSS_RTOL, each param's
    change against its (`delta_gap`)."""
    import tempfile

    import torch.multiprocessing as mp
    count = torch.cuda.device_count()
    fits = [n for n in MESH_RANKS if n <= count]
    if not fits:
        log(f"[mesh] multi-card steps ((n, 1) and the (1, 2) tensor-parallel step) not run: "
            f"{count} CUDA device(s) here, the check needs 2 or more (one NCCL rank a card)")
        return
    for n, model_ranks in ((fits[0], 1), (2, 2)):
        with tempfile.TemporaryDirectory() as d:
            out = os.path.join(d, "gap.json")
            t0 = time.perf_counter()
            mp.spawn(mesh_rank, args=(n, os.path.join(d, "rdzv"), out, "cuda", model_ranks),
                     nprocs=n)
            gap = json.loads(Path(out).read_text())
        rel = abs(gap["loss"] - gap["unmeshed_loss"]) / abs(gap["unmeshed_loss"])
        assert rel <= MESH_LOSS_RTOL and gap["worst"] <= 1 and gap["held"] > 0, gap
        log(f"[mesh] {n} NCCL ranks, a ({n // model_ranks}, {model_ranks}) mesh, {TRAIN_ARCH} "
            f"full width and depth in float32: first "
            f"step loss {gap['loss']:.6f} vs unmeshed {gap['unmeshed_loss']:.6f} (rel {rel:.3g}), "
            f"params max |gap| {gap['params_max_abs']:.3g}, each param's change within "
            f"{gap['worst']:.3g} of its tolerance ({MESH_DELTA_TOL} of its leaf's largest change; "
            f"the worst {gap['worst_leaf']}) on the {gap['held']:.1%} of elements whose grad is "
            f"above {MESH_SATURATED} and {MESH_EXEMPT} of the largest ({gap['grad_max']:.3g}); "
            f"{time.perf_counter() - t0:.1f} s")


def shared_card_probe(rank: int, device: torch.device) -> str | None:
    """The capability question alone: can two gloo ranks on the one card
    all-gather and all-reduce a small CUDA tensor? -> None, or the error."""
    import torch.distributed as dist
    try:
        x = torch.full((4,), float(rank + 1), device=device)
        buf = torch.empty((8,), device=device)
        dist.all_gather_into_tensor(buf, x)
        dist.all_reduce(x)
        torch.cuda.synchronize()
    except Exception as e:                           # noqa: BLE001 - the answer is the error
        return f"{type(e).__name__}: {e}"[:600]
    want = torch.tensor([1.0] * 4 + [2.0] * 4)
    assert torch.equal(buf.cpu(), want) and torch.equal(x.cpu(), torch.full((4,), 3.0)), \
        (buf, x)
    return None


#: the shared-card (1, 2) step's cases: (arch, layers) at full width under
#: mitchell, each rank's share of the unmeshed oracle, and the quantized
#: denses a layer a forward (the dense Qwen2 layer's 7, a Mamba2 layer's
#: in_proj and out_proj, its 64 SSM heads split over "model")
TP_SHARED_CASES = {"dense": (TRAIN_ARCH, TRAIN_CUT_LAYERS, 0, 7),
                   "hybrid": ("zamba2-1.2b", 2, 1, 2)}


def tp_shared_case(cfg, mesh, device: torch.device, check: bool, oracle: bool) -> dict:
    """`cfg` through the meshed prefill and DRYRUN_DECODE_STEPS serve steps
    on `mesh`, with `check` every `mitchell_matmul` call held against its
    plain version; with `oracle`, the unmeshed steps too (deferred: a
    function that runs them and compares)."""
    from repro_torch.models import build_model
    from repro_torch.runtime import sharding as shd
    model = build_model(cfg, device)
    params = model.init(torch.Generator(device).manual_seed(0))
    batch, prompt_len, _ = LM_TRAFFIC
    s_max = prompt_len + DRYRUN_DECODE_STEPS + 1
    prompt = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (batch, prompt_len), dtype=np.int64)).to(device)
    p = shd.distribute_tree(params, shd.param_shardings(params, cfg, mesh, multi_pod=False))
    caches = model.init_cache(batch, s_max)
    c = shd.distribute_tree(caches, shd.cache_shardings(caches, cfg, mesh, multi_pod=False))
    stats = {"calls": 0, "max_err": 0}
    shd.reset_collectives()
    t0 = time.perf_counter()
    # rank 0's calls are the ones held against plain: rank 1 leaves the card
    # to them instead of checking calls nobody reads
    with checked_mitchell(stats) if check else contextlib.nullcontext():
        got = serve_mesh_generate(model, p, c, prompt, mesh)
    torch.cuda.synchronize()
    result = {"stats": stats, "collectives": dict(shd.COLLECTIVES),
              "mesh_s": time.perf_counter() - t0}
    del p, c

    def compare() -> dict:
        t1 = time.perf_counter()
        want = serve_mesh_generate(model, params, model.init_cache(batch, s_max), prompt)
        torch.cuda.synchronize()
        return {**result, "oracle_s": time.perf_counter() - t1,
                "max_abs": max(float((g - w).abs().max())
                               for g, w in zip(got["logits"], want["logits"])),
                "equal": all(torch.equal(g, w) for g, w in zip(got["logits"], want["logits"]))}
    return compare if oracle else result


def tp_shared_rank(rank: int, world: int, rdzv: str, out: str) -> None:
    """(a spawned rank) two gloo ranks on the one card: where they can share
    it (`shared_card_probe`), each TP_SHARED_CASES case at full width,
    mitchell, through the meshed prefill and DRYRUN_DECODE_STEPS serve
    steps on a (1, 2) mesh (tensor parallel over "model"), every
    `mitchell_matmul` call held against its plain version; then each rank
    runs the unmeshed steps of its cases (the two ranks in parallel) and
    writes `out`.<rank>. A fault past the probe fails the rank, and so
    the phase."""
    import dataclasses
    from datetime import timedelta

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    error = shared_card_probe(rank, device)
    if error is not None:
        if rank == 0:
            Path(out).write_text(json.dumps({"shared": False, "error": error}))
        dist.destroy_process_group()
        return
    mesh = init_device_mesh("cuda", (1, world), mesh_dim_names=("data", "model"))
    runs = {}
    for name, (arch, layers, oracle_rank, _) in TP_SHARED_CASES.items():
        cfg = dataclasses.replace(lm_config(arch), num_layers=layers, matmul_method="mitchell")
        runs[name] = tp_shared_case(cfg, mesh, device, rank == 0, oracle_rank == rank)
    dist.destroy_process_group()
    results = {name: run() if callable(run) else run for name, run in runs.items()}
    Path(f"{out}.{rank}").write_text(json.dumps({"shared": True, "cases": results}))


def phase_tp_shared_card(max_err: dict) -> None:
    """Whether two gloo ranks can share the one card with CUDA tensors
    (`shared_card_probe`); where they can, the (1, 2) tensor-parallel
    serve steps of `tp_shared_rank`, each case's logits byte-equal to the
    unmeshed steps', rank 0's mitchell_matmul calls (the case's denses a
    layer a forward: the prefill and each serve step) equal to plain,
    asserted."""
    import tempfile

    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "tp.json")
        mp.spawn(tp_shared_rank, args=(2, os.path.join(d, "rdzv"), out), nprocs=2)
        if os.path.exists(out):
            got = json.loads(Path(out).read_text())
        else:
            ranks = [json.loads(Path(f"{out}.{r}").read_text()) for r in range(2)]
            got = {"shared": True, "ranks": ranks}
    if not got["shared"]:
        log(f"[mesh] two gloo ranks on the one card with CUDA tensors: not possible here "
            f"({got['error']}); the (1, 2) tensor-parallel serve steps not run "
            f"({time.perf_counter() - t0:.1f} s)")
        return
    for name, (arch, layers, oracle_rank, denses) in TP_SHARED_CASES.items():
        stats = got["ranks"][0]["cases"][name]["stats"]
        case = got["ranks"][oracle_rank]["cases"][name]
        max_err["mitchell_matmul"] = max(max_err["mitchell_matmul"], stats["max_err"])
        calls = (1 + DRYRUN_DECODE_STEPS) * denses * layers
        assert stats["max_err"] == 0 and stats["calls"] == calls, (name, stats, calls)
        assert case["equal"], (name, case)
        log(f"[mesh] two gloo ranks on the one card, a (1, 2) mesh (tensor parallel), "
            f"{arch} {layers} layers full width, mitchell: prefill + {DRYRUN_DECODE_STEPS} "
            f"serve steps, rank 0's {stats['calls']} mitchell_matmul calls == plain "
            f"({denses} a layer a forward; max |err| {stats['max_err']}); logits byte-equal "
            f"to the unmeshed steps' (rank {oracle_rank}; max |diff| {case['max_abs']:.6g}); "
            f"collectives {case['collectives']}; meshed {case['mesh_s']:.1f} s, unmeshed "
            f"{case['oracle_s']:.1f} s")
    log(f"[mesh] the shared-card (1, 2) steps, spawn to end: {time.perf_counter() - t0:.1f} s")


def phase_mesh(device: torch.device, max_err: dict, smi: str,
               unmeshed: dict | None) -> dict[str, int]:
    """The [mesh] phase: multi-card training's path at world size 1 (an
    in-process NCCL group, a (1, 1) mesh): the parity step, then
    TRAIN_ARCH at full width and depth under LM_METHODS beside the [train]
    phase's unmeshed numbers (`unmeshed`, by method); then the multi-card
    check where there are cards for it. -> the matmul kernels' launches in
    the mesh run_training steps."""
    import tempfile

    from repro_torch.launch.mesh import make_host_mesh

    t0 = time.perf_counter()
    launches = dict.fromkeys(MATMUL_KERNELS, 0)
    rows = {}
    with tempfile.TemporaryDirectory() as d, nccl_world(0, 1, os.path.join(d, "rdzv")):
        mesh = make_host_mesh()
        phase_mesh_parity(mesh, device, max_err)
        for method in LM_METHODS:
            plain = (unmeshed or {}).get(method)
            rows[method], got = phase_mesh_method(method, mesh, device,
                                                  None if plain is None else plain["first"],
                                                  restore=method == LM_METHODS[0])
            for name in MATMUL_KERNELS:
                launches[name] += got[name]
    for method, row in rows.items():
        plain = (unmeshed or {}).get(method)
        coll = row["collectives"]
        kinds = {k: v for k, v in coll.items() if not k.endswith("_bytes")}
        volume = sum(v for k, v in coll.items() if k.endswith("_bytes"))
        log(f"[mesh] {smi}: {method}: mesh (1, 1) / unmeshed step ms "
            f"{row['step_ms']:.4f} / " + ("not measured" if plain is None else
                                          f"{plain['step_ms']:.4f}")
            + f", tokens/s {row['tokens_per_s']:.2f} / "
            + ("-" if plain is None else f"{plain['tokens_per_s']:.2f}")
            + f", host syncs {row['syncs']} / " + ("-" if plain is None else f"{plain['syncs']}")
            + ", busy " + ("-" if row["busy"] is None else f"{row['busy']:.4f}") + " / "
            + ("-" if plain is None or plain["busy"] is None else f"{plain['busy']:.4f}")
            + f", peak GiB {row['peak_gib']:.3f} / "
            + ("-" if plain is None else f"{plain['peak_gib']:.3f}")
            + f"; collectives a step {kinds} ({volume / 2**20:.1f} MiB) / none"
            + ("" if row["restore_ms"] is None else f"; sharded save {row['save_ms']:.1f} ms, "
               f"restore {row['restore_ms']:.1f} ms"))
    phase_mesh_ranks()
    phase_tp_shared_card(max_err)
    log(f"[mesh] phase {time.perf_counter() - t0:.1f} s (host clock); main-path launches "
        f"{launches}")
    return launches


#: (arch, shape, mesh, cells ok): nemotron-4-340b's prefill was refused
#: before the per-layer gather (its params whole pass the card)
DRYRUN_CELLS = (("qwen2-0.5b", "decode_32k", "both", 2), ("qwen2-0.5b", "train_4k", "single", 1),
                ("nemotron-4-340b", "prefill_32k", "single", 1))
DRYRUN_TIMEOUT_S = 240
DRYRUN_DECODE_STEPS = 3


def dryrun_cli() -> tuple[str, list[subprocess.Popen]]:
    """Start `python -m repro_torch.launch.dryrun` for the DRYRUN_CELLS,
    each in a process of its own (fake CUDA tensors over a
    fake process group of 256 or 512 ranks, on the host's cores while the
    earlier phases use the card); -> (their directory, the processes),
    both ended at exit if the script stops before `dryrun_records`."""
    import atexit
    import shutil
    import tempfile

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = []
    for arch, shape, mesh, _ in DRYRUN_CELLS:
        log_path = os.path.join(out_dir, f"{arch}__{shape}__{mesh}.log")
        with open(log_path, "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                 "--shape", shape, "--mesh", mesh, "--out", os.path.join(out_dir, "records")],
                env=env, stdout=out, stderr=subprocess.STDOUT, text=True))

    def end() -> None:
        for proc in procs:
            proc.kill()
            proc.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    atexit.register(end)
    return out_dir, procs


def dryrun_records(out_dir: str, procs: list[subprocess.Popen]) -> None:
    """Wait for the DRYRUN_CELLS processes; each must exit 0 with its cells
    ok; print every record's terms."""
    for proc, (arch, shape, mesh, n_ok) in zip(procs, DRYRUN_CELLS):
        try:
            proc.wait(timeout=DRYRUN_TIMEOUT_S)
        finally:
            proc.kill()
        out = Path(out_dir, f"{arch}__{shape}__{mesh}.log").read_text()
        assert proc.returncode == 0 and f"ok={n_ok} fail=0" in out, \
            f"dryrun {arch} {shape} --mesh {mesh}: rc {proc.returncode}\n{out[-4000:]}"
    records = os.path.join(out_dir, "records")
    for name in sorted(os.listdir(records)):
        rec = json.load(open(os.path.join(records, name)))
        r, ma = rec["roofline"], rec["memory_analysis"]
        log(f"[dryrun] {rec['arch']} {rec['shape']} {rec['mesh']} ({rec['chips']} cards, "
            f"fake CUDA tensors, counted in {rec['compile_s']} s of host time): per card "
            f"flops {r['flops']:.6e}, bytes {r['hbm_bytes']:.6e}, collective bytes "
            f"{r['coll_bytes']:.6e} {{{', '.join(f'{k} {v:.6e}' for k, v in r['coll_breakdown'].items() if v)}}}; "
            f"compute {r['compute_s'] * 1e3:.4f} ms, memory {r['memory_s'] * 1e3:.4f} ms, "
            f"collective {r['collective_s'] * 1e3:.4f} ms: {r['bottleneck']}; useful "
            f"{r['useful_ratio']:.4f}; arguments {ma['argument_size_in_bytes'] / 2**30:.3f} GiB, "
            f"peak {(ma['argument_size_in_bytes'] + ma['temp_size_in_bytes']) / 2**30:.3f} GiB "
            f"of {rec['card']['hbm_bytes'] / 2**30:.2f} (fits {rec['fits_hbm']}); "
            f"{rec['counts']['collectives'].get('all_gather', 0)} all-gathers, layers "
            f"{rec.get('tensor_parallel') or 'unsplit'}")


def dryrun_train_cell(device: torch.device, smi: str, unmeshed: dict | None) -> None:
    """Count the [train] phase's exact step (TRAIN_ARCH at full width and
    depth, batch x seq TRAIN_SHAPE, world 1) on fake CUDA tensors and print
    the count beside the [train] phase's measurements from this run."""
    import dataclasses

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import count_cell
    from repro_torch.roofline.analysis import HW, analyze_step, model_flops

    cfg = dataclasses.replace(lm_config(TRAIN_ARCH), matmul_method="exact")
    shape = ShapeConfig("train", TRAIN_SHAPE[1], TRAIN_SHAPE[0], "train")
    t0 = time.perf_counter()
    counts, n_params = count_cell(cfg, shape, None, device.type)
    secs = time.perf_counter() - t0
    mf = model_flops(cfg, n_params, shape)
    r = analyze_step(counts, model_flops_val=mf, chips=1)
    bound_ms = max(r.compute_s, r.memory_s, r.collective_s) * 1e3
    peak = counts.peak_bytes / 2**30
    measured = (unmeshed or {}).get("exact")
    assert counts.flops > 0 and counts.peak_bytes > 0 and not counts.kernels, counts
    line = (f"[dryrun] {smi}: {TRAIN_ARCH} exact train step, batch {TRAIN_SHAPE[0]} x seq "
            f"{TRAIN_SHAPE[1]}, world 1, counted on fake CUDA tensors in {secs:.1f} s: "
            f"{n_params} parameters, model flops {mf:.6e}, counted flops {r.flops:.6e} "
            f"({', '.join(f'{k} {v:.6e}' for k, v in counts.flops_by_dtype.items())}), bytes "
            f"{r.hbm_bytes:.6e}; compute {r.compute_s * 1e3:.4f} ms, memory "
            f"{r.memory_s * 1e3:.4f} ms: bound {bound_ms:.4f} ms ({r.bottleneck}); "
            f"predicted peak {peak:.3f} GiB")
    if measured is None:
        log(line + "; the [train] step not measured")
        return
    step_ms = measured["step_ms"]
    peak_flops = HW().peak_flops             # the H100 SXM's dense bf16 rate
    log(line + f"; measured step {step_ms:.4f} ms: roofline_fraction "
        f"{bound_ms / step_ms:.6f}, MFU {mf / (step_ms * 1e-3 * peak_flops):.6f} "
        f"(model flops / (step s x {peak_flops:.4g})); measured peak "
        f"{measured['peak_gib']:.3f} GiB (max_memory_allocated)")


def serve_mesh_generate(model, params, caches, prompt, mesh=None) -> dict:
    """Prefill `prompt`, then DRYRUN_DECODE_STEPS greedy serve steps: the
    logits of each, the tokens, and the caches whole."""
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime.serve_lib import make_prefill_step, make_serve_step
    logits, caches, _ = make_prefill_step(model, mesh)(params, {"tokens": prompt}, caches)
    out = {"logits": [logits]}
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    for i in range(DRYRUN_DECODE_STEPS):
        step = make_serve_step(model, seq_len=prompt.shape[1] + 1 + i, mesh=mesh)
        logits, caches = step(params, tok, caches)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        out["logits"].append(logits)
    out["caches"] = [shd.gather(t) for layer in caches for t in layer.values()]
    return out


def dryrun_serve_mesh(device: torch.device, max_err: dict) -> dict[str, int]:
    """Prefill and DRYRUN_DECODE_STEPS decode steps of TRAIN_ARCH at
    TRAIN_CUT_LAYERS layers, full width, at LM_TRAFFIC's batch and prompt,
    through the meshed serve steps (the per-layer gather, the split
    layers) on a (1, 1) NCCL mesh under exact, mitchell and
    karatsuba_int16: logits and caches byte-equal to the unmeshed steps,
    every `mitchell_matmul` / limb kernel call of the meshed run equal to
    its plain version; -> the matmul kernels' launches in the meshed runs."""
    import tempfile

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.runtime import sharding as shd

    batch, prompt_len, _ = LM_TRAFFIC
    s_max = prompt_len + DRYRUN_DECODE_STEPS + 1
    launches = dict.fromkeys(MATMUL_KERNELS, 0)
    with tempfile.TemporaryDirectory() as d, nccl_world(0, 1, os.path.join(d, "rdzv")):
        mesh = make_host_mesh()
        for method in LM_METHODS:
            cfg = train_cut(method)
            model = build_model(cfg)
            params = model.init(torch.Generator(device).manual_seed(0))
            prompt = torch.from_numpy(np.random.default_rng(11).integers(
                0, cfg.vocab_size, (batch, prompt_len), dtype=np.int64)).to(device)
            want = serve_mesh_generate(model, params, model.init_cache(batch, s_max), prompt)
            p = shd.distribute_tree(params, shd.param_shardings(params, cfg, mesh,
                                                                multi_pod=False))
            caches = model.init_cache(batch, s_max)
            c = shd.distribute_tree(caches, shd.cache_shardings(caches, cfg, mesh,
                                                                multi_pod=False))
            stats = {"calls": 0, "max_err": 0}
            reset_matmul_launches()
            shd.reset_collectives()
            checked = checked_limbs if method == "karatsuba_int16" else checked_mitchell
            kernel = "karatsuba_matmul_i8" if method == "karatsuba_int16" else "mitchell_matmul"
            with checked(stats):
                got = serve_mesh_generate(model, p, c, prompt, mesh)
            torch.cuda.synchronize()
            for name, n in matmul_launches().items():
                launches[name] += n
            coll = dict(shd.COLLECTIVES)
            max_err[kernel] = max(max_err[kernel], stats["max_err"])
            equal = (all(torch.equal(g, w) for g, w in zip(got["logits"], want["logits"]))
                     and all(torch.equal(g, w) for g, w in zip(got["caches"], want["caches"])))
            assert equal and stats["max_err"] == 0, (method, stats)
            calls = (prefill_calls(cfg) + DRYRUN_DECODE_STEPS * dense_calls(cfg)
                     if method != "exact" else 0)
            assert stats["calls"] == calls and matmul_launches()[kernel] == calls, \
                (method, stats, matmul_launches())
            log(f"[dryrun] serve mesh (1, 1), {TRAIN_ARCH} {TRAIN_CUT_LAYERS} layers full width, "
                f"{method}: prefill of {batch} x {prompt_len} + {DRYRUN_DECODE_STEPS} decode "
                f"steps through the per-layer gather, logits of every step and "
                f"{len(want['caches'])} caches byte-equal to the unmeshed steps; "
                f"{stats['calls']} {kernel} calls == plain (max |err| {stats['max_err']}); "
                f"collectives {coll}")
            del model, params, p, c, want, got
    torch.cuda.empty_cache()
    return launches


def phase_dryrun(device: torch.device, max_err: dict, smi: str, unmeshed: dict | None,
                 cli: tuple[str, list[subprocess.Popen]]) -> dict[str, int]:
    """The [dryrun] phase: the [train] cell counted beside its measurements
    (`unmeshed`, the [train] phase's numbers by method), the meshed serve
    steps on a (1, 1) NCCL mesh, then the records of the dry-run CLI's
    processes (`cli`, started by `dryrun_cli` after the build). -> the
    matmul kernels' launches in the meshed serve runs."""
    t0 = time.perf_counter()
    dryrun_train_cell(device, smi, unmeshed)
    launches = dryrun_serve_mesh(device, max_err)
    dryrun_records(*cli)
    log(f"[dryrun] phase {time.perf_counter() - t0:.1f} s (host clock, the CLI's processes "
        f"run from the build on); serve-mesh launches {launches}")
    return launches


# the VLM's image K / V projection: the one LM call on the tiled route
VLM_TILED_SHAPE = (6400, 8192, 1024)


def train_kernel_times(int32_ops_per_s: float, device: torch.device,
                       max_err: dict) -> dict[tuple, dict]:
    """The two matmul kernels at the train step's shapes (M = batch x seq
    = 1024 rows against Qwen2-0.5B's four (K, N)), and `mitchell_matmul` at
    the VLM's tiled-route image projection: device ms of one call (10
    queued while the card is held) beside the bound and the launches a
    train step (forward + recompute). The int8 limb kernel is timed on its
    packed limbs (`product`), its pack step apart. At each train shape both
    kernels' results are held against their plain versions on the same
    operands (max |err| 0; the VLM's call is held in `phase_matmul_parity`)."""
    from repro_torch.core.quant import quantize_limbs
    from repro_torch.kernels import karatsuba_matmul_i8 as km8
    from repro_torch.kernels import mitchell_matmul as mm
    from repro_torch.kernels.karatsuba_matmul import karatsuba_matmul_plain

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rng = np.random.default_rng(91)
    m = TRAIN_SHAPE[0] * TRAIN_SHAPE[1]
    results, failures, checked = {}, [], 0
    shapes = [((m, k, n), 2 * per_step) for (k, n), per_step in LM_DENSE[TRAIN_ARCH]]
    for (mm_, k, n), per_step in shapes + [(VLM_TILED_SHAPE, 0)]:
        a = torch.from_numpy(rng.integers(-255, 256, (mm_, k)).astype(np.int32)).to(device)
        b = torch.from_numpy(rng.integers(-255, 256, (k, n)).astype(np.int32)).to(device)
        bound, by = mitchell_bound((mm_, k, n), int32_ops_per_s)
        if per_step:
            check_equal(max_err, failures, "mitchell_matmul", mm.mitchell_matmul_kernel(a, b),
                        mm.mitchell_matmul_plain(a, b), f"train shape {(mm_, k, n)}")
            checked += 1
        row = {"kernel": "mitchell_matmul", "shape": [mm_, k, n],
               "plan": str(mm.launch_plan(mm_, k, n, sms)),
               "device_ms": time_ms_batched(lambda: mm.mitchell_matmul_kernel(a, b)),
               "bound_ms": bound, "bound_by": by, "launches_a_train_step": per_step}
        if per_step:
            row["plain_ms"] = time_ms(lambda: mm.mitchell_matmul_plain(a, b), 1, warmup=0)
        results[("mitchell_train", mm_, k, n)] = row
        log("[train] " + json.dumps(row))
        if per_step:
            x = torch.from_numpy(rng.standard_normal((mm_, k), dtype=np.float32)).to(device)
            w = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)).to(device)
            da, _ = quantize_limbs(x, karatsuba=True)
            db, _ = quantize_limbs(w, karatsuba=True)
            limbs = (da.hi, da.lo, db.hi, db.lo)
            packed = km8.pack(*limbs, karatsuba=True)
            for part, got, want in zip(("hh", "mid", "ll"), km8.product(packed),
                                       karatsuba_matmul_plain(*limbs, karatsuba=True)):
                check_equal(max_err, failures, "karatsuba_matmul_i8", got, want,
                            f"{part} train shape {(mm_, k, n)}")
            checked += 1
            ops_ms = 3 * 2 * mm_ * k * n / INT8_OPS_PER_S * 1e3
            bytes_ms = 4 * (2 * mm_ * k + 2 * k * n + 3 * mm_ * n) / HBM_BYTES_PER_S * 1e3
            ah, al, bh, bl = (t.to(torch.int8) for t in limbs)
            asum = (da.hi + da.lo).to(torch.int8)
            bsum = (db.hi + db.lo).to(torch.int8)
            library = lambda: (torch._int_mm(ah, bh), torch._int_mm(al, bl),  # noqa: E731
                               torch._int_mm(asum, bsum))
            row = {"kernel": "karatsuba_matmul_i8", "shape": [mm_, k, n], "karatsuba": True,
                   "product_device_ms": time_ms_batched(lambda: km8.product(packed)),
                   "pack_device_ms": time_ms_batched(
                       lambda: km8.pack_async(*limbs, karatsuba=True)),
                   "bound_ms": max(ops_ms, bytes_ms),
                   "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                   "plain_ms": time_ms(lambda: karatsuba_matmul_plain(*limbs, karatsuba=True),
                                       3, warmup=1),
                   "library_device_ms": time_ms_batched(library),
                   "library": "3 torch._int_mm calls on the int8 limbs (the same partial "
                              "sums), B row-major as the limbs lie",
                   "launches_a_train_step": per_step}
            results[("karatsuba_train", mm_, k, n)] = row
            log("[train] " + json.dumps(row))
    step = {name: sum(row.get("device_ms", row.get("product_device_ms", 0.0))
                      * row["launches_a_train_step"] for key, row in results.items()
                      if key[0] == tag)
            for name, tag in (("mitchell_matmul", "mitchell_train"),
                              ("karatsuba_matmul_i8", "karatsuba_train"))}
    results["train_step"] = {**step, "mitchell_bound_ms": train_step_bound(int32_ops_per_s)}
    log(f"[train] {checked} matmul kernel/plain comparisons at the train shapes, max |err| "
        f"{ {name: max_err[name] for name in ('mitchell_matmul', 'karatsuba_matmul_i8')} }")
    if failures:
        raise AssertionError("matmul kernels disagree with their plain versions at the "
                             "train shapes:\n" + "\n".join(failures))
    log(f"[train] a Qwen2-0.5B train step's kernel calls (device ms a call x launches, "
        f"forward + recompute): mitchell_matmul {step['mitchell_matmul']:.6f} ms (bound "
        f"{train_step_bound(int32_ops_per_s):.6f} ms), karatsuba_matmul_i8 products "
        f"{step['karatsuba_matmul_i8']:.6f} ms")
    return results


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
            # at the big shape the plain versions take seconds a call: not
            # timed there
            runs = 0 if big else plain_runs
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
                row_.update({"plain_ms": time_ms(plain, runs, warmup=1) if runs else None,
                             "plain_runs": runs,
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


def wide_limbs(shape: tuple[int, int, int], bound: int, seed: int,
               device: torch.device) -> list[torch.Tensor]:
    """Seeded limbs a_hi, a_lo (M, K), b_hi, b_lo (K, N) in [-bound, bound)
    on the card, the WIDE_EDGES that fit placed in: A's first row, a_lo's
    last row backwards, B's first column, b_lo's last column backwards."""
    m, k, n = shape
    rng = np.random.default_rng(seed)
    out = [rng.integers(-bound, bound, s, dtype=np.int64) for s in ((m, k), (m, k), (k, n), (k, n))]
    for j, v in enumerate([v for v in WIDE_EDGES if -bound <= v < bound][:k]):
        out[0][0, j], out[1][m - 1, k - 1 - j] = v, v
        out[2][j, 0], out[3][k - 1 - j, n - 1] = v, v
    return [torch.from_numpy(v.astype(np.int32)).to(device) for v in out]


def wide_route_parity(max_err: dict, failures: list, device: torch.device) -> int:
    """The wide kernel through `karatsuba_matmul_kernel` at WIDE_THIN_SHAPES
    and WIDE_DIGIT_SHAPES on limbs needing 2, 3 and 4 int8 digits (the
    int32 extremes among them), both modes, against `karatsuba_matmul_plain`
    on CPU copies (its float64 route on the card is not exact past 2**53):
    each call must launch the route `launch_plan` names for the shape and
    the limbs' digit count. The digit route is also forced at every digit
    count from the limbs' own to 4, against the plain version and against
    `digit_product_plain` on the card. Both routes and all three digit
    counts must have run. -> the number of comparisons."""
    from repro_torch.kernels import karatsuba_matmul as km

    checked = 0
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    routes, counts = set(), set()
    for i, shape in enumerate(WIDE_THIN_SHAPES + WIDE_DIGIT_SHAPES):
        for digits, bound in WIDE_DIGIT_BOUNDS:
            limbs = wide_limbs(shape, bound, 120 + 4 * i + digits, device)
            cpu = [t.cpu() for t in limbs]
            for kar in (True, False):
                what = f"{shape} in [-{bound}, {bound}) karatsuba={kar}"
                if km.limb_digits(*limbs, karatsuba=kar) != digits:
                    failures.append(f"karatsuba_matmul {what}: not {digits} digits")
                plan = km.launch_plan(*shape, digits, sms)
                before = dict(km.ROUTE_LAUNCHES)
                got = km.karatsuba_matmul_kernel(*limbs, karatsuba=kar)
                ran = {r: c - before[r] for r, c in km.ROUTE_LAUNCHES.items() if c != before[r]}
                if ran != {plan.route: 1}:
                    failures.append(f"karatsuba_matmul {what}: launched {ran}, the plan "
                                    f"names {plan.route}")
                routes.add(plan.route)
                want = km.karatsuba_matmul_plain(*cpu, karatsuba=kar)
                for part, g, w in zip(("hh", "mid", "ll"), got, want):
                    check_equal(max_err, failures, "karatsuba_matmul", g.cpu(), w,
                                f"{part} {what} ({plan})")
                checked += 1
                for forced in range(digits, 5):
                    plan = km.route_plan("digits", *shape, forced, sms)
                    got = km.run_plan(*limbs, plan, karatsuba=kar)
                    plain = km.digit_product_plain(*limbs, karatsuba=kar, digits=forced)
                    for part, g, w, d in zip(("hh", "mid", "ll"), got, want, plain):
                        check_equal(max_err, failures, "karatsuba_matmul", g.cpu(), w,
                                    f"{part} {what} forced {plan}")
                        check_equal(max_err, failures, "karatsuba_matmul", g, d,
                                    f"{part} {what} forced {plan} vs digit_product_plain")
                    counts.add(forced)
                    checked += 1
        log(f"[parity] karatsuba_matmul {shape}: {km.launch_plan(*shape, 2, sms)}")
    if routes != {"thin", "digits"} or counts != {2, 3, 4}:
        failures.append(f"karatsuba_matmul: routes {routes}, digit counts {counts} ran")
    return checked


def phase_matmul_parity(max_err: dict, device: torch.device) -> None:
    """The matmul kernels against their plain versions on the same CUDA
    tensors: every LNS variant; both limb modes on int8 limbs (the int8
    kernel), on limbs just past int8 and on limbs up to 2**20 (the wide
    kernel), on ragged shapes and at the full-width shape with M cut to
    MM_PLAIN_ROWS. Each limb call must launch the kernel that the wrapper's
    rule (`select_route`) names for its limbs, and a wide call the route
    that `launch_plan` names; then the wide kernel's routes and digit
    counts (`wide_route_parity`)."""
    from repro_torch.kernels import karatsuba_matmul as km
    from repro_torch.kernels import karatsuba_matmul_i8 as i8
    from repro_torch.kernels import mitchell_matmul as mm

    failures: list[str] = []
    checked = 0
    m, k, n = MM_SHAPE
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    def limb_check(limbs, kar: bool, what: str, route: str) -> None:
        nonlocal checked
        if i8.select_route(*limbs, karatsuba=kar) != route:
            failures.append(f"{what}: the rule does not pick {route}")
        before, routes = matmul_launches(), dict(km.ROUTE_LAUNCHES)
        got = km.karatsuba_matmul_kernel(*limbs, karatsuba=kar)
        want = km.karatsuba_matmul_plain(*limbs, karatsuba=kar)
        ran = [name for name, count in matmul_launches().items() if count != before[name]]
        if ran != [route]:
            failures.append(f"{what}: launched {ran}, expected [{route}]")
        if route == "karatsuba_matmul":
            digits = km.limb_digits(*limbs, karatsuba=kar)
            plan = km.launch_plan(limbs[0].shape[0], limbs[0].shape[1], limbs[2].shape[1],
                                  digits, sms)
            ran = {r: c - routes[r] for r, c in km.ROUTE_LAUNCHES.items() if c != routes[r]}
            if ran != {plan.route: 1}:
                failures.append(f"{what}: wide routes {ran}, the plan names {plan}")
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
    for i, shape in enumerate(LM_EDGE_SHAPES):       # the LM edges on both limb kernels
        for kar in (True, False):
            limb_check(int8_limbs(shape, kar, 75 + i, device), kar,
                       f"{shape} int8 limbs", "karatsuba_matmul_i8")
            # past int8, and within the plain version's exact float64 range up to
            # K = 28672 (sums below 2**49)
            a, b, a_lo, b_lo = mm_operands(shape, -(1 << 16), 1 << 16, 78 + i, device)
            limb_check((a, a_lo, b, b_lo), kar, f"{shape} in [-2**16, 2**16)",
                       "karatsuba_matmul")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for i, shape in enumerate(MOE_VLM_EDGE_SHAPES):  # once each: the plain version is costly
        plan = mm.launch_plan(*shape, sms)
        a, b, _, _ = mm_operands(shape, -255, 256, 90 + i, device)
        before = dict(mm.ROUTE_LAUNCHES)
        got = mm.mitchell_matmul_kernel(a, b)
        ran = {r: c - before[r] for r, c in mm.ROUTE_LAUNCHES.items() if c != before[r]}
        if ran != {plan.route: 1}:
            failures.append(f"mitchell_matmul {shape}: launched {ran}, the plan names "
                            f"{plan.route}")
        check_equal(max_err, failures, "mitchell_matmul", got, mm.mitchell_matmul_plain(a, b),
                    f"{shape} 8-bit operands ({plan})")
        log(f"[parity] mitchell_matmul {shape}: {plan}, grid {plan.grid(shape[0], shape[2])}")
        checked += 1
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
    checked += wide_route_parity(max_err, failures, device)
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


def phase_wide_main(device: torch.device) -> tuple[dict[str, int], dict[str, int], dict]:
    """`infer.forward` on both models calibrated at each of WIDE_NBITS bits,
    with each of WIDE_METHODS, whose limbs pass int8 (but schoolbook's at
    14 bits): accumulators and logits equal to the int8 oracle. Each limb
    call (`infer.runner`'s, wrapped) must launch what the wrapper's rule and
    `launch_plan` name for its limbs: the int8 kernel, or one launch of the
    wide kernel's route. -> (launches by kernel, the wide kernel's launches
    by route, and CPU copies of the limbs of the karatsuba_int16 calls at 14
    bits and the schoolbook_int16 calls at 16, keyed (call, karatsuba), for
    phase_matmul_times)."""
    from repro_torch.data.images import inference_batch
    from repro_torch.infer import MODELS, calibrate, forward, init_params, runner
    from repro_torch.kernels import karatsuba_matmul as km
    from repro_torch.kernels import karatsuba_matmul_i8 as i8

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    x_cal = inference_batch(4, INFER_HW, seed=100)
    x = inference_batch(INFER_BATCH, INFER_HW, seed=0)
    real = runner.karatsuba_matmul_kernel
    calls: list[tuple] = []          # (method, nbits, model, shape, expected, ran)
    kept: dict[tuple[str, bool], tuple] = {}
    context: dict = {}

    def counts() -> dict[str, int]:
        return {**km.ROUTE_LAUNCHES, i8.KERNEL: i8.LAUNCHES[i8.KERNEL]}

    def checked_call(a_hi, a_lo, b_hi, b_lo, *, karatsuba=True):
        limbs = (a_hi, a_lo, b_hi, b_lo)
        shape = (a_hi.shape[0], a_hi.shape[1], b_hi.shape[1])
        digits = km.limb_digits(*limbs, karatsuba=karatsuba)
        want = i8.KERNEL if digits == 1 else km.launch_plan(*shape, digits, sms).route
        before = counts()
        out = real(*limbs, karatsuba=karatsuba)
        ran = [r for r, c in counts().items() if c != before[r]]
        method, nbits, model = context["key"]
        calls.append((method, nbits, model, shape, want, ran))
        if (method, nbits) in (("karatsuba_int16", 14), ("schoolbook_int16", 16)):
            name = WIDE_CALLS[model][sum(1 for c in calls if c[:3] == context["key"]) - 1]
            kept[(name, karatsuba)] = tuple(t.cpu() for t in limbs)
        return out

    torch.cuda.synchronize()
    reset_matmul_launches()
    t0 = time.perf_counter()
    runner.karatsuba_matmul_kernel = checked_call
    try:
        for nbits in WIDE_NBITS:
            for model in ("cnn", "mlp"):
                graph = MODELS[model](INFER_HW)
                cal = calibrate(graph, init_params(graph, seed=0), x_cal, nbits=nbits,
                                device=device)
                o_logits, o_accs = forward(cal, x, "int8", collect=True)
                for method in WIDE_METHODS:
                    context["key"] = (method, nbits, model)
                    logits, accs = forward(cal, x, method, collect=True)
                    assert all(torch.equal(a, o) for a, o in zip(accs, o_accs)), \
                        f"{model} nbits={nbits}: {method} accumulators != int8 oracle"
                    assert torch.equal(logits, o_logits), f"{model} nbits={nbits}: {method} logits"
    finally:
        runner.karatsuba_matmul_kernel = real
    torch.cuda.synchronize()
    launches, routes = matmul_launches(), dict(km.ROUTE_LAUNCHES)
    log(f"[wide] cnn + mlp at nbits={WIDE_NBITS} x {WIDE_METHODS} == int8 oracle in "
        f"{time.perf_counter() - t0:.1f} s; launches {launches}, wide routes {routes}")
    for method, nbits, model, shape, want, ran in calls:
        log(f"[wide] {method} nbits={nbits} {model} {shape}: {ran} (expected {want})")
    wrong = [c for c in calls if c[5] != [c[4]]]
    assert not wrong, f"limb calls launched other than their route: {wrong}"
    assert len(calls) == len(WIDE_NBITS) * len(WIDE_METHODS) * 5, f"{len(calls)} limb calls"
    assert launches["karatsuba_matmul"] > 0 and routes["thin"] > 0, \
        f"the wide limb kernel's thin route never launched on the wide path: {launches}"
    assert len(kept) == 10, sorted(kept)
    return launches, routes, kept


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
    shapes = dict.fromkeys(shape for dense in LM_DENSE.values() for shape, _ in dense)
    for m in (LM_DECODE_M, LM_PREFILL_M):
        for k, n in shapes:
            a, b = operands(m, k, n)
            bound, by = mitchell_bound((m, k, n), int32_ops_per_s)
            row = {"kernel": "mitchell_matmul", "shape": [m, k, n], "num_ecc": 0,
                   "case_split": True, "plan": str(mm.launch_plan(m, k, n, sms)),
                   "device_ms": time_ms_batched(lambda: mm.mitchell_matmul_kernel(a, b)),
                   "call_ms": time_ms(lambda: mm.mitchell_matmul_kernel(a, b), 10),
                   "bound_ms": bound, "bound_by": by}
            if m == LM_DECODE_M:
                row["launches_a_decode_step"] = {arch: per_step for arch, dense in LM_DENSE.items()
                                                 for shape, per_step in dense if shape == (k, n)}
                # the plain version forms every element product: cheap at
                # M = 4, 1.5e11 of them over the prefill shapes (not timed)
                row["plain_ms"] = time_ms(lambda: mm.mitchell_matmul_plain(a, b), 1, warmup=0)
            results[("mitchell_lm", m, k, n)] = row
            log(json.dumps(row))
    results["mitchell_decode_step"] = {}
    for arch, dense in LM_DENSE.items():
        rows = [(results[("mitchell_lm", LM_DECODE_M, k, n)], per_step)
                for (k, n), per_step in dense]
        step = {"ms": sum(row["device_ms"] * per_step for row, per_step in rows),
                "bound_ms": lm_step_bound(arch, int32_ops_per_s),
                "calls": sum(per_step for _, per_step in rows)}
        results["mitchell_decode_step"][arch] = step
        log(f"[times] mitchell_matmul a {arch} decode step (batch 4, {step['calls']} calls): "
            f"{step['ms']:.6f} ms summed (device ms a call x launches), bound "
            f"{step['bound_ms']:.6f} ms")
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


def phase_matmul_times(x: torch.Tensor, w: torch.Tensor, int32_ops_per_s: float,
                       wide_kept: dict) -> dict[tuple, dict]:
    """Each matmul kernel at the full-width shape on the operands the main
    path quantized, beside its plain version, its bound and, for the limb
    kernels, torch._int_mm on the int8 limbs (B row-major as the limbs lie,
    and column-major, cuBLAS's faster layout). The int8 kernel is timed
    through the wrapper (pack, range-check sync, product) and its two steps
    apart; then the wide kernel (`wide_times`)."""
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
    results.update(wide_times(wide_kept, x, int32_ops_per_s))
    return results


def wide_bound(shape: tuple[int, int, int], karatsuba: bool, plan,
               int32_ops_per_s: float) -> tuple[float, str]:
    """(bound ms, what bounds it) of one wide call: the larger of its bytes
    (four int32 limb arrays in, three int32 arrays out) over the memory rate
    and its work: on the thin route one multiply-add on the INT32 lanes per
    partial product (3 or 4 a (m, k, n)), on the digit route 2 int8
    operations per digit pair and partial product at the int8 rate."""
    m, k, n = shape
    passes = 3 if karatsuba else 4
    bytes_ms = 4 * (2 * m * k + 2 * k * n + 3 * m * n) / HBM_BYTES_PER_S * 1e3
    if plan.route == "thin":
        ops_ms = passes * m * k * n / int32_ops_per_s * 1e3
    else:
        ops_ms = passes * plan.pairs() * 2 * m * k * n / INT8_OPS_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def float64_library(limbs, karatsuba: bool):
    """3 (Karatsuba) or 4 float64 torch.matmul calls on the limbs cast
    beforehand, the same partial sums, if they are exact (every partial sum
    below 2**53: K max|a| max|b|); -> (the call or None, what it is)."""
    ah, al, bh, bl = (t.to(torch.float64) for t in limbs)
    pairs = [(ah, bh), (al, bl)]
    pairs += [(ah + al, bh + bl)] if karatsuba else [(ah, bl), (al, bh)]
    k = ah.shape[1]
    worst = max(k * float(a.abs().max()) * float(b.abs().max()) for a, b in pairs)
    if worst >= 2.0 ** 53:
        return None, f"none: K max|a| max|b| = {worst:.3g} >= 2**53, float64 not exact"
    return (lambda: [a @ b for a, b in pairs]), (
        f"{len(pairs)} float64 torch.matmul on the limbs cast beforehand")


def wide_times(kept: dict, x: torch.Tensor, int32_ops_per_s: float) -> dict[tuple, dict]:
    """The wide limb kernel at the five [wide] calls, on the limbs that path
    made (karatsuba_int16 at 14 bits, schoolbook_int16 at 16), and at
    MM_SHAPE on 2-digit limbs (the main path's x and a seeded B, quantized
    to +-WIDE_Q16) and full-range int32 limbs (4 digits): device ms of the
    route `launch_plan` names (10 calls queued while the card is held) and
    ms of the wrapper (pack, sync, route; CUDA events), the pack step alone,
    the other route where it runs (the threshold THIN_MAX_N), the plain
    version, the bound and the float64 library. At the five calls also the
    same shapes on int8 limbs (the limbs clamped to [-64, 63]): the thin
    route beside the int8 route the 8-bit infer path takes there (recorded,
    not routed). [wide-time] lines."""
    from repro_torch.core.quant import balanced_limbs
    from repro_torch.kernels import karatsuba_matmul as km
    from repro_torch.kernels import karatsuba_matmul_i8 as i8

    device = x.device
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    m, k, n = MM_SHAPE
    rng = np.random.default_rng(29)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(device)
    cases = [((name, kar), tuple(t.to(device) for t in limbs), True)
             for (name, kar), limbs in kept.items()]
    for kar in (True, False):
        big = []
        for t in (x, w):
            q = torch.round(t / (float(t.abs().max()) / WIDE_Q16)).to(torch.int32)
            big += list(balanced_limbs(q, 7 if kar else 8))
        cases.append((("2048x896x4864 q16", kar), tuple(big), False))
        cases.append((("2048x896x4864 full", kar),
                      tuple(wide_limbs(MM_SHAPE, 1 << 31, 30 + kar, device)), False))
    results = {}
    for (name, kar), limbs, on_path in cases:
        shape = (limbs[0].shape[0], limbs[0].shape[1], limbs[2].shape[1])
        digits = km.limb_digits(*limbs, karatsuba=kar)
        plan = km.launch_plan(*shape, digits, sms)
        bound, by = wide_bound(shape, kar, plan, int32_ops_per_s)
        library, what = float64_library(limbs, kar)
        plain = km.digit_product_plain if digits == 4 else km.karatsuba_matmul_plain
        row = {"kernel": "karatsuba_matmul", "call": name, "shape": list(shape),
               "karatsuba": kar, "digits": digits, "plan": str(plan),
               "device_ms": time_ms_batched(lambda: km.run_plan(*limbs, plan, karatsuba=kar)),
               "call_ms": time_ms(lambda: km.karatsuba_matmul_kernel(*limbs, karatsuba=kar), 10),
               "pack_device_ms": time_ms_batched(
                   lambda: i8.pack_async(*limbs, karatsuba=kar)),
               # past 2**53 the float64 plain route is not exact: the digit route's
               "plain_ms": time_ms(lambda: plain(*limbs, karatsuba=kar), 3, warmup=1),
               "plain": plain.__name__, "bound_ms": bound, "bound_by": by,
               "library_ms": time_ms(library, 10) if library else None, "library": what}
        for other in ("thin", "digits"):
            if other != plan.route and (other == "digits" or shape[2] <= km.THIN_MAX_N):
                alt = km.route_plan(other, *shape, digits, sms)
                row[f"{other}_device_ms"] = time_ms_batched(
                    lambda: km.run_plan(*limbs, alt, karatsuba=kar))
        if on_path:
            l8 = tuple(t.clamp(-64, 63) for t in limbs)
            packed = i8.pack(*l8, karatsuba=kar)
            assert packed is not None
            thin = km.route_plan("thin", *shape, 1, sms)
            row["int8_limbs"] = {
                "thin_device_ms": time_ms_batched(lambda: km.run_plan(*l8, thin, karatsuba=kar)),
                "int8_call_ms": time_ms(lambda: km.karatsuba_matmul_kernel(*l8, karatsuba=kar),
                                        10),
                "int8_pack_device_ms": time_ms_batched(lambda: i8.pack_async(*l8, karatsuba=kar)),
                "int8_product_device_ms": time_ms_batched(lambda: i8.product(packed))}
            del l8, packed
        results[("karatsuba_matmul", name, kar)] = row
        log("[wide-time] " + json.dumps(row))
        del library
        torch.cuda.empty_cache()
    return results


def stamp(t_start: float, what: str) -> None:
    """The host seconds since the script's start, after `what`."""
    log(f"[time] {what} done at {time.perf_counter() - t_start:.1f} s (host clock)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401 -- fails here when run without the repository
    t_start = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    kind, smi, int32_ops_per_s = phase_card()
    phase_build()
    stamp(t_start, 'phase_build')
    dryrun = dryrun_cli()
    from repro_torch.filters.conv import KERNELS
    max_err = dict.fromkeys(KERNELS + MATMUL_KERNELS, 0)
    phase_parity(max_err)
    stamp(t_start, 'phase_parity')
    phase_recurse_parity(max_err)
    stamp(t_start, 'phase_recurse_parity')
    phase_range_parity(max_err)
    stamp(t_start, 'phase_range_parity')
    phase_matmul_parity(max_err, device)
    stamp(t_start, 'phase_matmul_parity')
    launches, main_frames = phase_main(device)
    main_routes = route_launches()
    stamp(t_start, 'route_launches')
    phase_batch_fold(main_frames)
    stamp(t_start, 'phase_batch_fold')
    mm_launches, (x, w) = phase_matmul_main(device)
    infer_launches = phase_infer_main(device)
    stamp(t_start, 'phase_infer_main')
    for name in ("mitchell_matmul", "karatsuba_matmul_i8"):
        launches[name] = mm_launches[name] + infer_launches[name]
    wide_launches, wide_routes, wide_kept = phase_wide_main(device)
    launches["karatsuba_matmul"] = wide_launches["karatsuba_matmul"]
    stamp(t_start, 'phase_wide_main')
    scale_frames = phase_scale(device)
    stamp(t_start, 'phase_scale')
    inputs = {MAIN_SHAPE: main_frames, SCALE_SHAPE: scale_frames}
    tile_times = phase_tiles(inputs, max_err)
    stamp(t_start, 'phase_tiles')
    phase_tune(inputs)
    stamp(t_start, 'phase_tune')
    phase_sharded(inputs)
    stamp(t_start, 'phase_sharded')
    phase_streamed()
    stamp(t_start, 'phase_streamed')
    serve_launches = phase_serve(device)
    phase_pool(device)
    stamp(t_start, 'phase_pool')
    lm_launches, lm_mitchell_ms = phase_lm(device, max_err, int32_ops_per_s)
    stamp(t_start, 'phase_lm')
    train_launches, train_mitchell_ms, train_numbers = phase_train(device, max_err,
                                                                   int32_ops_per_s)
    stamp(t_start, 'phase_train')
    mesh_launches = phase_mesh(device, max_err, smi, train_numbers)
    stamp(t_start, 'phase_mesh')
    dryrun_launches = phase_dryrun(device, max_err, smi, train_numbers, dryrun)
    stamp(t_start, 'phase_dryrun')
    times = phase_times({MAIN_SHAPE: main_frames, SCALE_SHAPE: scale_frames},
                        int32_ops_per_s)
    stamp(t_start, 'phase_times')
    mm_times = phase_matmul_times(x, w, int32_ops_per_s, wide_kept)
    del wide_kept
    stamp(t_start, 'phase_matmul_times')
    train_times = train_kernel_times(int32_ops_per_s, device, max_err)["train_step"]
    stamp(t_start, 'train_kernel_times')
    log(f"[times] mitchell_matmul a {TRAIN_ARCH} train step: {train_times['mitchell_matmul']:.6f} "
        f"ms summed at its shapes, " + ("not measured" if train_mitchell_ms is None
                                        else f"{train_mitchell_ms:.6f} ms")
        + f" under the [train] profiler; bound {train_times['mitchell_bound_ms']:.6f} ms")
    steps = mm_times["mitchell_decode_step"]
    for arch, step in steps.items():
        step["lm_device_ms"] = lm_mitchell_ms[arch]
        log(f"[times] mitchell_matmul a {arch} decode step: {step['ms']:.6f} ms summed at "
            f"its shapes, " + ("not measured" if step["lm_device_ms"] is None
                               else f"{step['lm_device_ms']:.6f} ms")
            + f" under the [lm] profiler; bound {step['bound_ms']:.6f} ms")
    step = steps[LM_ARCHS[0]]
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
            "train_launches": 0, "tile_launches": main_routes[name],
            "tile_device_ms": {row["tile"]: row["device_ms"] for (k, _, shape, _), row
                               in tile_times.items() if k == name and shape == SCALE_SHAPE
                               and row["filter"] in ("fig9", "gaussian5")},
        })
    wide_rows = [mm_times[("karatsuba_matmul", name, True)]
                 for names in WIDE_CALLS.values() for name in names]
    libs = [row["library_ms"] for row in wide_rows]
    mm_times["karatsuba_matmul"] = {
        "kernel_ms": sum(row["device_ms"] for row in wide_rows),
        "plain_ms": sum(row["plain_ms"] for row in wide_rows),
        "bound_ms": sum(row["bound_ms"] for row in wide_rows),
        # what bounds the rows that hold most of the summed bound
        "bound_by": max(("bytes", "operations"), key=lambda by: sum(
            r["bound_ms"] for r in wide_rows if r["bound_by"] == by)),
        "library_ms": None if None in libs else sum(libs)}
    for name, key in (("mitchell_matmul", ("mitchell_matmul", 0, True)),
                      ("karatsuba_matmul", "karatsuba_matmul"),
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
            "lm_launches": lm_launches[name], "train_launches": train_launches[name],
            "mesh_train_launches": mesh_launches[name],
            "serve_mesh_launches": dryrun_launches[name],
            **({"decode_step_ms": step["ms"], "decode_step_bound_ms": step["bound_ms"],
                "lm_decode_step_device_ms": step["lm_device_ms"],
                "decode_step_by_arch": steps,
                "train_step_ms": train_times["mitchell_matmul"],
                "train_step_bound_ms": train_times["mitchell_bound_ms"],
                "train_step_device_ms": train_mitchell_ms}
               if name == "mitchell_matmul" else {}),
            **({"shape": "the five [wide] calls of a karatsuba_int16 forward at 14 bits, "
                         "summed (device ms)",
                "route_launches": wide_routes,
                "wide_calls": [row for key, row in mm_times.items()
                               if isinstance(key, tuple) and len(key) == 3
                               and key[0] == "karatsuba_matmul"]}
               if name == "karatsuba_matmul" else {}),
        })
    log(f"[time] chip_smoke {time.perf_counter() - t_start:.1f} s (host clock)")
    log(smi)                    # the card's name and power limit, again at the end
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
