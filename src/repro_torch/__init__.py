"""repro_torch -- the REFMLM datapaths on PyTorch and CUDA.

A port of the JAX package `repro` to PyTorch, with every Pallas kernel
rewritten as a CUDA C++ kernel for Hopper (`csrc/`). Module names follow
the JAX package so each module's counterpart is easy to find:

  core/      the multiplier family (Mitchell, Babic BB+kECC, ODMA, REFMLM),
             the KCM product ROMs, the KOM scaffold, LNS codecs, the
             quantizers, and `matmul` over the family;
  filters/   the filter bank, the conv passes (CUDA kernel + plain PyTorch
             version of each), the `apply_filter` pipeline and its oracle;
  kernels/   the nvcc build of `csrc/`, the two matmul kernels
             (`mitchell_matmul`, `karatsuba_matmul`) with their plain
             versions and oracles, `lns_matmul` / `limb_matmul`, and the
             legacy Gaussian entry point;
  infer/     quantized inference: layer graphs, static-scale calibration,
             the routed forward (on the matmul kernels), the error report;
  tuning/    execution-plan resolution;
  data/      synthetic fingerprint images, inference batches and PSNR;
  convert    carries reference filter specs and calibrated models across.

Entry points run on the CUDA card unless the caller passes `device="cpu"`;
with no card and no explicit device they raise. This package never imports
`jax` or `repro`.
"""
