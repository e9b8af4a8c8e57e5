"""repro_torch -- the REFMLM image-filter datapath on PyTorch and CUDA.

A port of the JAX package `repro` to PyTorch, with the Pallas conv kernels
rewritten as CUDA C++ kernels for Hopper (`csrc/`). Module names follow the
JAX package so each module's counterpart is easy to find:

  core/      the multiplier family (Mitchell, Babic BB+kECC, ODMA, REFMLM)
             and the KCM product ROMs built by the selected multiplier;
  filters/   the filter bank, the conv passes (CUDA kernel + plain PyTorch
             version of each), the `apply_filter` pipeline and its oracle;
  kernels/   the nvcc build of `csrc/` and the legacy Gaussian entry point;
  tuning/    execution-plan resolution;
  data/      synthetic fingerprint images and the PSNR metric.

Entry points run on the CUDA card unless the caller passes `device="cpu"`;
with no card and no explicit device they raise. This package never imports
`jax` or `repro`.
"""
