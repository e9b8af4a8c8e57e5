"""The nvcc build of the CUDA kernels (`build`) and the legacy Gaussian
entry point of the paper's Fig. 9 experiment (`gaussian_conv`, `ops`)."""
