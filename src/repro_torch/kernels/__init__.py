"""The port's kernels: the nvcc build of `csrc/` (`build`), the two matmul
kernels with their plain versions (`mitchell_matmul`, `karatsuba_matmul`),
their oracles under the reference's names (`ref`), the legacy Gaussian
entry point of the paper's Fig. 9 experiment (`gaussian_conv`), and the
float-in / float-out entry points (`ops`), re-exported here.

The re-exports resolve on first access: `ops` imports the filter pipeline,
whose conv passes import `kernels.build`, so loading `ops` with this
package would be circular.
"""
__all__ = ["apply_filter", "filter_bank_apply", "gaussian_filter",
           "gaussian_kernel_3x3", "limb_matmul", "lns_matmul"]


def __getattr__(name: str):
    if name in __all__:
        from repro_torch.kernels import ops
        return getattr(ops, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
