"""repro_torch.core -- the REFMLM multiplier family on torch integer tensors.

  mitchell / babic_bb / babic_ecc     (paper §2.1-2.2, baseline [18])
  odma                                (baseline [19])
  refmlm / efmlm2 / mlm2              (paper §3, the artifact)
  kcm.tap_multiplier / product_table  (constant-coefficient product ROMs)
  karatsuba.kom / lns / quant         (KOM scaffold, log codecs, quantizers)
  matmul(a, b, method=...)            (the multipliers as a matmul, on the
                                       matmul kernels for impl='kernel'/'auto')
"""
from repro_torch.core.approx_matmul import METHODS, matmul
from repro_torch.core.mitchell import babic_bb, babic_ecc, mitchell
from repro_torch.core.odma import odma
from repro_torch.core.refmlm import efmlm2, mlm2, refmlm

__all__ = ["METHODS", "babic_bb", "babic_ecc", "efmlm2", "matmul", "mitchell",
           "mlm2", "odma", "refmlm"]
