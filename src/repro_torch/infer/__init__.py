"""repro_torch.infer -- quantized inference on the approximate-multiplier
stack: layer graphs, static-scale calibration, the per-layer routed forward
runner (on the `mitchell_matmul` and `karatsuba_matmul` kernels on the
card) and the Table-10-style error report. Counterpart of `repro.infer`;
its serving adapter (`InferWorkload`) is not ported yet."""
from repro_torch.infer.calibrate import (
    CalibratedModel,
    LayerQuant,
    calibrate,
    export_scales,
    float_forward,
    with_scales,
)
from repro_torch.infer.graph import (
    MODELS,
    Conv,
    Dense,
    Flatten,
    LayerGraph,
    cnn_classifier,
    init_params,
    mlp_head,
)
from repro_torch.infer.report import error_report, format_report
from repro_torch.infer.runner import INFER_METHODS, forward

__all__ = [
    "CalibratedModel", "Conv", "Dense", "Flatten", "INFER_METHODS",
    "LayerGraph", "LayerQuant", "MODELS", "calibrate", "cnn_classifier",
    "error_report", "export_scales", "float_forward", "format_report",
    "forward", "init_params", "mlp_head", "with_scales",
]
