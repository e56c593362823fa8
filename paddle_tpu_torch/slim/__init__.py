"""Model compression (port of ``paddle_tpu.slim``): quantization — the
serving weight quantization and its artifact, quantization-aware training,
post-training quantization and the int8 inference layers."""
from . import quantization  # noqa: F401
from .quantization import (  # noqa: F401
    FP8_E4M3_MAX,
    QUANT_MODES,
    FakeQuantAbsMax,
    FakeQuantChannelWiseAbsMax,
    FakeQuantMovingAverage,
    ImperativeQuantAware,
    Int8Conv2D,
    Int8Linear,
    MovingAverageAbsMaxScale,
    PostTrainingQuantization,
    QuantizedConv2D,
    QuantizedLinear,
    export_quantized,
    fake_quant_dequant,
    quantize_model,
    quantize_model_trees,
    quantize_to_fp8,
    quantize_to_int8,
    quantize_weights,
)

__all__ = quantization.__all__
