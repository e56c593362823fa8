"""Model compression (port of ``paddle_tpu.slim``): the serving half —
int8 / fp8-e4m3 weight quantization of the parallel-linear layers and
the quantized weight artifact for hot swaps."""
from .quantization import (QUANT_MODES, export_quantized, quantize_model,
                           quantize_to_fp8, quantize_to_int8,
                           quantize_weights)

__all__ = ["QUANT_MODES", "quantize_to_int8", "quantize_to_fp8",
           "quantize_weights", "quantize_model", "export_quantized"]
