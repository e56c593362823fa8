"""Kernels of the port: hand-written CUDA for Hopper (``csrc/``), each
with a plain PyTorch version beside it, built by ``_build`` on first use
(``nms_sweep``, NMS's keep loop, has no TPU kernel behind it)."""
from .flash_attention import (flash_attention, flash_attention_bwd_chunk,
                              flash_attention_bwd_ref,
                              flash_attention_fwd_lse,
                              flash_attention_fwd_lse_ref,
                              flash_attention_ref)
from .fused_conv1x1_bn import (bn_apply_relu, bn_apply_relu_ref,
                               conv1x1_bn_relu, conv1x1_bn_relu_ref,
                               conv1x1_bn_stats, conv1x1_bn_stats_ref)
from .fused_layernorm import layernorm_residual, layernorm_residual_ref
from .fused_softmax_xent import (softmax_cross_entropy,
                                 softmax_cross_entropy_ref)
from .grouped_matmul import grouped_matmul, grouped_matmul_ref
from .nms_sweep import nms_sweep, nms_sweep_ref
from .paged_attention import paged_flash_decode, paged_flash_decode_ref
from .quantized_matmul import (fp8_matmul, quantize_activations,
                               quantized_linear, quantized_linear_ref,
                               quantized_matmul)

__all__ = ["paged_flash_decode", "paged_flash_decode_ref",
           "layernorm_residual", "layernorm_residual_ref",
           "softmax_cross_entropy", "softmax_cross_entropy_ref",
           "quantized_linear", "quantized_linear_ref", "quantized_matmul",
           "fp8_matmul", "quantize_activations", "conv1x1_bn_stats",
           "conv1x1_bn_stats_ref", "bn_apply_relu", "bn_apply_relu_ref",
           "conv1x1_bn_relu", "conv1x1_bn_relu_ref", "flash_attention",
           "flash_attention_ref", "flash_attention_fwd_lse",
           "flash_attention_fwd_lse_ref", "flash_attention_bwd_chunk",
           "flash_attention_bwd_ref", "grouped_matmul", "grouped_matmul_ref",
           "nms_sweep", "nms_sweep_ref"]
