"""Functional ops of the port (the parts the ported models call)."""
from .attention import scaled_dot_product_attention
from .common import embedding
from .conv import conv2d
from .loss import cross_entropy
from .norm import batch_norm
from .pooling import adaptive_avg_pool2d, max_pool2d

__all__ = ["cross_entropy", "embedding", "conv2d", "batch_norm", "max_pool2d",
           "adaptive_avg_pool2d", "scaled_dot_product_attention"]
