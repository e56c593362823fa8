"""Layers of the port (``torch.nn.Module``\\ s with the JAX package's
parameter names and layouts)."""
from .activation import GELU
from .common import Dropout, Embedding, Linear
from .norm import LayerNorm

__all__ = ["Linear", "Embedding", "Dropout", "LayerNorm", "GELU"]
