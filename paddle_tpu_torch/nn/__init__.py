"""Layers of the port (``torch.nn.Module``\\ s with the JAX package's
parameter names and layouts)."""
from . import functional
from .activation import GELU, Tanh
from .common import Dropout, Embedding, Linear
from .layer import Layer
from .loss import CrossEntropyLoss
from .norm import LayerNorm

__all__ = ["Layer", "Linear", "Embedding", "Dropout", "LayerNorm", "GELU",
           "Tanh", "CrossEntropyLoss", "functional"]
