"""Layers of the port: ``nn.Layer`` subclasses (``torch.nn.Module``\\ s
whose call applies the amp policy) with the JAX package's class names,
parameter names and layouts."""
from . import functional, initializer
from .activation import GELU, ReLU, Tanh
from .common import Dropout, Embedding, Linear
from .container import Sequential
from .initializer import ParamAttr
from .conv import Conv2D
from .layer import Layer
from .loss import CrossEntropyLoss
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   LayerNorm)
from .pooling import AdaptiveAvgPool2D, MaxPool2D

__all__ = ["Layer", "Linear", "Embedding", "Dropout", "LayerNorm", "GELU",
           "Tanh", "ReLU", "CrossEntropyLoss", "Conv2D", "MaxPool2D",
           "AdaptiveAvgPool2D", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "Sequential", "functional", "initializer",
           "ParamAttr"]
