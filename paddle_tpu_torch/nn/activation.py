"""Activations — ports of ``paddle_tpu.nn.activation`` (GELU, Tanh, ReLU).

GELU: the JAX package's default — the one GPT and BERT use — is the exact
(erf) form (``jax.nn.gelu(x, approximate=False)``), which is also
``torch.nn.functional.gelu``'s default; the tanh form is not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layer import Layer

__all__ = ["GELU", "Tanh", "ReLU"]


class GELU(Layer):
    def forward(self, x):
        return F.gelu(x)


class Tanh(Layer):
    def forward(self, x):
        return torch.tanh(x)


class ReLU(Layer):
    def forward(self, x):
        return torch.relu(x)
