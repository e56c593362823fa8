"""GELU — port of ``paddle_tpu.nn.activation.GELU``.

The JAX package's default — the one GPT uses — is the exact (erf) form
(``jax.nn.gelu(x, approximate=False)``), which is also
``torch.nn.functional.gelu``'s default; the tanh form is not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["GELU"]


class GELU(torch.nn.Module):
    def forward(self, x):
        return F.gelu(x)
