"""LayerNorm — port of ``paddle_tpu.nn.norm.LayerNorm``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["LayerNorm"]


class LayerNorm(torch.nn.Module):
    """Normalizes over the last dim; ``weight`` ones, ``bias`` zeros."""

    def __init__(self, normalized_shape: int, epsilon: float = 1e-5):
        super().__init__()
        self.normalized_shape = (int(normalized_shape),)
        self.epsilon = float(epsilon)
        self.weight = torch.nn.Parameter(torch.empty(self.normalized_shape))
        self.bias = torch.nn.Parameter(torch.empty(self.normalized_shape))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)
