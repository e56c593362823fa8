"""paddle.regularizer — L1Decay / L2Decay (port of
``paddle_tpu.regularizer``).

Pass an instance as ``weight_decay=`` to an optimizer (a bare float keeps
meaning L2): the optimizer adds the penalty gradient ``dP/dw`` to each
parameter's gradient before its update rule.
"""
from __future__ import annotations

import torch

__all__ = ["WeightDecayRegularizer", "L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    """Base: maps a parameter value to its penalty gradient dP/dw."""

    def __call__(self, w):
        raise NotImplementedError


class L1Decay(WeightDecayRegularizer):
    """P = coeff * ||w||_1 → dP/dw = coeff * sign(w)."""

    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)

    def __call__(self, w):
        return self.coeff * torch.sign(w)

    def __repr__(self):
        return f"L1Decay(coeff={self.coeff})"


class L2Decay(WeightDecayRegularizer):
    """P = 0.5 * coeff * ||w||² → dP/dw = coeff * w."""

    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)

    def __call__(self, w):
        return self.coeff * w

    def __repr__(self):
        return f"L2Decay(coeff={self.coeff})"
