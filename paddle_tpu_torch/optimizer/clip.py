"""Gradient clipping strategies (port of ``paddle_tpu.optimizer.clip``).

Parity: paddle.nn.ClipGradByValue / ClipGradByNorm / ClipGradByGlobalNorm
(reference: python/paddle/fluid/clip.py).  Each is a function from a
``{name: grad}`` dict to a new one; the optimizer calls it on the whole
dict before its step count advances.  Norms are taken in float32 whatever
the grad dtype, and the scale stays a device tensor (no host sync).  A
SelectedRows gradient (a sparse table's) is merged first — its duplicate
ids summed — so a norm counts each row once and a clamp acts on the
summed row; the clips return it merged.
"""
from __future__ import annotations

import torch

from ..framework.selected_rows import SelectedRows

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]


def _sq_norm(g):
    if isinstance(g, SelectedRows):
        return g.merged().l2_norm_sq()
    return g.float().square().sum()


def _scaled(g, scale):
    if isinstance(g, SelectedRows):
        g = g.merged()
        return SelectedRows(g.ids, (g.values.float() * scale).to(g.dtype),
                            g.height, _merged=True)
    return (g.float() * scale).to(g.dtype)


def _clamped(g, lo, hi):
    if isinstance(g, SelectedRows):
        g = g.merged()  # clamp the summed row gradient, not its parts
        return SelectedRows(g.ids, g.values.clamp(lo, hi), g.height,
                            _merged=True)
    return g.clamp(lo, hi)


class ClipGradByValue:
    """Clamp every gradient element into [min, max]."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, grads):
        return {k: _clamped(g, self.min, self.max)
                for k, g in grads.items()}

    def __repr__(self):
        return f"ClipGradByValue(min={self.min}, max={self.max})"


class ClipGradByNorm:
    """Rescale each gradient independently to at most clip_norm (L2)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, grads):
        out = {}
        for k, g in grads.items():
            norm = _sq_norm(g).sqrt()
            scale = (self.clip_norm / norm.clamp_min(1e-12)).clamp_max(1.0)
            out[k] = _scaled(g, scale)
        return out

    def __repr__(self):
        return f"ClipGradByNorm(clip_norm={self.clip_norm})"


class ClipGradByGlobalNorm:
    """Rescale ALL gradients jointly so the global L2 norm is at most
    clip_norm: ``scale = clip_norm / max(gnorm, clip_norm)``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, grads):
        if not grads:
            return grads
        gnorm = torch.stack([_sq_norm(g) for g in grads.values()]).sum()
        gnorm = gnorm.sqrt()
        scale = self.clip_norm / gnorm.clamp_min(self.clip_norm)
        return {k: _scaled(g, scale) for k, g in grads.items()}

    def __repr__(self):
        return f"ClipGradByGlobalNorm(clip_norm={self.clip_norm})"
