"""Detection ops — port of ``paddle_tpu.nn.functional.detection``: so
far only ``sigmoid_focal_loss``, which shadows ``loss.py``'s in
``nn.functional`` (and so in ``fluid.layers``) as in the JAX package; the
rest of the module is ROADMAP queue A item 2's tail."""
from __future__ import annotations

import torch

from ...tensor._common import t as _t

__all__ = ["sigmoid_focal_loss"]


def sigmoid_focal_loss(x, label, fg_num, gamma=2.0, alpha=0.25):
    """Dense-detection focal loss ``[N, C]``: x ``[N, C]`` logits, label
    ``[N, 1]`` with classes 1..C (0: background, a negative for every
    class; -1: ignored), scaled by ``1 / max(fg_num, 1)``."""
    x = _t(x)
    label = _t(label, x).reshape(-1, 1)
    fg = torch.clamp_min(_t(fg_num, x).to(x.dtype).reshape(()), 1.0)
    d = torch.arange(x.shape[1], device=x.device)[None, :]
    c_pos = (label == d + 1).to(x.dtype)
    c_neg = ((label != -1) & (label != d + 1)).to(x.dtype)
    p = torch.sigmoid(x)
    term_pos = torch.pow(1.0 - p, gamma) * torch.log(torch.clamp_min(p,
                                                                     1e-37))
    pos = (x >= 0).to(x.dtype)
    log1mp = -x * pos - torch.log1p(torch.exp(x - 2.0 * x * pos))
    term_neg = torch.pow(p, gamma) * log1mp
    return -(c_pos * term_pos * (alpha / fg)
             + c_neg * term_neg * ((1.0 - alpha) / fg))
