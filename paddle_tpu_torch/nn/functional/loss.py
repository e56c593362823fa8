"""Loss functions — port of ``paddle_tpu.nn.functional.loss`` (the hard-
label ``cross_entropy`` that BERT's QA head and a ``CrossEntropyLoss``
layer need)."""
from __future__ import annotations

import torch

from ...framework.errors import InvalidArgumentError, UnimplementedError

__all__ = ["cross_entropy"]


def cross_entropy(input, label, ignore_index: int = -100,
                  reduction: str = "mean"):
    """Parity: ``paddle.nn.functional.cross_entropy`` with hard labels over
    the last axis.

    ``-log_softmax(input)[label]`` (computed in the input's dtype, as the
    JAX package does); ``label`` may carry a size-1 class axis.  Entries
    equal to ``ignore_index`` contribute 0, and ``"mean"`` divides by the
    number of the others (at least 1).  ``reduction``: ``"mean"``,
    ``"sum"`` or ``"none"``.
    """
    if reduction not in ("mean", "sum", "none"):
        raise InvalidArgumentError(
            f"reduction must be 'mean', 'sum' or 'none', got {reduction!r}")
    if label.is_floating_point():
        raise UnimplementedError(
            "cross_entropy: soft labels are not ported yet (ROADMAP queue "
            "A, training step)")
    logp = torch.log_softmax(input, dim=-1)
    lbl = label
    if lbl.dim() == input.dim() and lbl.shape[-1] == 1:
        lbl = lbl.squeeze(-1)
    safe = lbl.long().clamp(0, input.shape[-1] - 1)
    loss = -torch.gather(logp, -1, safe.unsqueeze(-1)).squeeze(-1)
    mask = lbl != ignore_index
    loss = torch.where(mask, loss, torch.zeros_like(loss))
    if reduction == "mean":
        return loss.sum() / mask.to(logp.dtype).sum().clamp_min(1.0)
    return loss.sum() if reduction == "sum" else loss
