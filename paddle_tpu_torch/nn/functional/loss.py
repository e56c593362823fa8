"""Loss functions — port of ``paddle_tpu.nn.functional.loss``'s
``cross_entropy`` and ``softmax_with_cross_entropy`` with the JAX
package's full signature: hard or soft labels, per-class ``weight``,
``axis``, ``use_softmax=False`` (the input is already probabilities) and
``label_smoothing``."""
from __future__ import annotations

import torch

from ...framework.errors import InvalidArgumentError

__all__ = ["cross_entropy", "softmax_with_cross_entropy"]


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise InvalidArgumentError(
        f"reduction must be 'mean', 'sum' or 'none', got {reduction!r}")


def cross_entropy(input, label, weight=None, ignore_index: int = -100,
                  reduction: str = "mean", soft_label: bool = False,
                  axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0, name=None):
    """Parity: ``paddle.nn.functional.cross_entropy``, the JAX package's
    arithmetic (in the input's dtype).

    ``log_softmax(input)`` over ``axis`` (``use_softmax=False``: ``log``
    of the input clipped at 1e-15).  Soft labels: ``-sum(label · logp)``.
    Hard labels (``label`` may carry a size-1 class axis): the label's
    ``-logp``, or with ``label_smoothing`` ε ``-sum(((1 - ε)·onehot +
    ε/C) · logp)``; times ``weight[label]`` where given; entries equal to
    ``ignore_index`` give 0, and ``"mean"`` divides by the weights of the
    others (without ``weight``: their number, at least 1).
    """
    if reduction not in ("mean", "sum", "none"):
        raise InvalidArgumentError(
            f"reduction must be 'mean', 'sum' or 'none', got {reduction!r}")
    input = torch.as_tensor(input)
    label = torch.as_tensor(label, device=input.device)
    axis = axis % input.dim()
    logp = (torch.log_softmax(input, dim=axis) if use_softmax
            else torch.log(input.clamp_min(1e-15)))
    if soft_label:
        return _reduce(-(label.to(logp.dtype) * logp).sum(axis), reduction)
    lbl = label
    if lbl.dim() == input.dim() and lbl.shape[axis] == 1:
        lbl = lbl.squeeze(axis)
    n = input.shape[axis]
    safe = lbl.long().clamp(0, n - 1)
    if label_smoothing > 0.0:
        onehot = torch.nn.functional.one_hot(safe, n).to(logp.dtype)
        onehot = torch.where((lbl >= 0).unsqueeze(-1) & (
            lbl < n).unsqueeze(-1), onehot, torch.zeros_like(onehot))
        onehot = onehot.movedim(-1, axis)
        smoothed = onehot * (1 - label_smoothing) + label_smoothing / n
        loss = -(smoothed * logp).sum(axis)
    else:
        loss = -torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
    w = None
    if weight is not None:
        w = torch.as_tensor(weight, device=logp.device).to(logp.dtype)[safe]
        loss = loss * w
    mask = lbl != ignore_index
    loss = torch.where(mask, loss, torch.zeros_like(loss))
    if reduction == "mean":
        if w is not None:
            denom = torch.where(mask, w, torch.zeros_like(w)).sum()
        else:
            denom = mask.to(logp.dtype).sum().clamp_min(1.0)
        return loss.sum() / denom
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label: bool = False,
                               ignore_index: int = -100,
                               numeric_stable_mode: bool = True,
                               return_softmax: bool = False, axis: int = -1):
    """Parity: ``paddle.nn.functional.softmax_with_cross_entropy``: the
    per-entry loss with the class axis kept (size 1); with
    ``return_softmax`` the softmax beside it."""
    logits = torch.as_tensor(logits)
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis % logits.dim())
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss
