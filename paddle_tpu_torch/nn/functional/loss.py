"""Loss functions — port of ``paddle_tpu.nn.functional.loss``, with the
JAX package's arithmetic, reductions and defaults.  ``cross_entropy``
and ``softmax_with_cross_entropy`` take the JAX package's full signature:
hard or soft labels, per-class ``weight``, ``axis``, ``use_softmax=False``
(the input is already probabilities) and ``label_smoothing``.
``ctc_loss`` runs the CTC forward recursion in log space one time step
after another (the JAX package's ``lax.scan``), differentiable by
autograd; ``hsigmoid_loss`` walks the default complete binary tree in
exact integer arithmetic, or a custom tree's ``path_table`` /
``path_code``."""
from __future__ import annotations

import math

import torch

from ...framework.errors import InvalidArgumentError
from ...tensor._common import t as _t

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "mse_loss", "l1_loss", "nll_loss",
    "kl_div", "smooth_l1_loss", "margin_ranking_loss", "cosine_embedding_loss",
    "hinge_embedding_loss", "triplet_margin_loss", "label_smooth",
    "square_error_cost", "log_loss", "sigmoid_focal_loss", "dice_loss",
    "npair_loss", "cosine_similarity", "ctc_loss", "hsigmoid_loss",
]


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


def _like(v, x):
    """``v`` as a tensor in x's dtype and on its device."""
    return _t(v, x).to(device=x.device, dtype=x.dtype)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    """``-(y log p + (1 - y) log(1 - p))``, p clipped to [1e-12, 1 -
    1e-7]."""
    x = _t(input).clamp(1e-12, 1.0 - 1e-7)
    y = _like(label, x)
    loss = -(y * torch.log(x) + (1 - y) * torch.log1p(-x))
    if weight is not None:
        loss = loss * _like(weight, x)
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """The stable ``max(x, 0) - x y + log(1 + exp(-|x|))``; with
    ``pos_weight``, ``-(pw y log σ(x) + (1 - y) log σ(-x))``."""
    x = _t(logit)
    y = _like(label, x)
    loss = (torch.clamp_min(x, 0.0) - x * y
            + torch.log1p(torch.exp(-x.abs())))
    if pos_weight is not None:
        pw = _like(pos_weight, x)
        loss = -(pw * y * torch.nn.functional.logsigmoid(x)
                 + (1 - y) * torch.nn.functional.logsigmoid(-x))
    if weight is not None:
        loss = loss * _like(weight, x)
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    x = _t(input)
    return _reduce((x - _t(label, x)).square(), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    x = _t(input)
    return _reduce((x - _t(label, x)).abs(), reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """input: log-probabilities ``[N, C, ...]``; label ``[N, ...]``."""
    x = _t(input)
    label = _t(label, x)
    safe = label.long().clamp(0, x.shape[1] - 1)
    loss = -torch.gather(x, 1, safe.unsqueeze(1)).squeeze(1)
    w = None
    if weight is not None:
        w = _like(weight, x)[safe]
        loss = loss * w
    mask = label != ignore_index
    loss = torch.where(mask, loss, torch.zeros_like(loss))
    if reduction == "mean":
        if w is not None:
            denom = torch.where(mask, w, torch.zeros_like(w)).sum()
        else:
            denom = mask.to(x.dtype).sum().clamp_min(1.0)
        return loss.sum() / denom
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", name=None):
    """input: log-probabilities, label: probabilities; ``"batchmean"``
    divides the sum by the batch size."""
    x = _t(input)
    y = _like(label, x)
    loss = y * (torch.log(y.clamp_min(1e-12)) - x)
    if reduction == "batchmean":
        return loss.sum() / x.shape[0]
    return _reduce(loss, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    x = _t(input)
    d = x - _t(label, x)
    ad = d.abs()
    loss = torch.where(ad < delta, 0.5 * d * d / delta,
                       ad - 0.5 * delta) * delta
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    x = _t(input)
    loss = torch.clamp_min(-_t(label, x) * (x - _t(other, x)) + margin, 0.0)
    return _reduce(loss, reduction)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    """``x1 · x2 / max(|x1| |x2|, eps)`` along ``axis``."""
    x1 = _t(x1)
    x2 = _like(x2, x1)
    dot = (x1 * x2).sum(axis)
    n1 = x1.square().sum(axis).sqrt()
    n2 = x2.square().sum(axis).sqrt()
    return dot / torch.clamp_min(n1 * n2, eps)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    cos = cosine_similarity(input1, input2, axis=-1)
    label = _t(label, cos)
    loss = torch.where(label == 1, 1 - cos, torch.clamp_min(cos - margin,
                                                            0.0))
    return _reduce(loss, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    x = _t(input)
    y = _like(label, x)
    loss = torch.where(y == 1, x, torch.clamp_min(margin - x, 0.0))
    return _reduce(loss, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def pdist(a, b):
        return ((a - b + epsilon).abs() ** p).sum(-1) ** (1.0 / p)

    x = _t(input)
    pos, neg = _t(positive, x), _t(negative, x)
    dp, dn = pdist(x, pos), pdist(x, neg)
    if swap:
        dn = torch.minimum(dn, pdist(pos, neg))
    return _reduce(torch.clamp_min(dp - dn + margin, 0.0), reduction)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    y = _t(label)
    if prior_dist is not None:
        return (1 - epsilon) * y + epsilon * _like(prior_dist, y)
    return (1 - epsilon) * y + epsilon / y.shape[-1]


def square_error_cost(input, label):
    x = _t(input)
    return (x - _t(label, x)).square()


def log_loss(input, label, epsilon=1e-4, name=None):
    x = _t(input)
    y = _like(label, x)
    return -y * torch.log(x + epsilon) - (1 - y) * torch.log(1 - x + epsilon)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    x = _t(logit)
    y = _like(label, x)
    p = torch.sigmoid(x)
    ce = binary_cross_entropy_with_logits(x, y, reduction="none")
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / _like(normalizer, x)
    return _reduce(loss, reduction)


def dice_loss(input, label, epsilon=1e-5, name=None):
    """input: probabilities ``[N, ..., C]``; label ``[N, ..., 1]`` class
    ids."""
    x = _t(input)
    ids = _t(label, x).squeeze(-1)
    onehot = (ids.unsqueeze(-1) == torch.arange(
        x.shape[-1], device=x.device)).to(x.dtype)
    axes = tuple(range(1, x.dim()))
    inter = (x * onehot).sum(axes)
    denom = x.sum(axes) + onehot.sum(axes)
    return (1 - (2 * inter + epsilon) / (denom + epsilon)).mean()


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    a = _t(anchor)
    pos = _t(positive, a)
    labels = _t(labels, a)
    reg = l2_reg * (a.square().sum(1).mean()
                    + pos.square().sum(1).mean()) * 0.25
    sim = a @ pos.T
    lbl = (labels[:, None] == labels[None, :]).to(a.dtype)
    lbl = lbl / lbl.sum(1, keepdim=True)
    xent = (-(lbl * torch.log_softmax(sim, 1)).sum(1)).mean()
    return xent + reg


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC: log_probs ``[T, N, C]`` (paddle's layout), labels ``[N, S]``;
    the negative log-likelihood of each label sequence (``"mean"``: each
    over its label length, then the batch mean)."""
    lp = _t(log_probs)
    labels = _t(labels, lp).long()
    T, N, _ = lp.shape
    S = labels.shape[1]
    dev = lp.device
    in_len = _t(input_lengths, lp).to(dev)
    lab_len = _t(label_lengths, lp).to(dev)
    neg = torch.tensor(-1e30, dtype=lp.dtype, device=dev)
    ext = torch.full((N, 2 * S + 1), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    ext_len = 2 * lab_len.long() + 1

    def lse2(a, b):
        m = torch.maximum(a, b)
        fin = torch.isfinite(m)
        m_safe = torch.where(fin, m, torch.zeros_like(m))
        return torch.where(fin, m_safe + torch.log(
            torch.exp(a - m_safe) + torch.exp(b - m_safe)), neg)

    p0 = lp[0]
    first = torch.gather(p0, 1, ext[:, :1])
    cols = [first]
    if 2 * S + 1 > 1:
        cols.append(torch.where((ext_len > 1)[:, None],
                                torch.gather(p0, 1, ext[:, 1:2]), neg))
    rest = 2 * S + 1 - len(cols)
    alpha = torch.cat(cols + [neg.expand(N, rest)], 1)
    same2 = torch.cat([torch.ones(N, 2, dtype=torch.bool, device=dev),
                       ext[:, 2:] == ext[:, :-2]], 1)[:, :2 * S + 1]
    for t in range(1, T):
        shift1 = torch.cat([neg.expand(N, 1), alpha[:, :-1]], 1)
        shift2 = torch.cat([neg.expand(N, 2), alpha[:, :-2]], 1)[
            :, :2 * S + 1]
        shift2 = torch.where(same2, neg, shift2)
        new = lse2(lse2(alpha, shift1), shift2) + torch.gather(lp[t], 1, ext)
        alpha = torch.where((t < in_len)[:, None], new, alpha)
    last = torch.gather(alpha, 1, (ext_len - 1)[:, None])[:, 0]
    prev = torch.gather(alpha, 1, (ext_len - 2).clamp_min(0)[:, None])[:, 0]
    loss = -lse2(last, prev)
    if norm_by_times:
        loss = loss / in_len.to(loss.dtype)
    if reduction == "mean":
        return (loss / lab_len.to(loss.dtype).clamp_min(1.0)).mean()
    return _reduce(loss, reduction)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss ``[N, 1]``: the summed binary
    cross-entropies of the classifiers on each label's tree path.  The
    default complete tree codes leaf ``c = label + num_classes``; bit
    ``j`` of the path (from the least significant) is node ``(c >> (j +
    1)) - 1`` with target ``(c >> j) & 1``, for the ``floor(log2 c)``
    bits the leaf has.  A custom tree passes ``path_table`` /
    ``path_code`` ``[N, L]`` (-1 padded).  ``is_sparse`` is accepted and
    ignored, as in the JAX package."""
    x = _t(input)
    y = _t(label, x).long().reshape(-1)
    w = _t(weight, x)
    if (path_table is None) != (path_code is None):
        raise InvalidArgumentError(
            "path_table and path_code must be given together")
    if path_table is not None:
        idx = _t(path_table, x).long()
        bits = _like(path_code, x)
        valid = idx >= 0
        idx = torch.where(valid, idx, torch.zeros_like(idx))
    else:
        c = y + int(num_classes)
        L = int(math.ceil(math.log2(max(num_classes, 2)))) + 1
        j = torch.arange(L, device=x.device)[None, :]
        powers = torch.ones(L, dtype=torch.long, device=x.device) << \
            torch.arange(1, L + 1, device=x.device)
        length = (c[:, None] >= powers[None]).sum(1, keepdim=True)
        valid = j < length
        idx = torch.where(valid, (c[:, None] >> (j + 1)) - 1,
                          torch.zeros_like(j))
        bits = ((c[:, None] >> j) & 1).to(x.dtype)
    logits = torch.einsum("nld,nd->nl", w[idx].to(x.dtype), x)
    if bias is not None:
        logits = logits + _like(bias, x).reshape(-1)[idx]
    per_node = binary_cross_entropy_with_logits(logits, bits,
                                                reduction="none")
    per_node = torch.where(valid, per_node, torch.zeros_like(per_node))
    return per_node.sum(1, keepdim=True)
