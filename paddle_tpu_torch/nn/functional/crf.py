"""Linear-chain CRF ops — port of ``paddle_tpu.nn.functional.crf``:
the forward-algorithm negative log-likelihood, Viterbi decoding and
``crf_decoding``.

``transition`` is ``[(D+2), D]``: row 0 the start weights, row 1 the stop
weights, rows 2.. the D × D matrix.  Sequences are dense ``[B, T, D]``
with a ``length [B]`` tensor (None: full rows).  Emission and transition
are scored in float32 whatever their dtype, as in JAX.

The recurrences are time loops on the device — a few launches a step and
no host read, so a CUDA graph captures them (``Executor.run_steps``);
autograd gives the gradient, as ``jax.grad`` of the scan does there.  The
forward algorithm keeps alpha relative to its running maximum (JAX's scan
does not): the same function, whose float32 alpha stays O(1) over long
sequences instead of growing with the log-partition.  A masked step
carries alpha / delta unchanged and its back-pointer points to itself; the stop weight is read at ``length - 1``; Viterbi takes the first
maximum (``torch.max`` over a dim returns the first, as ``jnp.argmax``);
positions past ``length`` decode to 0.
"""
from __future__ import annotations

import torch

from ...tensor._common import t as _t

__all__ = ["linear_chain_crf", "crf_decoding", "viterbi_decode"]


def _split(transition, like):
    t = _t(transition, like).to(device=like.device, dtype=torch.float32)
    return t[0], t[1], t[2:]  # start [D], stop [D], trans [D, D]


def _lengths_mask(B, T, length, like):
    dev = like.device
    if length is None:
        return (torch.ones((B, T), dtype=torch.bool, device=dev),
                torch.full((B,), T, dtype=torch.int64, device=dev))
    length = _t(length, like).to(device=dev, dtype=torch.int64).reshape(B)
    mask = torch.arange(T, device=dev)[None, :] < length[:, None]
    return mask, length


def linear_chain_crf(emission, transition, label, length=None):
    """Negative log-likelihood of the ``label`` paths: emission
    ``[B, T, D]``, transition ``[(D+2), D]``, label ``[B, T]`` int,
    length ``[B]`` (None: full rows) → ``[B, 1]`` float32 (the
    reference's LogLikelihood output, used as a cost)."""
    e = _t(emission).to(torch.float32)
    B, T, D = e.shape
    y = _t(label, e).to(device=e.device, dtype=torch.int64).reshape(B, T)
    start, stop, trans = _split(transition, e)
    mask, length = _lengths_mask(B, T, length, e)

    # partition function: the forward algorithm over time.  alpha is kept
    # relative to its running maximum (``shift`` holds the offsets; their
    # gradient is exactly zero: lse(a - c) + c = lse(a) for any c), so its
    # entries stay O(1) and the float32 softmax weights of the backward do
    # not lose the bits a log-partition of hundreds would take
    alpha = start[None, :] + e[:, 0]  # [B, D]
    shift = torch.zeros_like(alpha[:, 0])
    for t in range(1, T):
        m = alpha.detach().amax(dim=1)
        nxt = torch.logsumexp((alpha - m[:, None])[:, :, None]
                              + trans[None], dim=1) + e[:, t]
        alpha = torch.where(mask[:, t, None], nxt, alpha)
        shift = torch.where(mask[:, t], shift + m, shift)
    log_z = torch.logsumexp(alpha + stop[None, :], dim=-1) + shift  # [B]

    # the gold path's score
    e_path = torch.gather(e, 2, y[:, :, None])[:, :, 0]  # [B, T]
    score = start[y[:, 0]] + e_path[:, 0]
    if T > 1:
        steps = trans[y[:, :-1], y[:, 1:]] + e_path[:, 1:]  # [B, T-1]
        score = score + torch.where(mask[:, 1:], steps,
                                    torch.zeros_like(steps)).sum(dim=1)
    # length 0 reads the last step, as JAX's negative index wraps
    last = torch.remainder(length - 1, T)
    y_last = torch.gather(y, 1, last[:, None])[:, 0]
    score = score + stop[y_last]
    return (log_z - score)[:, None]


def viterbi_decode(emission, transition, length=None):
    """The highest-scoring tag path: ``(path [B, T] int64, score [B]
    float32)``; positions past ``length`` hold 0."""
    e = _t(emission).to(torch.float32)
    B, T, D = e.shape
    start, stop, trans = _split(transition, e)
    mask, _ = _lengths_mask(B, T, length, e)
    own = torch.arange(D, device=e.device)[None, :]

    delta = start[None, :] + e[:, 0]  # [B, D]
    backs = []
    for t in range(1, T):
        best, back = torch.max(delta[:, :, None] + trans[None], dim=1)
        m = mask[:, t, None]
        delta = torch.where(m, best + e[:, t], delta)
        # a padded step points to itself: the backtrace passes through
        backs.append(torch.where(m, back, own))
    final = delta + stop[None, :]
    best_score, tag = torch.max(final, dim=-1)  # [B]
    tags = [tag]
    for back in reversed(backs):
        tag = torch.gather(back, 1, tag[:, None])[:, 0]
        tags.append(tag)
    path = torch.stack(tags[::-1], dim=1)  # [B, T]
    return torch.where(mask, path, torch.zeros_like(path)), best_score


def crf_decoding(emission, transition, label=None, length=None):
    """The Viterbi path ``[B, T]``; with ``label``, an int64 0/1 tensor
    marking where the path and the label agree (0 past ``length``), so
    ``out.sum() / tokens`` is the tagging accuracy (crf_decoding_op.h:70).
    """
    path, _ = viterbi_decode(emission, transition, length)
    if label is None:
        return path
    B, T = path.shape
    y = _t(label, path).to(device=path.device,
                           dtype=torch.int64).reshape(B, T)
    mask, _ = _lengths_mask(B, T, length, path)
    return torch.where(mask, (path == y).to(torch.int64),
                       torch.zeros_like(path))
