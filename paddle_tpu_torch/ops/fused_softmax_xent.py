"""Fused softmax cross-entropy — port of ``paddle_tpu/ops/fused_softmax_xent.py``.

The LM losses (GPT next-token, BERT MLM) compute
``-log_softmax(logits)[label]`` over a vocabulary-sized axis.
:func:`softmax_cross_entropy` gives the per-row loss without writing the
``[M, V]`` log-probability matrix: on the card that is the hand-written
CUDA kernel ``ops/csrc/fused_softmax_xent.cu`` (``sm_90a``, built with
nvcc on first use, bound with ctypes), one block per row streaming the
vocabulary once with an online (max, sum of exp):

    loss[i] = logsumexp(logits[i, :]) - logits[i, label[i]]

A label outside ``[0, V)`` contributes no logit (``loss = lse``), as in
the TPU kernel; callers that ignore rows mask them themselves.

The gradient is a ``torch.autograd.Function``: the kernel also returns the
per-row ``lse``, which is saved, and the backward is
``(exp(logits - lse) - onehot)·g`` in plain PyTorch (``_sxent_bwd``), with
the onehot applied as a subtraction at the label index, never
materialized.  Labels get no gradient.

:func:`softmax_cross_entropy_ref` is the plain PyTorch version,
differentiable by autograd: the CPU path and the yardstick the kernel is
held to on the card.  A CUDA tensor always goes to the kernel.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..framework.errors import InvalidArgumentError
from . import _build

__all__ = ["softmax_cross_entropy", "softmax_cross_entropy_ref"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None
_fn_lock = threading.Lock()


def _check(logits, labels):
    if logits.dim() < 1 or tuple(logits.shape[:-1]) != tuple(labels.shape):
        raise InvalidArgumentError(
            f"softmax_cross_entropy: logits {tuple(logits.shape)} vs labels "
            f"{tuple(labels.shape)}")
    if labels.dtype.is_floating_point or labels.dtype == torch.bool:
        raise InvalidArgumentError(
            f"softmax_cross_entropy: labels must be integer, got "
            f"{labels.dtype}")
    return logits.shape[-1]


def _forward_ref(x2, lab2):
    """Plain forward on ``[M, V]`` rows: ``(loss [M], lse [M])``, f32."""
    V = x2.shape[-1]
    xf = x2.float()
    lse = torch.logsumexp(xf, dim=-1)
    lab = lab2.long()
    valid = (lab >= 0) & (lab < V)
    picked = torch.gather(xf, 1, lab.clamp(0, V - 1)[:, None])[:, 0]
    return lse - torch.where(valid, picked, torch.zeros_like(picked)), lse


def softmax_cross_entropy_ref(logits, labels):
    """Plain PyTorch version of :func:`softmax_cross_entropy` (same
    signature and semantics), differentiable by autograd."""
    V = _check(logits, labels)
    loss, _ = _forward_ref(logits.reshape(-1, V), labels.reshape(-1))
    return loss.reshape(labels.shape)


def _kernel_fn():
    global _fn
    with _fn_lock:
        if _fn is None:
            _fn = _build.entry("fused_softmax_xent", "softmax_xent_fwd",
                               [ctypes.c_int] + [ctypes.c_void_p] * 4
                               + [ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p])
        return _fn


def _forward_kernel(x2, lab2):
    """Launch the CUDA kernel on ``[M, V]`` rows; same outputs as
    :func:`_forward_ref`.  Adds one to ``softmax_cross_entropy.launches``."""
    M, V = x2.shape
    if lab2.device != x2.device:
        raise InvalidArgumentError(
            f"softmax_cross_entropy: labels on {lab2.device}, logits on "
            f"{x2.device}")
    if x2.dtype not in _DTYPES:
        raise InvalidArgumentError(
            f"softmax_cross_entropy: the kernel takes float32 or bfloat16 "
            f"logits, got {x2.dtype}")
    if not x2.is_contiguous():
        raise InvalidArgumentError(
            "softmax_cross_entropy: logits must be contiguous")
    if V == 0 or V >= 2 ** 31 or M >= 2 ** 31:
        raise InvalidArgumentError(
            f"softmax_cross_entropy: [M={M}, V={V}] outside the kernel's "
            f"range (1 <= V, M < 2**31)")
    lab = lab2.to(torch.int32).contiguous()
    loss = torch.empty(M, dtype=torch.float32, device=x2.device)
    lse = torch.empty(M, dtype=torch.float32, device=x2.device)
    if M == 0:
        return loss, lse
    fn = _kernel_fn()
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        fn(_DTYPES[x2.dtype], x2.data_ptr(), lab.data_ptr(), loss.data_ptr(),
           lse.data_ptr(), M, V, stream)
    softmax_cross_entropy.launches += 1
    return loss, lse


class _SoftmaxCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, lab2):
        if x2.device.type in _build.PLAIN_DEVICES:
            loss, lse = _forward_ref(x2, lab2)
        elif x2.device.type == "cuda":
            loss, lse = _forward_kernel(x2, lab2)
        else:
            raise InvalidArgumentError(
                f"softmax_cross_entropy: tensors on {x2.device} (cpu or "
                f"cuda only)")
        ctx.save_for_backward(x2, lab2, lse)
        ctx.mark_non_differentiable(lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        x2, lab2, lse = ctx.saved_tensors
        V = x2.shape[-1]
        # (softmax - onehot)·g: the onehot is a -1 added at each valid
        # label's column, so no [M, V] onehot is ever built
        d = torch.exp(x2.float() - lse[:, None])
        lab = lab2.long()
        valid = ((lab >= 0) & (lab < V)).to(d.dtype)
        d.scatter_add_(1, lab.clamp(0, V - 1)[:, None], -valid[:, None])
        d.mul_(g.float()[:, None])
        return d.to(x2.dtype), None


def softmax_cross_entropy(logits, labels):
    """Per-row ``-log_softmax(logits)[label]`` without the probability
    matrix.

    logits: ``[..., V]`` float32 or bfloat16, labels: ``[...]`` integer
    class ids.  Returns float32 losses of the label shape.
    Differentiable in logits.  CPU tensors take
    :func:`softmax_cross_entropy_ref`'s arithmetic; CUDA tensors launch
    the kernel on the current stream (logits contiguous) and add one to
    ``softmax_cross_entropy.launches``; anything else raises.
    """
    V = _check(logits, labels)
    loss = _SoftmaxCrossEntropy.apply(logits.reshape(-1, V),
                                      labels.reshape(-1))
    return loss.reshape(labels.shape)


#: kernel launches so far (CUDA tensors only; the CPU path never counts)
softmax_cross_entropy.launches = 0
