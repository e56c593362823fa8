"""The greedy sweep of non-maximum suppression: a hand-written CUDA kernel
with no TPU kernel behind it.

``nn.functional.detection.nms`` sorts the candidates by score, builds
their pairwise IoU matrix and then decides, in order, which to keep: a
candidate survives when no kept candidate before it overlaps it above the
threshold, and the threshold decays by ``eta`` after each kept box while
it is above 0.5 (``paddle_tpu/nn/functional/detection.py:340-352``).  On
the TPU that loop is one compiled ``lax.fori_loop``; here it is
:func:`nms_sweep`: on the card the kernel of ``ops/csrc/nms_sweep.cu``
(one thread block an instance, one launch for a whole batch of
instances), on the CPU :func:`nms_sweep_ref`, the loop itself.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..framework.errors import InvalidArgumentError
from . import _build

__all__ = ["nms_sweep", "nms_sweep_ref"]

_fn = None
_fn_lock = threading.Lock()


def _check(iou, scores):
    if (iou.dim() != 3 or scores.dim() != 2
            or tuple(iou.shape) != (scores.shape[0], scores.shape[1],
                                    scores.shape[1])):
        raise InvalidArgumentError(
            f"nms_sweep: iou [B, k, k] and scores [B, k], got "
            f"{tuple(iou.shape)} and {tuple(scores.shape)}")
    if iou.device != scores.device:
        raise InvalidArgumentError(
            f"nms_sweep: iou on {iou.device}, scores on {scores.device}")


def nms_sweep_ref(iou, scores, threshold, eta=1.0):
    """The plain loop: ``iou [B, k, k]`` over each instance's candidates
    in descending score order, ``scores [B, k]`` sorted descending →
    ``keep [B, k]`` bool.  The threshold is float32, and decays to
    ``threshold · eta`` (rounded to float32) after each kept box while it
    is above 0.5."""
    _check(iou, scores)
    B, k = scores.shape
    keep = torch.zeros((B, k), dtype=torch.bool, device=scores.device)
    thr = torch.full((B,), float(threshold), dtype=torch.float32,
                     device=scores.device)
    finite = torch.isfinite(scores)
    for i in range(k):
        suppressed = (keep[:, :i] & (iou[:, i, :i] > thr[:, None])).any(1)
        ok = ~suppressed & finite[:, i]
        keep[:, i] = ok
        if eta < 1.0:
            thr = torch.where(ok & (thr > 0.5), thr * eta, thr)
    return keep


def _kernel_fn():
    global _fn
    with _fn_lock:
        if _fn is None:
            _fn = _build.entry(
                "nms_sweep", "nms_sweep",
                [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_float, ctypes.c_float,
                                         ctypes.c_void_p])
        return _fn


def _sweep_kernel(iou, scores, threshold, eta):
    if iou.dtype != torch.float32 or scores.dtype != torch.float32:
        raise InvalidArgumentError(
            f"nms_sweep: the kernel takes float32 iou and scores, got "
            f"{iou.dtype} and {scores.dtype}")
    B, k = scores.shape
    if B >= 2 ** 31 or k >= 2 ** 31:
        raise InvalidArgumentError(f"nms_sweep: [B={B}, k={k}] too large")
    iou = iou.contiguous()
    scores = scores.contiguous()
    keep = torch.zeros((B, k), dtype=torch.uint8, device=scores.device)
    if B == 0 or k == 0:
        return keep.bool()
    kept = torch.empty((B, k), dtype=torch.int32, device=scores.device)
    fn = _kernel_fn()
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        fn(iou.data_ptr(), scores.data_ptr(), keep.data_ptr(),
           kept.data_ptr(), B, k, float(threshold), float(eta), stream)
    nms_sweep.launches += 1
    return keep.bool()


def nms_sweep(iou, scores, threshold, eta=1.0):
    """Keep mask ``[B, k]`` of the greedy sweep (see :func:`nms_sweep_ref`
    for the function).  CPU (and meta) tensors take the plain loop; CUDA
    tensors launch the kernel on the current stream (float32 only) and add
    one to ``nms_sweep.launches``; anything else raises."""
    _check(iou, scores)
    if scores.device.type in _build.PLAIN_DEVICES:
        return nms_sweep_ref(iou, scores, threshold, eta)
    if scores.device.type == "cuda":
        return _sweep_kernel(iou, scores, threshold, eta)
    raise InvalidArgumentError(
        f"nms_sweep: tensors on {scores.device} (cpu or cuda only)")


#: kernel launches so far (CUDA tensors only; the CPU path never counts)
nms_sweep.launches = 0
