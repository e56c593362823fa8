"""Functional metrics: chunk_eval (sequence chunking F1) and mean_iou —
port of ``paddle_tpu.metric.functional``.

chunk_eval is a host-side metric (numpy, the JAX package's code as it
is); mean_iou is dense tensor code (confusion counts by scatter-add), on
the input's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.errors import InvalidArgumentError

__all__ = ["chunk_eval", "mean_iou"]

#: scheme → (num_tag_types, tag_begin, tag_inside, tag_end, tag_single)
#: (chunk_eval_op.h:119-148)
_SCHEMES = {
    "IOB": (2, 0, 1, -1, -1),
    "IOE": (2, -1, 0, 1, -1),
    "IOBES": (4, 0, 1, 2, 3),
    "plain": (1, -1, -1, -1, -1),
}


def _chunk_end(prev_tag, prev_type, tag, type_, other, tb, ti, te, ts):
    if prev_type == other:
        return False
    if type_ == other or type_ != prev_type:
        return True
    if prev_tag == tb or prev_tag == ti:
        return tag == tb or tag == ts
    return prev_tag == te or prev_tag == ts


def _chunk_begin(prev_tag, prev_type, tag, type_, other, tb, ti, te, ts):
    if prev_type == other:
        return type_ != other
    if type_ == other:
        return False
    if type_ != prev_type:
        return True
    if tag == tb or tag == ts:
        return True
    if tag == ti or tag == te:
        return prev_tag in (te, ts)
    return False


def _segments(labels, num_tag_types, other, tb, ti, te, ts):
    """Transcribes GetSegments (chunk_eval_op.h:40): label id →
    (tag=id%T, type=id//T); emit (begin, end, type) spans."""
    out = []
    in_chunk = False
    start = 0
    tag, type_ = -1, other
    for i, lab in enumerate(labels):
        prev_tag, prev_type = tag, type_
        tag, type_ = int(lab) % num_tag_types, int(lab) // num_tag_types
        if in_chunk and _chunk_end(prev_tag, prev_type, tag, type_, other,
                                   tb, ti, te, ts):
            out.append((start, i - 1, prev_type))
            in_chunk = False
        if _chunk_begin(prev_tag, prev_type, tag, type_, other,
                        tb, ti, te, ts):
            start = i
            in_chunk = True
    if in_chunk:
        out.append((start, len(labels) - 1, type_))
    return out


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None):
    """Chunk-detection precision/recall/F1 for sequence tagging (NER)
    (ref: fluid/layers/nn.py:1047).  Dense batch form: input/label
    ``[N, M]`` (or ``[N, M, 1]``) int labels; ``seq_length`` ``[N]``
    gives valid lengths (dense-padding replacement for the reference's
    LoD input).

    Returns (precision, recall, f1, num_infer_chunks, num_label_chunks,
    num_correct_chunks) — scalars, reference output order.
    """
    if chunk_scheme not in _SCHEMES:
        raise InvalidArgumentError(
            f"chunk_scheme must be one of {sorted(_SCHEMES)}, "
            f"got {chunk_scheme!r}")
    num_tag, tb, ti, te, ts = _SCHEMES[chunk_scheme]
    other = int(num_chunk_types)
    excluded = set(excluded_chunk_types or ())

    pred = np.asarray(input).astype(np.int64)
    lab = np.asarray(label).astype(np.int64)
    if pred.ndim == 3:
        pred = pred[..., 0]
    if lab.ndim == 3:
        lab = lab[..., 0]
    if pred.ndim == 1:
        pred, lab = pred[None], lab[None]
    if pred.shape != lab.shape:
        raise InvalidArgumentError(
            f"input/label shape mismatch: {pred.shape} vs {lab.shape}")
    if (pred.max(initial=0) > num_chunk_types * num_tag
            or lab.max(initial=0) > num_chunk_types * num_tag):
        raise InvalidArgumentError(
            "label ids must be <= num_chunk_types * num_tag_types "
            "(chunk_eval_op.h label check)")
    lengths = (np.asarray(seq_length).astype(np.int64)
               if seq_length is not None
               else np.full(pred.shape[0], pred.shape[1], np.int64))

    n_infer = n_label = n_correct = 0
    for i in range(pred.shape[0]):
        L = int(lengths[i])
        segs_p = [s for s in _segments(pred[i, :L], num_tag, other,
                                       tb, ti, te, ts)
                  if s[2] not in excluded]
        segs_l = [s for s in _segments(lab[i, :L], num_tag, other,
                                       tb, ti, te, ts)
                  if s[2] not in excluded]
        n_infer += len(segs_p)
        n_label += len(segs_l)
        n_correct += len(set(segs_p) & set(segs_l))

    precision = n_correct / n_infer if n_infer else 0.0
    recall = n_correct / n_label if n_label else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if n_correct else 0.0)
    return (np.float32(precision), np.float32(recall), np.float32(f1),
            np.int64(n_infer), np.int64(n_label), np.int64(n_correct))


def mean_iou(input, label, num_classes):
    """Mean Intersection-over-Union over classes (the reference kernel:
    correct[c] += pred == label == c; a mismatch increments wrong[] for
    BOTH classes; classes with an empty denominator are left out of the
    mean).

    Returns (mean_iou float32 0-d tensor, out_wrong ``[num_classes]``
    int32, out_correct ``[num_classes]`` int32).
    """
    pred = torch.as_tensor(input).reshape(-1).to(torch.int64)
    lab = torch.as_tensor(label, device=pred.device).reshape(-1).to(
        torch.int64)
    n = int(num_classes)
    hit = pred == lab

    def count(idx):
        """Per-class counts of ``idx``, entries out of [0, n) dropped."""
        ok = (idx >= 0) & (idx < n)
        return torch.zeros(n, dtype=torch.int32, device=pred.device
                           ).index_add_(0, idx[ok], torch.ones_like(
                               idx[ok], dtype=torch.int32))

    correct = count(torch.where(hit, pred, n))
    wrong = count(torch.where(hit, n, pred)) + count(torch.where(hit, n, lab))
    denom = correct + wrong
    valid = denom > 0
    iou = correct / torch.clamp(denom, min=1).to(torch.float32)
    miou = iou.sum() / torch.clamp(valid.sum(), min=1).to(torch.float32)
    return miou.to(torch.float32), wrong, correct
