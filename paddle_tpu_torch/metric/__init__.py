"""paddle_tpu_torch.metric — evaluation metrics (port of
``paddle_tpu.metric``): ``Metric``, ``Accuracy`` (top-k), ``Precision``,
``Recall``, ``Auc`` (with ``bucket_auc``), the functional ``accuracy``,
``chunk_eval`` and ``mean_iou``.

Metrics accumulate on the host in numpy, as in the JAX package: a step's
outputs are pulled from the device once per batch that updates a metric
(``Model.fit`` syncs there by design).  Tensors are taken as they come
(``compute`` / ``update`` convert them to numpy).
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from ..framework.dtype import to_numpy as _np
from ..framework.errors import InvalidArgumentError
from . import metrics  # noqa: F401  (paddle.metric.metrics alias module)
from .functional import chunk_eval, mean_iou

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy",
           "bucket_auc", "chunk_eval", "mean_iou"]


class Metric:
    """Base metric: ``reset``/``update``/``accumulate``/``name``.

    ``compute(pred, label)`` optionally pre-processes a step's outputs (it
    may run on device values); its return feeds ``update``.
    """

    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, pred, label, *args):
        return pred, label


class Accuracy(Metric):
    """Top-k accuracy."""

    def __init__(self, topk: Union[int, Sequence[int]] = (1,), name: str = "acc"):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name
        self.reset()

    def compute(self, pred, label, *args):
        """pred [N, C] scores, label [N] or [N, 1] int → correctness matrix
        [N, maxk], on the host."""
        pred = _np(pred)
        label = _np(label).reshape(pred.shape[0], -1)[:, 0]
        topk_idx = np.argsort(-pred, axis=-1)[:, : self.maxk]
        return (topk_idx == label[:, None]).astype(np.float32)

    def update(self, correct):
        correct = _np(correct)
        accs = []
        for k in self.topk:
            num = correct[:, :k].sum()
            accs.append(num / max(correct.shape[0], 1))
            self.total[self.topk.index(k)] += num
            self.count[self.topk.index(k)] += correct.shape[0]
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c > 0 else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision: TP/(TP+FP). pred is probability of class 1."""

    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds).flatten().round().astype(np.int64)
        labels = _np(labels).flatten().astype(np.int64)
        if preds.shape != labels.shape:
            raise InvalidArgumentError("pred/label shape mismatch")
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom > 0 else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall: TP/(TP+FN)."""

    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds).flatten().round().astype(np.int64)
        labels = _np(labels).flatten().astype(np.int64)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom > 0 else 0.0

    def name(self):
        return self._name


def bucket_auc(stat_pos, stat_neg, degenerate: float = 0.0) -> float:
    """Trapezoid AUC over bucketed score histograms, sweeping thresholds
    high→low (the reference's estimate in both metrics.py:509 and the
    fleet metric.py:203).  ``degenerate``: value when one class is empty
    (the two reference surfaces disagree: 0.0 for the Metric, 0.5 for
    fleet.metrics — callers pick)."""
    pos = np.asarray(stat_pos, dtype=np.float64).ravel()
    neg = np.asarray(stat_neg, dtype=np.float64).ravel()
    tot_pos = tot_neg = area = 0.0
    for p, n in zip(pos[::-1], neg[::-1]):
        area += n * (tot_pos + p / 2.0)
        tot_pos += p
        tot_neg += n
    if tot_pos == 0 or tot_neg == 0:
        return degenerate
    return float(area / (tot_pos * tot_neg))


class Auc(Metric):
    """ROC AUC via thresholded confusion histogram (reference uses the same
    bucketed approximation, metrics.py:509 num_thresholds=4095)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self.num_thresholds = num_thresholds
        self._name = name
        self.curve = curve
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds)
        if preds.ndim == 2:  # [N,2] softmax → prob of positive class
            preds = preds[:, 1]
        preds = preds.flatten()
        labels = _np(labels).flatten().astype(np.int64)
        buckets = np.clip(
            (preds * self.num_thresholds).astype(np.int64), 0, self.num_thresholds
        )
        pos = np.bincount(buckets[labels == 1], minlength=self.num_thresholds + 1)
        neg = np.bincount(buckets[labels == 0], minlength=self.num_thresholds + 1)
        self._stat_pos += pos
        self._stat_neg += neg

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, dtype=np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, dtype=np.int64)

    def accumulate(self):
        return bucket_auc(self._stat_pos, self._stat_neg, degenerate=0.0)

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Functional top-k accuracy: the fraction of rows whose label is among
    the k largest scores, a 0-d tensor in the input's dtype.
    ``correct`` / ``total`` (in-place accumulators in the reference) are
    accepted and ignored (use the Accuracy Metric to accumulate)."""
    logits = torch.as_tensor(input)
    y = torch.as_tensor(label, device=logits.device).reshape(
        logits.shape[0], -1)[:, :1]
    topk = torch.argsort(-logits, dim=-1, stable=True)[:, :k]
    hit = (topk == y).any(dim=-1)
    # the mean as XLA computes it: the sum times the reciprocal count
    return hit.to(logits.dtype).sum() * (1.0 / hit.numel())
