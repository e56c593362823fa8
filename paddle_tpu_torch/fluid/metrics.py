"""paddle.fluid.metrics — the 1.x running-metric accumulators (port of
``paddle_tpu.fluid.metrics``): ``MetricBase``, ``Accuracy`` (a weighted
running mean over ``update(value, weight)``), ``Precision`` / ``Recall``
(binary counters), ``ChunkEvaluator`` (``chunk_eval``'s counts →
precision, recall, F1), ``EditDistance``, ``Auc`` (the 2.0 estimator of
``metric``), ``CompositeMetric`` and ``DetectionMAP``.  Host numpy, as in
the JAX package and the reference; tensors are read to the host.
"""
from __future__ import annotations

import numpy as np

from ..framework.dtype import to_numpy
from ..framework.errors import InvalidArgumentError, UnimplementedError

__all__ = [
    "MetricBase", "CompositeMetric", "Precision", "Recall", "Accuracy",
    "ChunkEvaluator", "EditDistance", "Auc", "DetectionMAP",
]


class MetricBase:
    def __init__(self, name=None):
        self._name = str(name) if name is not None else self.__class__.__name__

    def name(self):
        return self._name

    def reset(self):
        """Reset every scalar/array state attr (ref :58 behavior)."""
        for k, v in self.__dict__.items():
            if k.startswith("_"):
                continue
            if isinstance(v, (int, float)):
                setattr(self, k, 0)
            elif isinstance(v, np.ndarray):
                setattr(self, k, np.zeros_like(v))

    def update(self, *a, **k):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(MetricBase):
    """Weighted running mean of batch accuracies (ref :435)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        if not np.isscalar(weight) and to_numpy(weight).size != 1:
            raise InvalidArgumentError("weight must be a scalar")
        weight = float(to_numpy(weight).reshape(()))
        if weight < 0:
            raise InvalidArgumentError("weight must be non-negative")
        self.value += float(to_numpy(value).reshape(())) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise InvalidArgumentError(
                "call update() before eval() — no samples accumulated")
        return self.value / self.weight


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(to_numpy(preds)).astype(np.int64).reshape(-1)
        labels = to_numpy(labels).astype(np.int64).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def eval(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(to_numpy(preds)).astype(np.int64).reshape(-1)
        labels = to_numpy(labels).astype(np.int64).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def eval(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0


class ChunkEvaluator(MetricBase):
    """Accumulates chunk_eval's count outputs (ref :513); eval →
    (precision, recall, f1)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks,
               num_correct_chunks):
        self.num_infer_chunks += int(to_numpy(num_infer_chunks).reshape(()))
        self.num_label_chunks += int(to_numpy(num_label_chunks).reshape(()))
        self.num_correct_chunks += int(
            to_numpy(num_correct_chunks).reshape(()))

    def eval(self):
        precision = (self.num_correct_chunks / self.num_infer_chunks
                     if self.num_infer_chunks else 0.0)
        recall = (self.num_correct_chunks / self.num_label_chunks
                  if self.num_label_chunks else 0.0)
        f1 = (2 * precision * recall / (precision + recall)
              if self.num_correct_chunks else 0.0)
        return precision, recall, f1


class EditDistance(MetricBase):
    """Accumulates edit_distance outputs (ref :611); eval →
    (avg_distance, instance_error_rate)."""

    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        d = to_numpy(distances).astype(np.float64).reshape(-1)
        self.total_distance += float(d.sum())
        self.seq_num += int(to_numpy(seq_num).reshape(()))
        self.instance_error += int((d > 0).sum())

    def eval(self):
        if self.seq_num == 0:
            raise InvalidArgumentError(
                "call update() before eval() — no sequences accumulated")
        return (self.total_distance / self.seq_num,
                self.instance_error / self.seq_num)


class Auc(MetricBase):
    """Bucketed ROC AUC (ref :699) — shares the 2.0 estimator."""

    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        from ..metric import Auc as _Auc2

        self._impl = _Auc2(curve=curve, num_thresholds=num_thresholds)

    def update(self, preds, labels):
        self._impl.update(to_numpy(preds), to_numpy(labels))

    def reset(self):
        self._impl.reset()

    def eval(self):
        return self._impl.accumulate()


class CompositeMetric(MetricBase):
    """Bundle of metrics updated with the same inputs (ref :199)."""

    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        if not isinstance(metric, MetricBase):
            raise InvalidArgumentError("add_metric expects a MetricBase")
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def eval(self):
        return [m.eval() for m in self._metrics]


def _iou_one_to_many(a, bs):
    """JaccardOverlap (detection_map_op.h:136) of one box against [G, 4]
    — vectorized for the per-prediction matching loop."""
    iw = np.minimum(a[2], bs[:, 2]) - np.maximum(a[0], bs[:, 0])
    ih = np.minimum(a[3], bs[:, 3]) - np.maximum(a[1], bs[:, 1])
    disjoint = (iw < 0) | (ih < 0)
    inter = iw * ih
    ua = ((a[2] - a[0]) * (a[3] - a[1])
          + (bs[:, 2] - bs[:, 0]) * (bs[:, 3] - bs[:, 1]) - inter)
    return np.where(disjoint | (ua <= 0), 0.0, inter / np.maximum(ua, 1e-12))


class DetectionMAP:
    """Running mean-average-precision evaluator (ref: metrics.py:805
    over operators/detection_map_op.h).  The reference wires Program
    ops; this is the same accumulation on host:

    * ``update(detections, gt_labels, gt_boxes, difficult=None)`` —
      per batch.  ``detections``: per-image ``[M, 6]`` rows of (label,
      score, xmin, ymin, xmax, ymax) — exactly what
      ``nn.functional.multiclass_nms`` / ``detection_output`` emit
      (label=-1 padding rows are skipped); ``gt_labels``/``gt_boxes``:
      per-image ``[G]`` / ``[G, 4]``.
    * ``eval()`` — mAP under ``ap_version`` 'integral' or '11point'
      (detection_map_op.h:456-483), matching greedily per class with
      ``overlap_threshold``, clipping predictions to [0, 1] like the
      kernel's ClipBBox.
    """

    def __init__(self, input=None, gt_label=None, gt_box=None,
                 gt_difficult=None, class_num=None, background_label=0,
                 overlap_threshold=0.5, evaluate_difficult=True,
                 ap_version="integral"):
        if ap_version not in ("integral", "11point"):
            raise UnimplementedError(
                f"ap_version must be 'integral' or '11point', "
                f"got {ap_version!r}")
        self.class_num = class_num
        self.background_label = background_label
        self.overlap_threshold = overlap_threshold
        self.evaluate_difficult = evaluate_difficult
        self.ap_version = ap_version
        self.reset()

    def reset(self, executor=None, reset_program=None):
        self._pos_count = {}  # label → #gt
        self._tp = {}  # label → [(score, 0/1)]
        self._fp = {}

    def update(self, detections, gt_labels, gt_boxes, difficult=None):
        n = len(gt_labels)
        if len(detections) != n or len(gt_boxes) != n:
            raise InvalidArgumentError(
                "update() wants per-image lists of equal length")
        for i in range(n):
            labels = to_numpy(gt_labels[i]).reshape(-1).astype(int)
            boxes = to_numpy(gt_boxes[i]).reshape(-1, 4)
            diff = (to_numpy(difficult[i]).reshape(-1).astype(bool)
                    if difficult is not None
                    else np.zeros(len(labels), bool))
            if not (len(labels) == len(boxes) == len(diff)):
                raise InvalidArgumentError(
                    f"image {i}: gt_labels ({len(labels)}), gt_boxes "
                    f"({len(boxes)}) and difficult ({len(diff)}) must "
                    f"have equal lengths")
            gt_by_label = {}
            for lab, box, d in zip(labels, boxes, diff):
                gt_by_label.setdefault(int(lab), []).append((box, d))
            for lab, items in gt_by_label.items():
                count = (len(items) if self.evaluate_difficult
                         else sum(1 for _, d in items if not d))
                if count:
                    self._pos_count[lab] = self._pos_count.get(lab, 0) + count

            det = to_numpy(detections[i]).reshape(-1, 6)
            det = det[det[:, 0] >= 0]  # drop NMS padding rows
            det_by_label = {}
            for row in det:
                det_by_label.setdefault(int(row[0]), []).append(
                    (float(row[1]), row[2:6]))
            for lab, preds in det_by_label.items():
                preds.sort(key=lambda p: -p[0])
                gts = gt_by_label.get(lab)
                if not gts:
                    for score, _ in preds:
                        self._tp.setdefault(lab, []).append((score, 0))
                        self._fp.setdefault(lab, []).append((score, 1))
                    continue
                visited = [False] * len(gts)
                gt_arr = np.stack([g for g, _ in gts])
                for score, box in preds:
                    box = np.clip(box, 0.0, 1.0)  # ClipBBox (:157)
                    overlaps = _iou_one_to_many(box, gt_arr)
                    j = int(np.argmax(overlaps))
                    if overlaps[j] > self.overlap_threshold:
                        if self.evaluate_difficult or not gts[j][1]:
                            hit = 0 if visited[j] else 1
                            visited[j] = True
                            self._tp.setdefault(lab, []).append((score, hit))
                            self._fp.setdefault(lab, []).append(
                                (score, 1 - hit))
                    else:
                        self._tp.setdefault(lab, []).append((score, 0))
                        self._fp.setdefault(lab, []).append((score, 1))

    def eval(self, executor=None, eval_program=None):
        """→ mAP over classes with ground truth (detection_map_op.h:424)."""
        total = 0.0
        count = 0
        for lab, num_pos in self._pos_count.items():
            if lab == self.background_label:
                continue
            if lab not in self._tp:
                count += 1
                continue
            pairs = sorted(zip(self._tp[lab], self._fp[lab]),
                           key=lambda p: -p[0][0])
            tp_sum = np.cumsum([t for (_, t), _ in pairs])
            fp_sum = np.cumsum([f for _, (_, f) in pairs])
            precision = tp_sum / np.maximum(tp_sum + fp_sum, 1e-12)
            recall = tp_sum / num_pos
            if self.ap_version == "11point":
                ap = 0.0
                for t in np.arange(0.0, 1.1, 0.1):
                    mask = recall >= t - 1e-9
                    ap += (precision[mask].max() if mask.any() else 0.0) / 11
            else:  # integral
                ap = 0.0
                prev_r = 0.0
                for p, r in zip(precision, recall):
                    if abs(r - prev_r) > 1e-6:
                        ap += p * abs(r - prev_r)
                    prev_r = r
            total += ap
            count += 1
        return total / count if count else 0.0
