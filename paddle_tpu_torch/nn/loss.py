"""Loss layers — port of ``paddle_tpu.nn.loss``: each calls its function
of ``nn.functional.loss`` with the arguments it was built with, usable as
``Model.prepare(loss=CrossEntropyLoss())``.  ``HSigmoidLoss`` owns the
path classifiers: ``weight`` ``[num_classes - 1, feature_size]``
(``num_classes`` rows for a custom tree; XavierNormal) and ``bias``
(zeros)."""
from __future__ import annotations

from ..framework.errors import InvalidArgumentError
from .functional import loss as L
from .initializer import (Constant, XavierNormal, create_parameter,
                          fill_at_construction, init_parameter)
from .layer import Layer

__all__ = [
    "CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
    "BCEWithLogitsLoss", "KLDivLoss", "SmoothL1Loss", "MarginRankingLoss",
    "CosineEmbeddingLoss", "HingeEmbeddingLoss", "TripletMarginLoss",
    "CTCLoss", "HSigmoidLoss",
]


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return L.cross_entropy(
            input, label, weight=self.weight, ignore_index=self.ignore_index,
            reduction=self.reduction, soft_label=self.soft_label,
            axis=self.axis, use_softmax=self.use_softmax,
            label_smoothing=self.label_smoothing)


class _Reduced(Layer):
    """A loss of ``(input, label)`` and a reduction."""
    _fn = None

    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return getattr(L, self._fn)(input, label, reduction=self.reduction)


class MSELoss(_Reduced):
    _fn = "mse_loss"


class L1Loss(_Reduced):
    _fn = "l1_loss"


class KLDivLoss(_Reduced):
    _fn = "kl_div"


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight, self.ignore_index = weight, ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return L.nll_loss(input, label, self.weight, self.ignore_index,
                          self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return L.binary_cross_entropy(input, label, self.weight,
                                      self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return L.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction, self.delta = reduction, delta

    def forward(self, input, label):
        return L.smooth_l1_loss(input, label, self.reduction, self.delta)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, other, label):
        return L.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input1, input2, label):
        return L.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, label):
        return L.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.args = (margin, p, epsilon, swap, reduction)

    def forward(self, input, positive, negative):
        return L.triplet_margin_loss(input, positive, negative, *self.args)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return L.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


class HSigmoidLoss(Layer):
    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        if num_classes < 2:
            raise InvalidArgumentError("num_classes must be >= 2")
        self.num_classes, self.is_custom = num_classes, is_custom
        n_nodes = num_classes if is_custom else num_classes - 1
        self._attrs = (weight_attr, bias_attr)
        self.weight = create_parameter((n_nodes, feature_size), weight_attr)
        self.bias = create_parameter((n_nodes,), bias_attr)
        fill_at_construction(self)

    def reset_parameters(self, generator=None):
        init_parameter(self.weight, self._attrs[0], XavierNormal(),
                       generator)
        init_parameter(self.bias, self._attrs[1], Constant(0.0), generator)

    def forward(self, input, label, path_table=None, path_code=None):
        if self.is_custom and (path_table is None or path_code is None):
            raise InvalidArgumentError(
                "is_custom=True needs path_table and path_code")
        return L.hsigmoid_loss(input, label, self.num_classes, self.weight,
                               self.bias, path_table=path_table,
                               path_code=path_code)
