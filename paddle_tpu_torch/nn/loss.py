"""Loss layers — port of ``paddle_tpu.nn.loss`` (``CrossEntropyLoss``)."""
from __future__ import annotations

from .functional.loss import cross_entropy
from .layer import Layer

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss(Layer):
    """Hard-label cross entropy as a layer: ``loss(input, label)``, usable
    as ``Model.prepare(loss=CrossEntropyLoss())``."""

    def __init__(self, ignore_index: int = -100, reduction: str = "mean"):
        super().__init__()
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return cross_entropy(input, label, ignore_index=self.ignore_index,
                             reduction=self.reduction)
