"""paddle_tpu_torch.optimizer — optimizers, weight averaging, lr
schedulers and gradient clipping (port of ``paddle_tpu.optimizer``; see
optimizer.py for the rules and their SelectedRows modes).
``GradientMergeOptimizer`` is in ``optimizer.gradient_merge``, as in the
JAX package; ``DGCMomentum`` (optimizer/dgc.py) steps inside the fleet
``DGCPlan`` (``strategy.dgc``)."""
from . import lr
from .averaging import ExponentialMovingAverage, Lookahead, ModelAverage
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .dgc import DGCMomentum
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Ftrl,
                        Lamb, Lars, Momentum, Optimizer, RMSProp)

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "Adam", "AdamW",
           "Adamax", "RMSProp", "Adadelta", "Ftrl", "Lamb", "Lars",
           "ExponentialMovingAverage", "Lookahead", "ModelAverage",
           "DGCMomentum", "lr", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]
