"""paddle_tpu_torch.optimizer — optimizers, lr schedulers and gradient
clipping (port of ``paddle_tpu.optimizer``; see optimizer.py for the
rules)."""
from . import lr
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "lr",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]
