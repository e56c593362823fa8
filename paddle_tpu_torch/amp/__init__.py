"""paddle_tpu_torch.amp — automatic mixed precision (port of
``paddle_tpu.amp``): the per-layer autocast policy (``auto_cast``,
``decorate``) and dynamic loss scaling (``GradScaler``)."""
from .auto_cast import (BLACK_CLASSES, WHITE_CLASSES, amp_guard, amp_state,
                        auto_cast, decorate)
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["auto_cast", "amp_guard", "decorate", "amp_state",
           "WHITE_CLASSES", "BLACK_CLASSES", "GradScaler", "AmpScaler"]
