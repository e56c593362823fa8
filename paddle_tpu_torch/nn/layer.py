"""``Layer`` — the port's ``torch.nn.Module`` base for models, with the
paddle ``astype`` spelling (port of ``paddle_tpu.nn.layer_base.Layer``'s
dtype cast)."""
from __future__ import annotations

import torch

from ..framework.dtype import convert_dtype

__all__ = ["Layer"]


class Layer(torch.nn.Module):
    def astype(self, dtype):
        """Cast every floating parameter and buffer to ``dtype`` (a paddle
        name such as ``"bfloat16"`` or a torch dtype), in place; returns
        ``self`` — ``BertForPretraining(cfg).astype("bfloat16")``."""
        return self.to(dtype=convert_dtype(dtype))
