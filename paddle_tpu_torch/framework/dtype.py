"""Dtype names of the port (the subset of ``paddle_tpu.framework.dtype``
that the models and optimizers read): paddle's names ``"float32"``,
``"bfloat16"`` and ``"float16"`` map onto torch dtypes; a torch dtype
passes through.
"""
from __future__ import annotations

import torch

from .errors import InvalidArgumentError

__all__ = ["convert_dtype", "is_low_precision"]

_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def convert_dtype(d) -> torch.dtype:
    """A paddle dtype name (``"float32"``, ``"bfloat16"``, ``"float16"``)
    or a torch dtype → torch dtype."""
    if isinstance(d, torch.dtype):
        return d
    if d not in _NAMES:
        raise InvalidArgumentError(f"unsupported dtype {d!r}")
    return _NAMES[d]


def is_low_precision(x) -> bool:
    """True for bfloat16/float16 tensors (or dtypes): the ones that get
    float32 optimizer moments and, with ``multi_precision``, a float32
    master copy."""
    dt = x if isinstance(x, torch.dtype) else x.dtype
    return dt in (torch.bfloat16, torch.float16)
