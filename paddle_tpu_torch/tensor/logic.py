"""Comparisons, logical and bitwise functions — port of
``paddle_tpu.tensor.logic``."""
from __future__ import annotations

import torch

from ._common import t

__all__ = [
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "equal_all", "allclose", "isclose",
    "logical_and", "logical_or", "logical_xor", "logical_not",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_left_shift", "bitwise_right_shift",
    "is_tensor", "is_empty", "isin",
]


def _pair(x, y):
    x = t(x)
    return x, (y if isinstance(y, (int, float, bool)) else t(y, x))


def equal(x, y, name=None):
    return torch.eq(*_pair(x, y))


def not_equal(x, y, name=None):
    return torch.ne(*_pair(x, y))


def greater_than(x, y, name=None):
    return torch.gt(*_pair(x, y))


def greater_equal(x, y, name=None):
    return torch.ge(*_pair(x, y))


def less_than(x, y, name=None):
    return torch.lt(*_pair(x, y))


def less_equal(x, y, name=None):
    return torch.le(*_pair(x, y))


def equal_all(x, y, name=None):
    """True when the shapes match and every element is equal (a 0-d bool
    tensor)."""
    x, y = t(x), t(y)
    same = x.shape == y.shape and bool(torch.equal(x, y.to(x.dtype)))
    return torch.tensor(same, device=x.device)


def _fpair(x, y):
    x = t(x)
    y = t(y, x)
    dt = torch.promote_types(x.dtype, y.dtype)
    if not (dt.is_floating_point or dt.is_complex):
        dt = torch.float32
    return x.to(dt), y.to(dt)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = _fpair(x, y)
    return torch.tensor(torch.allclose(x, y, rtol, atol, equal_nan),
                        device=x.device)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.isclose(*_fpair(x, y), rtol, atol, equal_nan)


def logical_and(x, y, out=None, name=None):
    return torch.logical_and(*_pair(x, y))


def logical_or(x, y, out=None, name=None):
    return torch.logical_or(*_pair(x, y))


def logical_xor(x, y, out=None, name=None):
    return torch.logical_xor(*_pair(x, y))


def logical_not(x, out=None, name=None):
    return torch.logical_not(t(x))


def bitwise_and(x, y, out=None, name=None):
    return torch.bitwise_and(*_pair(x, y))


def bitwise_or(x, y, out=None, name=None):
    return torch.bitwise_or(*_pair(x, y))


def bitwise_xor(x, y, out=None, name=None):
    return torch.bitwise_xor(*_pair(x, y))


def bitwise_not(x, out=None, name=None):
    return torch.bitwise_not(t(x))


def bitwise_left_shift(x, y, name=None):
    return torch.bitwise_left_shift(*_pair(x, y))


def bitwise_right_shift(x, y, name=None):
    return torch.bitwise_right_shift(*_pair(x, y))


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def is_empty(x, name=None):
    x = t(x)
    return torch.tensor(x.numel() == 0, device=x.device)


def isin(x, test_x, assume_unique=False, invert=False, name=None):
    x = t(x)
    return torch.isin(x, t(test_x, x), assume_unique=assume_unique,
                      invert=invert)
