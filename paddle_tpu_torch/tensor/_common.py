"""What the tensor functions share: turning arguments into tensors on the
right device, the default float dtype, axis normalisation."""
from __future__ import annotations

import numpy as np
import torch

from ..framework.device import resolve_device
from ..framework.dtype import convert_dtype, numpy_to_tensor

DEFAULT_FLOAT = torch.float32


def device_of(place=None) -> torch.device:
    """``place`` or the default device (the card unless ``set_device``
    chose the CPU)."""
    return resolve_device(place)


def t(x, like=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor passes through; numpy arrays, Python
    numbers and lists land on ``like``'s device, or the default one.
    float64 host data becomes float32, as the JAX package's arrays (x64
    off)."""
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if isinstance(like, torch.Tensor) else device_of()
    if isinstance(x, (list, tuple)) and any(
            isinstance(v, torch.Tensor) for v in x):
        return torch.stack([t(v, like) for v in x]).to(dev)
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return numpy_to_tensor(a, dev)


def f(x, like=None) -> torch.Tensor:
    """``x`` as a floating tensor: integer and bool ones become float32."""
    x = t(x, like)
    if not (x.is_floating_point() or x.is_complex()):
        x = x.to(DEFAULT_FLOAT)
    return x


def dtype_or(d, default=None):
    return convert_dtype(d) if d is not None else default


def axes(axis):
    """A paddle axis (int, list or tuple) as torch's ``dim``."""
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return axis


def all_dims(x) -> tuple:
    return tuple(range(x.dim()))
