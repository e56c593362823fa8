"""Tensor creation — port of ``paddle_tpu.tensor.creation``.

A call without ``place`` creates its tensor on the default device (the
card unless ``set_device("cpu")`` chose the CPU).  Floats default to
float32, as in the JAX package."""
from __future__ import annotations

import builtins

import torch

from ..framework.errors import InvalidArgumentError
from ._common import DEFAULT_FLOAT, device_of, dtype_or, t

__all__ = ["to_tensor", "zeros", "ones", "full", "zeros_like", "ones_like",
           "full_like", "empty", "empty_like", "arange", "linspace",
           "logspace", "eye", "meshgrid", "diag", "diagflat", "tril", "triu",
           "tril_indices", "triu_indices", "assign", "clone", "complex",
           "real", "imag", "numel", "one_hot"]


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """Parity: ``paddle.to_tensor`` on ``place`` (default: the default
    device); float64 host data without ``dtype`` becomes float32.
    ``stop_gradient=False`` makes a leaf that requires grad."""
    dev = device_of(place)
    if isinstance(data, torch.Tensor):
        out = data.to(dev)
        if dtype is not None:
            out = out.to(dtype_or(dtype))
        else:
            out = out.clone() if out is data else out
    else:
        out = t(data, torch.empty(0, device=dev))
        if dtype is not None:
            out = out.to(dtype_or(dtype))
    if not stop_gradient:
        out.requires_grad_(True)
    return out


def zeros(shape, dtype=None, place=None):
    return torch.zeros(_shape(shape), dtype=dtype_or(dtype, DEFAULT_FLOAT),
                       device=device_of(place))


def ones(shape, dtype=None, place=None):
    return torch.ones(_shape(shape), dtype=dtype_or(dtype, DEFAULT_FLOAT),
                      device=device_of(place))


def full(shape, fill_value, dtype=None, place=None):
    """A Python int or float fills float32 without ``dtype`` (paddle's
    default float), a bool fills bool."""
    if dtype is None:
        if isinstance(fill_value, bool):
            dtype = torch.bool
        elif isinstance(fill_value, (int, float)):
            dtype = DEFAULT_FLOAT
    if isinstance(fill_value, torch.Tensor):
        fill_value = fill_value.item()
    return torch.full(_shape(shape), fill_value, dtype=dtype_or(dtype),
                      device=device_of(place))


def zeros_like(x, dtype=None):
    return torch.zeros_like(t(x), dtype=dtype_or(dtype))


def ones_like(x, dtype=None):
    return torch.ones_like(t(x), dtype=dtype_or(dtype))


def full_like(x, fill_value, dtype=None):
    return torch.full_like(t(x), fill_value, dtype=dtype_or(dtype))


def empty(shape, dtype=None, place=None):
    """Zeros, as the JAX package's (its buffers have no uninitialised
    state)."""
    return zeros(shape, dtype, place)


def empty_like(x, dtype=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, place=None):
    if end is None:
        start, end = 0, start
    if dtype is None and builtins.all(
            isinstance(v, int) for v in (start, end, step)):
        dtype = torch.int64
    return torch.arange(start, end, step, dtype=dtype_or(
        dtype, DEFAULT_FLOAT), device=device_of(place))


def linspace(start, stop, num, dtype=None, place=None):
    return torch.linspace(float(start), float(stop), int(num),
                          dtype=dtype_or(dtype, DEFAULT_FLOAT),
                          device=device_of(place))


def logspace(start, stop, num, base=10.0, dtype=None, place=None):
    return torch.logspace(float(start), float(stop), int(num), base=base,
                          dtype=dtype_or(dtype, DEFAULT_FLOAT),
                          device=device_of(place))


def eye(num_rows, num_columns=None, dtype=None, place=None):
    return torch.eye(num_rows, num_columns if num_columns is not None
                     else num_rows, dtype=dtype_or(dtype, DEFAULT_FLOAT),
                     device=device_of(place))


def meshgrid(*args):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = tuple(args[0])
    return list(torch.meshgrid(*[t(a) for a in args], indexing="ij"))


def diag(x, offset=0, padding_value=0):
    x = t(x)
    d = torch.diag(x, offset)
    if x.dim() == 1 and padding_value != 0:
        mask = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
        d = torch.where(mask, d, torch.full_like(d, padding_value))
    return d


def diagflat(x, offset=0):
    return torch.diagflat(t(x), offset)


def tril(x, diagonal=0):
    return torch.tril(t(x), diagonal)


def triu(x, diagonal=0):
    return torch.triu(t(x), diagonal)


def tril_indices(row, col, offset=0, place=None):
    return torch.tril_indices(row, col, offset, device=device_of(place))


def triu_indices(row, col=None, offset=0, place=None):
    return torch.triu_indices(row, col if col is not None else row, offset,
                              device=device_of(place))


def assign(x, output=None):
    """Parity: ``paddle.assign``: a copy of ``x``; with ``output`` the
    copy is written into it (in place), which is returned."""
    src = t(x).clone()
    if output is not None:
        with torch.no_grad():
            output.copy_(src)
        return output
    return src


def clone(x):
    return t(x).clone()


def complex(real_, imag_):
    return torch.complex(t(real_), t(imag_))


def real(x):
    x = t(x)
    return torch.real(x) if x.is_complex() else x.clone()


def imag(x):
    x = t(x)
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def numel(x):
    x = t(x)
    return torch.tensor(x.numel(), device=x.device)


def one_hot(x, num_classes):
    if num_classes <= 0:
        raise InvalidArgumentError("num_classes must be > 0")
    x = t(x).long()
    valid = (x >= 0) & (x < num_classes)
    out = torch.nn.functional.one_hot(x.clamp(0, num_classes - 1),
                                      num_classes).to(DEFAULT_FLOAT)
    return out * valid.unsqueeze(-1)

