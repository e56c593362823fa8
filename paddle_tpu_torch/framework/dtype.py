"""Dtype names of the port (the subset of ``paddle_tpu.framework.dtype``
that the models and optimizers read): paddle's names ``"float32"``,
``"bfloat16"`` and ``"float16"`` map onto torch dtypes; a torch dtype
passes through.
"""
from __future__ import annotations

import numpy as np
import torch

from .errors import InvalidArgumentError

__all__ = ["convert_dtype", "is_low_precision", "numpy_to_tensor",
           "to_numpy", "promote", "RAW_BITS"]

_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64,
          "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
          "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
          "complex64": torch.complex64, "complex128": torch.complex128}
_PY = {float: torch.float32, int: torch.int64, bool: torch.bool}


def convert_dtype(d) -> torch.dtype:
    """A paddle dtype name (``"float32"``, ``"bfloat16"``, ``"int64"``,
    ``"bool"`` …), a numpy dtype, a Python type or a torch dtype → torch
    dtype."""
    if isinstance(d, torch.dtype):
        return d
    if d in _PY:
        return _PY[d]
    try:
        name = d if isinstance(d, str) else np.dtype(d).name
    except TypeError:
        name = None
    if name not in _NAMES:
        raise InvalidArgumentError(f"unsupported dtype {d!r}")
    return _NAMES[name]


def is_low_precision(x) -> bool:
    """True for bfloat16/float16 tensors (or dtypes): the ones that get
    float32 optimizer moments and, with ``multi_precision``, a float32
    master copy."""
    dt = x if isinstance(x, torch.dtype) else x.dtype
    return dt in (torch.bfloat16, torch.float16)


def numpy_to_tensor(a, device=None) -> torch.Tensor:
    """A numpy array (or scalar) as a tensor on ``device``.  An
    ``ml_dtypes.bfloat16`` array — what the JAX package hands out for a
    bf16 value — is recognised by its dtype name and reinterpreted bit for
    bit as ``torch.bfloat16``, without importing ``ml_dtypes``.  Tensors
    pass through (moved to ``device`` if one is given)."""
    if isinstance(a, torch.Tensor):
        return a if device is None else a.to(device)
    a = np.asarray(a)
    if not a.flags.writeable:  # torch tensors may not alias read-only data
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    t = t.reshape(a.shape)  # ascontiguousarray makes a 0-d array 1-d
    return t if device is None else t.to(device)


#: tensors of these dtypes have no numpy dtype without ``ml_dtypes``:
#: ``to_numpy`` widens them to float32, which holds each value exactly
#: numpy has no float8 / bfloat16: host arrays that must keep such a
#: tensor's bits (a KV hand-off payload) carry them in these integer dtypes
#: (torch dtype, numpy dtype)
RAW_BITS = {torch.float8_e4m3fn: (torch.uint8, np.uint8),
            torch.bfloat16: (torch.int16, np.int16)}

_WIDEN = {torch.bfloat16, getattr(torch, "float8_e4m3fn", None),
          getattr(torch, "float8_e5m2", None)} - {None}


def to_numpy(x) -> np.ndarray:
    """The inverse of :func:`numpy_to_tensor`: a tensor as a host numpy
    array (a bf16 or float8 one widened to float32, exactly); anything
    else through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        return (t.float() if t.dtype in _WIDEN else t).cpu().numpy()
    return np.asarray(x)


def promote(*tensors):
    """``tensors`` cast to their promoted dtype (float32 for bf16 beside
    float32, or bf16 beside fp16), as ``jnp.matmul`` / ``jnp.einsum``
    promote mixed operands where a torch product raises.  Amp O1 hands a
    product such operands: a bf16 activation beside a float32 weight."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t if t.dtype == dt else t.to(dt) for t in tensors)
