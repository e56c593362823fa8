"""paddle.save / paddle.load — checkpoint serialization (port of
``paddle_tpu.framework.serialization``).

The same file format as the JAX package, so a checkpoint written by either
package loads in the other: the magic ``PTPU0001`` and a pickle of nested
containers (dicts, lists, tuples, namedtuples) whose leaves are numpy
arrays, numpy scalars or plain Python values.  Tensors are copied to host
numpy before writing; a ``bfloat16`` (or float8) tensor is written as a
float32 array, which is lossless, so reading the file needs no
``ml_dtypes`` — ``Layer.set_state_dict`` in both packages casts each value
back to its parameter's dtype.  The write goes to ``path + ".tmp"`` and
is renamed over ``path`` (``os.replace``), so a crashed save never leaves
a damaged checkpoint.

``load`` returns numpy leaves.  It rejects a file without the magic, with
one exception: headerless pickles from the reference's ``paddle.save`` load
when (and only when) the file is named ``*.pdparams`` / ``*.pdopt``.  A
JAX checkpoint whose leaves are ``ml_dtypes.bfloat16`` arrays loads where
``ml_dtypes`` can be imported; where it cannot, ``load`` raises
``InvalidArgumentError`` naming the first such leaf — it never
reinterprets one silently.  Unpickling any file implies trusting its
origin.
"""
from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

from ..resilience.faults import fault_point
from .dtype import to_numpy
from .errors import InvalidArgumentError, NotFoundError

__all__ = ["save", "load"]

_MAGIC = b"PTPU0001"


def _to_host(obj: Any) -> Any:
    """Tensors (parameters included) in ``obj`` as host numpy arrays,
    recursively through dicts, lists, tuples and namedtuples."""
    if isinstance(obj, torch.Tensor):
        return to_numpy(obj)  # bf16 / float8 as float32: lossless
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # namedtuple
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj  # numpy values, scalars, scheduler state: picklable as is


def save(obj: Any, path, protocol: int = 4, **configs):
    """Serialize ``obj`` (state dicts, nested containers, tensors) to
    ``path``; parent directories are created."""
    if not isinstance(path, (str, os.PathLike)):
        raise InvalidArgumentError(f"save path must be str, got {type(path)}")
    path = os.fspath(path)
    if os.path.isdir(path):
        raise InvalidArgumentError(f"save path {path!r} is a directory")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    payload = _to_host(obj)
    fault_point("serialization.save")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        pickle.dump(payload, f, protocol=protocol)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# -- reading ml_dtypes leaves without ml_dtypes --------------------------------
class _Missing:
    """Stands for a class of a module that cannot be imported."""

    def __init__(self, qualname: str):
        self.qualname = qualname


class _MissingDtype(_Missing):
    def __setstate__(self, state):
        pass


class _PendingArray(np.ndarray):
    """An array being unpickled; ``missing`` names its dtype where that
    dtype's module cannot be imported."""

    missing = None

    def __setstate__(self, state):
        if isinstance(state[2], _MissingDtype):
            self.missing = state[2].qualname
            return
        super().__setstate__(state)


def _dtype(*args):
    if isinstance(args[0], _Missing):
        return _MissingDtype(args[0].qualname)
    return np.dtype(*args)


def _reconstruct(cls, shape, dtype):
    return np.ndarray.__new__(_PendingArray, shape, dtype)


def _scalar(dtype, *args):
    if isinstance(dtype, _MissingDtype):
        return _MissingDtype(dtype.qualname)
    return np.core.multiarray.scalar(dtype, *args)


class _TolerantUnpickler(pickle.Unpickler):
    """Unpickles ``ml_dtypes`` arrays into markers instead of failing, so
    :func:`load` can name the leaf."""

    def find_class(self, module, name):
        if module.split(".")[0] == "ml_dtypes":
            return _Missing(f"{module}.{name}")
        if module == "numpy" and name == "dtype":
            return _dtype
        if module in ("numpy.core.multiarray", "numpy._core.multiarray"):
            if name == "_reconstruct":
                return _reconstruct
            if name == "scalar":
                return _scalar
        return super().find_class(module, name)


def _settle(obj, path: str):
    """``obj`` with pending arrays made plain; raises at the first leaf
    whose dtype could not be imported."""
    if isinstance(obj, (_PendingArray, _MissingDtype)):
        missing = getattr(obj, "missing", None) or getattr(obj, "qualname",
                                                           None)
        if missing is not None:
            raise InvalidArgumentError(
                f"checkpoint leaf {path or '<root>'} is a {missing} array, "
                f"and ml_dtypes cannot be imported here to read it; load "
                f"the file where ml_dtypes is installed, or save its "
                f"low-precision leaves as float32")
        return obj.view(np.ndarray)
    if isinstance(obj, dict):
        return {k: _settle(v, f"{path}.{k}" if path else str(k))
                for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_settle(v, f"{path}.{f}" if path else f)
                           for f, v in zip(obj._fields, obj)))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_settle(v, f"{path}[{i}]")
                         for i, v in enumerate(obj))
    return obj


def _unpickle(f, path: str):
    start = f.tell()
    try:
        return pickle.load(f)
    except ImportError as e:
        if "ml_dtypes" not in str(e):
            raise
    f.seek(start)
    return _settle(_TolerantUnpickler(f).load(), "")


def load(path, **configs) -> Any:
    """Load an object written by :func:`save` (either package's).  Leaves
    come back as numpy arrays; feed them to ``Layer.set_state_dict`` /
    ``Optimizer.set_state_dict``, which cast them onto each target's
    device and dtype."""
    path = os.fspath(path)
    if not os.path.exists(path):
        raise NotFoundError(f"checkpoint file {path!r} does not exist")
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic == _MAGIC:
            try:
                return _unpickle(f, path)
            except InvalidArgumentError:
                raise
            except Exception as e:
                # a magic-headed file that fails to unpickle is a DAMAGED
                # checkpoint (truncated write, bit flip), not a format
                # mismatch
                raise InvalidArgumentError(
                    f"{path!r} is a paddle_tpu checkpoint but its payload "
                    f"is corrupt ({type(e).__name__}: {e}) — truncated or "
                    f"bit-flipped write") from e
        # the compat fallback only for the reference's own extensions: a
        # stray pickle under another name is rejected before unpickling
        if not path.endswith((".pdparams", ".pdopt")):
            raise InvalidArgumentError(
                f"{path!r} is not a paddle_tpu checkpoint (bad magic "
                f"{magic!r}); reference paddle pickles load only from "
                f".pdparams/.pdopt files")
        f.seek(0)
        try:
            return _unpickle(f, path)
        except InvalidArgumentError:
            raise
        except Exception:
            raise InvalidArgumentError(
                f"{path!r} is neither a paddle_tpu checkpoint (magic "
                f"{_MAGIC!r}) nor a reference paddle pickle")
