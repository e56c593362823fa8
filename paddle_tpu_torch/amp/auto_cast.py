"""Automatic mixed precision — the autocast policy (port of
``paddle_tpu.amp.auto_cast``).

The policy acts at the layer call, by class name, as the JAX package's
does: inside :func:`auto_cast`, a white-list layer (``Linear``,
``BertSelfAttention``, the parallel linears, ...) casts its floating
inputs AND its own parameters down to the amp dtype for the call; a
black-list layer (the norms, the loss layers) casts them up to float32;
every other layer runs in whatever dtype arrives, except under O2, where
every layer that is not black-listed casts down.  ``Layer.__call__``
applies the policy (:func:`cast_layer_call`), so it reaches exactly the
port's ``nn.Layer`` subclasses, whose class names are the JAX package's.

It is not ``torch.autocast``, which decides per operation: that would,
for one, run BERT's tied MLM decoder product in bf16 where the JAX policy
keeps it in float32.  A parameter's cast stays in the autograd graph, so
its gradient reaches the float32 parameter in float32.  The parameters
are put back when the call returns or raises.  With amp off the cost is
one thread-local check a layer call.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Set

import torch

from ..framework.dtype import convert_dtype
from ..framework.errors import InvalidArgumentError

__all__ = ["auto_cast", "amp_guard", "decorate", "amp_state",
           "cast_layer_call", "WHITE_CLASSES", "BLACK_CLASSES"]

# layer-class names, the JAX package's lists
WHITE_CLASSES: Set[str] = {
    "Linear", "Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
    "Conv2DTranspose", "Conv3DTranspose", "ColumnParallelLinear",
    "RowParallelLinear", "MultiHeadAttention", "ParallelAttention",
    "BertSelfAttention",
}
BLACK_CLASSES: Set[str] = {
    "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D", "SyncBatchNorm",
    "LayerNorm", "GroupNorm", "InstanceNorm1D", "InstanceNorm2D",
    "InstanceNorm3D", "Softmax", "LogSoftmax",
    "CrossEntropyLoss", "NLLLoss", "BCELoss", "BCEWithLogitsLoss",
    "KLDivLoss", "MSELoss", "L1Loss", "SmoothL1Loss",
}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.white: Set[str] = set()
        self.black: Set[str] = set()


_state = _AmpState()


def amp_state() -> _AmpState:
    """This thread's policy: ``enabled``, ``dtype``, ``level``, ``white``,
    ``black``."""
    return _state


def _cast_floats(x, dtype):
    """Floating tensors in ``x`` (recursively through tuples, lists and
    dicts) cast to ``dtype``; everything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    if isinstance(x, (tuple, list)):
        return type(x)(_cast_floats(v, dtype) for v in x)
    if isinstance(x, dict):
        return {k: _cast_floats(v, dtype) for k, v in x.items()}
    return x


def _policy_dtype(layer) -> Optional[torch.dtype]:
    """The dtype ``layer``'s floats compute in under the active policy, or
    None (no cast)."""
    if not _state.enabled:
        return None
    name = type(layer).__name__
    if name in _state.black:
        return torch.float32
    if name in _state.white or _state.level == "O2":
        return _state.dtype
    return None


@contextlib.contextmanager
def cast_layer_call(layer, args, kwargs):
    """Called from ``Layer.__call__``: the active policy applied to the
    call's inputs and to the layer's own parameters (not its sublayers':
    each of those applies the policy at its own call).  The cast
    parameters stand in ``layer._parameters`` for the call — the forward
    reads ``self.weight`` as usual — and the originals are put back in a
    ``finally``."""
    dtype = _policy_dtype(layer)
    if dtype is None:
        yield args, kwargs
        return
    args = _cast_floats(tuple(args), dtype)
    kwargs = _cast_floats(dict(kwargs), dtype)
    params = layer._parameters
    saved = {}
    for name, p in params.items():
        if p is not None and p.is_floating_point() and p.dtype != dtype:
            saved[name] = p
    try:
        for name, p in saved.items():
            params[name] = p.to(dtype)  # in the graph: grads reach p
        yield args, kwargs
    finally:
        params.update(saved)


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list=None,
              custom_black_list=None, level: str = "O1", dtype="bfloat16"):
    """Enable the mixed-precision policy for the block.

    O1: the white / black lists (default).  O2: every floating layer call
    is cast to the amp dtype except black-list layers (use with
    :func:`decorate` for low-precision parameters with float32 masters).
    ``custom_white_list`` / ``custom_black_list`` add class names; a name
    in the custom white list leaves the black list."""
    if level not in ("O0", "O1", "O2"):
        raise InvalidArgumentError(f"amp level {level!r} not in O0/O1/O2")
    dt = (torch.bfloat16 if str(dtype) in ("bfloat16", "bf16",
                                           "torch.bfloat16")
          else torch.float16)
    prev = (_state.enabled, _state.dtype, _state.level, _state.white,
            _state.black)
    white = set(WHITE_CLASSES) | set(custom_white_list or ())
    black = ((set(BLACK_CLASSES) - set(custom_white_list or ()))
             | set(custom_black_list or ()))
    white -= set(custom_black_list or ())
    _state.enabled = enable and level != "O0"
    _state.dtype = dt
    _state.level = level
    _state.white = white
    _state.black = black
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level,
         _state.white, _state.black) = prev


amp_guard = auto_cast  # the legacy name


def decorate(models=None, optimizers=None, level: str = "O2",
             dtype="bfloat16", master_weight: Optional[bool] = None,
             save_dtype=None):
    """O2 preparation: cast the models' floating parameters and buffers to
    the amp dtype and give the optimizers float32 master weights
    (``multi_precision``) unless ``master_weight=False``.  Other levels
    return the arguments untouched."""
    from ..nn.layer import Layer
    from ..optimizer.optimizer import Optimizer

    if level != "O2":
        return (models, optimizers) if optimizers is not None else models
    nets = models if isinstance(models, (list, tuple)) else [models]
    for net in nets:
        if isinstance(net, Layer):
            net.astype(convert_dtype(str(dtype).replace("torch.", "")))
    opts = (optimizers if isinstance(optimizers, (list, tuple))
            else [optimizers])
    for opt in opts:
        if isinstance(opt, Optimizer) and master_weight is not False:
            opt._multi_precision = True
    if optimizers is None:
        return models
    return models, optimizers
