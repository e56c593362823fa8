"""Tensor printing — port of ``paddle_tpu.tensor.to_string``:
``set_printoptions`` sets the options (numpy's too, which
``to_string`` formats through) and torch's."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..framework.dtype import to_numpy

__all__ = ["set_printoptions", "to_string"]


@dataclass
class _PrintOptions:
    precision: int = 8
    threshold: int = 1000
    edgeitems: int = 3
    sci_mode: bool = False
    linewidth: int = 80


_options = _PrintOptions()


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    if precision is not None:
        _options.precision = int(precision)
    if threshold is not None:
        _options.threshold = int(threshold)
    if edgeitems is not None:
        _options.edgeitems = int(edgeitems)
    if sci_mode is not None:
        _options.sci_mode = bool(sci_mode)
    if linewidth is not None:
        _options.linewidth = int(linewidth)
    np.set_printoptions(precision=_options.precision,
                        threshold=_options.threshold,
                        edgeitems=_options.edgeitems,
                        linewidth=_options.linewidth,
                        suppress=not _options.sci_mode)
    torch.set_printoptions(precision=_options.precision,
                           threshold=_options.threshold,
                           edgeitems=_options.edgeitems,
                           linewidth=_options.linewidth,
                           sci_mode=_options.sci_mode)


def to_string(x, prefix="Tensor"):
    arr = to_numpy(x)
    with np.printoptions(precision=_options.precision,
                         threshold=_options.threshold,
                         edgeitems=_options.edgeitems,
                         linewidth=_options.linewidth,
                         suppress=not _options.sci_mode):
        body = np.array2string(arr, separator=", ")
    return (f"{prefix}(shape={list(arr.shape)}, dtype={arr.dtype},\n"
            f"       {body})")
