"""Statistics — port of ``paddle_tpu.tensor.stat``."""
from __future__ import annotations

import numpy as np
import torch

from ..framework.dtype import numpy_to_tensor
from ._common import all_dims, axes, f, t
from .creation import numel  # noqa: F401  (stat's names, as in JAX)
from .math import mean  # noqa: F401

__all__ = ["mean", "std", "var", "numel", "quantile", "nanquantile",
           "histogramdd"]


def _dims(x, axis):
    return all_dims(x) if axis is None else axes(axis)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = f(x)
    return torch.std(x, dim=_dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = f(x)
    return torch.var(x, dim=_dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def _quantile(fn, x, q, axis, keepdim, interpolation):
    x = f(x)
    qs = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    if axis is None:
        out = fn(x.reshape(-1), qs, interpolation=interpolation)
        if keepdim:
            out = out.reshape(qs.shape + (1,) * x.dim())
        return out
    return fn(x, qs, dim=axis, keepdim=keepdim, interpolation=interpolation)


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    return _quantile(torch.quantile, x, q, axis, keepdim, interpolation)


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    return _quantile(torch.nanquantile, x, q, axis, keepdim, interpolation)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """``np.histogramdd`` on the host, as the JAX package: the counts
    (float64 as numpy's, here float32) and the edges of each dim."""
    x = t(x)
    hist, edges = np.histogramdd(
        x.detach().cpu().numpy(), bins=bins, range=ranges, density=density,
        weights=None if weights is None else t(weights).cpu().numpy())
    return (numpy_to_tensor(hist.astype(np.float32), x.device),
            [numpy_to_tensor(e.astype(np.float32), x.device) for e in edges])

