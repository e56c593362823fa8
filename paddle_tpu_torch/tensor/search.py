"""Search and sort — port of ``paddle_tpu.tensor.search``.

As the JAX package: ``median``'s default ``mode="avg"`` averages the two
middle values (``torch.median`` takes the lower); ``argsort`` / ``sort``
are stable; ``topk`` breaks ties toward the lower index; ``nonzero``
returns ``[n, ndim]`` int64 in row-major order; ``mode`` returns the
smallest most frequent value and its index in a stable sort."""
from __future__ import annotations

import torch

from ._common import DEFAULT_FLOAT, dtype_or, t

__all__ = ["argmax", "argmin", "argsort", "sort", "topk", "where",
           "nonzero", "index_select_search", "kthvalue", "mode", "median",
           "nanmedian", "searchsorted", "bucketize", "masked_select_idx"]


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    x = t(x)
    out = torch.argmax(x) if axis is None else torch.argmax(x, axis, keepdim)
    return out.to(dtype_or(dtype))


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    x = t(x)
    out = torch.argmin(x) if axis is None else torch.argmin(x, axis, keepdim)
    return out.to(dtype_or(dtype))


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    return torch.sort(t(x), dim=axis, descending=descending,
                      stable=True).indices


def sort(x, axis=-1, descending=False, stable=False, name=None):
    return torch.sort(t(x), dim=axis, descending=descending,
                      stable=True).values


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    """The ``k`` largest (smallest) along ``axis`` (default last), ties
    toward the lower index (``lax.top_k``)."""
    x = t(x)
    axis = -1 if axis is None else axis
    idx = torch.sort(x, dim=axis, descending=largest,
                     stable=True).indices.narrow(axis, 0, k)
    return torch.gather(x, axis, idx), idx


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    c = t(condition).bool()
    x = x if isinstance(x, (int, float)) else t(x, c)
    y = y if isinstance(y, (int, float)) else t(y, c)
    return torch.where(c, x, y)


def nonzero(x, as_tuple=False):
    """``[n, ndim]`` int64 indices in row-major order; ``as_tuple``: one
    ``[n, 1]`` tensor per dim."""
    idx = torch.nonzero(t(x))
    if as_tuple:
        return tuple(idx[:, i:i + 1] for i in range(idx.shape[1]))
    return idx


def index_select_search(x, index, axis=0):
    x = t(x)
    return torch.index_select(x, axis, t(index, x).long())


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    x = t(x)
    vals, idx = torch.sort(x, dim=axis, stable=True)
    v = vals.narrow(axis, k - 1, 1)
    i = idx.narrow(axis, k - 1, 1)
    return (v, i) if keepdim else (v.squeeze(axis), i.squeeze(axis))


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest of a tie) and
    the index, in the input, of its first entry in a stable sort."""
    x = t(x)
    n = x.shape[axis]
    vals, order = torch.sort(x.movedim(axis, -1), dim=-1, stable=True)
    flat, forder = vals.reshape(-1, n), order.reshape(-1, n)
    new_run = torch.ones_like(flat, dtype=torch.bool)
    new_run[:, 1:] = flat[:, 1:] != flat[:, :-1]
    run_id = torch.cumsum(new_run.long(), -1) - 1
    counts = torch.zeros_like(run_id).scatter_add_(
        1, run_id, torch.ones_like(run_id))
    best = counts.argmax(-1, keepdim=True)          # first largest run
    pos = (run_id == best).long().argmax(-1, keepdim=True)
    v = flat.gather(1, pos).reshape(vals.shape[:-1])
    i = forder.gather(1, pos).reshape(vals.shape[:-1])
    if keepdim:
        v, i = v.unsqueeze(axis), i.unsqueeze(axis)
    return v, i


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    """``mode="avg"``: the mean of the two middle values of an even count
    (``jnp.median``); ``"min"``: the lower one."""
    x = t(x)
    if not x.is_floating_point():
        x = x.to(DEFAULT_FLOAT)
    if axis is None:
        flat = x.reshape(-1)
        if mode == "avg":
            return torch.quantile(flat, 0.5).reshape(
                (1,) * x.dim() if keepdim else ())
        return torch.sort(flat).values[(flat.shape[0] - 1) // 2]
    if mode == "avg":
        return torch.quantile(x, 0.5, dim=axis, keepdim=keepdim)
    n = x.shape[axis]
    out = torch.sort(x, dim=axis).values.narrow(axis, (n - 1) // 2, 1)
    return out if keepdim else out.squeeze(axis)


def nanmedian(x, axis=None, keepdim=False, name=None):
    """The median of the non-NaN values (the two middle ones averaged,
    ``jnp.nanmedian``)."""
    x = t(x)
    if not x.is_floating_point():
        x = x.to(DEFAULT_FLOAT)
    if axis is None:
        out = torch.nanquantile(x.reshape(-1), 0.5)
        return out.reshape((1,) * x.dim()) if keepdim else out
    return torch.nanquantile(x, 0.5, dim=axis, keepdim=keepdim)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    s = t(sorted_sequence)
    return torch.searchsorted(s, t(values, s), right=right,
                              out_int32=out_int32)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def masked_select_idx(x, mask):
    x = t(x)
    return torch.masked_select(x, t(mask, x).bool())
