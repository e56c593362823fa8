"""Shape and layout manipulation — port of
``paddle_tpu.tensor.manipulation``.

The JAX package's semantics where torch's differ: ``split(x, n)`` makes
``n`` equal sections (``torch.split`` makes chunks of ``n``) and a
section list may hold one -1; ``chunk`` / ``tensor_split`` split as
``array_split``; ``pad``'s flat list is per-dim pairs in dim order when it
covers every dim, else last-dim-first pairs of the trailing dims;
``scatter(overwrite=False)`` zeroes the target rows and adds the
updates; ``unique`` / ``unique_consecutive`` / ``masked_select`` have
data-dependent sizes and run on the host, as in the JAX package."""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..framework.errors import InvalidArgumentError
from ._common import dtype_or, t

__all__ = [
    "reshape", "flatten", "squeeze", "unsqueeze", "transpose", "moveaxis",
    "concat", "stack", "unstack", "split", "chunk", "tile", "expand",
    "expand_as", "broadcast_to", "broadcast_tensors", "flip", "reverse",
    "rot90", "roll", "gather", "gather_nd", "scatter", "scatter_nd",
    "scatter_nd_add", "index_select", "index_sample", "index_add",
    "index_put", "put_along_axis", "take_along_axis", "slice",
    "strided_slice", "crop", "pad", "cast", "repeat_interleave", "unbind",
    "unique", "unique_consecutive", "masked_select", "masked_fill",
    "as_complex", "as_real", "view", "view_as", "tensordot", "atleast_1d",
    "atleast_2d", "atleast_3d", "tolist", "shard_index", "tensor_split",
    "hsplit", "vsplit", "dsplit", "hstack", "vstack", "dstack",
    "column_stack", "row_stack",
]


def _ts(xs):
    xs = list(xs)
    first = t(xs[0])
    return [first] + [t(v, first) for v in xs[1:]]


def _axis(axis):
    return int(axis.item()) if isinstance(axis, torch.Tensor) else axis


def _host(x):
    return t(x).detach().cpu().numpy()


def _back(a, like):
    from ..framework.dtype import numpy_to_tensor

    return numpy_to_tensor(np.asarray(a), like.device)


def reshape(x, shape, name=None):
    return torch.reshape(t(x), (shape,) if isinstance(shape, int)
                         else tuple(shape))


def view(x, shape_or_dtype, name=None):
    x = t(x)
    if isinstance(shape_or_dtype, (list, tuple)):
        return x.reshape(tuple(shape_or_dtype))
    return x.view(dtype_or(shape_or_dtype))


def view_as(x, other, name=None):
    return t(x).reshape(t(other).shape)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = t(x)
    if x.dim() == 0:
        return x.reshape(1)
    s, e = start_axis % x.dim(), stop_axis % x.dim()
    if s > e:
        raise InvalidArgumentError("start_axis must be <= stop_axis")
    return torch.flatten(x, s, e)


def squeeze(x, axis=None, name=None):
    x = t(x)
    if axis is None:
        return torch.squeeze(x)
    if isinstance(axis, int):
        axis = [axis]
    dims = tuple(a % x.dim() for a in axis if x.shape[a % x.dim()] == 1)
    return torch.squeeze(x, dims) if dims else x


def unsqueeze(x, axis, name=None):
    x = t(x)
    if isinstance(axis, int):
        axis = [axis]
    nd = x.dim() + len(axis)
    for a in sorted(a % nd for a in axis):
        x = x.unsqueeze(a)
    return x


def transpose(x, perm=None, name=None):
    x = t(x)
    if perm is None:
        perm = list(range(x.dim()))[::-1]
    return x.permute(tuple(perm))


def moveaxis(x, source, destination, name=None):
    return torch.movedim(t(x), source, destination)


def concat(x, axis=0, name=None):
    return torch.cat(_ts(x), dim=_axis(axis))


def stack(x, axis=0, name=None):
    return torch.stack(_ts(x), dim=axis)


def unstack(x, axis=0, num=None, name=None):
    return list(torch.unbind(t(x), dim=axis))


def split(x, num_or_sections, axis=0, name=None):
    """``num_or_sections``: the number of equal sections (the axis must
    divide), or the sections' sizes (one may be -1)."""
    x = t(x)
    axis = _axis(axis)
    total = x.shape[axis]
    if isinstance(num_or_sections, int):
        if total % num_or_sections:
            raise InvalidArgumentError(
                f"split: {total} does not divide into {num_or_sections} "
                f"equal sections")
        return list(torch.split(x, total // num_or_sections, dim=axis))
    sections = [int(s) for s in num_or_sections]
    if -1 in sections:
        known = builtins.sum(s for s in sections if s != -1)
        sections = [total - known if s == -1 else s for s in sections]
    return list(torch.split(x, sections, dim=axis))


def _array_split(x, n_or_idx, axis):
    x = t(x)
    if isinstance(n_or_idx, int):
        return list(torch.tensor_split(x, n_or_idx, dim=axis))
    return list(torch.tensor_split(x, [int(i) for i in n_or_idx], dim=axis))


def chunk(x, chunks, axis=0, name=None):
    return _array_split(x, chunks, axis)


def tensor_split(x, num_or_indices, axis=0, name=None):
    return _array_split(x, num_or_indices, axis)


def _split_along(x, n_or_idx, axis):
    if isinstance(n_or_idx, int) and t(x).shape[axis] % n_or_idx:
        raise InvalidArgumentError("array split does not result in an "
                                   "equal division")
    return _array_split(x, n_or_idx, axis)


def hsplit(x, num_or_indices, name=None):
    x = t(x)
    return _split_along(x, num_or_indices, 0 if x.dim() == 1 else 1)


def vsplit(x, num_or_indices, name=None):
    return _split_along(x, num_or_indices, 0)


def dsplit(x, num_or_indices, name=None):
    return _split_along(x, num_or_indices, 2)


def hstack(x, name=None):
    return torch.hstack(_ts(x))


def vstack(x, name=None):
    return torch.vstack(_ts(x))


row_stack = vstack


def dstack(x, name=None):
    return torch.dstack(_ts(x))


def column_stack(x, name=None):
    return torch.column_stack(_ts(x))


def tile(x, repeat_times, name=None):
    return torch.tile(t(x), tuple(repeat_times))


def expand(x, shape, name=None):
    x = t(x)
    lead = len(shape) - x.dim()
    shape = tuple(x.shape[i - lead] if s == -1 else s
                  for i, s in enumerate(shape))
    return x.expand(shape)


def expand_as(x, y, name=None):
    return t(x).expand(t(y).shape)


def broadcast_to(x, shape, name=None):
    return torch.broadcast_to(t(x), tuple(shape))


def broadcast_tensors(inputs, name=None):
    return list(torch.broadcast_tensors(*_ts(inputs)))


def flip(x, axis, name=None):
    if isinstance(axis, int):
        axis = [axis]
    return torch.flip(t(x), tuple(axis))


def reverse(x, axis, name=None):
    """The legacy name of :func:`flip`."""
    return flip(x, axis)


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(t(x), k, tuple(axes))


def roll(x, shifts, axis=None, name=None):
    x = t(x)
    if axis is None:
        return torch.roll(x.reshape(-1), shifts).reshape(x.shape)
    return torch.roll(x, shifts, axis)


def gather(x, index, axis=0, name=None):
    """Parity: ``paddle.gather``: the rows of ``x`` along ``axis``."""
    x = t(x)
    return torch.index_select(x, _axis(axis), t(index, x).reshape(-1).long(
    )).reshape(x.shape[:_axis(axis)] + tuple(t(index).shape)
               + x.shape[_axis(axis) + 1:])


def gather_nd(x, index, name=None):
    x = t(x)
    index = t(index, x).long()
    return x[tuple(index.movedim(-1, 0))]


def scatter(x, index, updates, overwrite=True, name=None):
    """Parity: ``paddle.scatter``: rows of ``x`` replaced by ``updates``
    (``overwrite=False``: the target rows zeroed, then the updates
    added)."""
    x = t(x)
    index = t(index, x).reshape(-1).long()
    updates = t(updates, x).to(x.dtype)
    if overwrite:
        return x.index_copy(0, index, updates)
    return x.index_fill(0, index, 0).index_add(0, index, updates)


def scatter_nd_add(x, index, updates, name=None):
    x = t(x)
    index = t(index, x).long()
    return x.index_put(tuple(index.movedim(-1, 0)),
                       t(updates, x).to(x.dtype), accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    updates = t(updates)
    zeros = torch.zeros(tuple(shape), dtype=updates.dtype,
                        device=updates.device)
    return scatter_nd_add(zeros, index, updates)


def index_select(x, index, axis=0, name=None):
    x = t(x)
    return torch.index_select(x, axis, t(index, x).long())


def index_sample(x, index, name=None):
    x = t(x)
    return torch.gather(x, 1, t(index, x).long())


def index_add(x, index, axis, value, name=None):
    x = t(x)
    return torch.index_add(x, axis, t(index, x).long(),
                           t(value, x).to(x.dtype))


def index_put(x, indices, value, accumulate=False, name=None):
    x = t(x)
    idx = tuple(t(i, x).long() if not t(i, x).dtype == torch.bool
                else t(i, x) for i in indices)
    return x.index_put(idx, t(value, x).to(x.dtype), accumulate=accumulate)


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    arr = t(arr)
    indices = t(indices, arr).long()
    values = torch.broadcast_to(t(values, arr).to(arr.dtype), indices.shape)
    if reduce == "assign":
        return arr.scatter(axis, indices, values)
    if reduce == "add":
        return arr.scatter_add(axis, indices, values)
    if reduce in ("mul", "multiply"):
        return arr.scatter_reduce(axis, indices, values, "prod")
    raise InvalidArgumentError(f"unknown reduce {reduce!r}")


def take_along_axis(arr, indices, axis, name=None):
    arr = t(arr)
    return torch.take_along_dim(arr, t(indices, arr).long(), axis)


def slice(input, axes, starts, ends, name=None):
    """Parity: ``paddle.slice``."""
    x = t(input)
    sl = [builtins.slice(None)] * x.dim()
    for ax, st, en in zip(axes, starts, ends):
        sl[ax] = builtins.slice(int(st), int(en))
    return x[tuple(sl)]


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Python slicing per axis, negative strides too (as index lists:
    torch slicing takes positive steps only)."""
    x = t(x)
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        n = x.shape[ax]
        idx = range(*builtins.slice(int(st), int(en), int(sd)).indices(n))
        x = x.index_select(ax, torch.as_tensor(list(idx), dtype=torch.long,
                                               device=x.device))
    return x


def crop(x, shape=None, offsets=None, name=None):
    x = t(x)
    shape = list(shape) if shape is not None else list(x.shape)
    offsets = list(offsets) if offsets is not None else [0] * x.dim()
    shape = [x.shape[i] - offsets[i] if s == -1 else s
             for i, s in enumerate(shape)]
    # lax.dynamic_slice clamps the start so the window stays inside
    starts = [builtins.min(builtins.max(int(o), 0), x.shape[i] - s)
              for i, (o, s) in enumerate(zip(offsets, shape))]
    return x[tuple(builtins.slice(st, st + s)
                   for st, s in zip(starts, shape))]


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Parity: ``paddle.pad``: a list of ``2·ndim`` is per-dim pairs in
    dim order; a shorter one pads the trailing dims, last dim first.
    ``mode``: constant, reflect, replicate, circular."""
    x = t(x)
    pad = [int(p) for p in pad]
    nd = x.dim()
    if len(pad) == 2 * nd:
        widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        widths = [(0, 0)] * nd
        for i in range(len(pad) // 2):
            widths[nd - 1 - i] = (pad[2 * i], pad[2 * i + 1])
    if mode == "constant":
        flat = [w for lo_hi in reversed(widths) for w in lo_hi]
        return torch.nn.functional.pad(x, flat, value=value)
    np_mode = {"reflect": "reflect", "replicate": "edge",
               "circular": "wrap"}.get(mode)
    if np_mode is None:
        raise InvalidArgumentError(f"unknown pad mode {mode!r}")
    # torch's reflect / replicate / circular pad only trailing spatial
    # dims of batched inputs: index arithmetic covers any dim
    out = x
    for d, (lo, hi) in enumerate(widths):
        if lo == 0 and hi == 0:
            continue
        n = out.shape[d]
        idx = np.pad(np.arange(n), (lo, hi), mode=np_mode)
        out = out.index_select(d, torch.as_tensor(idx, device=x.device))
    return out


def cast(x, dtype, name=None):
    return t(x).to(dtype_or(dtype))


def repeat_interleave(x, repeats, axis=None, name=None):
    x = t(x)
    if isinstance(repeats, (list, tuple, np.ndarray, torch.Tensor)):
        repeats = t(repeats, x).long()
    if axis is None:
        return torch.repeat_interleave(x.reshape(-1), repeats)
    return torch.repeat_interleave(x, repeats, dim=axis)


def unbind(input, axis=0, name=None):
    return unstack(input, axis=axis)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, name=None):
    """``np.unique`` on the host (a data-dependent size), as the JAX
    package: sorted values, first indices, inverse, counts."""
    x = t(x)
    res = np.unique(_host(x), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not isinstance(res, tuple):
        return _back(res, x)
    return tuple(_back(r, x) for r in res)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, name=None):
    """Collapse runs of equal values (slices along ``axis``), on the
    host as in the JAX package."""
    x = t(x)
    xs = _host(x)
    if axis is None:
        xs, axis = xs.ravel(), 0
    n = xs.shape[axis]
    changed = np.ones(n, dtype=bool)
    if n > 1:
        a = np.take(xs, range(1, n), axis=axis)
        b = np.take(xs, range(0, n - 1), axis=axis)
        ne = a != b
        changed[1:] = ne.any(axis=tuple(i for i in range(xs.ndim)
                                        if i != axis)) if xs.ndim > 1 else ne
    idx = np.nonzero(changed)[0]
    rets = [_back(np.take(xs, idx, axis=axis), x)]
    if return_inverse:
        rets.append(_back(np.cumsum(changed) - 1, x))
    if return_counts:
        rets.append(_back(np.diff(np.append(idx, n)), x))
    return rets[0] if len(rets) == 1 else tuple(rets)


def masked_select(x, mask, name=None):
    x = t(x)
    return torch.masked_select(x, t(mask, x).bool())


def masked_fill(x, mask, value, name=None):
    x = t(x)
    v = t(value, x).to(x.dtype) if isinstance(value, torch.Tensor) else value
    return torch.where(t(mask, x).bool(), torch.as_tensor(
        v, dtype=x.dtype, device=x.device), x)


def as_complex(x, name=None):
    x = t(x)
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x, name=None):
    x = t(x)
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, (list, tuple)) and len(axes) == 2 and builtins.all(
            isinstance(a, (list, tuple)) for a in axes):
        axes = [list(axes[0]), list(axes[1])]
    return torch.tensordot(t(x), t(y), dims=axes)


def _atleast(fn, inputs):
    out = fn(*[t(v) for v in inputs])
    return list(out) if isinstance(out, tuple) else out


def atleast_1d(*inputs, name=None):
    return _atleast(torch.atleast_1d, inputs)


def atleast_2d(*inputs, name=None):
    return _atleast(torch.atleast_2d, inputs)


def atleast_3d(*inputs, name=None):
    """``jnp.atleast_3d``: a 1-D ``[n]`` becomes ``[1, n, 1]``, a 2-D
    ``[m, n]`` ``[m, n, 1]`` (torch's puts the new axes elsewhere)."""
    def one(v):
        v = t(v)
        if v.dim() == 0:
            return v.reshape(1, 1, 1)
        if v.dim() == 1:
            return v.reshape(1, -1, 1)
        if v.dim() == 2:
            return v.unsqueeze(-1)
        return v
    outs = [one(v) for v in inputs]
    return outs[0] if len(outs) == 1 else outs


def tolist(x):
    return _host(x).tolist()


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """Parity: ``paddle.shard_index``: ids of shard ``shard_id`` as local
    ids, the others ``ignore_value``."""
    x = t(input)
    size = (index_num + nshards - 1) // nshards
    return torch.where(torch.div(x, size, rounding_mode="floor") == shard_id,
                       torch.remainder(x, size),
                       torch.full_like(x, ignore_value))
