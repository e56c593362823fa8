"""Dense sequence ops — port of ``paddle_tpu.nn.functional.sequence``:
the LoD ``sequence_*`` family on padded batches.

Every op takes a dense ``[B, T, ...]`` batch and a ``lengths [B]``
tensor (None: full rows) and masks the padding where the LoD kernels
skipped it.  ``sequence_expand`` (its time axis is ``max(lengths)``) and
the host checks of ``sequence_slice`` / ``sequence_reshape`` read the
lengths on the host, as the JAX ops do eagerly; on meta tensors (a
Program's shape probe) the checks are skipped, as under a JAX trace.
"""
from __future__ import annotations

import torch

from ...framework.errors import InvalidArgumentError
from ...tensor._common import t as _t

__all__ = [
    "sequence_pool", "sequence_softmax", "sequence_reverse",
    "sequence_first_step", "sequence_last_step", "sequence_expand",
    "sequence_expand_as", "sequence_enumerate", "sequence_pad",
    "sequence_unpad", "sequence_concat", "sequence_slice",
    "sequence_scatter", "sequence_reshape",
]


def _lengths(lengths, x):
    return _t(lengths, x).to(x.device).reshape(x.shape[0])


def _mask(x, lengths):
    """``[B, T]`` bool validity mask of ``x [B, T, ...]``."""
    B, T = x.shape[0], x.shape[1]
    if lengths is None:
        return torch.ones((B, T), dtype=torch.bool, device=x.device)
    return torch.arange(T, device=x.device)[None, :] < \
        _lengths(lengths, x)[:, None]


def _expand_mask(m, x):
    return m.reshape(tuple(m.shape) + (1,) * (x.dim() - 2))


def _on_host(*ts) -> bool:
    """True unless a tensor of ``ts`` is a meta tensor (a shape probe)."""
    return not any(isinstance(v, torch.Tensor) and v.device.type == "meta"
                   for v in ts)


def sequence_pool(input, pool_type, is_test=False, pad_value=0.0,
                  lengths=None):
    """Pool each sequence over its valid steps (average / sum / sqrt /
    max / last / first); an empty sequence gives ``pad_value``.
    ``[B, T, D]`` → ``[B, D]``."""
    x = _t(input)
    m = _expand_mask(_mask(x, lengths), x)
    n = m.sum(dim=1)  # [B, 1...] valid counts
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    pool_type = pool_type.lower()
    if pool_type == "sum":
        out = torch.where(m, x, zero).sum(dim=1)
    elif pool_type == "average":
        out = torch.where(m, x, zero).sum(dim=1) / torch.clamp(n, min=1)
    elif pool_type == "sqrt":
        out = torch.where(m, x, zero).sum(dim=1) / torch.sqrt(
            torch.clamp(n, min=1).to(x.dtype))
    elif pool_type == "max":
        out = torch.where(m, x, torch.full((), -float("inf"), dtype=x.dtype,
                                           device=x.device)).amax(dim=1)
    elif pool_type == "first":
        out = x[:, 0]
    elif pool_type == "last":
        idx = torch.clamp(_mask(x, lengths).sum(dim=1) - 1, min=0)
        out = torch.gather(x, 1, idx.reshape((-1, 1) + (1,) * (x.dim() - 2))
                           .expand((-1, 1) + tuple(x.shape[2:])))[:, 0]
    else:
        raise InvalidArgumentError(
            f"pool_type must be one of average/sum/sqrt/max/last/first, "
            f"got {pool_type!r}")
    pad = torch.full((), pad_value, dtype=out.dtype, device=x.device)
    return torch.where(n == 0, pad, out)


def sequence_first_step(input, lengths=None):
    """``x[:, 0]``."""
    return sequence_pool(input, "first", lengths=lengths)


def sequence_last_step(input, lengths=None):
    """``x[:, length - 1]`` a row."""
    return sequence_pool(input, "last", lengths=lengths)


def sequence_softmax(input, use_cudnn=False, name=None, lengths=None):
    """Softmax over each row's valid steps; the padding gets 0."""
    x = _t(input)
    m = _expand_mask(_mask(x, lengths), x)
    z = torch.where(m, x, torch.full((), -float("inf"), dtype=x.dtype,
                                     device=x.device))
    out = torch.softmax(z, dim=1)
    return torch.where(m, out, torch.zeros((), dtype=out.dtype,
                                           device=x.device))


def sequence_reverse(x, name=None, lengths=None):
    """Reverse each row's valid prefix in place, the padding untouched."""
    x = _t(x)
    B, T = x.shape[0], x.shape[1]
    if lengths is None:
        return torch.flip(x, dims=(1,))
    n = _lengths(lengths, x).to(torch.int64)[:, None]
    t = torch.arange(T, device=x.device)[None, :]
    src = torch.where(t < n, n - 1 - t, t)
    return torch.gather(x, 1, src.reshape((B, T) + (1,) * (x.dim() - 2))
                        .expand(x.shape))


def sequence_expand(x, lengths, name=None):
    """Row i of ``x`` repeated ``lengths[i]`` times on a new time axis:
    ``[B, D]`` → ``[B, max(lengths), D]`` (validity: the given lengths).
    The time axis is data-dependent: read on the host."""
    x = _t(x)
    n = _lengths(lengths, x)
    if not _on_host(n):
        raise InvalidArgumentError(
            "sequence_expand needs concrete lengths (the output time axis "
            "is max(lengths), a data-dependent shape); call it eagerly")
    T = int(n.max())
    return x[:, None].expand((x.shape[0], T) + tuple(x.shape[1:])).clone()


def sequence_expand_as(x, y, lengths=None, name=None):
    """Each row of ``x`` tiled across y's time axis: ``[B, D]``, y
    ``[B, T, ...]`` → ``[B, T, D]``."""
    x = _t(x)
    T = _t(y).shape[1]
    return x[:, None].expand((x.shape[0], T) + tuple(x.shape[1:])).clone()


def sequence_enumerate(input, win_size, pad_value=0, name=None,
                       lengths=None):
    """Every length-``win_size`` window a position: window j of row i is
    ``x[i, j : j + win]``, ``pad_value`` past the row's valid length.
    ``[B, T]`` → ``[B, T, win_size]``."""
    x = _t(input)
    if x.dim() == 3 and x.shape[-1] == 1:
        x = x[..., 0]
    B, T = x.shape
    valid = _mask(x, lengths)
    dev = x.device
    cols = torch.arange(T, device=dev)[:, None] + \
        torch.arange(win_size, device=dev)[None, :]  # [T, W]
    in_range = cols < T
    idx = torch.clamp(cols, max=T - 1)
    gather = x[:, idx]  # [B, T, W]
    win_valid = in_range[None] & valid[:, idx] & valid[:, :, None]
    return torch.where(win_valid, gather,
                       torch.full((), pad_value, dtype=x.dtype, device=dev))


def sequence_pad(x, pad_value, maxlen=None, name=None, lengths=None):
    """Re-pad the batch to ``maxlen`` (trim or extend): returns
    ``(padded, lengths)``, the reference's output pair."""
    x = _t(x)
    B, T = x.shape[0], x.shape[1]
    n = (_lengths(lengths, x).to(torch.int64) if lengths is not None
         else torch.full((B,), T, dtype=torch.int64, device=x.device))
    target = int(maxlen) if maxlen is not None else T
    pv = _t(pad_value, x).to(device=x.device, dtype=x.dtype)
    if target > T:
        block = pv.expand((B, target - T) + tuple(x.shape[2:]))
        x = torch.cat([x, block], dim=1)
    elif target < T:
        x = x[:, :target]
    n = torch.clamp(n, max=target)
    m = torch.arange(target, device=x.device)[None, :] < n[:, None]
    return torch.where(_expand_mask(m, x), x, pv), n


def sequence_unpad(x, length, name=None):
    """The padding zeroed (the batch and its lengths are the ragged
    value)."""
    x = _t(x)
    m = _expand_mask(_mask(x, length), x)
    return torch.where(m, x, torch.zeros((), dtype=x.dtype, device=x.device))


def sequence_slice(input, offset, length, name=None):
    """Row i keeps ``input[i, offset[i] : offset[i] + length]``, one
    static window length for every row."""
    x = _t(input)
    B, T = x.shape[0], x.shape[1]
    off = _t(offset, x).to(device=x.device, dtype=torch.int64).reshape(B)
    if not isinstance(length, int):
        L = _t(length, x).reshape(-1)
        if L.shape[0] != 1 or not _on_host(L):
            raise InvalidArgumentError(
                "dense sequence_slice needs one static window length "
                "(the output time axis); keep per-row raggedness via a "
                "lengths tensor instead")
        length = int(L[0])
    if _on_host(off):
        o = off.cpu()
        if bool((o < 0).any()) or bool((o + length > T).any()):
            raise InvalidArgumentError(
                f"sequence_slice window [offset, offset+{length}) leaves "
                f"the time axis of length {T} (the reference op enforces "
                f"offset+length <= seq_len)")
    idx = off[:, None] + torch.arange(length, device=x.device)[None, :]
    in_range = (idx >= 0) & (idx < T)
    shape = (B, length) + (1,) * (x.dim() - 2)
    got = torch.gather(x, 1, torch.clamp(idx, 0, T - 1).reshape(shape)
                       .expand((B, length) + tuple(x.shape[2:])))
    return torch.where(in_range.reshape(shape), got,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def sequence_scatter(input, index, updates, lengths=None, name=None):
    """``out = input; out[i, index[i, k]] += updates[i, k]`` — index
    ``[B, K]``, updates ``[B, K, ...]``; entries past ``lengths`` (of the
    K axis) and out-of-range positions are dropped."""
    x = _t(input)
    B, T = x.shape[0], x.shape[1]
    index = _t(index, x).to(device=x.device, dtype=torch.int64)
    upd = _t(updates, x).to(device=x.device, dtype=x.dtype)
    K = index.shape[1]
    keep = (index >= -T) & (index < T)
    if lengths is not None:
        keep = keep & (torch.arange(K, device=x.device)[None, :]
                       < _lengths(lengths, x)[:, None])
    index = torch.where(keep, torch.remainder(index, T),
                        torch.zeros_like(index))
    upd = torch.where(_expand_mask(keep, upd), upd,
                      torch.zeros((), dtype=upd.dtype, device=x.device))
    bidx = torch.arange(B, device=x.device)[:, None].expand(B, K)
    return x.index_put((bidx, index), upd, accumulate=True)


def sequence_reshape(input, new_dim, lengths=None, name=None):
    """Re-chunk each row's features to width ``new_dim``: ``[B, T, D]``
    → ``[B, T·D/new_dim, new_dim]``, and with ``lengths`` the scaled
    lengths too."""
    x = _t(input)
    B, T, D = x.shape[0], x.shape[1], x.shape[2]
    if (T * D) % new_dim:
        raise InvalidArgumentError(
            f"T·D = {T * D} not divisible by new_dim {new_dim}")
    out = x.reshape(B, T * D // new_dim, new_dim)
    if lengths is None:
        return out
    n = _lengths(lengths, x)
    if (D % new_dim) and (new_dim % D):
        raise InvalidArgumentError(
            f"per-row rescaling needs D ({D}) and new_dim ({new_dim}) "
            f"divisible one way or the other")
    if _on_host(n) and bool((n.cpu() * D % new_dim != 0).any()):
        raise InvalidArgumentError(
            f"a row's valid elements (lengths·{D}) are not divisible by "
            f"new_dim {new_dim} — the reference op rejects this "
            f"(sequence_reshape_op) rather than dropping data")
    return out, n * D // new_dim


def sequence_concat(input, lengths=None, name=None):
    """Concatenate the batches of ``input`` row by row along time:
    full rows are ``torch.cat``; with ``lengths`` each row's valid
    prefixes are packed together (the padding after them is 0)."""
    xs = [_t(x) for x in input]
    if lengths is None:
        return torch.cat(xs, dim=1)
    B = xs[0].shape[0]
    dev = xs[0].device
    total = sum(x.shape[1] for x in xs)
    tail = tuple(xs[0].shape[2:])
    # one spare slot past the end takes every padding step, then drops
    out = torch.zeros((B, total + 1) + tail, dtype=xs[0].dtype, device=dev)
    offset = torch.zeros((B,), dtype=torch.int64, device=dev)
    bidx = None
    for x, ln in zip(xs, lengths):
        n = _lengths(ln, x).to(torch.int64)
        t = torch.arange(x.shape[1], device=dev)[None, :]
        dest = torch.where(t < n[:, None], offset[:, None] + t,
                           torch.full((), total, device=dev))
        bidx = torch.arange(B, device=dev)[:, None].expand(dest.shape)
        out = out.index_put((bidx, dest), x.to(out.dtype))
        offset = offset + n
    return out[:, :total]
