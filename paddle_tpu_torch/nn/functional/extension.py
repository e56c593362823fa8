"""Extension ops — port of ``paddle_tpu.nn.functional.extension``:
``row_conv``, ``diag_embed`` and the beam-search backtrace
``gather_tree``.  ``gather_tree`` takes and returns int64 ids (the port's
integer kind, ROADMAP §C)."""
from __future__ import annotations

import torch

from ...framework.errors import InvalidArgumentError
from ...tensor._common import t as _t

__all__ = ["row_conv", "diag_embed", "gather_tree"]


def row_conv(input, weight, act=None, name=None):
    """Lookahead row convolution: ``out[:, t] = Σ_{j < k} x[:, t + j] ·
    w[j]``, zero past the sequence's end; input ``[B, T, D]``, weight
    ``[k, D]``; ``act`` names a function of ``nn.functional``'s
    activations."""
    x = _t(input)
    w = _t(weight, x).to(x.dtype)
    k, T = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, 0, k - 1))
    out = sum(xp[:, j:j + T, :] * w[j] for j in range(k))
    if act:
        from . import activation as A

        fn = getattr(A, act, None)
        if fn is None:
            raise InvalidArgumentError(f"unsupported act {act!r}")
        out = fn(out)
    return out


def diag_embed(input, offset: int = 0, dim1: int = -2, dim2: int = -1,
               name=None):
    """``out[..., i, i + offset] = input[..., i]``, the two new axes at
    ``dim1`` / ``dim2`` of the output."""
    x = _t(input)
    m = x.shape[-1]
    n = m + abs(offset)
    rows = torch.arange(m, device=x.device) + max(-offset, 0)
    cols = torch.arange(m, device=x.device) + max(offset, 0)
    flat = x.new_zeros((x.numel() // max(m, 1), n, n))
    batch = torch.arange(flat.shape[0], device=x.device)[:, None]
    flat = flat.index_put((batch, rows[None, :], cols[None, :]),
                          x.reshape(-1, m))
    out = flat.reshape(x.shape[:-1] + (n, n))
    nd = out.dim()
    d1, d2 = dim1 % nd, dim2 % nd
    if (d1, d2) != (nd - 2, nd - 1):
        out = torch.movedim(out, (nd - 2, nd - 1), (d1, d2))
    return out


def gather_tree(ids, parents):
    """Backtrace beam-search ancestry (``[max_time, batch, beam]`` ids and
    parent slots): each (batch, beam) starts from its own slot at the last
    step and follows ``parents`` back, reading ``ids`` along the path."""
    ids = _t(ids)
    parents = _t(parents, ids)
    if ids.dim() != 3:
        raise InvalidArgumentError(
            f"gather_tree expects [time, batch, beam], got shape "
            f"{tuple(ids.shape)}")
    T, B, W = ids.shape
    slot = torch.arange(W, device=ids.device).expand(B, W)
    out = torch.empty_like(ids)
    for step in range(T - 1, -1, -1):
        out[step] = torch.gather(ids[step], 1, slot)
        slot = torch.gather(parents[step].long(), 1, slot)
    return out
