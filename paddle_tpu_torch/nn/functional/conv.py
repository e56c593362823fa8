"""Convolutions — port of ``paddle_tpu.nn.functional.conv``: ``conv1d`` /
``conv2d`` / ``conv3d`` and the three transposed convolutions.

paddle's layouts at the surface: channels-first (``NCL`` / ``NCHW`` /
``NCDHW``) or channels-last (``NLC`` / ``NHWC`` / ``NDHWC``) activations,
``[Cout, Cin/groups, *k]`` weights (torch's own layout), and for the
transposed convolutions ``[Cin, Cout/groups, *k]`` weights (torch's
``conv_transpose`` layout too).  Padding takes the JAX package's forms:
an int, one int per spatial dim, the ``2n`` list ``[d0 lo, d0 hi, d1 lo,
…]`` (asymmetric: ResNet's space-to-depth stem pads ``[2, 1, 2, 1]``),
the ``n + 2`` list of pairs including batch and channel, or ``"SAME"`` /
``"VALID"`` as XLA reads them.

Forward convolutions: SAME splits the total padding with the smaller half
first; asymmetric pads are applied with ``F.pad``, symmetric ones go to
``torch.nn.functional.conv{n}d``.

Transposed convolutions follow ``lax.conv_transpose(transpose_kernel=
True)``, the JAX package's route: a convolution of the stride-dilated
input with the flipped kernel and raw padding ``(lo, hi)`` per dim —
paddle's padding ``p`` maps to ``dk - 1 - p`` (``dk`` the dilated kernel
size) with ``output_padding`` added to the high side; ``"SAME"`` /
``"VALID"`` map as ``lax._conv_transpose_padding`` maps them, and then
``output_padding`` appends zeros.  ``torch.nn.functional.conv_transpose``
computes that convolution with padding ``(dk - 1 - c)`` on both sides for
its own ``padding=c``; the rest of each side is one ``F.pad`` of the
result (negative widths crop, positive ones append zeros, which is what
the extra raw padding yields).  Groups split the input channels, as in
JAX.  ``output_size`` only crops (``[:t]`` per spatial dim), as in JAX.

Channels-last: a contiguous channels-last tensor permuted to
channels-first is a channels_last view, so the convolution runs on it and
its result is permuted back — no layout copy either way.  A float input
meeting bf16 / f16 weights is cast to the weights' dtype (the JAX
package's AMP convention).  The convolutions themselves are cuDNN's on the
card (the JAX package leaves them to XLA, outside any Pallas kernel).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ...framework.errors import InvalidArgumentError

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

#: the data formats of each rank: (channels-first, channels-last)
_FORMATS = {1: ("NCL", "NLC"), 2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _norm_tuple(v, n, name):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(v)
    if len(v) == 1:
        return v * n
    if len(v) != n:
        raise InvalidArgumentError(f"{name} must have length {n}, got {v}")
    return v


def _padding(padding, n):
    """``"SAME"`` / ``"VALID"`` or a list of ``n`` (lo, hi) pairs."""
    if isinstance(padding, str):
        p = padding.upper()
        if p in ("SAME", "VALID"):
            return p
        raise InvalidArgumentError(f"unknown padding {padding!r}")
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    if len(padding) == n + 2:  # [[0,0],[0,0],[h0,h1],[w0,w1]]
        return [tuple(p) for p in padding[2:]]
    return [tuple(p) for p in padding]


def _same_pads(sizes, kernel, stride, dilation):
    """XLA's SAME: output ``ceil(in / stride)``, the total padding split
    with the smaller half first."""
    pads = []
    for size, k, s, d in zip(sizes, kernel, stride, dilation):
        eff = (k - 1) * d + 1
        total = max((math.ceil(size / s) - 1) * s + eff - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _channel_last(data_format, n, op):
    first, last = _FORMATS[n]
    if data_format not in (first, last):
        raise InvalidArgumentError(
            f"{op}: data_format must be {first!r} or {last!r}, got "
            f"{data_format!r}")
    return data_format == last


def _amp_cast(x, weight):
    if (x.dtype != weight.dtype and x.is_floating_point()
            and weight.dtype in (torch.bfloat16, torch.float16)):
        # the JAX package's AMP convention: a float input meeting
        # low-precision weights computes in the weights' dtype
        return x.to(weight.dtype)
    return x


def _to_first(x, n):
    """A channels-last tensor as its channels-first view."""
    return x.permute(0, n + 1, *range(1, n + 1))


def _to_last(x, n):
    return x.permute(0, *range(2, n + 2), 1)


def _pad_spatial(x, pads, value=0.0, channel_last=False):
    """``F.pad`` of the spatial dims of ``x`` by ``pads`` (lo, hi) pairs
    in dim order; negative widths crop."""
    widths = [0, 0] if channel_last else []  # a channels-last C dim
    for lo, hi in reversed(pads):  # F.pad's order: last dim first
        widths += [lo, hi]
    return F.pad(x, widths, value=value)


def _add_bias(out, bias, channel_last):
    if bias is None:
        return out
    shape = [1] * out.ndim
    shape[-1 if channel_last else 1] = -1
    return out + bias.to(out.dtype).reshape(shape)


def _conv_nd(x, weight, bias, stride, padding, dilation, groups, n,
             data_format, op):
    channel_last = _channel_last(data_format, n, op)
    x = _amp_cast(x, weight)
    stride = _norm_tuple(stride, n, "stride")
    dilation = _norm_tuple(dilation, n, "dilation")
    spatial = x.shape[1:n + 1] if channel_last else x.shape[2:]
    pads = _padding(padding, n)
    if pads == "VALID":
        pads = [(0, 0)] * n
    elif pads == "SAME":
        pads = _same_pads(spatial, weight.shape[2:], stride, dilation)
    if all(lo == hi for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        # padded before the permute: a channels-last input stays a
        # contiguous channels-last tensor into the convolution
        x = _pad_spatial(x, pads, channel_last=channel_last)
        sym = (0,) * n
    if channel_last:
        x = _to_first(x, n)
    out = _CONV[n](x, weight, None, stride, sym, dilation, groups)
    if channel_last:
        out = _to_last(out, n)
    return _add_bias(out, bias, channel_last)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    """Parity: ``paddle.nn.functional.conv1d``."""
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 1,
                    data_format, "conv1d")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """Parity: ``paddle.nn.functional.conv2d``.  ``x`` NCHW or NHWC,
    ``weight`` OIHW ``[Cout, Cin/groups, kh, kw]``, ``bias`` ``[Cout]``."""
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 2,
                    data_format, "conv2d")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    """Parity: ``paddle.nn.functional.conv3d``."""
    return _conv_nd(x, weight, bias, stride, padding, dilation, groups, 3,
                    data_format, "conv3d")


def _transpose_pads(mode, dk, s):
    """``lax._conv_transpose_padding`` for a string padding: the raw
    (lo, hi) padding of the dilated-input convolution."""
    if mode == "SAME":
        total = dk + s - 2
        lo = dk - 1 if s > dk - 1 else int(np.ceil(total / 2))
    else:  # VALID
        total = dk + s - 2 + max(dk - s, 0)
        lo = dk - 1
    return lo, total - lo


def _conv_transpose_nd(x, weight, bias, stride, padding, output_padding,
                       dilation, groups, n, data_format, output_size, op):
    channel_last = _channel_last(data_format, n, op)
    x = _amp_cast(x, weight)
    stride = _norm_tuple(stride, n, "stride")
    dilation = _norm_tuple(dilation, n, "dilation")
    opad = (_norm_tuple(output_padding, n, "output_padding")
            if output_padding else (0,) * n)
    dk = [d * (k - 1) + 1 for d, k in zip(dilation, weight.shape[2:])]
    pads = _padding(padding, n)
    if isinstance(pads, str):
        raw = [_transpose_pads(pads, k, s) for k, s in zip(dk, stride)]
        tail = opad  # zeros appended after the convolution
    else:
        raw = [(k - 1 - lo, k - 1 - hi + o)
               for k, (lo, hi), o in zip(dk, pads, opad)]
        tail = (0,) * n
    if channel_last:
        x = _to_first(x, n)
    # F.conv_transpose's padding c is raw padding dk - 1 - c on both
    # sides; the rest of each side (and output_padding's zeros) is F.pad's
    adj = [(lo - (k - 1), hi - (k - 1)) for k, (lo, hi) in zip(dk, raw)]
    common = [max(0, min(-lo, -hi)) for lo, hi in adj]
    out = _CONV_T[n](x, weight, None, stride, tuple(common), 0, groups,
                     dilation)
    rest = [(lo + c, hi + c + t) for (lo, hi), c, t in zip(adj, common, tail)]
    if output_size is not None:  # crop only, as the JAX package
        sizes = out.shape[2:]
        rest = [(lo, min(hi, int(t) - (size + lo)))
                for (lo, hi), size, t in zip(rest, sizes, output_size)]
    if any(lo or hi for lo, hi in rest):
        out = _pad_spatial(out, rest)
    if channel_last:
        out = _to_last(out, n)
    return _add_bias(out, bias, channel_last)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    """Parity: ``paddle.nn.functional.conv1d_transpose``."""
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 1,
                              data_format, output_size, "conv1d_transpose")


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    """Parity: ``paddle.nn.functional.conv2d_transpose``; ``weight``
    ``[Cin, Cout/groups, kh, kw]``."""
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 2,
                              data_format, output_size, "conv2d_transpose")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    """Parity: ``paddle.nn.functional.conv3d_transpose``."""
    return _conv_transpose_nd(x, weight, bias, stride, padding,
                              output_padding, dilation, groups, 3,
                              data_format, output_size, "conv3d_transpose")
