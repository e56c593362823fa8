"""2-D convolution — port of ``paddle_tpu.nn.functional.conv.conv2d``.

paddle's layouts at the surface: NCHW or NHWC activations, OIHW weights
(torch's own weight layout).  Padding takes the JAX package's forms: an
int, one int per spatial dim, the ``2n`` list ``[top, bottom, left,
right]`` (asymmetric: ResNet's space-to-depth stem pads ``[2, 1, 2, 1]``),
the ``n + 2`` list of pairs including batch and channel, or ``"SAME"`` /
``"VALID"`` as XLA reads them (SAME splits the total padding with the
smaller half first).  Asymmetric pads are applied with ``F.pad``, the
rest go to ``torch.nn.functional.conv2d``.

NHWC: a contiguous ``[N, H, W, C]`` tensor permuted to NCHW is a
channels_last tensor, so the convolution runs on that view and its
channels_last result is permuted back — no layout copy either way.

The convolution itself is cuDNN's on the card (the JAX package leaves it
to XLA, outside any Pallas kernel).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...framework.errors import InvalidArgumentError

__all__ = ["conv2d"]


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


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """Parity: ``paddle.nn.functional.conv2d``.  ``x`` NCHW or NHWC,
    ``weight`` OIHW ``[Cout, Cin/groups, kh, kw]``, ``bias`` ``[Cout]``."""
    if data_format not in ("NCHW", "NHWC"):
        raise InvalidArgumentError(
            f"conv2d: data_format must be 'NCHW' or 'NHWC', got "
            f"{data_format!r}")
    if (x.dtype != weight.dtype and x.is_floating_point()
            and weight.dtype in (torch.bfloat16, torch.float16)):
        # the JAX package's AMP convention: a float input meeting
        # low-precision weights computes in the weights' dtype
        x = x.to(weight.dtype)
    stride = _norm_tuple(stride, 2, "stride")
    dilation = _norm_tuple(dilation, 2, "dilation")
    channel_last = data_format == "NHWC"
    spatial = tuple(x.shape[1:3] if channel_last else x.shape[2:4])
    pads = _padding(padding, 2)
    if pads == "VALID":
        pads = [(0, 0), (0, 0)]
    elif pads == "SAME":
        pads = _same_pads(spatial, weight.shape[2:], stride, dilation)
    if all(lo == hi for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        # F.pad's order is last dim first: (W lo, W hi, H lo, H hi), and
        # for NHWC the channel dim comes before them
        (ht, hb), (wl, wr) = pads
        x = F.pad(x, ((0, 0) if channel_last else ()) + (wl, wr, ht, hb))
        sym = (0, 0)
    if channel_last:
        x = x.permute(0, 3, 1, 2)  # a channels_last NCHW view
    out = F.conv2d(x, weight, None, stride, sym, dilation, groups)
    if channel_last:
        out = out.permute(0, 2, 3, 1)
    if bias is not None:
        shape = [1, 1, 1, -1] if channel_last else [1, -1, 1, 1]
        out = out + bias.to(out.dtype).reshape(shape)
    return out
