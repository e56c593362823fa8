"""2-D pooling — ports of ``paddle_tpu.nn.functional.pooling``'s
``max_pool2d`` and ``adaptive_avg_pool2d``.

``max_pool2d`` follows the JAX package's ``lax.reduce_window``: the
input is padded with -inf, and ``ceil_mode`` adds ``stride - rem`` more
padding on the high side wherever ``(size + 2·pad - kernel) % stride``
leaves a remainder ``rem``.  Where torch's implicit padding is the same
thing (no ``ceil_mode``, pad at most half the window) the pool takes it;
otherwise the -inf padding is made explicit.  ``adaptive_avg_pool2d``
takes the JAX package's two paths: an even split reshapes and averages,
an uneven one averages each window ``[floor(i·in/out), ceil((i+1)·in/out))``
and concatenates.  Means of bf16/f16 inputs are taken in float32 and cast
back, as ``jnp.mean`` does.  NHWC runs on the channels_last NCHW view.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...framework.errors import InvalidArgumentError, UnimplementedError

__all__ = ["max_pool2d", "adaptive_avg_pool2d"]


def _norm(v, n):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(v)
    return v * n if len(v) == 1 else v


def _check_format(data_format):
    if data_format not in ("NCHW", "NHWC"):
        raise InvalidArgumentError(
            f"data_format must be 'NCHW' or 'NHWC', got {data_format!r}")
    return data_format == "NHWC"


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    """Parity: ``paddle.nn.functional.max_pool2d`` (without
    ``return_mask``)."""
    if return_mask:
        raise UnimplementedError(
            "max_pool2d(return_mask=True) is not ported yet (ROADMAP queue "
            "A, vision)")
    if isinstance(padding, str):
        raise InvalidArgumentError(
            "string padding not supported for pool; use ints")
    channel_last = _check_format(data_format)
    kernel = _norm(kernel_size, 2)
    stride = _norm(stride if stride is not None else kernel, 2)
    padding = _norm(padding, 2)
    spatial = tuple(x.shape[1:3] if channel_last else x.shape[2:4])
    pads = [[p, p] for p in padding]
    if ceil_mode:
        for i in range(2):
            rem = (spatial[i] + 2 * padding[i] - kernel[i]) % stride[i]
            if rem:
                pads[i][1] += stride[i] - rem
    implicit = (not ceil_mode
                and all(2 * p <= k for p, k in zip(padding, kernel)))
    if not implicit and any(lo or hi for lo, hi in pads):
        (ht, hb), (wl, wr) = pads
        x = F.pad(x, ((0, 0) if channel_last else ()) + (wl, wr, ht, hb),
                  value=-math.inf)
        padding = (0, 0)
    if channel_last:
        x = x.permute(0, 3, 1, 2)
    out = F.max_pool2d(x, kernel, stride, padding if implicit else 0)
    return out.permute(0, 2, 3, 1) if channel_last else out


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Parity: ``paddle.nn.functional.adaptive_avg_pool2d``; an entry of
    ``output_size`` that is None keeps that dim."""
    channel_last = _check_format(data_format)
    start = 1 if channel_last else 2
    if isinstance(output_size, int):
        output_size = (output_size,) * 2
    output_size = tuple(x.shape[start + i] if s is None else int(s)
                        for i, s in enumerate(output_size))
    low = x.dtype in (torch.bfloat16, torch.float16)

    def mean(t, dim, keepdim=False):  # jnp.mean: f32 sums, cast back
        return (t.float().mean(dim, keepdim).to(t.dtype) if low
                else t.mean(dim, keepdim))

    out = x
    for i in range(2):
        dim = start + i
        size, o = out.shape[dim], output_size[i]
        if size % o == 0:  # even split: reshape + mean
            shape = out.shape[:dim] + (o, size // o) + out.shape[dim + 1:]
            out = mean(out.reshape(shape), dim + 1)
        else:  # uneven: one window per output index
            pieces = [mean(out.narrow(dim, (j * size) // o,
                                      -(-((j + 1) * size) // o)
                                      - (j * size) // o), dim, True)
                      for j in range(o)]
            out = torch.cat(pieces, dim)
    return out
