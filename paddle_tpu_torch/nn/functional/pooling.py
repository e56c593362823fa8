"""Pooling — port of ``paddle_tpu.nn.functional.pooling``: the average and
max pools of rank 1-3 and the adaptive average and max pools.

The windows are the JAX package's ``lax.reduce_window``: ``padding`` on
both sides of each spatial dim (a string raises), and ``ceil_mode`` adds
``stride - rem`` more on the high side wherever ``(size + 2·pad -
kernel) % stride`` leaves a remainder ``rem`` — so the output has
``ceil((size + 2·pad - kernel) / stride) + 1`` windows, the last of which
may lie in the padding (torch's ``ceil_mode`` drops such a window).
Where torch's implicit padding is the same thing (no added ceil padding,
pad at most half the window, no input dim shorter than the window) the
pool takes it; otherwise the padding is made explicit (-inf for max,
zeros for average) and torch pools without any.

* Average: ``exclusive=True`` divides each window's sum by its count of
  input (non-pad) elements, the ceil padding counting as pad (the counts
  are a pool of ones, as in JAX); ``exclusive=False`` always divides by
  ``prod(kernel)``; ``divisor_override`` divides the sum by itself.
* Max with ``return_mask``: the flat index of each window's maximum in
  the unpadded input's spatial plane, per channel, ``-1`` where the
  window holds no element above -inf (JAX's reducer starts from (-inf,
  -1) and takes an element only when strictly greater).  Ties have no
  defined index in JAX (XLA does not fix the order of a window's
  reduction); here they take torch's.
* Adaptive: window ``i`` of ``out`` over a dim of ``L`` spans
  ``[floor(i·L/out), ceil((i+1)·L/out))``; an even split reshapes and
  reduces.  Means of bf16 / f16 inputs are taken in float32 and cast
  back, as ``jnp.mean`` does.  The adaptive max pools return ``None`` as
  their mask and read channels-first input, as the JAX ones do.

Channels-last input runs on its channels-first view (channels_last
memory), as the convolutions do.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...framework.errors import InvalidArgumentError
from .conv import _FORMATS, _pad_spatial, _to_first, _to_last

__all__ = [
    "avg_pool1d", "avg_pool2d", "avg_pool3d",
    "max_pool1d", "max_pool2d", "max_pool3d",
    "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
    "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d",
]

_AVG = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}
_MAX = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _norm(v, n):
    if isinstance(v, int):
        return (v,) * n
    v = tuple(v)
    return v * n if len(v) == 1 else v


def _check_format(data_format, n):
    first, last = _FORMATS[n]
    if data_format not in (first, last):
        raise InvalidArgumentError(
            f"data_format must be {first!r} or {last!r}, got "
            f"{data_format!r}")
    return data_format == last


def _window(x, kernel_size, stride, padding, n, ceil_mode):
    """(kernel, stride, padding, pads): ``pads`` the (lo, hi) pairs of
    ``x``'s spatial dims (channels-first) with the ceil padding."""
    if isinstance(padding, str):
        raise InvalidArgumentError(
            "string padding not supported for pool; use ints")
    kernel = _norm(kernel_size, n)
    stride = _norm(stride if stride is not None else kernel, n)
    padding = _norm(padding, n)
    pads = []
    for size, k, s, p in zip(x.shape[2:], kernel, stride, padding):
        rem = (size + 2 * p - k) % s
        pads.append((p, p + (s - rem if ceil_mode and rem else 0)))
    return kernel, stride, padding, pads


def _implicit(x, kernel, padding, pads):
    """Torch's own padding is the JAX window: no ceil padding, pad at
    most half the window, and (``avg_pool3d``'s check) no input dim
    shorter than the window."""
    return (all(lo == hi for lo, hi in pads)
            and all(2 * p <= k for p, k in zip(padding, kernel))
            and all(s >= k for s, k in zip(x.shape[2:], kernel)))


def _sum_pool(x, kernel, stride, n):
    """Window sums of an explicitly padded channels-first ``x``."""
    if n == 1:
        return F.avg_pool2d(x.unsqueeze(-1), (kernel[0], 1), (stride[0], 1),
                            divisor_override=1).squeeze(-1)
    return _AVG[n](x, kernel, stride, divisor_override=1)


def _avg_pool(x, kernel_size, stride, padding, n, data_format, exclusive,
              ceil_mode, divisor_override=None):
    channel_last = _check_format(data_format, n)
    x = _to_first(x, n) if channel_last else x
    kernel, stride, padding, pads = _window(x, kernel_size, stride,
                                            padding, n, ceil_mode)
    # torch's CUDA backward of a padded 1-D or 2-D average pool on
    # channels-last input gives input gradients off the CPU's (torch
    # 2.11; tools/torch_pool_channels_last_grad.py): such input is padded
    # explicitly
    if (_implicit(x, kernel, padding, pads)
            and (n > 1 or not divisor_override)
            and not (channel_last and n < 3 and any(padding))):
        if divisor_override:
            out = _AVG[n](x, kernel, stride, padding,
                          divisor_override=divisor_override)
        else:
            out = _AVG[n](x, kernel, stride, padding,
                          count_include_pad=not exclusive)
    else:
        xp = _pad_spatial(x, pads)
        if divisor_override:
            out = _sum_pool(xp, kernel, stride, n) / divisor_override
        elif exclusive:
            ones = _pad_spatial(x.new_ones((1, 1) + tuple(x.shape[2:])),
                                pads)
            out = (_sum_pool(xp, kernel, stride, n)
                   / _sum_pool(ones, kernel, stride, n))
        else:
            out = _AVG[n](xp, kernel, stride)
    return _to_last(out, n) if channel_last else out


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    """Parity: ``paddle.nn.functional.avg_pool1d``."""
    return _avg_pool(x, kernel_size, stride, padding, 1, data_format,
                     exclusive, ceil_mode)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    """Parity: ``paddle.nn.functional.avg_pool2d``."""
    return _avg_pool(x, kernel_size, stride, padding, 2, data_format,
                     exclusive, ceil_mode, divisor_override)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    """Parity: ``paddle.nn.functional.avg_pool3d``."""
    return _avg_pool(x, kernel_size, stride, padding, 3, data_format,
                     exclusive, ceil_mode, divisor_override)


def _unpadded_index(idx, padded, spatial, pads):
    """Flat indices into the padded spatial plane ``padded`` → flat
    indices into the unpadded plane ``spatial``, -1 for a pad element."""
    flat = torch.zeros_like(idx)
    valid = torch.ones_like(idx, dtype=torch.bool)
    rest, scale = idx, 1
    for size_p, size, (lo, _) in zip(reversed(padded), reversed(spatial),
                                     reversed(pads)):
        coord = rest % size_p - lo
        rest = rest // size_p
        valid &= (coord >= 0) & (coord < size)
        flat += coord * scale
        scale *= size
    return torch.where(valid, flat, -1)


def _max_pool(x, kernel_size, stride, padding, n, data_format, ceil_mode,
              return_mask):
    channel_last = _check_format(data_format, n)
    x = _to_first(x, n) if channel_last else x
    kernel, stride, padding, pads = _window(x, kernel_size, stride,
                                            padding, n, ceil_mode)
    if _implicit(x, kernel, padding, pads):
        out = _MAX[n](x, kernel, stride, padding,
                      return_indices=return_mask)
    else:
        low = -math.inf if x.is_floating_point() else torch.iinfo(
            x.dtype).min
        xp = _pad_spatial(x, pads, value=low)
        out = _MAX[n](xp, kernel, stride, return_indices=return_mask)
        if return_mask:
            out = (out[0], _unpadded_index(out[1], xp.shape[2:],
                                           x.shape[2:], pads))
    if return_mask:
        out, mask = out
        if out.is_floating_point():  # nothing above JAX's -inf start
            mask = torch.where(out == -math.inf, -1, mask)
    if channel_last:
        out = _to_last(out, n)
        if return_mask:
            mask = _to_last(mask, n)
    return (out, mask) if return_mask else out


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    """Parity: ``paddle.nn.functional.max_pool1d``."""
    return _max_pool(x, kernel_size, stride, padding, 1, data_format,
                     ceil_mode, return_mask)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    """Parity: ``paddle.nn.functional.max_pool2d``."""
    return _max_pool(x, kernel_size, stride, padding, 2, data_format,
                     ceil_mode, return_mask)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    """Parity: ``paddle.nn.functional.max_pool3d``."""
    return _max_pool(x, kernel_size, stride, padding, 3, data_format,
                     ceil_mode, return_mask)


def _adaptive_pool(x, output_size, n, channel_last, op):
    start = 1 if channel_last else 2
    if isinstance(output_size, int):
        output_size = (output_size,) * n
    output_size = tuple(x.shape[start + i] if s is None else int(s)
                        for i, s in enumerate(output_size))
    low = x.dtype in (torch.bfloat16, torch.float16)

    def reduce(t, dim, keepdim=False):
        if op == "max":
            return t.amax(dim, keepdim)
        # jnp.mean: f32 sums, cast back
        return (t.float().mean(dim, keepdim).to(t.dtype) if low
                else t.mean(dim, keepdim))

    out = x
    for i in range(n):
        dim = start + i
        size, o = out.shape[dim], output_size[i]
        if size % o == 0:  # even split: reshape + reduce
            shape = out.shape[:dim] + (o, size // o) + out.shape[dim + 1:]
            out = reduce(out.reshape(shape), dim + 1)
        else:  # uneven: one window per output index
            pieces = [reduce(out.narrow(dim, (j * size) // o,
                                        -(-((j + 1) * size) // o)
                                        - (j * size) // o), dim, True)
                      for j in range(o)]
            out = torch.cat(pieces, dim)
    return out


def adaptive_avg_pool1d(x, output_size, name=None):
    """Parity: ``paddle.nn.functional.adaptive_avg_pool1d`` (NCL)."""
    return _adaptive_pool(x, output_size, 1, False, "avg")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Parity: ``paddle.nn.functional.adaptive_avg_pool2d``; an entry of
    ``output_size`` that is None keeps that dim."""
    return _adaptive_pool(x, output_size, 2, _check_format(data_format, 2),
                          "avg")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    """Parity: ``paddle.nn.functional.adaptive_avg_pool3d``."""
    return _adaptive_pool(x, output_size, 3, _check_format(data_format, 3),
                          "avg")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    """Parity: ``paddle.nn.functional.adaptive_max_pool1d``; the mask is
    None, as the JAX package's."""
    out = _adaptive_pool(x, output_size, 1, False, "max")
    return (out, None) if return_mask else out


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    """Parity: ``paddle.nn.functional.adaptive_max_pool2d`` (NCHW); the
    mask is None, as the JAX package's."""
    out = _adaptive_pool(x, output_size, 2, False, "max")
    return (out, None) if return_mask else out


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    """Parity: ``paddle.nn.functional.adaptive_max_pool3d`` (NCDHW); the
    mask is None, as the JAX package's."""
    out = _adaptive_pool(x, output_size, 3, False, "max")
    return (out, None) if return_mask else out
