"""Normalization — port of ``paddle_tpu.nn.functional.norm``: every
function keeps its statistics in float32 for bf16 / f16 inputs and returns
the input's dtype.  ``layer_norm`` normalizes over the trailing
``normalized_shape`` axes, ``instance_norm`` over each sample's spatial
axes, ``group_norm`` over each sample's channel groups (biased variances);
``local_response_norm`` divides by ``(k + alpha Σ x²)^beta`` over a
window of ``size`` channels; ``normalize`` by the ``p``-norm along
``axis``, at least ``epsilon``.

``batch_norm`` has the JAX package's arithmetic (not ``torch.nn.functional.batch_norm``,
which stores the unbiased variance, counts momentum the other way and does
not fold bf16):

* statistics in float32 for bf16/f16 inputs, from ONE pass
  (``Σx / n``, ``max(Σx² / n − mean², 0)``); float32 inputs take the
  two-pass mean and biased variance;
* paddle's momentum: ``new = momentum·old + (1 − momentum)·batch``, with
  the BIASED batch variance; the new stats keep the running stats' dtype;
* bf16/f16 normalization folds into ``x·scale + shift``, scale and shift
  computed per channel in float32 and cast once.

The running-stat update takes no part in autograd.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...framework.errors import InvalidArgumentError
from ...tensor._common import t as _t

__all__ = ["batch_norm", "layer_norm", "instance_norm", "group_norm",
           "local_response_norm", "normalize"]


def _channel_last(data_format):
    return data_format in ("NHWC", "NLC", "NDHWC")


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Functional batch norm: ``(out, new_mean, new_var)`` when batch
    statistics are used (training, not ``use_global_stats``), ``out``
    otherwise."""
    ch_axis = x.dim() - 1 if _channel_last(data_format) else 1
    axes = tuple(i for i in range(x.dim()) if i != ch_axis)
    low = x.dtype in (torch.bfloat16, torch.float16)
    sd = torch.float32 if low else x.dtype
    if use_global_stats is None:
        use_global_stats = not training
    shape = [1] * x.dim()
    shape[ch_axis] = x.shape[ch_axis]

    new_mean = new_var = None
    if training and not use_global_stats:
        n = 1
        for i in axes:
            n *= x.shape[i]
        if low:
            xf = x.to(sd)
            mean = xf.sum(axes) / n
            var = torch.clamp_min((xf * xf).sum(axes) / n - mean * mean, 0.0)
        else:
            mean = x.mean(axes)
            c = x - mean.reshape(shape)
            var = (c * c).mean(axes)
        with torch.no_grad():
            new_mean = (momentum * running_mean.to(sd)
                        + (1 - momentum) * mean).to(running_mean.dtype)
            new_var = (momentum * running_var.to(sd)
                       + (1 - momentum) * var).to(running_var.dtype)
    else:
        mean = running_mean.to(sd)
        var = running_var.to(sd)

    inv = torch.rsqrt(var + epsilon)
    if low:
        scale = inv if weight is None else inv * weight.to(sd)
        shift = -mean * scale
        if bias is not None:
            shift = shift + bias.to(sd)
        out = (x * scale.to(x.dtype).reshape(shape)
               + shift.to(x.dtype).reshape(shape))
    else:
        out = (x - mean.reshape(shape)) * inv.reshape(shape)
        if weight is not None:
            out = out * weight.to(sd).reshape(shape)
        if bias is not None:
            out = out + bias.to(sd).reshape(shape)
        out = out.to(x.dtype)
    if new_mean is not None:
        return out, new_mean, new_var
    return out


def _stat_dtype(x):
    return torch.float32 if x.dtype in (torch.bfloat16, torch.float16) \
        else x.dtype


def _channel_shape(x, ch_axis):
    shape = [1] * x.dim()
    shape[ch_axis] = x.shape[ch_axis]
    return shape


def _affine(out, weight, bias, shape, sd):
    if weight is not None:
        out = out * _t(weight, out).to(sd).reshape(shape)
    if bias is not None:
        out = out + _t(bias, out).to(sd).reshape(shape)
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    x = _t(x)
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    normalized_shape = tuple(int(d) for d in normalized_shape)
    if tuple(x.shape[x.dim() - len(normalized_shape):]) != normalized_shape:
        raise InvalidArgumentError(
            f"normalized_shape {normalized_shape} does not match trailing "
            f"dims of {tuple(x.shape)}")
    sd = _stat_dtype(x)
    out = F.layer_norm(
        x.to(sd), normalized_shape,
        None if weight is None else _t(weight, x).to(sd),
        None if bias is None else _t(bias, x).to(sd), epsilon)
    return out.to(x.dtype)


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    x = _t(x)
    channel_last = _channel_last(data_format)
    ch_axis = x.dim() - 1 if channel_last else 1
    axes = (tuple(range(1, x.dim() - 1)) if channel_last
            else tuple(range(2, x.dim())))
    sd = _stat_dtype(x)
    xf = x.to(sd)
    mean = xf.mean(axes, keepdim=True)
    var = xf.var(axes, unbiased=False, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return _affine(out, weight, bias, _channel_shape(x, ch_axis),
                   sd).to(x.dtype)


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    x = _t(x)
    channel_last = _channel_last(data_format)
    ch_axis = x.dim() - 1 if channel_last else 1
    C = x.shape[ch_axis]
    if C % num_groups != 0:
        raise InvalidArgumentError(
            f"channels {C} not divisible by groups {num_groups}")
    sd = _stat_dtype(x)
    xf = x.to(sd)
    moved = xf.movedim(ch_axis, 1) if channel_last else xf
    grouped = moved.reshape((moved.shape[0], num_groups, C // num_groups)
                            + tuple(moved.shape[2:]))
    axes = tuple(range(2, grouped.dim()))
    mean = grouped.mean(axes, keepdim=True)
    var = grouped.var(axes, unbiased=False, keepdim=True)
    out = ((grouped - mean) * torch.rsqrt(var + epsilon)).reshape(
        moved.shape)
    if channel_last:
        out = out.movedim(1, ch_axis)
    return _affine(out, weight, bias, _channel_shape(x, ch_axis),
                   sd).to(x.dtype)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    x = _t(x)
    ch_axis = x.dim() - 1 if _channel_last(data_format) else 1
    sq = x.float().square()
    lo = (size - 1) // 2
    widths = [0, 0] * x.dim()
    # F.pad lists the last axis first
    widths[2 * (x.dim() - 1 - ch_axis)] = lo
    widths[2 * (x.dim() - 1 - ch_axis) + 1] = size - 1 - lo
    summed = F.pad(sq, widths).unfold(ch_axis, size, 1).sum(-1)
    return (x.float() / torch.pow(k + alpha * summed, beta)).to(x.dtype)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    x = _t(x)
    if p == 2:
        n = x.square().sum(axis, keepdim=True).sqrt()
    else:
        n = (x.abs() ** p).sum(axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp_min(n, epsilon)
