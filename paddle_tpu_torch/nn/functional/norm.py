"""Batch normalization — port of ``paddle_tpu.nn.functional.norm.batch_norm``
with the JAX package's arithmetic (not ``torch.nn.functional.batch_norm``,
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

__all__ = ["batch_norm"]


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
