"""Fused residual add + LayerNorm — port of ``paddle_tpu/ops/fused_layernorm.py``.

Every transformer sublayer boundary runs ``s = x + sublayer_out`` and a
LayerNorm of ``s``.  :func:`layernorm_residual` does both in one pass over
the rows: on the card that is the hand-written CUDA kernel
``ops/csrc/fused_layernorm.cu`` (``sm_90a``, built with nvcc on first use,
bound with ctypes): for ``D <= MAX_FEATURES`` one warp per row with the
row in registers, for wider rows (up to ``MAX_WIDE_FEATURES``) one block
per row with the row in shared memory; either way ``x`` and ``r`` are
read once and ``s`` and ``y`` written once.

Semantics (both paths): ``s`` is the sum rounded to the activation dtype,
and it is that ROUNDED sum which is normalized; statistics are float32,
two-pass (mean, then the mean of the centred squares); ``rstd =
rsqrt(var + eps)``; ``y = (s - mean)·rstd·weight + bias`` in the activation
dtype.  Pre-LN blocks (GPT) use both ``s`` and ``y``, post-LN blocks (BERT)
``y``.

The gradient is a ``torch.autograd.Function`` whose backward is the
closed-form LayerNorm VJP of the JAX package (``_ln_res_bwd``) in plain
PyTorch ops: the JAX package has no backward kernel for this op either.

:func:`layernorm_residual_ref` is the plain PyTorch version, differentiable
by autograd.  It is the CPU path and the yardstick the kernel is held to
on the card; a CUDA tensor always goes to the kernel, and what the kernel
does not take raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..framework.errors import InvalidArgumentError
from . import _build

__all__ = ["layernorm_residual", "layernorm_residual_ref", "MAX_FEATURES",
           "MAX_WIDE_FEATURES"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the largest feature dim the narrow variant holds in registers (32 x 24)
MAX_FEATURES = 768
#: the largest feature dim the wide variant stages in shared memory
MAX_WIDE_FEATURES = 49152
_fns = {}
_fn_lock = threading.Lock()


def _check(x, residual, weight, bias):
    if x.shape != residual.shape:
        raise InvalidArgumentError(
            f"layernorm_residual: x {tuple(x.shape)} vs residual "
            f"{tuple(residual.shape)}")
    D = x.shape[-1]
    if tuple(weight.shape) != (D,) or tuple(bias.shape) != (D,):
        raise InvalidArgumentError(
            f"layernorm_residual: affine shapes {tuple(weight.shape)}/"
            f"{tuple(bias.shape)} do not match feature dim {D}")
    return D


def _forward_ref(x2, r2, weight, bias, epsilon):
    """Plain forward on ``[M, D]`` rows: ``(s, y, mean [M], rstd [M])``."""
    s = (x2.float() + r2.float()).to(x2.dtype)
    sf = s.float()
    mean = sf.mean(-1, keepdim=True)
    c = sf - mean
    var = (c * c).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + epsilon)
    y = (c * rstd * weight.float() + bias.float()).to(x2.dtype)
    return s, y, mean[:, 0], rstd[:, 0]


def layernorm_residual_ref(x, residual, weight, bias, *,
                           epsilon: float = 1e-5):
    """Plain PyTorch version of :func:`layernorm_residual` (same signature
    and semantics), differentiable by autograd."""
    D = _check(x, residual, weight, bias)
    s, y, _, _ = _forward_ref(x.reshape(-1, D), residual.reshape(-1, D),
                              weight, bias, float(epsilon))
    return s.reshape(x.shape), y.reshape(x.shape)


def _kernel_fn(symbol):
    with _fn_lock:
        if symbol not in _fns:
            _fns[symbol] = _build.entry(
                "fused_layernorm", symbol,
                [ctypes.c_int] + [ctypes.c_void_p] * 8
                + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p])
        return _fns[symbol]


def _forward_kernel(x2, r2, weight, bias, epsilon):
    """Launch the CUDA kernel on ``[M, D]`` rows; same outputs as
    :func:`_forward_ref`.  Adds one to ``layernorm_residual.launches``."""
    M, D = x2.shape
    for name, t in (("residual", r2), ("weight", weight), ("bias", bias)):
        if t.device != x2.device:
            raise InvalidArgumentError(
                f"layernorm_residual: {name} on {t.device}, x on {x2.device}")
        if t.dtype != x2.dtype:
            raise InvalidArgumentError(
                f"layernorm_residual: {name} is {t.dtype}, x is {x2.dtype} "
                f"(the kernel takes one dtype for all four)")
    if x2.dtype not in _DTYPES:
        raise InvalidArgumentError(
            f"layernorm_residual: the kernel takes float32 or bfloat16, got "
            f"{x2.dtype}")
    for name, t in (("x", x2), ("residual", r2), ("weight", weight),
                    ("bias", bias)):
        if not t.is_contiguous():
            raise InvalidArgumentError(
                f"layernorm_residual: {name} must be contiguous")
    if not 0 < D <= MAX_WIDE_FEATURES:
        raise InvalidArgumentError(
            f"layernorm_residual: feature dim {D} outside the kernel's "
            f"1..{MAX_WIDE_FEATURES}")
    s = torch.empty_like(x2)
    y = torch.empty_like(x2)
    mean = torch.empty(M, dtype=torch.float32, device=x2.device)
    rstd = torch.empty(M, dtype=torch.float32, device=x2.device)
    if M == 0:
        return s, y, mean, rstd
    fn = _kernel_fn("layernorm_residual_fwd" if D <= MAX_FEATURES
                    else "layernorm_residual_fwd_wide")
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        fn(_DTYPES[x2.dtype], x2.data_ptr(), r2.data_ptr(), weight.data_ptr(),
           bias.data_ptr(), s.data_ptr(), y.data_ptr(), mean.data_ptr(),
           rstd.data_ptr(), M, D, epsilon, stream)
    layernorm_residual.launches += 1
    return s, y, mean, rstd


class _LayerNormResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, r2, weight, bias, epsilon):
        if x2.device.type == "cpu":
            s, y, mean, rstd = _forward_ref(x2, r2, weight, bias, epsilon)
        elif x2.device.type == "cuda":
            s, y, mean, rstd = _forward_kernel(x2, r2, weight, bias, epsilon)
        else:
            raise InvalidArgumentError(
                f"layernorm_residual: tensors on {x2.device} (cpu or cuda "
                f"only)")
        ctx.save_for_backward(s, mean, rstd, weight)
        ctx.set_materialize_grads(False)
        return s, y

    @staticmethod
    def backward(ctx, ds_out, dy):
        s, mean, rstd, weight = ctx.saved_tensors
        if dy is None:  # only the residual stream was used
            return ds_out, ds_out, None, None, None
        mean, rstd = mean[:, None], rstd[:, None]
        xhat = (s.float() - mean) * rstd
        dyf = dy.float()
        dxhat = dyf * weight.float()
        # the closed-form LayerNorm VJP (_ln_res_bwd): three row reductions
        m1 = dxhat.mean(-1, keepdim=True)
        m2 = (dxhat * xhat).mean(-1, keepdim=True)
        ds = rstd * (dxhat - m1 - xhat * m2)
        if ds_out is not None:
            ds = ds + ds_out.float()
        ds = ds.to(s.dtype)
        dg = (dyf * xhat).sum(0).to(weight.dtype)
        db = dyf.sum(0).to(weight.dtype)
        return ds, ds, dg, db, None


def layernorm_residual(x, residual, weight, bias, *, epsilon: float = 1e-5):
    """``s = x + residual;  y = LayerNorm(s)·weight + bias`` in one pass.

    x/residual: ``[..., D]`` (same shape and dtype), weight/bias: ``[D]``.
    Returns ``(s, y)`` in x's dtype.  Differentiable in x, residual,
    weight and bias.  CPU tensors take :func:`layernorm_residual_ref`'s
    arithmetic; CUDA tensors launch the kernel (float32 or bfloat16, all
    four tensors one dtype, contiguous, ``D <= MAX_WIDE_FEATURES``; the
    variant picked by D) on the current stream and add one to
    ``layernorm_residual.launches``; anything else raises.
    """
    D = _check(x, residual, weight, bias)
    s, y = _LayerNormResidual.apply(x.reshape(-1, D),
                                    residual.reshape(-1, D), weight, bias,
                                    float(epsilon))
    return s.reshape(x.shape), y.reshape(x.shape)


#: kernel launches so far (CUDA tensors only; the CPU path never counts)
layernorm_residual.launches = 0
