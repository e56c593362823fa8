"""Elementwise and reduction math — port of ``paddle_tpu.tensor.math``.

The JAX package's semantics, not torch's where they differ: ``mod`` /
``remainder`` take the divisor's sign (``jnp.mod``), ``divide`` is true
division (integers give float32), the unary functions promote integers
to float32, ``cummax`` / ``cummin`` index the last position of the
running extreme, ``outer`` flattens its operands."""
from __future__ import annotations

import numpy as np
import torch

from ._common import DEFAULT_FLOAT, all_dims, axes, dtype_or, f, t

__all__ = [
    "add", "add_n", "addcmul", "subtract", "multiply", "divide",
    "floor_divide", "mod", "floor_mod", "remainder", "pow", "maximum",
    "minimum", "fmax", "fmin", "atan2", "logaddexp", "heaviside", "gcd",
    "lcm", "hypot", "copysign", "nextafter", "ldexp",
    "abs", "neg", "exp", "expm1", "log", "log2", "log10", "log1p", "sqrt",
    "rsqrt", "square", "reciprocal", "sign", "floor", "ceil", "round",
    "trunc", "frac", "sin", "cos", "tan", "asin", "acos", "atan", "sinh",
    "cosh", "tanh", "asinh", "acosh", "atanh", "erf", "erfinv", "sigmoid",
    "logit", "digamma", "lgamma", "angle", "conj", "deg2rad", "rad2deg",
    "exp2", "i0", "i0e", "i1", "i1e", "sgn",
    "scale", "clip", "stanh",
    "sum", "nansum", "mean", "nanmean", "prod", "max", "min", "amax",
    "amin", "logsumexp", "all", "any", "count_nonzero",
    "cumsum", "cumprod", "cummax", "cummin", "logcumsumexp",
    "addmm", "inner", "outer", "multiplex", "lerp", "diff", "trapezoid",
    "isfinite", "isinf", "isnan", "nan_to_num", "broadcast_shape",
    "increment", "kron", "renorm", "trace", "diagonal", "take",
]


def _pair(x, y):
    """Both operands as tensors (a Python number stays a number)."""
    if isinstance(x, torch.Tensor):
        return x, (y if isinstance(y, (int, float, bool)) else t(y, x))
    if isinstance(y, torch.Tensor):
        return (x if isinstance(x, (int, float, bool)) else t(x, y)), y
    x = t(x)
    return x, t(y, x)


# -- elementwise binary --------------------------------------------------------
def add(x, y, name=None):
    return torch.add(*_pair(x, y))


def subtract(x, y, name=None):
    return torch.subtract(*_pair(x, y))


def multiply(x, y, name=None):
    return torch.multiply(*_pair(x, y))


def divide(x, y, name=None):
    return torch.true_divide(*_pair(x, y))


def floor_divide(x, y, name=None):
    return torch.floor_divide(*_pair(x, y))


def mod(x, y, name=None):
    """``jnp.mod``: the result takes the divisor's sign."""
    return torch.remainder(*_pair(x, y))


remainder = mod
floor_mod = mod


def pow(x, y, name=None):
    return torch.pow(*_pair(x, y))


def maximum(x, y, name=None):
    return torch.maximum(*(t(v) for v in _pair(x, y)))


def minimum(x, y, name=None):
    return torch.minimum(*(t(v) for v in _pair(x, y)))


def fmax(x, y, name=None):
    return torch.fmax(*(t(v) for v in _pair(x, y)))


def fmin(x, y, name=None):
    return torch.fmin(*(t(v) for v in _pair(x, y)))


def atan2(x, y, name=None):
    x, y = _pair(x, y)
    return torch.atan2(f(x), f(y, x))


def logaddexp(x, y, name=None):
    x, y = _pair(x, y)
    return torch.logaddexp(f(x), f(y, x))


def heaviside(x, y, name=None):
    x, y = _pair(x, y)
    x, y = t(x), t(y, x)
    dt = torch.promote_types(x.dtype, y.dtype)
    return torch.heaviside(x.to(dt), y.to(dt))


def gcd(x, y, name=None):
    x, y = _pair(x, y)
    return torch.gcd(t(x), t(y, x))


def lcm(x, y, name=None):
    x, y = _pair(x, y)
    return torch.lcm(t(x), t(y, x))


def hypot(x, y, name=None):
    x, y = _pair(x, y)
    return torch.hypot(f(x), f(y, x))


def copysign(x, y, name=None):
    x, y = _pair(x, y)
    return torch.copysign(t(x), t(y, x))


def nextafter(x, y, name=None):
    x, y = _pair(x, y)
    x, y = t(x), t(y, x)
    return torch.nextafter(x, y.to(x.dtype))


def ldexp(x, y, name=None):
    x, y = _pair(x, y)
    return torch.ldexp(f(x), t(y, x))


# -- elementwise unary ---------------------------------------------------------
def abs(x, name=None):
    return torch.abs(t(x))


def neg(x, name=None):
    return torch.neg(t(x))


def exp(x, name=None):
    return torch.exp(f(x))


def expm1(x, name=None):
    return torch.expm1(f(x))


def exp2(x, name=None):
    return torch.exp2(f(x))


def log(x, name=None):
    return torch.log(f(x))


def log2(x, name=None):
    return torch.log2(f(x))


def log10(x, name=None):
    return torch.log10(f(x))


def log1p(x, name=None):
    return torch.log1p(f(x))


def sqrt(x, name=None):
    return torch.sqrt(f(x))


def rsqrt(x, name=None):
    return torch.rsqrt(f(x))


def square(x, name=None):
    return torch.square(t(x))


def reciprocal(x, name=None):
    return torch.reciprocal(f(x))


def sign(x, name=None):
    return torch.sign(t(x))


def sgn(x, name=None):
    return torch.sgn(t(x))


def floor(x, name=None):
    x = t(x)
    return torch.floor(x) if x.is_floating_point() else x.clone()


def ceil(x, name=None):
    x = t(x)
    return torch.ceil(x) if x.is_floating_point() else x.clone()


def round(x, name=None):
    """Half to even, as ``jnp.round``."""
    x = t(x)
    return torch.round(x) if x.is_floating_point() else x.clone()


def trunc(x, name=None):
    x = t(x)
    return torch.trunc(x) if x.is_floating_point() else x.clone()


def frac(x, name=None):
    x = t(x)
    return x - trunc(x)


def sin(x, name=None):
    return torch.sin(f(x))


def cos(x, name=None):
    return torch.cos(f(x))


def tan(x, name=None):
    return torch.tan(f(x))


def asin(x, name=None):
    return torch.asin(f(x))


def acos(x, name=None):
    return torch.acos(f(x))


def atan(x, name=None):
    return torch.atan(f(x))


def sinh(x, name=None):
    return torch.sinh(f(x))


def cosh(x, name=None):
    return torch.cosh(f(x))


def tanh(x, name=None):
    return torch.tanh(f(x))


def asinh(x, name=None):
    return torch.asinh(f(x))


def acosh(x, name=None):
    return torch.acosh(f(x))


def atanh(x, name=None):
    return torch.atanh(f(x))


def erf(x, name=None):
    return torch.erf(f(x))


def erfinv(x, name=None):
    return torch.erfinv(f(x))


def sigmoid(x, name=None):
    return torch.sigmoid(f(x))


def logit(x, eps=None, name=None):
    return torch.logit(f(x), eps)


def digamma(x, name=None):
    return torch.digamma(f(x))


def lgamma(x, name=None):
    return torch.lgamma(f(x))


def angle(x, name=None):
    x = t(x)
    return torch.angle(x if x.is_floating_point() or x.is_complex()
                       else x.to(DEFAULT_FLOAT))


def conj(x, name=None):
    x = t(x)
    return torch.conj(x).resolve_conj() if x.is_complex() else x.clone()


def deg2rad(x, name=None):
    return torch.deg2rad(f(x))


def rad2deg(x, name=None):
    return torch.rad2deg(f(x))


def i0(x, name=None):
    return torch.special.i0(f(x))


def i0e(x, name=None):
    return torch.special.i0e(f(x))


def i1(x, name=None):
    return torch.special.i1(f(x))


def i1e(x, name=None):
    return torch.special.i1e(f(x))


# -- scale / clip --------------------------------------------------------------
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """Parity: ``paddle.scale``: ``x·scale + bias`` (or ``(x + bias)·scale``)
    in ``x``'s dtype, then ``act`` (``relu``, ``tanh``, ``sigmoid``)."""
    x = t(x)
    s = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
    b = torch.as_tensor(bias, dtype=x.dtype, device=x.device)
    out = x * s + b if bias_after_scale else (x + b) * s
    if act == "relu":
        out = torch.relu(out)
    elif act == "tanh":
        out = torch.tanh(out)
    elif act == "sigmoid":
        out = torch.sigmoid(out)
    return out


def clip(x, min=None, max=None, name=None):
    x = t(x)
    if min is None and max is None:
        return x.clone()
    return torch.clamp(x, min, max)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * f(x))


# -- reductions ----------------------------------------------------------------
def _dims(x, axis):
    return all_dims(x) if axis is None else axes(axis)


def _int_sum_dtype(x, dtype):
    """``jnp.sum`` of bool / small ints accumulates in the default int."""
    if dtype is not None:
        return dtype_or(dtype)
    if x.dtype == torch.bool:
        return torch.int64
    return None


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    x = t(x)
    return torch.sum(x, dim=_dims(x, axis), keepdim=keepdim,
                     dtype=_int_sum_dtype(x, dtype))


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    x = t(x)
    return torch.nansum(x, dim=_dims(x, axis), keepdim=keepdim,
                        dtype=_int_sum_dtype(x, dtype))


def mean(x, axis=None, keepdim=False, name=None):
    x = f(x)
    return torch.mean(x, dim=_dims(x, axis), keepdim=keepdim)


def nanmean(x, axis=None, keepdim=False, name=None):
    x = f(x)
    return torch.nanmean(x, dim=_dims(x, axis), keepdim=keepdim)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    x = t(x)
    dt = _int_sum_dtype(x, dtype)
    if axis is None:
        out = torch.prod(x.reshape(-1), 0, dtype=dt)
        return out.reshape((1,) * x.dim()) if keepdim else out
    for a in sorted((d % x.dim() for d in (
            axis if isinstance(axis, (list, tuple)) else [axis])),
            reverse=True):
        x = torch.prod(x, a, keepdim=keepdim, dtype=dt)
    return x


def max(x, axis=None, keepdim=False, name=None):
    x = t(x)
    return torch.amax(x, dim=_dims(x, axis), keepdim=keepdim)


def min(x, axis=None, keepdim=False, name=None):
    x = t(x)
    return torch.amin(x, dim=_dims(x, axis), keepdim=keepdim)


amax = max
amin = min


def logsumexp(x, axis=None, keepdim=False, name=None):
    x = f(x)
    return torch.logsumexp(x, dim=_dims(x, axis), keepdim=keepdim)


def all(x, axis=None, keepdim=False, name=None):
    x = t(x).bool()
    return torch.all(x, dim=_dims(x, axis), keepdim=keepdim)


def any(x, axis=None, keepdim=False, name=None):
    x = t(x).bool()
    return torch.any(x, dim=_dims(x, axis), keepdim=keepdim)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    x = t(x)
    return (x != 0).sum(dim=_dims(x, axis), keepdim=keepdim)


# -- cumulative ----------------------------------------------------------------
def _flat_axis(x, axis):
    x = t(x)
    return (x.reshape(-1), 0) if axis is None else (x, axis)


def cumsum(x, axis=None, dtype=None, name=None):
    x, axis = _flat_axis(x, axis)
    return torch.cumsum(x, axis, dtype=_int_sum_dtype(x, dtype))


def cumprod(x, dim=None, dtype=None, name=None):
    x, dim = _flat_axis(x, dim)
    return torch.cumprod(x, dim, dtype=_int_sum_dtype(x, dtype))


def _cum_extreme(x, axis, dtype, op):
    x, axis = _flat_axis(x, axis)
    values = op(x, axis).values
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    iota = torch.arange(x.shape[axis], device=x.device).reshape(
        shape).expand(x.shape)
    # the last position where the running extreme was reached
    idx = torch.cummax(torch.where(x == values, iota, -1), axis).values
    return values, idx.to(dtype_or(dtype))


def cummax(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(x, axis, dtype, torch.cummax)


def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(x, axis, dtype, torch.cummin)


def logcumsumexp(x, axis=None, name=None):
    x, axis = _flat_axis(f(x), axis)
    return torch.logcumsumexp(x, axis)


# -- the rest --------------------------------------------------------------------
def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return beta * t(input) + alpha * torch.matmul(t(x), t(y))


def inner(x, y, name=None):
    return torch.inner(t(x), t(y))


def outer(x, y, name=None):
    return torch.outer(t(x).reshape(-1), t(y).reshape(-1))


def multiplex(inputs, index, name=None):
    """Parity: ``paddle.multiplex``: row i from ``inputs[index[i]]``."""
    stacked = torch.stack([t(v) for v in inputs])
    idx = t(index).reshape(-1).long()
    return stacked[idx, torch.arange(stacked.shape[1],
                                     device=stacked.device)]


def lerp(x, y, weight, name=None):
    x = f(x)
    w = t(weight, x).to(x.dtype) if not isinstance(weight, (int, float)) \
        else weight
    return x + w * (t(y, x).to(x.dtype) - x)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    x = t(x)
    pre = t(prepend, x) if prepend is not None else None
    app = t(append, x) if append is not None else None
    return torch.diff(x, n=n, dim=axis, prepend=pre, append=app)


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    y = f(y)
    if x is not None:
        return torch.trapezoid(y, t(x, y).to(y.dtype), dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


def isfinite(x, name=None):
    return torch.isfinite(t(x))


def isinf(x, name=None):
    return torch.isinf(t(x))


def isnan(x, name=None):
    return torch.isnan(t(x))


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(t(x), nan=nan, posinf=posinf, neginf=neginf)


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def increment(x, value=1.0, name=None):
    """``x + value`` in ``x``'s dtype (a new tensor, as the JAX
    package's)."""
    x = t(x)
    return x + torch.as_tensor(value, dtype=x.dtype, device=x.device)


def kron(x, y, name=None):
    return torch.kron(t(x), t(y))


def renorm(x, p, axis, max_norm, name=None):
    x = f(x)
    dims = tuple(i for i in range(x.dim()) if i != axis % x.dim())
    norms = (x.abs() ** p).sum(dim=dims, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    return x * factor


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(t(x), offset, axis1, axis2).sum(-1)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(t(x), offset, axis1, axis2)


def take(x, index, mode="raise", name=None):
    """Flat indexing; ``mode`` ``"wrap"`` wraps, ``"clip"`` clamps into
    ``[-n, n)``; negative indices count from the end."""
    x = t(x).reshape(-1)
    n = x.shape[0]
    idx = t(index, x).long()
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    elif mode == "clip":
        idx = idx.clamp(-n, n - 1)
    idx = torch.where(idx < 0, idx + n, idx)
    return x[idx]


def add_n(inputs, name=None):
    """The elementwise sum of a list of tensors."""
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    out = t(inputs[0])
    for v in inputs[1:]:
        out = out + t(v, out)
    return out


def addcmul(input, tensor1, tensor2, value=1.0, name=None):
    """``input + value · tensor1 · tensor2``."""
    return t(input) + value * t(tensor1) * t(tensor2)

