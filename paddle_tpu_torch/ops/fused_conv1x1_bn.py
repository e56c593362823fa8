"""Fused 1x1 convolution + batch-norm statistics and the batch-norm apply
epilogue — port of ``paddle_tpu/ops/fused_conv1x1_bn.py``.

ResNet's train-mode ``conv3 (1x1) → bn3 → +identity → relu`` tail in two
passes over the conv output instead of three: :func:`conv1x1_bn_stats`
computes ``Y = X @ W`` (a 1x1 stride-1 NHWC convolution flattened to
``[M = N·H·W, Cin] @ [Cin, Cout]``) together with each column's ``Σy`` and
``Σy²`` in float32, taken from the float32 product before ``y`` is rounded
to the activation dtype; :func:`bn_apply_relu` then normalizes, adds the
residual and applies the ReLU in one pass.  On the card each is the
hand-written CUDA kernel of ``ops/csrc/fused_conv1x1_bn.cu`` (``sm_90a``,
built with nvcc on first use, bound with ctypes; bf16 products on the
tensor cores, float32 on SIMT FMAs, deterministic column sums).  Each
kernel has two designs, and the wrapper picks one by shape before the
launch (:func:`_stats_plan`, :func:`_apply_plan`): the Hopper design
(kernel 7: persistent, a TMA ring, wgmma, the statistics in the epilogue,
``w`` read in the layout it comes in; kernel 8: each thread's scale and
shift resident in registers, 8 rows in flight) where it applies, the
first design elsewhere.

:func:`conv1x1_bn_relu` is the tail as a ``torch.autograd.Function`` with
the JAX body's forward arithmetic — ``mean = Σ/M``, ``var = max(Σ²/M −
mean², 0)``, ``scale = γ·inv`` and ``shift = β − mean·γ·inv`` each cast to
``y``'s dtype, the residual cast to ``y``'s dtype — and returns the new
running statistics with paddle's momentum and the UNBIASED variance
``var·M/(M−1)``, in float32, as the JAX function does.  The JAX Pallas
kernels have no VJP (``jax.grad`` through them stops with an
``AssertionError``); the port's backward is the closed-form gradient of
the same function in plain PyTorch, the gradient of the plain tail
``relu(bn3(conv3(x)) + identity)`` that the JAX package defines.

Each kernel has a plain PyTorch version beside it with the same signature
(``*_ref``): the CPU path and the yardstick on the card.  A CUDA tensor
always goes to the kernel; what the kernel does not take raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..framework.errors import InvalidArgumentError
from . import _build

__all__ = ["conv1x1_bn_stats", "conv1x1_bn_stats_ref", "bn_apply_relu",
           "bn_apply_relu_ref", "conv1x1_bn_relu", "conv1x1_bn_relu_ref",
           "fused_epilogues_eligible"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: output tile edge of the stats kernel's first design, by dtype (csrc: kBM /
#: kFBM) and of its Hopper design (kHM x kHN)
_TILE = {torch.float32: 64, torch.bfloat16: 128}
_HOPPER_ROWS = 128
#: blocks the stats kernel's first design aims for: six per SM of an H100
_TARGET_BLOCKS = 6 * 132
#: the resident bn_apply design: rows a thread takes a turn (csrc:
#: kApplyRows), and at most this many 256-thread blocks an SM
_APPLY_ROWS = 8
_APPLY_BLOCKS_PER_SM = 32
#: the channel multiple of the fused-tail gate (the JAX package's LANE)
LANE = 128
_fns = {}
_fns_lock = threading.Lock()


def fused_epilogues_eligible(feature_dim: int, x: torch.Tensor) -> bool:
    """Should a model's hot path take the fused kernels?  The JAX gate
    (``ops.autotune.fused_epilogues_eligible``) asks for a real TPU
    backend and lane-aligned channels; here the backend is the activation
    ``x``: a CUDA tensor, for which the kernels always run.  Channels stay
    a multiple of ``LANE`` (every ResNet conv3 meets it).  On the CPU the
    plain path runs, as the JAX package's does off the TPU."""
    return x.device.type == "cuda" and feature_dim % LANE == 0


#: the C entries of ``csrc/fused_conv1x1_bn.cu`` and their ctypes argtypes
_ARGTYPES = {
    "conv1x1_bn_stats_fwd": [ctypes.c_int] + [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "conv1x1_bn_stats_wgmma": [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int] + [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    "bn_apply_relu_fwd": [ctypes.c_int] + [ctypes.c_void_p] * 5
    + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "bn_apply_relu_resident": [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
    + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p],
}


def _entry(symbol):
    with _fns_lock:
        fn = _fns.get(symbol)
        if fn is None:
            fn = _fns[symbol] = _build.entry("fused_conv1x1_bn", symbol,
                                             _ARGTYPES[symbol])
        return fn


def _device_check(name, tensors, dtype_of):
    dev = tensors[0][1].device
    for what, t in tensors:
        if t.device != dev:
            raise InvalidArgumentError(
                f"{name}: {what} on {t.device}, {tensors[0][0]} on {dev}")
        if t.dtype != dtype_of:
            raise InvalidArgumentError(
                f"{name}: {what} is {t.dtype}, expected {dtype_of} (the "
                f"kernel takes one dtype for its operands)")
    if dtype_of not in _DTYPES:
        raise InvalidArgumentError(
            f"{name}: the kernel takes float32 or bfloat16, got {dtype_of}")
    if dev.type not in _build.PLAIN_DEVICES + ("cuda",):
        raise InvalidArgumentError(f"{name}: tensors on {dev} (cpu or cuda)")
    return dev


def _vec_ok(widths, tensors, itemsize):
    """16-byte vectors are safe: every row a multiple of 16 bytes and every
    base 16-byte aligned."""
    per = 16 // itemsize
    return int(all(w % per == 0 for w in widths)
               and all(t.data_ptr() % 16 == 0 for t in tensors))


# -- kernel 7: Y = X @ W with column statistics --------------------------------
def _check_stats(x, w):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise InvalidArgumentError(
            f"conv1x1_bn_stats: shape mismatch {tuple(x.shape)} @ "
            f"{tuple(w.shape)}")
    return _device_check("conv1x1_bn_stats", [("x", x), ("w", w)], x.dtype)


def conv1x1_bn_stats_ref(x, w):
    """Plain PyTorch version of :func:`conv1x1_bn_stats`: the product in
    float32, the statistics from it, then ``y`` rounded to x's dtype."""
    _check_stats(x, w)
    yf = x.float() @ w.float()
    return yf.to(x.dtype), yf.sum(0), (yf * yf).sum(0)


def _splits(M, N, dtype):
    """(tiles a block walks, blocks along M) for the stats kernel."""
    tile = _TILE[dtype]
    m_tiles, n_tiles = -(-M // tile), -(-N // tile)
    splits = min(m_tiles, max(1, -(-_TARGET_BLOCKS // n_tiles)))
    per = -(-m_tiles // splits)
    return per, -(-m_tiles // per)


def _stats_plan(x, w):
    """``(design, w_layout)`` of a call on contiguous ``x``: the Hopper
    design ``"wgmma"`` for bf16 with K and N multiples of 8 (TMA's 16-byte
    row strides) and a 16-byte-aligned x, else ``"first"``; ``w`` read as
    it is, ``"mn-major"`` (a contiguous ``[K, N]``) or ``"k-major"`` (the
    ``.t()`` view of a contiguous ``[N, K]`` weight: the Hopper design only),
    or ``"copy"`` (``w.contiguous()`` first, then MN-major)."""
    K, N = w.shape
    aligned_w = w.data_ptr() % 16 == 0
    if (x.dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0
            and x.data_ptr() % 16 == 0):
        if w.is_contiguous() and aligned_w:
            return "wgmma", "mn-major"
        if w.t().is_contiguous() and aligned_w:
            return "wgmma", "k-major"
        return "wgmma", "copy"
    return "first", "mn-major" if w.is_contiguous() else "copy"


def _stats_tile(N):
    """The Hopper design's tile width: 256 columns where N is a multiple of
    256 (every ResNet conv3: 3-11% faster than 128 at the four shapes),
    else 128."""
    return 256 if N % 256 == 0 else 128


def _stats_blocks(M, N, tile_n, sms):
    """The Hopper design's grid: one block an SM, at most one a tile of
    128 rows x ``tile_n`` columns."""
    tiles = -(-M // _HOPPER_ROWS) * -(-N // tile_n)
    return max(1, min(tiles, sms))


def _stats_kernel(x, w, design=None, tile_n=None):
    """Launch the CUDA stats kernel (two launches: the tiles and the fixed-
    order reduction of their partial sums) in the design
    :func:`_stats_plan` picks, or ``design="first"``; the Hopper design's
    tile width from :func:`_stats_tile` or ``tile_n`` (128 or 256).  Adds
    one to ``conv1x1_bn_stats.launches``."""
    M, K = x.shape
    N = w.shape[1]
    x = x.contiguous()
    y = torch.empty(M, N, dtype=x.dtype, device=x.device)
    s = torch.empty(N, dtype=torch.float32, device=x.device)
    q = torch.empty(N, dtype=torch.float32, device=x.device)
    if M * K * N == 0:
        return y.zero_(), s.zero_(), q.zero_()
    plan, layout = _stats_plan(x, w)
    if design is not None:
        if design not in ("wgmma", "first") or (design == "wgmma"
                                                 and plan != "wgmma"):
            raise InvalidArgumentError(
                f"conv1x1_bn_stats: design {design!r} does not take "
                f"{x.dtype} [{M}, {K}] @ [{K}, {N}]")
        plan = design
    if plan == "wgmma":
        if layout == "copy":
            w = w.contiguous()
        tile_n = tile_n or _stats_tile(N)
        if tile_n not in (128, 256):
            raise InvalidArgumentError(
                f"conv1x1_bn_stats: tile_n {tile_n} (128 or 256)")
        blocks = _stats_blocks(M, N, tile_n, _build.sm_count(x.device))
        part = torch.empty(2, blocks, N, dtype=torch.float32,
                           device=x.device)
        fn = _entry("conv1x1_bn_stats_wgmma")
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            fn(x.data_ptr(), w.data_ptr(), int(layout == "k-major"),
               y.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
               s.data_ptr(), q.data_ptr(), M, K, N, tile_n, blocks, stream)
        conv1x1_bn_stats.launches += 1
        return y, s, q
    w = w.contiguous()
    per, splits = _splits(M, N, x.dtype)
    if splits > 65535:
        raise InvalidArgumentError(
            f"conv1x1_bn_stats: M = {M} needs {splits} row blocks, more "
            f"than the grid's 65535")
    part = torch.empty(2, splits, N, dtype=torch.float32, device=x.device)
    fn = _entry("conv1x1_bn_stats_fwd")
    vec = _vec_ok((K, N), (x, w, y), x.element_size())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        fn(_DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), y.data_ptr(),
           part[0].data_ptr(), part[1].data_ptr(), s.data_ptr(),
           q.data_ptr(), M, K, N, per, vec, stream)
    conv1x1_bn_stats.launches += 1
    return y, s, q


def conv1x1_bn_stats(x, w):
    """``Y = X @ W`` plus per-output-channel ``(Σy, Σy²)`` in one pass.

    x ``[M, Cin]`` (flattened NHWC activations), w ``[Cin, Cout]``, one
    dtype (float32 or bfloat16).  Returns ``(y [M, Cout] in x's dtype,
    sum [Cout] float32, sumsq [Cout] float32)``, the statistics taken from
    the float32 product before rounding.  CPU tensors take
    :func:`conv1x1_bn_stats_ref`; CUDA tensors launch the kernel on the
    current stream and add one to ``conv1x1_bn_stats.launches``.  Not
    differentiable (neither is the JAX kernel): :func:`conv1x1_bn_relu`
    carries the gradient.
    """
    dev = _check_stats(x, w)
    if dev.type in _build.PLAIN_DEVICES:
        return conv1x1_bn_stats_ref(x, w)
    return _stats_kernel(x, w)


#: kernel launches so far (CUDA tensors only; the CPU path never counts)
conv1x1_bn_stats.launches = 0


# -- kernel 8: relu(y·scale + shift [+ residual]) ------------------------------
def _check_apply(y, scale, shift, residual):
    if y.dim() != 2:
        raise InvalidArgumentError(
            f"bn_apply_relu: y must be [M, N], got {tuple(y.shape)}")
    N = y.shape[1]
    if tuple(scale.shape) != (N,) or tuple(shift.shape) != (N,):
        raise InvalidArgumentError(
            f"bn_apply_relu: scale/shift {tuple(scale.shape)}/"
            f"{tuple(shift.shape)} do not match {N} channels")
    ops = [("y", y)] + ([("residual", residual)]
                        if residual is not None else [])
    if residual is not None and residual.shape != y.shape:
        raise InvalidArgumentError(
            f"bn_apply_relu: residual {tuple(residual.shape)} vs y "
            f"{tuple(y.shape)}")
    dev = _device_check("bn_apply_relu", ops, y.dtype)
    for what, t in (("scale", scale), ("shift", shift)):
        if t.device != dev:
            raise InvalidArgumentError(
                f"bn_apply_relu: {what} on {t.device}, y on {dev}")
    return dev


def bn_apply_relu_ref(y, scale, shift, residual=None):
    """Plain PyTorch version of :func:`bn_apply_relu`: float32 math,
    ``(y·scale + shift) + residual`` with each step rounded, one cast."""
    _check_apply(y, scale, shift, residual)
    out = y.float() * scale.float() + shift.float()
    if residual is not None:
        out = out + residual.float()
    return torch.relu(out).to(y.dtype)


def _apply_plan(dtype, N, aligned):
    """The design of a bn_apply launch: ``"resident"`` where rows are whole
    16-byte vectors (N a multiple of 16 bytes' worth of ``dtype``) and y,
    the residual and out are 16-byte aligned (``aligned``), else
    ``"first"`` (its scalar loop)."""
    per = 16 // (torch.finfo(dtype).bits // 8)
    return "resident" if aligned and N % per == 0 else "first"


def _apply_blocks(M, N, itemsize, sms):
    """The resident design's grid: enough 256-thread blocks that each
    thread takes one turn of ``_APPLY_ROWS`` rows, at most
    ``_APPLY_BLOCKS_PER_SM`` an SM and at least one thread a column
    chunk."""
    chunks = N * itemsize // 16
    want = -(-(-(-M // _APPLY_ROWS) * chunks) // 256)
    return max(-(-chunks // 256), min(want, sms * _APPLY_BLOCKS_PER_SM))


def _apply_kernel(y, scale, shift, residual, design=None):
    """Launch the CUDA bn_apply kernel in the design :func:`_apply_plan`
    picks, or ``design="first"``.  Adds one to ``bn_apply_relu.launches``."""
    M, N = y.shape
    y = y.contiguous()
    res = residual.contiguous() if residual is not None else None
    out = torch.empty_like(y)
    if M == 0 or N == 0:
        return out
    tensors = (y, out) + ((res,) if res is not None else ())
    vec = _vec_ok((N,), tensors, y.element_size())
    plan = _apply_plan(y.dtype, N, all(t.data_ptr() % 16 == 0
                                       for t in tensors))
    if design is not None:
        if design not in ("resident", "first") or (design == "resident"
                                                    and plan != "resident"):
            raise InvalidArgumentError(
                f"bn_apply_relu: design {design!r} does not take {y.dtype} "
                f"[{M}, {N}]")
        plan = design
    if plan == "resident":
        # scale and shift as they come when both are float32 or bf16 (the
        # kernel widens bf16 exactly), else as float32
        if scale.dtype == shift.dtype and scale.dtype in _DTYPES:
            sc, sh = scale.contiguous(), shift.contiguous()
        else:
            sc, sh = scale.float().contiguous(), shift.float().contiguous()
        fn = _entry("bn_apply_relu_resident")
        blocks = _apply_blocks(M, N, y.element_size(),
                               _build.sm_count(y.device))
        with torch.cuda.device(y.device):
            stream = torch.cuda.current_stream(y.device).cuda_stream
            fn(_DTYPES[y.dtype], _DTYPES[sc.dtype], y.data_ptr(),
               sc.data_ptr(), sh.data_ptr(),
               res.data_ptr() if res is not None else None, out.data_ptr(),
               M, N, blocks, stream)
        bn_apply_relu.launches += 1
        return out
    sc = scale.float().contiguous()
    sh = shift.float().contiguous()
    n_vec = -(-M * N * y.element_size() // 16)
    blocks = max(1, min(-(-n_vec // 256), 132 * 16))
    fn = _entry("bn_apply_relu_fwd")
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        fn(_DTYPES[y.dtype], y.data_ptr(), sc.data_ptr(), sh.data_ptr(),
           res.data_ptr() if res is not None else None, out.data_ptr(), M, N,
           vec, blocks, stream)
    bn_apply_relu.launches += 1
    return out


def bn_apply_relu(y, scale, shift, residual=None):
    """Batch-norm normalize + residual add + ReLU in one pass:
    ``relu(y·scale + shift [+ residual])``.

    y ``[M, Cout]`` (float32 or bfloat16), scale/shift ``[Cout]`` (any
    float dtype; the math is float32), residual optional ``[M, Cout]`` in
    y's dtype.  Returns y's dtype.  CPU tensors take
    :func:`bn_apply_relu_ref`; CUDA tensors launch the kernel, bit-equal
    to the plain version, and add one to ``bn_apply_relu.launches``.
    """
    dev = _check_apply(y, scale, shift, residual)
    if dev.type in _build.PLAIN_DEVICES:
        return bn_apply_relu_ref(y, scale, shift, residual)
    return _apply_kernel(y, scale, shift, residual)


#: kernel launches so far (CUDA tensors only; the CPU path never counts)
bn_apply_relu.launches = 0


# -- the tail ------------------------------------------------------------------
def _fold(s, q, M, gamma, beta, epsilon, dtype):
    """The JAX body's statistics and folded affine: ``(mean, var, inv,
    scale, shift)``, scale and shift cast to ``dtype``."""
    mean = s / M
    var = torch.clamp_min(q / M - mean * mean, 0.0)
    inv = torch.rsqrt(var + epsilon)
    g = gamma.float()
    scale = (g * inv).to(dtype)
    shift = (beta.float() - mean * g * inv).to(dtype)
    return mean, var, inv, scale, shift


def _running(mean, var, M, momentum, running_mean, running_var):
    if (running_mean is None) != (running_var is None):
        raise InvalidArgumentError(
            "conv1x1_bn_relu: pass running_mean and running_var together "
            "(or neither)")
    if running_mean is None:
        return None, None
    with torch.no_grad():
        unbiased = var * float(M) / max(M - 1, 1)
        return (momentum * running_mean.float() + (1 - momentum) * mean,
                momentum * running_var.float() + (1 - momentum) * unbiased)


class _Conv1x1BnRelu(torch.autograd.Function):
    """Forward: kernel 7, the fold, kernel 8 (or their plain versions on
    the CPU).  Backward: the closed-form gradient in plain PyTorch."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta, residual, epsilon):
        M = x.shape[0]
        y, s, q = conv1x1_bn_stats(x, w)
        mean, var, inv, scale, shift = _fold(s, q, M, gamma, beta, epsilon,
                                             y.dtype)
        res = None if residual is None else residual.to(y.dtype)
        out = bn_apply_relu(y, scale, shift, res)
        ctx.save_for_backward(x, w, y, out, mean, inv, gamma)
        ctx.res_dtype = None if residual is None else residual.dtype
        ctx.beta_dtype = beta.dtype
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        x, w, y, out, mean, inv, gamma = ctx.saved_tensors
        M = y.shape[0]
        g = torch.where(out > 0, dout.float(), 0.0)    # d pre-activation
        yhat = (y.float() - mean) * inv
        sg = g.sum(0)                                  # = dβ
        sgy = (g * yhat).sum(0)                        # = dγ
        dy = (gamma.float() * inv / M) * (M * g - sg - yhat * sgy)
        dy = dy.to(x.dtype)
        need = ctx.needs_input_grad
        dx = dy @ w.t() if need[0] else None
        dw = x.t() @ dy if need[1] else None
        dres = (g.to(ctx.res_dtype)
                if ctx.res_dtype is not None and need[4] else None)
        return (dx, dw, sgy.to(gamma.dtype), sg.to(ctx.beta_dtype), dres,
                None)


def conv1x1_bn_relu(x, w, gamma, beta, *, epsilon: float = 1e-5,
                    residual=None, momentum: float = 0.9, running_mean=None,
                    running_var=None):
    """Train-mode ``relu(BN(X @ W) [+ residual])`` through kernels 7 and 8
    (the JAX ``conv1x1_bn_relu(..., fused_epilogue=True)``).

    x ``[M, Cin]`` NHWC-flattened, w ``[Cin, Cout]``, gamma/beta
    ``[Cout]``, residual ``[M, Cout]``.  Returns ``(out [M, Cout] in x's
    dtype, new_running_mean, new_running_var)`` with paddle's momentum
    (``new = momentum·old + (1 − momentum)·batch``) and the unbiased batch
    variance, float32; ``None`` for both when no running stats are
    given.  Differentiable in x, w, gamma, beta and residual.
    """
    out, mean, var = _Conv1x1BnRelu.apply(x, w, gamma, beta, residual,
                                          float(epsilon))
    rm, rv = _running(mean, var, x.shape[0], momentum, running_mean,
                      running_var)
    return out, rm, rv


def conv1x1_bn_relu_ref(x, w, gamma, beta, *, epsilon: float = 1e-5,
                        residual=None, momentum: float = 0.9,
                        running_mean=None, running_var=None):
    """Plain PyTorch version of :func:`conv1x1_bn_relu` (the same forward
    through the two plain kernel versions), differentiable by autograd."""
    M = x.shape[0]
    y, s, q = conv1x1_bn_stats_ref(x, w)
    mean, var, _, scale, shift = _fold(s, q, M, gamma, beta, float(epsilon),
                                       y.dtype)
    res = None if residual is None else residual.to(y.dtype)
    out = bn_apply_relu_ref(y, scale, shift, res)
    rm, rv = _running(mean.detach(), var.detach(), M, momentum, running_mean,
                      running_var)
    return out, rm, rv

