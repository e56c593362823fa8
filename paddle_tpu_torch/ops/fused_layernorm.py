"""Fused residual add + LayerNorm — port of ``paddle_tpu/ops/fused_layernorm.py``.

Every transformer sublayer boundary runs ``s = x + sublayer_out`` and a
LayerNorm of ``s``.  :func:`layernorm_residual` does both in one pass over
the rows: on the card that is the hand-written CUDA kernel
``ops/csrc/fused_layernorm.cu`` (``sm_90a``, built with nvcc on first use,
bound with ctypes).  It holds two designs, and :func:`_forward_plan` picks
one by shape before the launch: the Hopper design (``"vector"``) for
``D <= MAX_REGISTER_FEATURES`` with whole 16-byte rows and aligned
tensors — one warp a row in registers, 16-byte loads and stores, a
persistent grid whose warps keep ``g`` and ``b`` in registers — and the
first design (``"first"``) elsewhere: for ``D <= MAX_FEATURES`` one warp
per row with scalar loads, for wider rows (up to ``MAX_WIDE_FEATURES``)
one block per row with the row in shared memory.  Either way ``x`` and
``r`` are read once and ``s`` and ``y`` written once.

Dtypes, the JAX kernel's own contract: the activation dtype ``T`` (x, and
the outputs ``s`` and ``y``) is float32, bfloat16 or float16; ``residual``
is ``T`` or float32; ``weight`` and ``bias`` are one dtype, ``T`` or
float32 (a float32 ``T`` takes float32 for all four).  Mixed operands are
what amp O1 hands the kernel: a bf16 sublayer output beside a float32
residual stream and float32 LayerNorm parameters.  The kernels read each
operand at its own width; any other mix raises ``InvalidArgumentError``.

Semantics (both paths): ``s`` is the sum rounded to the activation dtype,
and it is that ROUNDED sum which is normalized; statistics are float32,
two-pass (mean, then the mean of the centred squares); ``rstd =
rsqrt(var + eps)``; ``y = (s - mean)·rstd·weight + bias`` in the activation
dtype.  Pre-LN blocks (GPT) use both ``s`` and ``y``, post-LN blocks (BERT)
``y``.

The gradient is a ``torch.autograd.Function`` whose backward is the
closed-form LayerNorm VJP of the JAX package (``_ln_res_bwd``, which XLA
fuses into one pass on a TPU).  On the card it is one deterministic CUDA
pass of the same kernel source (two launches: the rows, then a fixed-order
sum of the column partials; no float atomics) for ``D <=
MAX_REGISTER_FEATURES`` (:func:`_backward_plan`: 16-byte vectors where the
rows are whole vectors and aligned, element loads elsewhere), counted in
``layernorm_residual.backward_launches``.  Wider rows (``D >
MAX_REGISTER_FEATURES``, plan ``"plain"``) take :func:`_backward_ref`'s
arithmetic on the card, with no launch counted.

The forward launch is the custom operator
``paddle_tpu_torch::layernorm_residual_fwd`` (``torch.library``): a graph
that ``torch.export`` traces keeps it whole, its fake implementation
gives only shapes and dtypes, and the design, alignment and grid choices
are made inside it at run time, so one exported graph serves every batch.
The autograd Function calls it, so training is unchanged.

:func:`layernorm_residual_ref` is the plain PyTorch version, differentiable
by autograd, and :func:`_backward_ref` the plain backward.  They are the
CPU path and the yardsticks the kernels are held to on the card; a CUDA
tensor always goes to a kernel where the plan says so, and what the
kernel does not take raises.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..framework.errors import InvalidArgumentError
from . import _build

__all__ = ["layernorm_residual", "layernorm_residual_ref", "MAX_FEATURES",
           "MAX_REGISTER_FEATURES", "MAX_WIDE_FEATURES"]

#: the kernels' dtype codes (csrc: 0 float32, 1 bfloat16, 2 float16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: the largest feature dim the first design's narrow variant holds in
#: registers (32 x 24)
MAX_FEATURES = 768
#: the largest feature dim the Hopper designs (forward and backward) hold
#: in registers: 32 lanes x 32 values (csrc: kMaxVPL).  The backward keeps
#: two column sums a value beside the row, so wider rows would spill.
MAX_REGISTER_FEATURES = 1024
#: the largest feature dim the first design's wide variant stages in shared
#: memory
MAX_WIDE_FEATURES = 49152
#: threads of a Hopper-design block (csrc: kThreads): four warps, a row each
_WARPS = 4
_fns = {}
_fn_lock = threading.Lock()
_occupancy = {}

#: the C entries of ``csrc/fused_layernorm.cu`` and their ctypes argtypes
_ARGTYPES = {
    "layernorm_residual_fwd": [ctypes.c_int] * 3 + [ctypes.c_void_p] * 8
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    "layernorm_residual_fwd_wide": [ctypes.c_int] * 3
    + [ctypes.c_void_p] * 8
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    "layernorm_residual_fwd_vec": [ctypes.c_int] * 4 + [ctypes.c_void_p] * 8
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
       ctypes.c_void_p],
    "layernorm_residual_bwd": [ctypes.c_int] * 4 + [ctypes.c_void_p] * 10
    + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "layernorm_residual_occupancy": [ctypes.c_int] * 7
    + [ctypes.POINTER(ctypes.c_int)],
}


def _codes(x_dtype, residual_dtype, weight_dtype):
    """The kernels' dtype codes of (x, residual, weight / bias), or
    ``InvalidArgumentError`` for a mix they do not take: x float32,
    bfloat16 or float16; residual and weight each x's dtype or float32."""
    if x_dtype not in _DTYPES:
        raise InvalidArgumentError(
            f"layernorm_residual: the kernel takes float32, bfloat16 or "
            f"float16 activations, got {x_dtype}")
    for name, dt in (("residual", residual_dtype), ("weight", weight_dtype)):
        if dt not in (x_dtype, torch.float32):
            raise InvalidArgumentError(
                f"layernorm_residual: {name} is {dt}, x is {x_dtype} (the "
                f"kernel takes x's dtype or float32)")
    return _DTYPES[x_dtype], _DTYPES[residual_dtype], _DTYPES[weight_dtype]


def _dtype_triple(dtypes):
    """``dtypes`` as (x, residual, weight): one dtype stands for all
    three."""
    if isinstance(dtypes, torch.dtype):
        return dtypes, dtypes, dtypes
    return tuple(dtypes)


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


def _entry(symbol):
    with _fn_lock:
        if symbol not in _fns:
            _fns[symbol] = _build.entry("fused_layernorm", symbol,
                                        _ARGTYPES[symbol])
        return _fns[symbol]


def _per_vector(dtype) -> int:
    """Values of ``dtype`` in a 16-byte vector."""
    return 16 // (torch.finfo(dtype).bits // 8)


def _vpl(D: int) -> int:
    """Values a lane holds in the Hopper designs: the multiple of 8 that
    covers D over 32 lanes (8, 16, 24 or 32)."""
    return 8 * -(-D // 256)


def _forward_plan(dtypes, D: int, aligned: bool) -> str:
    """The forward's design for ``dtypes`` — x's dtype, or the (x,
    residual, weight) dtypes: ``"vector"`` (the Hopper design) where the
    row fits its registers (``D <= MAX_REGISTER_FEATURES``), is whole
    16-byte vectors of x's dtype (a float32 residual or weight is then
    whole vectors too) and every tensor is 16-byte aligned (``aligned``);
    else ``"first"`` (the first design's narrow variant for ``D <=
    MAX_FEATURES``, its wide one above).  Raises ``InvalidArgumentError``
    for a dtype mix the kernels do not take."""
    x_dt, r_dt, w_dt = _dtype_triple(dtypes)
    _codes(x_dt, r_dt, w_dt)
    if D <= MAX_REGISTER_FEATURES and D % _per_vector(x_dt) == 0 and aligned:
        return "vector"
    return "first"


def _backward_plan(dtypes, D: int, aligned: bool) -> str:
    """The backward's design for ``dtypes`` — s's dtype, or the (s,
    weight) dtypes (it reads no residual): for ``D <=
    MAX_REGISTER_FEATURES`` the CUDA pass, ``"vector"`` (16-byte accesses)
    where the rows are whole vectors of s's dtype and every tensor is
    16-byte aligned, else ``"scalar"`` (element accesses); wider rows
    ``"plain"``: :func:`_backward_ref`'s arithmetic on the card, no
    launch.  Raises ``InvalidArgumentError`` for a mix the kernel does not
    take."""
    if isinstance(dtypes, torch.dtype):
        dtypes = (dtypes, dtypes)
    s_dt, w_dt = dtypes
    _codes(s_dt, s_dt, w_dt)
    if D > MAX_REGISTER_FEATURES:
        return "plain"
    if D % _per_vector(s_dt) == 0 and aligned:
        return "vector"
    return "scalar"


def _blocks(which, codes, vpl, vec, has_ds, M, device) -> int:
    """A Hopper-design grid: the blocks the card holds at once (SMs x the
    kernel's occupancy, cached), at most one a ``_WARPS`` rows.  ``codes``:
    the (x, residual, weight) dtype codes."""
    key = (which, codes, vpl, vec, has_ds)
    occ = _occupancy.get(key)
    if occ is None:
        out = ctypes.c_int(0)
        _entry("layernorm_residual_occupancy")(which, *codes, vpl, int(vec),
                                               int(has_ds),
                                               ctypes.byref(out))
        occ = _occupancy[key] = max(1, out.value)
    return max(1, min(-(-M // _WARPS), _build.sm_count(device) * occ))


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _forward_kernel(x2, r2, weight, bias, epsilon, design=None):
    """Launch the CUDA kernel on ``[M, D]`` rows in the design
    :func:`_forward_plan` picks, or ``design="first"``; same outputs as
    :func:`_forward_ref`.  Adds one to ``layernorm_residual.launches``."""
    M, D = x2.shape
    for name, t in (("residual", r2), ("weight", weight), ("bias", bias)):
        if t.device != x2.device:
            raise InvalidArgumentError(
                f"layernorm_residual: {name} on {t.device}, x on {x2.device}")
    if bias.dtype != weight.dtype:
        raise InvalidArgumentError(
            f"layernorm_residual: bias is {bias.dtype}, weight is "
            f"{weight.dtype} (the kernel takes one dtype for both)")
    codes = _codes(x2.dtype, r2.dtype, weight.dtype)
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
    plan = _forward_plan((x2.dtype, r2.dtype, weight.dtype), D,
                         _aligned(x2, r2, weight, bias, s, y))
    if design is not None:
        if design not in ("vector", "first") or (design == "vector"
                                                  and plan != "vector"):
            raise InvalidArgumentError(
                f"layernorm_residual: design {design!r} does not take "
                f"{x2.dtype} [{M}, {D}]")
        plan = design
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        ptrs = (x2.data_ptr(), r2.data_ptr(), weight.data_ptr(),
                bias.data_ptr(), s.data_ptr(), y.data_ptr(), mean.data_ptr(),
                rstd.data_ptr())
        if plan == "vector":
            vpl = _vpl(D)
            _entry("layernorm_residual_fwd_vec")(
                *codes, vpl, *ptrs, M, D, epsilon,
                _blocks(0, codes, vpl, True, False, M, x2.device), stream)
        else:
            _entry("layernorm_residual_fwd" if D <= MAX_FEATURES
                   else "layernorm_residual_fwd_wide")(
                *codes, *ptrs, M, D, epsilon, stream)
    layernorm_residual.launches += 1
    return s, y, mean, rstd


def _backward_ref(s, mean, rstd, weight, ds_out, dy):
    """Plain backward (``_ln_res_bwd``) on ``[M, D]`` rows: ``(ds, dg,
    db)`` from the saved ``s`` / ``mean`` / ``rstd`` / ``weight`` and the
    cotangents (``ds_out`` may be None: only ``y`` was used)."""
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
    return ds, dg, db


def _backward_kernel(s, mean, rstd, weight, ds_out, dy, design=None):
    """:func:`_backward_ref` on the card, in the design
    :func:`_backward_plan` picks (or ``design="vector"`` / ``"scalar"``):
    the CUDA pass, which adds one to ``layernorm_residual.backward_launches``
    (its two launches together); plan ``"plain"`` (``D >
    MAX_REGISTER_FEATURES``) runs the plain arithmetic and counts
    nothing."""
    M, D = s.shape
    dy = dy.contiguous()
    ds_out = ds_out.contiguous() if ds_out is not None else None
    for name, t in (("dy", dy), ("ds_out", ds_out), ("weight", weight)):
        if t is not None and ((t.dtype != s.dtype and name != "weight")
                              or t.device != s.device
                              or tuple(t.shape) != ((D,) if name == "weight"
                                                    else (M, D))):
            raise InvalidArgumentError(
                f"layernorm_residual backward: {name} {t.dtype} "
                f"{tuple(t.shape)} on {t.device} does not match s {s.dtype} "
                f"{tuple(s.shape)} on {s.device}")
    codes = _codes(s.dtype, s.dtype, weight.dtype)
    if not (s.is_contiguous() and weight.is_contiguous()):
        raise InvalidArgumentError(
            "layernorm_residual backward: the kernel takes contiguous s "
            "and weight")
    ds = torch.empty_like(s)
    tensors = (s, dy, ds, weight) + ((ds_out,) if ds_out is not None else ())
    plan = _backward_plan((s.dtype, weight.dtype), D, _aligned(*tensors))
    if design is not None:
        if design not in ("vector", "scalar") or plan == "plain" or (
                design == "vector" and plan != "vector"):
            raise InvalidArgumentError(
                f"layernorm_residual backward: design {design!r} does not "
                f"take {s.dtype} [{M}, {D}]")
        plan = design
    if plan == "plain":
        return _backward_ref(s, mean, rstd, weight, ds_out, dy)
    dg = torch.empty(D, dtype=weight.dtype, device=s.device)
    db = torch.empty_like(dg)
    if M == 0:
        return ds, dg.zero_(), db.zero_()
    vec = plan == "vector"
    vpl = _vpl(D) if vec else MAX_REGISTER_FEATURES // 32
    blocks = _blocks(1, codes, vpl, vec, ds_out is not None, M, s.device)
    part = torch.empty(2, blocks, D, dtype=torch.float32, device=s.device)
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        _entry("layernorm_residual_bwd")(
            codes[0], codes[2], vpl, int(vec), s.data_ptr(), dy.data_ptr(),
            ds_out.data_ptr() if ds_out is not None else None,
            mean.data_ptr(), rstd.data_ptr(), weight.data_ptr(),
            ds.data_ptr(), part.data_ptr(), dg.data_ptr(), db.data_ptr(), M,
            D, blocks, stream)
    layernorm_residual.backward_launches += 1
    return ds, dg, db


@torch.library.custom_op("paddle_tpu_torch::layernorm_residual_fwd",
                         mutates_args=())
def _forward_op(x2: torch.Tensor, r2: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor, epsilon: float
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """The forward as one operator that ``torch.export`` keeps whole:
    ``(s, y, mean, rstd)`` of ``[M, D]`` rows.  A CPU tensor takes
    :func:`_forward_ref`, a CUDA tensor launches the kernel
    (:func:`_forward_kernel`: the design, the alignment and the grid are
    chosen here, at run time, so one exported graph serves every M), a
    meta or fake tensor gets :func:`_forward_fake`'s shapes, anything else
    raises."""
    if x2.device.type == "cpu":
        return tuple(t.contiguous() for t in _forward_ref(
            x2, r2, weight, bias, epsilon))
    if x2.device.type == "cuda":
        return _forward_kernel(x2, r2, weight, bias, epsilon)
    raise InvalidArgumentError(
        f"layernorm_residual: tensors on {x2.device} (cpu or cuda only)")


@_forward_op.register_fake
def _forward_fake(x2, r2, weight, bias, epsilon):
    M, D = x2.shape
    return (x2.new_empty(M, D), x2.new_empty(M, D),
            x2.new_empty(M, dtype=torch.float32),
            x2.new_empty(M, dtype=torch.float32))


class _LayerNormResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, r2, weight, bias, epsilon):
        s, y, mean, rstd = _forward_op(x2, r2, weight, bias, epsilon)
        ctx.save_for_backward(s, mean, rstd, weight)
        ctx.set_materialize_grads(False)
        return s, y

    @staticmethod
    def backward(ctx, ds_out, dy):
        s, mean, rstd, weight = ctx.saved_tensors
        if dy is None:  # only the residual stream was used
            return ds_out, ds_out, None, None, None
        if s.device.type in _build.PLAIN_DEVICES:
            ds, dg, db = _backward_ref(s, mean, rstd, weight, ds_out, dy)
        else:
            ds, dg, db = _backward_kernel(s, mean, rstd, weight, ds_out, dy)
        return ds, ds, dg, db, None


def layernorm_residual(x, residual, weight, bias, *, epsilon: float = 1e-5):
    """``s = x + residual;  y = LayerNorm(s)·weight + bias`` in one pass.

    x/residual: ``[..., D]`` (same shape), weight/bias: ``[D]``.  Returns
    ``(s, y)`` in x's dtype.  Differentiable in x, residual, weight and
    bias: x and residual both get ``ds`` rounded to x's dtype (a float32
    residual gets that rounded value in float32, as JAX hands it), weight
    and bias their gradients in their own dtype.  CPU tensors take
    :func:`layernorm_residual_ref`'s arithmetic, forward and backward; CUDA
    tensors launch the kernel (x float32, bfloat16 or float16, residual and
    weight / bias each x's dtype or float32, contiguous, ``D <=
    MAX_WIDE_FEATURES``; the design picked by :func:`_forward_plan`) on the
    current stream and add one to ``layernorm_residual.launches``, and
    their backward launches the backward kernel (``D <=
    MAX_REGISTER_FEATURES``; :func:`_backward_plan`) and adds one to
    ``layernorm_residual.backward_launches``; anything else raises.
    """
    D = _check(x, residual, weight, bias)
    args = (x.reshape(-1, D), residual.reshape(-1, D), weight, bias,
            float(epsilon))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, residual, weight, bias)):
        s, y = _LayerNormResidual.apply(*args)
    else:  # inference (and torch.export): the operator alone
        s, y, _, _ = _forward_op(*args)
    return s.reshape(x.shape), y.reshape(x.shape)


#: forward kernel launches so far (CUDA tensors only; the CPU path never
#: counts)
layernorm_residual.launches = 0
#: backward kernel calls so far (each one call of the CUDA pass: its row and
#: column-sum launches together; neither the CPU path nor the plain
#: backward of rows wider than ``MAX_REGISTER_FEATURES`` counts)
layernorm_residual.backward_launches = 0
