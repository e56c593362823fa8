"""Quantized linear for the serving path — int8 / fp8-e4m3 weights.

Port of ``paddle_tpu/ops/quantized_matmul.py``.  The quantized serving
stack (``GPTConfig.quantization`` / ``GenerationEngine(quantized=...)``)
stores parallel-linear weights as int8 or float8_e4m3fn plus a
per-output-channel float32 dequant multiplier (``weight_scale``, see
``slim.quantize_weights``).  This module is the compute half: activations
are quantized on the fly (per-tensor abs-max), the matmul runs on the
low-precision operands and ONE fused epilogue applies the combined
``weight_scale * act_scale`` rescale plus the bias::

    int8:  acc = x_q @ w_q   (int8 x int8 -> int32, exact)
    fp8:   acc = x_q @ w_q   (e4m3 operands, float32 accumulate)
    out    = acc * (weight_scale * act_scale) + bias

On the card the product and the epilogue are the hand-written CUDA kernel
``ops/csrc/quantized_matmul.cu`` (``sm_90a``, built with nvcc on first
use, bound with ctypes): mma.sync tensor-core products for both branches,
a 4-stage cp.async ring of 128-deep K tiles, and at small M a split over K
across a thread-block cluster whose partial sums are added in a fixed
order (so two runs give the same bits in fp8 too) — the custom operator
``paddle_tpu_torch::quantized_matmul`` (``torch.library``), which a
``torch.export`` graph keeps whole; the activation quantization, the scale folding
and the cast back to ``x.dtype`` stay PyTorch ops, as they sit outside
the kernel in the JAX package too.  :func:`quantized_linear_ref` is the
plain PyTorch version of the same function — the CPU path and the
yardstick the kernel is held to on the card; the wrapper takes it only
for tensors that lie on the CPU.  A CUDA tensor always goes to the kernel:
a build or launch failure raises.  Inference only: no gradient is defined.

The quantization expressions keep the JAX package's order of operations
letter for letter (``x * (127 / amax)``, ``amax`` floored at 1e-9, round
half to even, fp8 clipped to +-448 BEFORE the cast), so both packages
produce the same codes and scales from the same input.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..framework.errors import InvalidArgumentError
from . import _build

__all__ = ["quantized_matmul", "fp8_matmul", "quantized_linear",
           "quantized_linear_ref", "quantize_activations",
           "quantized_product"]

#: largest finite float8_e4m3fn (no inf in e4m3fn — clip before casting)
FP8_MAX = 448.0
_MODES = {torch.int8: "int8", torch.float8_e4m3fn: "fp8"}
_DTYPES = {torch.int8: 0, torch.float8_e4m3fn: 1}
_fn = None
_fn_lock = threading.Lock()


def quantize_activations(x, mode: str):
    """Dynamic per-tensor activation quantization: float ``[..., K]`` →
    (quantized x, 0-dim float32 dequant multiplier on x's device)."""
    if mode not in ("int8", "fp8"):
        raise InvalidArgumentError(
            f"quantization mode must be 'int8' or 'fp8', got {mode!r}")
    xf = x.float()
    amax = xf.abs().max().clamp_min(1e-9)
    # tensor / tensor is an IEEE division on both devices; ``127.0 / amax``
    # would be ``amax.reciprocal() * 127`` and ``amax / 127.0`` a multiply
    # by 1/127 on the card, each an ulp off the JAX package's quotient
    top = torch.full_like(amax, 127.0 if mode == "int8" else FP8_MAX)
    if mode == "int8":
        xq = torch.clamp(torch.round(xf * (top / amax)),
                         -127, 127).to(torch.int8)
    else:
        xq = torch.clamp(xf * (top / amax),
                         -FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
    return xq, amax / top


def _check_qmm(xq, wq, scale, bias):
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[0]:
        raise InvalidArgumentError(
            f"quantized_linear: xq {tuple(xq.shape)} @ wq "
            f"{tuple(wq.shape)} is not [M, K] @ [K, N]")
    if wq.dtype not in _DTYPES or xq.dtype != wq.dtype:
        raise InvalidArgumentError(
            f"quantized_linear: operands must share int8 or float8_e4m3fn, "
            f"got {xq.dtype}/{wq.dtype}")
    N = wq.shape[1]
    for name, t in (("scale", scale), ("bias", bias)):
        if tuple(t.shape) != (N,) or t.dtype != torch.float32:
            raise InvalidArgumentError(
                f"quantized_linear: {name} must be float32 [{N}], got "
                f"{t.dtype} {tuple(t.shape)}")
    return xq.shape[0], xq.shape[1], N


def _matmul_ref(xq, wq, scale, bias):
    """Plain version of the kernel: ``[M, K]q @ [K, N]q`` with the
    dequant + bias epilogue, float32 ``[M, N]``.  The int8 product is
    accumulated exactly on either device (float64 holds every partial
    sum of K <= 2^38 products of 8-bit codes; CUDA has no integer
    matmul) and rounded once to float32, as the kernel's int32
    accumulator is; the epilogue multiplies, then adds, in float32."""
    _check_qmm(xq, wq, scale, bias)
    if xq.dtype == torch.int8:
        acc = torch.matmul(xq.double(), wq.double()).float()
    else:
        acc = torch.matmul(xq.float(), wq.float())
    return acc * scale[None, :] + bias[None, :]


def _kernel_fn():
    """The C entry of the built library (see :func:`_build.entry`)."""
    global _fn
    with _fn_lock:
        if _fn is None:
            _fn = _build.entry("quantized_matmul", "quantized_matmul",
                               [ctypes.c_int] + [ctypes.c_void_p] * 5
                               + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        return _fn


def _matmul_kernel(xq, wq, scale, bias):
    """Launch the CUDA kernel; same result as :func:`_matmul_ref`.  Adds
    one to ``quantized_linear.launches``."""
    M, K, N = _check_qmm(xq, wq, scale, bias)
    for name, t in (("wq", wq), ("scale", scale), ("bias", bias)):
        if t.device != xq.device:
            raise InvalidArgumentError(
                f"quantized_linear: {name} on {t.device}, xq on {xq.device}")
    for name, t in (("xq", xq), ("wq", wq), ("scale", scale),
                    ("bias", bias)):
        if not t.is_contiguous():
            raise InvalidArgumentError(
                f"quantized_linear: {name} must be contiguous")
    if max(M, K, N) >= 2 ** 31:
        raise InvalidArgumentError(
            f"quantized_linear: [{M}, {K}] @ [{K}, {N}] exceeds the "
            f"kernel's 32-bit dimensions")
    out = torch.empty(M, N, dtype=torch.float32, device=xq.device)
    if M == 0 or N == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        fn(_DTYPES[wq.dtype], xq.data_ptr(), wq.data_ptr(), scale.data_ptr(),
           bias.data_ptr(), out.data_ptr(), M, K, N, stream)
    quantized_linear.launches += 1
    return out


@torch.library.custom_op("paddle_tpu_torch::quantized_matmul",
                         mutates_args=())
def _matmul_op(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """The kernel's function as one operator that ``torch.export`` keeps
    whole: float32 ``[M, N]``.  A CPU tensor takes :func:`_matmul_ref`, a
    CUDA tensor launches the kernel (:func:`_matmul_kernel`; its split over
    K by M is chosen inside the launch, so one exported graph serves every
    M), a meta or fake tensor gets :func:`_matmul_fake`'s shape, anything
    else raises."""
    if xq.device.type == "cpu":
        return _matmul_ref(xq, wq, scale, bias)
    if xq.device.type == "cuda":
        return _matmul_kernel(xq, wq, scale, bias)
    raise InvalidArgumentError(
        f"quantized_linear: tensors on {xq.device} (cpu or cuda only)")


@_matmul_op.register_fake
def _matmul_fake(xq, wq, scale, bias):
    return xq.new_empty(xq.shape[0], wq.shape[1], dtype=torch.float32)


def _linear(matmul, x, w_q, weight_scale, bias):
    mode = _MODES.get(getattr(w_q, "dtype", None))
    if mode is None:
        raise InvalidArgumentError(
            f"quantized_linear: weight dtype "
            f"{getattr(w_q, 'dtype', type(w_q))} is not int8 or "
            f"float8_e4m3fn")
    if weight_scale is None:
        raise InvalidArgumentError(
            "quantized_linear: quantized weights need a weight_scale "
            "(per-output-channel float32 dequant multiplier)")
    K, N = w_q.shape
    lead = x.shape[:-1]
    out_dtype = x.dtype if x.is_floating_point() else torch.float32
    if x.numel() == 0:
        return torch.zeros(*lead, N, dtype=out_dtype, device=x.device)
    xq, act_scale = quantize_activations(x, mode)
    combined = weight_scale.float().reshape(-1) * act_scale
    b = (torch.zeros(N, dtype=torch.float32, device=x.device)
         if bias is None else bias.float().reshape(-1))
    out2 = matmul(xq.reshape(-1, K), w_q, combined, b)
    return out2.reshape(*lead, N).to(out_dtype)


def quantized_linear_ref(x, w_q, weight_scale, bias=None):
    """Plain PyTorch version of :func:`quantized_linear` (same signature
    and semantics) on any device."""
    return _linear(_matmul_ref, x, w_q, weight_scale, bias)


def quantized_linear(x, w_q, weight_scale, bias=None):
    """The serving Linear hot path: float activations x pre-quantized
    weights, dispatched on the weight dtype.

    ``x`` float ``[..., K]``; ``w_q`` int8 or float8_e4m3fn ``[K, N]``;
    ``weight_scale`` float32 ``[N]`` per-channel dequant multiplier
    (``w ≈ w_q * weight_scale``, the ``slim.quantize_weights``
    convention); optional ``bias`` ``[N]``.  Activations are quantized on
    the fly per-tensor; the output returns in ``x.dtype``.

    CPU tensors take :func:`quantized_linear_ref`'s arithmetic.  CUDA
    tensors launch the kernel on the current stream (it does not
    synchronise) and add one to ``quantized_linear.launches``; anything
    the kernel does not take (dtype, layout, device) raises instead of
    falling back.
    """
    return _linear(_matmul_op, x, w_q, weight_scale, bias)


#: kernel launches so far (CUDA tensors only; the CPU path never counts)
quantized_linear.launches = 0


def quantized_product(xq, wq, scale, bias):
    """The kernel's own function on codes the caller quantized (slim's
    ``Int8Linear`` / ``Int8Conv2D``, which quantize activations by a
    calibrated scale): ``[M, K] @ [K, N]`` int8 (or float8_e4m3fn) codes,
    then ``acc * scale + bias`` in float32 (``scale`` / ``bias`` float32
    ``[N]``).  CPU tensors take the plain version; CUDA tensors launch the
    kernel (counted in ``quantized_linear.launches``) or raise."""
    return _matmul_op(xq, wq, scale, bias)


def quantized_matmul(x, w_q, weight_scale, bias=None):
    """int8 leg of :func:`quantized_linear` (validates the dtype)."""
    if getattr(w_q, "dtype", None) != torch.int8:
        raise InvalidArgumentError(
            f"quantized_matmul: weight dtype "
            f"{getattr(w_q, 'dtype', type(w_q))} is not int8")
    return quantized_linear(x, w_q, weight_scale, bias)


def fp8_matmul(x, w_q, weight_scale, bias=None):
    """fp8-e4m3 leg of :func:`quantized_linear` (validates the dtype)."""
    if getattr(w_q, "dtype", None) != torch.float8_e4m3fn:
        raise InvalidArgumentError(
            f"fp8_matmul: weight dtype "
            f"{getattr(w_q, 'dtype', type(w_q))} is not float8_e4m3fn")
    return quantized_linear(x, w_q, weight_scale, bias)
