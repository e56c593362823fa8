"""Grouped matmul over ragged per-expert row groups — port of
``paddle_tpu/ops/grouped_matmul.py``.

The MoE expert FFN (:mod:`paddle_tpu_torch.moe`) is E independent
matmuls whose row counts the router decides at run time: expert ``e``
owns the first ``group_sizes[e]`` rows of its ``[C, D]`` capacity bucket
and the rest is padding.  :func:`grouped_matmul` computes

    y = einsum("ecd,edf->ecf", x * rowmask, w)

in one launch, with every row at or past ``group_sizes[e]`` exactly 0 —
downstream combine sums can trust the padding without re-masking.  The
product is float32 from upcast operands; the result is in ``x``'s dtype.

On the card the forward is a hand-written CUDA kernel of
``ops/csrc/grouped_matmul.cu`` (``sm_90a``, built with nvcc on first use,
bound with ctypes), chosen by :func:`_use_wgmma` from the shape, up
front: bf16 with D and F multiples of 8 and 16-byte-aligned x and w (what
TMA needs; every MoE shape the port runs) takes the Hopper design
(``grouped_matmul_wgmma``): one persistent block per SM walks the tiles
that hold valid rows (counted from ``group_sizes`` on the device), a
producer warpgroup keeps a TMA ring full and two consumer warpgroups run
wgmma; tiles wholly past their group cost only a zero store.  Everything
else — float32 (FMAs on the CUDA cores) and bf16 off that grid
(mma.sync) — takes the first design (``grouped_matmul``): one block per
(output tile, expert), a tile wholly past the group storing zeros.  No
split-K across blocks and no atomics in either, so two runs give the same
bits.  :func:`grouped_matmul_ref` is the plain
PyTorch version of the same function — the CPU path and the yardstick the
kernel is held to on the card; the public op takes it only for tensors
that lie on the CPU.  A CUDA tensor always goes to the kernel: a build or
launch failure raises.

The backward is the JAX package's closed-form VJP in plain PyTorch (two
masked products; the TPU kernel has no backward kernel either)::

    dx = (dy @ wᵀ) * rowmask        dw = (x * rowmask)ᵀ @ dy

``group_sizes`` gets no gradient.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from ..framework.errors import InvalidArgumentError
from . import _build

__all__ = ["grouped_matmul", "grouped_matmul_ref"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None
_wgmma_fn = None
_fn_lock = threading.Lock()


def _use_wgmma(dtype, D: int, F: int, aligned: bool) -> bool:
    """Does a call take the Hopper design?  bf16 with D and F multiples of
    8 (D >= 8: TMA's 16-byte row strides) and 16-byte-aligned x, w and y
    (``aligned``); everything else takes the first design."""
    return (dtype == torch.bfloat16 and aligned and D >= 8 and D % 8 == 0
            and F % 8 == 0)


def _check(x, w, group_sizes):
    """The JAX op's argument checks; returns ``(E, C, D, F)``."""
    if x.dim() != 3 or w.dim() != 3:
        raise InvalidArgumentError(
            f"grouped_matmul: x {tuple(x.shape)} / w {tuple(w.shape)} must "
            f"be rank 3")
    E, C, D = x.shape
    if w.shape[0] != E or w.shape[1] != D:
        raise InvalidArgumentError(
            f"grouped_matmul: w {tuple(w.shape)} does not match x "
            f"{tuple(x.shape)} (want [E={E}, D={D}, F])")
    if tuple(group_sizes.shape) != (E,):
        raise InvalidArgumentError(
            f"grouped_matmul: group_sizes {tuple(group_sizes.shape)} != "
            f"({E},)")
    if (group_sizes.is_floating_point() or group_sizes.is_complex()
            or group_sizes.dtype == torch.bool):
        raise InvalidArgumentError(
            f"grouped_matmul: group_sizes dtype {group_sizes.dtype} is not "
            f"integer")
    return E, C, D, w.shape[2]


def _rowmask(group_sizes, C, device):
    """``[E, C, 1]`` bool — True for the valid rows of each group."""
    rows = torch.arange(C, device=device)[None, :]
    return (rows < group_sizes.to(device)[:, None])[..., None]


def _forward_ref(x, w, group_sizes):
    y = torch.matmul(x.float(), w.float())
    # a where, not a multiply: NaN / Inf in padding rows still gives 0
    y = torch.where(_rowmask(group_sizes, x.shape[1], y.device), y,
                    torch.zeros((), dtype=y.dtype, device=y.device))
    return y.to(x.dtype)


def grouped_matmul_ref(x, w, group_sizes, *, block_m: Optional[int] = None,
                       block_n: Optional[int] = None):
    """Plain PyTorch version of :func:`grouped_matmul` (same signature and
    semantics, not differentiable through ``group_sizes``) on any
    device."""
    _check(x, w, group_sizes)
    return _forward_ref(x, w, group_sizes)


def _kernel_fn():
    """The first design's C entry (see :func:`_build.entry`)."""
    global _fn
    with _fn_lock:
        if _fn is None:
            _fn = _build.entry("grouped_matmul", "grouped_matmul",
                               [ctypes.c_int] + [ctypes.c_void_p] * 4
                               + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        return _fn


def _wgmma_kernel_fn():
    """The Hopper design's C entry (bf16)."""
    global _wgmma_fn
    with _fn_lock:
        if _wgmma_fn is None:
            _wgmma_fn = _build.entry("grouped_matmul", "grouped_matmul_wgmma",
                                     [ctypes.c_void_p] * 4
                                     + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        return _wgmma_fn


def _forward_kernel(x, w, group_sizes):
    """Launch the CUDA kernel; same result as :func:`_forward_ref`.  Adds
    one to ``grouped_matmul.launches``."""
    E, C, D, F = _check(x, w, group_sizes)
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise InvalidArgumentError(
            f"grouped_matmul: the kernel takes float32 or bfloat16 x and w "
            f"of one dtype, got {x.dtype} / {w.dtype}")
    for name, t in (("w", w), ("group_sizes", group_sizes)):
        if t.device != x.device:
            raise InvalidArgumentError(
                f"grouped_matmul: {name} on {t.device}, x on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise InvalidArgumentError(
            "grouped_matmul: x and w must be contiguous")
    if max(C, D, F) >= 2 ** 31 or E > 65535 or -(-C // 16) > 65535:
        raise InvalidArgumentError(
            f"grouped_matmul: [{E}, {C}, {D}] @ [{E}, {D}, {F}] exceeds the "
            f"kernel's 32-bit dimensions or its grid")
    y = torch.empty(E, C, F, dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    # int32 on the device: a host round trip would sync the step
    gs = group_sizes.to(torch.int32).contiguous()
    wgmma = _use_wgmma(x.dtype, D, F, all(t.data_ptr() % 16 == 0
                                          for t in (x, w, y)))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if wgmma:
            _wgmma_kernel_fn()(x.data_ptr(), w.data_ptr(), gs.data_ptr(),
                               y.data_ptr(), E, C, D, F, stream)
        else:
            _kernel_fn()(_DTYPES[x.dtype], x.data_ptr(), w.data_ptr(),
                         gs.data_ptr(), y.data_ptr(), E, C, D, F, stream)
    grouped_matmul.launches += 1
    return y


class _GroupedMatmul(torch.autograd.Function):
    """The kernel (card) or its plain version (CPU) forward; JAX's
    ``_gmm_bwd`` backward in plain PyTorch, with its dtype casts."""

    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w, group_sizes)
        if x.device.type in _build.PLAIN_DEVICES:
            return _forward_ref(x, w, group_sizes)
        return _forward_kernel(x, w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        mask = _rowmask(group_sizes, x.shape[1], dy.device).to(dy.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dt = torch.promote_types(dy.dtype, w.dtype)
            dx = (torch.matmul(dy.to(dt), w.to(dt).transpose(1, 2))
                  * mask.to(dt)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            xm = x * mask.to(x.dtype)
            dt = torch.promote_types(x.dtype, dy.dtype)
            dw = torch.matmul(xm.to(dt).transpose(1, 2),
                              dy.to(dt)).to(w.dtype)
        return dx, dw, None


def grouped_matmul(x, w, group_sizes, *, block_m: Optional[int] = None,
                   block_n: Optional[int] = None):
    """Per-expert matmul over ragged row groups in one kernel launch.

    ``x`` ``[E, C, D]`` capacity-bucketed rows (expert-major), ``w``
    ``[E, D, F]`` stacked expert weights, ``group_sizes`` ``[E]`` integer
    valid-row counts.  Returns ``[E, C, F]`` in ``x``'s dtype, equal to
    ``einsum("ecd,edf->ecf", x * rowmask, w)`` — rows at or beyond
    ``group_sizes[e]`` are exactly zero.  Differentiable in ``x`` and
    ``w``; ``group_sizes`` gets no gradient.  ``block_m`` / ``block_n``
    are kept only so that callers written for the JAX op (whose tiles
    the autotuner picks) run unchanged; they are ignored, and no caller
    in the port passes them: the kernels' tiles are fixed by dtype and
    shape (:func:`_use_wgmma`).

    CPU tensors take :func:`grouped_matmul_ref`'s arithmetic.  CUDA
    tensors launch the kernel on the current stream (it does not
    synchronise) and add one to ``grouped_matmul.launches``; what the
    kernel does not take (dtype, device) raises instead of falling back.
    """
    _check(x, w, group_sizes)
    if x.device.type not in _build.PLAIN_DEVICES + ("cuda",):
        raise InvalidArgumentError(
            f"grouped_matmul: tensors on {x.device} (cpu or cuda only)")
    return _GroupedMatmul.apply(x.contiguous(), w.contiguous(), group_sizes)


#: kernel launches so far (CUDA tensors only; the CPU path never counts)
grouped_matmul.launches = 0
