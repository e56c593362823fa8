"""Flash attention, forward — port of ``paddle_tpu/ops/flash_attention.py``.

Attention over ``[B, H, S, hd]`` q and ``[B, H, K, hd]`` k / v without the
``[S, K]`` score matrix in device memory: on the card that is the
hand-written CUDA kernel ``ops/csrc/flash_attention.cu`` (``sm_90a``, built
with nvcc on first use, bound with ctypes) — one block per (batch x head,
64-row q tile), k / v streamed through shared memory, the online softmax
in registers, tensor cores for bf16.

Semantics (both paths), those of the JAX kernel: scores are float32, from
upcast q and k, times ``sm_scale`` (default ``1/sqrt(hd)``); keys at or
past K are masked and, causal, every pair with ``q_position_offset + row <
key``: any offset is exact, negative or not block-aligned (ring attention
passes chunks ahead of the diagonal); a row with no valid key gives out 0
and lse ``-inf``; out is in q's dtype, lse float32 ``[B, H, S]``; ragged S
and K never fall back to O(S²) memory.

:func:`flash_attention_fwd_lse_ref` / :func:`flash_attention_ref` are the
plain PyTorch versions (``_naive_reference`` of the JAX module, in q-row
chunks, so that the card can run them as a yardstick at S = 32768 without
an ``[S, S]`` score tensor).  They are the CPU path; a CUDA tensor always
goes to the kernel, and what the kernel does not take raises.

The backward kernels (the JAX ``_bwd_dq`` / ``_bwd_dkv``) are not ported
yet: the forward is a ``torch.autograd.Function``, and calling it with
grad enabled on an input that requires grad raises
``UnimplementedError`` (ROADMAP queue A, long-context attention) — as the
JAX ``flash_attention_fwd_lse`` is forward-only.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from ..framework.errors import InvalidArgumentError, UnimplementedError
from . import _build

__all__ = ["flash_attention", "flash_attention_ref", "flash_attention_fwd_lse",
           "flash_attention_fwd_lse_ref", "HEAD_DIMS"]

#: the head dims the kernel is built for (those the two gates admit)
HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: float32 score elements one chunk of the plain version may hold (1 GiB)
_REF_CHUNK_ELEMS = 1 << 28
_fn = None
_fn_lock = threading.Lock()


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise InvalidArgumentError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} must be [B, H, S, hd] / [B, H, K, hd]")
    if (q.shape[0], q.shape[1], q.shape[3]) != (k.shape[0], k.shape[1],
                                                k.shape[3]):
        raise InvalidArgumentError(
            f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} "
            f"differ in batch, heads or head_dim")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise InvalidArgumentError(
            f"flash_attention: q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype} "
            f"differ")


def _scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else float(
        sm_scale)


def flash_attention_fwd_lse_ref(q, k, v, causal: bool = False,
                                sm_scale=None, q_position_offset: int = 0,
                                block_q=None, block_k=None):
    """Plain PyTorch version of :func:`flash_attention_fwd_lse` (same
    signature and semantics): float32 scores of q-row chunks against all
    keys, the causal mask by ``q_position_offset + row >= key``, zeros and
    ``-inf`` for rows with no valid key.  ``block_q`` / ``block_k`` are
    accepted and do not change the result."""
    _check(q, k, v)
    B, H, S, hd = q.shape
    K = k.shape[2]
    scale = _scale(q, sm_scale)
    off = int(q_position_offset)
    kf, vf = k.float(), v.float()
    out = torch.empty(B, H, S, hd, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    step = max(1, min(S, _REF_CHUNK_ELEMS // max(1, B * H * K)))
    keys = torch.arange(K, device=q.device)
    for r0 in range(0, S, step):
        r1 = min(S, r0 + step)
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, r0:r1].float(),
                         kf) * scale
        if causal:
            pos = off + torch.arange(r0, r1, device=q.device)
            s = s.masked_fill(pos[:, None] < keys[None, :], -math.inf)
        m = s.amax(-1, keepdim=True)
        dead = torch.isneginf(m)
        p = torch.exp(s - torch.where(dead, torch.zeros_like(m), m))
        l = p.sum(-1, keepdim=True)
        o = torch.einsum("bhqk,bhkd->bhqd", p, vf)
        out[:, :, r0:r1] = torch.where(dead, torch.zeros_like(o),
                                       o / l).to(q.dtype)
        lse[:, :, r0:r1] = torch.where(dead, m, m + torch.log(l))[..., 0]
    return out, lse


def flash_attention_ref(q, k, v, causal: bool = False, sm_scale=None,
                        block_q=None, block_k=None,
                        q_position_offset: int = 0):
    """Plain PyTorch version of :func:`flash_attention`."""
    return flash_attention_fwd_lse_ref(q, k, v, causal, sm_scale,
                                       q_position_offset)[0]


def _kernel_fn():
    global _fn
    with _fn_lock:
        if _fn is None:
            _fn = _build.entry("flash_attention", "flash_attention_fwd",
                               [ctypes.c_int] + [ctypes.c_void_p] * 5
                               + [ctypes.c_int] * 4
                               + [ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_float, ctypes.c_void_p])
        return _fn


def _aligned(t):
    """``t`` contiguous with a 16-byte aligned start (the kernel's vector
    loads need it)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward_kernel(q, k, v, causal, scale, off):
    """Launch the CUDA kernel; same outputs as the plain version.  Adds one
    to ``flash_attention.launches``."""
    B, H, S, hd = q.shape
    K = k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise InvalidArgumentError(
                f"flash_attention: {name} on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES:
        raise InvalidArgumentError(
            f"flash_attention: the kernel takes float32 or bfloat16, got "
            f"{q.dtype}")
    if hd not in HEAD_DIMS:
        raise InvalidArgumentError(
            f"flash_attention: the kernel takes head_dim in {HEAD_DIMS}, "
            f"got {hd}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
           out.data_ptr(), lse.data_ptr(), B * H, S, K, hd, off,
           int(bool(causal)), scale, stream)
    flash_attention.launches += 1
    return out, lse


class _FlashForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, off):
        if q.device.type == "cpu":
            out, lse = flash_attention_fwd_lse_ref(q, k, v, causal, scale,
                                                   off)
        elif q.device.type == "cuda":
            out, lse = _forward_kernel(q, k, v, causal, scale, off)
        else:
            raise InvalidArgumentError(
                f"flash_attention: tensors on {q.device} (cpu or cuda only)")
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        raise UnimplementedError(_NO_GRAD)


_NO_GRAD = ("flash_attention: the backward kernels (dq, dk/dv) are not "
            "ported yet (ROADMAP queue A, long-context attention); run the "
            "forward under torch.no_grad() or on inputs that need no "
            "gradient")


def flash_attention_fwd_lse(q, k, v, causal: bool = False, sm_scale=None,
                            q_position_offset: int = 0, block_q=None,
                            block_k=None):
    """Forward-only run returning ``(out, lse)``: out ``[B, H, S, hd]`` in
    q's dtype, lse float32 ``[B, H, S]``.  ``block_q`` / ``block_k`` keep
    the JAX signature; they only schedule the TPU grid, and the card uses
    the kernel's own tile (64 q rows, 64 keys; 32 at head_dim 256).

    CPU tensors take :func:`flash_attention_fwd_lse_ref`.  CUDA tensors
    (float32 or bfloat16, head_dim 64, 128 or 256) launch the kernel on the
    current stream and add one to ``flash_attention.launches``; anything
    else raises.  With grad enabled and an input that requires grad it
    raises ``UnimplementedError``: the backward kernels are not ported."""
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise UnimplementedError(_NO_GRAD)
    return _FlashForward.apply(q, k, v, bool(causal), _scale(q, sm_scale),
                               int(q_position_offset))


def flash_attention(q, k, v, causal: bool = False, sm_scale=None,
                    block_q=None, block_k=None, q_position_offset: int = 0):
    """Memory-efficient attention: q ``[B, H, S, hd]``, k / v ``[B, H, K,
    hd]`` (S may differ from K); returns out ``[B, H, S, hd]`` in q's
    dtype.  ``q_position_offset`` is the global position of q's first
    row for the causal mask.  See :func:`flash_attention_fwd_lse` for
    devices, dtypes, blocks and gradients."""
    return flash_attention_fwd_lse(q, k, v, causal, sm_scale,
                                   q_position_offset, block_q, block_k)[0]


#: kernel launches so far (CUDA tensors only; the CPU path never counts)
flash_attention.launches = 0
