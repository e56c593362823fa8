"""Flash attention, forward and backward — port of
``paddle_tpu/ops/flash_attention.py``.

Attention over ``[B, H, S, hd]`` q and ``[B, H, K, hd]`` k / v without the
``[S, K]`` score matrix in device memory, in both directions.  On the card
the forward is the hand-written CUDA kernel ``ops/csrc/flash_attention.cu``
(``sm_90a``, built with nvcc on first use, bound with ctypes) — in bf16
one block per (batch x head, 128-row q tile), k / v streamed by TMA
through a ring of shared-memory stages, both products on wgmma, the online
softmax in registers; in float32 64-row tiles on the CUDA cores — and the
backward is the two kernels of ``ops/csrc/flash_attention_bwd.cu``: dq (a
block owns a q tile and streams k / v) and dk / dv (a block owns a kv tile
and streams q / dO), each owning its output tile, so there are no atomics
and two runs give the same bits.  In bf16 both run on the forward's
machinery (``ops/csrc/hopper_sm90.cuh``: a TMA ring filled by a producer
warpgroup, every product on wgmma), except dk / dv at head_dim 256, which
stays on mma.sync.

Semantics (both paths), those of the JAX kernels: scores are float32, from
upcast q and k, times ``sm_scale`` (default ``1/sqrt(hd)``); keys at or
past K are masked and, causal, every pair with ``q_position_offset + row <
key``: any offset is exact, negative or not block-aligned (ring attention
passes chunks ahead of the diagonal); a row with no valid key gives out 0
and lse ``-inf``, and gradient 0; out is in q's dtype, lse float32 ``[B,
H, S]``; ragged S and K never fall back to O(S²) memory.  The backward is
the flash-2 recurrence from the saved lse and ``delta = rowsum(dO·O)``
(plain float32 ops, once per call): ``p = exp(s - lse)``, ``dv = pᵀ·dO``,
``ds = p·(dO·vᵀ - delta)·sm_scale``, ``dq = ds·k``, ``dk = dsᵀ·q``; dq in
q's dtype, dk / dv in k's.

:func:`flash_attention_fwd_lse_ref` / :func:`flash_attention_ref` /
:func:`flash_attention_bwd_ref` are the plain PyTorch versions
(``_naive_reference`` of the JAX module and its gradient, in q-row chunks,
so that the card can run them as a yardstick at S = 32768 without an
``[S, S]`` score tensor).  They are the CPU path; a CUDA tensor always
goes to the kernels, and what the kernels do not take raises.

The forward launch is the custom operator
``paddle_tpu_torch::flash_attention_fwd`` (``torch.library``): a graph
that ``torch.export`` traces keeps it whole (its fake implementation
gives only shapes and dtypes), and the operands' contiguity and 16-byte
alignment are settled inside it at run time.

:func:`flash_attention` is differentiable (a ``torch.autograd.Function``);
:func:`flash_attention_fwd_lse` is forward-only, as the JAX one is, and
:func:`flash_attention_bwd_chunk` is the backward of one (q, kv-chunk)
pair given the merged out / lse, for ring attention.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from ..framework.errors import InvalidArgumentError, UnimplementedError
from . import _build

__all__ = ["flash_attention", "flash_attention_ref", "flash_attention_fwd_lse",
           "flash_attention_fwd_lse_ref", "flash_attention_bwd_chunk",
           "flash_attention_bwd_ref", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv", "HEAD_DIMS"]

#: the head dims the kernels are built for (those the two gates admit)
HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: float32 score elements one chunk of the plain versions may hold (1 GiB)
_REF_CHUNK_ELEMS = 1 << 28
_P, _I = ctypes.c_void_p, ctypes.c_int
_TAIL = [_I] * 4 + [ctypes.c_longlong, _I, ctypes.c_float, _P]
#: C entry -> (source, argtypes: dtype, the pointers, then BH, S, K, hd,
#: q_off, causal, sm_scale, stream)
_ENTRIES = {
    "flash_attention_fwd": ("flash_attention", [_I] + [_P] * 5 + _TAIL),
    "flash_attention_bwd_dq": ("flash_attention_bwd",
                               [_I] + [_P] * 7 + _TAIL),
    "flash_attention_bwd_dkv": ("flash_attention_bwd",
                                [_I] + [_P] * 8 + _TAIL),
}
_fns = {}
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


def _delta(out, do):
    """``rowsum(dO·O)`` in float32 ``[B, H, S]`` (the JAX ``_flash_bwd``'s
    plain step, shared by both backward kernels)."""
    return (do.float() * out.float()).sum(-1)


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


def flash_attention_bwd_ref(q, k, v, out, lse, do, causal: bool = False,
                            sm_scale=None, q_position_offset: int = 0,
                            delta=None):
    """Plain PyTorch version of the flash backward — the VJP of
    :func:`flash_attention` and :func:`flash_attention_bwd_chunk` alike:
    returns ``(dq, dk, dv)`` for the cotangent ``do`` of ``out``, given
    the forward's (or, for a ring chunk, the merged) ``lse`` of q's rows.
    ``delta`` defaults to ``rowsum(do·out)``; ``out`` is read only for
    it.  Float32 throughout, q rows in chunks: dq per chunk, dk / dv
    summed over the chunks in order.  An lse of ``-inf`` counts as 0, so a
    row with no valid key has p = 0 and adds nothing.  dq comes out in q's
    dtype, dk and dv in k's."""
    _check(q, k, v)
    B, H, S, hd = q.shape
    K = k.shape[2]
    scale = _scale(q, sm_scale)
    off = int(q_position_offset)
    if delta is None:
        delta = _delta(out, do)
    lse = lse[:, :, :S].float()
    lse = torch.where(torch.isneginf(lse), torch.zeros_like(lse), lse)
    delta = delta[:, :, :S].float()
    kf, vf = k.float(), v.float()
    dq = torch.empty(B, H, S, hd, dtype=q.dtype, device=q.device)
    dk = torch.zeros(B, H, K, hd, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    step = max(1, min(S, _REF_CHUNK_ELEMS // max(1, B * H * K)))
    keys = torch.arange(K, device=q.device)
    for r0 in range(0, S, step):
        r1 = min(S, r0 + step)
        qc, doc = q[:, :, r0:r1].float(), do[:, :, r0:r1].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qc, kf) * scale
        if causal:
            pos = off + torch.arange(r0, r1, device=q.device)
            s = s.masked_fill(pos[:, None] < keys[None, :], -math.inf)
        p = s.sub_(lse[:, :, r0:r1, None]).exp_()
        ds = torch.einsum("bhqd,bhkd->bhqk", doc, vf)
        ds = ds.sub_(delta[:, :, r0:r1, None]).mul_(p).mul_(scale)
        dq[:, :, r0:r1] = torch.einsum("bhqk,bhkd->bhqd", ds,
                                       kf).to(q.dtype)
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, qc)
        dv += torch.einsum("bhqk,bhqd->bhkd", p, doc)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def _kernel_fn(symbol):
    with _fn_lock:
        fn = _fns.get(symbol)
        if fn is None:
            source, argtypes = _ENTRIES[symbol]
            fn = _fns[symbol] = _build.entry(source, symbol, argtypes)
        return fn


def _aligned(t):
    """``t`` contiguous with a 16-byte aligned start (the kernel's vector
    loads need it)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel_inputs(*ts):
    """The operands of a kernel launch (q, k, v and maybe do): on one card,
    a dtype and head_dim the kernels take, contiguous and aligned."""
    q = ts[0]
    for name, t in zip(("k", "v", "do"), ts[1:]):
        if t.device != q.device:
            raise InvalidArgumentError(
                f"flash_attention: {name} on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES:
        raise InvalidArgumentError(
            f"flash_attention: the kernels take float32 or bfloat16, got "
            f"{q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise InvalidArgumentError(
            f"flash_attention: the kernels take head_dim in {HEAD_DIMS}, "
            f"got {q.shape[-1]}")
    return tuple(_aligned(t) for t in ts)


def _launch(symbol, q, k, v, ptrs, causal, scale, off):
    if q.device.type != "cuda":
        raise InvalidArgumentError(
            f"{symbol}: the kernel takes CUDA tensors, got {q.device}")
    B, H, S, hd = q.shape
    fn = _kernel_fn(symbol)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
           *(t.data_ptr() for t in ptrs), B * H, S, k.shape[2], hd, off,
           int(bool(causal)), scale, stream)


def _forward_kernel(q, k, v, causal, scale, off):
    """Launch the forward kernel on aligned operands; same outputs as the
    plain version.  Adds one to ``flash_attention.launches``."""
    B, H, S, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    _launch("flash_attention_fwd", q, k, v, (out, lse), causal, scale, off)
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, sm_scale,
                           q_position_offset):
    """Launch the dq kernel (the JAX ``_bwd_dq``) on CUDA operands: q / do
    ``[B, H, S, hd]``, k / v ``[B, H, K, hd]`` (aligned and contiguous),
    lse / delta float32 ``[B, H, S]``.  Returns dq in q's dtype and adds
    one to ``flash_attention_bwd_dq.launches``.  The plain version is
    :func:`flash_attention_bwd_ref`."""
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    _launch("flash_attention_bwd_dq", q, k, v, (do, lse, delta, dq), causal,
            sm_scale, q_position_offset)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, sm_scale,
                            q_position_offset):
    """Launch the dk / dv kernel (the JAX ``_bwd_dkv``) on the operands
    :func:`flash_attention_bwd_dq` takes.  Returns ``(dk, dv)`` in k's
    dtype and adds one to ``flash_attention_bwd_dkv.launches``."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    _launch("flash_attention_bwd_dkv", q, k, v, (do, lse, delta, dk, dv),
            causal, sm_scale, q_position_offset)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def _backward(q, k, v, lse, do, delta, causal, scale, off):
    """``(dq, dk, dv)``: the plain version for CPU tensors, the two
    kernels for CUDA tensors."""
    S = q.shape[2]
    if q.device.type in _build.PLAIN_DEVICES:
        return flash_attention_bwd_ref(q, k, v, None, lse, do, causal,
                                       scale, off, delta)
    if q.device.type != "cuda":
        raise InvalidArgumentError(
            f"flash_attention: tensors on {q.device} (cpu or cuda only)")
    q, k, v, do = _kernel_inputs(q, k, v, do)
    lse, delta = (_aligned(t[:, :, :S].float()) for t in (lse, delta))
    for name, t in (("lse", lse), ("delta", delta)):
        if t.device != q.device:
            raise InvalidArgumentError(
                f"flash_attention: {name} on {t.device}, q on {q.device}")
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, scale, off)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal, scale,
                                     off)
    return dq, dk, dv


@torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd",
                         mutates_args=())
def _forward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, scale: float, offset: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward as one operator that ``torch.export`` keeps whole:
    ``(out, lse)``.  A CPU tensor takes :func:`flash_attention_fwd_lse_ref`,
    a CUDA tensor launches the kernel (the contiguous, 16-byte aligned
    operands are made here, at run time, so an exported graph holds no
    choice that depends on an address or a batch size), a meta or fake
    tensor gets :func:`_forward_fake`'s shapes, anything else raises."""
    if q.device.type == "cpu":
        return flash_attention_fwd_lse_ref(q, k, v, causal, scale, offset)
    if q.device.type == "cuda":
        q, k, v = _kernel_inputs(q, k, v)
        return _forward_kernel(q, k, v, causal, scale, offset)
    raise InvalidArgumentError(
        f"flash_attention: tensors on {q.device} (cpu or cuda only)")


@_forward_op.register_fake
def _forward_fake(q, k, v, causal, scale, offset):
    B, H, S, hd = q.shape
    return q.new_empty(B, H, S, hd), q.new_empty(B, H, S,
                                                 dtype=torch.float32)


def _forward(q, k, v, causal, scale, off):
    """``(out, lse)``: through :class:`_Flash` where autograd needs the
    backward, else the operator alone (inference, ``torch.export``)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Flash.apply(q, k, v, causal, scale, off)
    return _forward_op(q, k, v, causal, scale, off)


class _Flash(torch.autograd.Function):
    """The forward operator, with the two backward kernels as its VJP (the
    JAX ``_flash`` custom VJP).  No gradient reaches lse, the causal flag,
    the scale or the offset."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, off):
        out, lse = _forward_op(q, k, v, causal, scale, off)
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, off)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, off = ctx.args
        dq, dk, dv = _backward(q, k, v, lse, dout, _delta(out, dout),
                               causal, scale, off)
        return dq, dk, dv, None, None, None


_FWD_ONLY = ("flash_attention_fwd_lse is forward-only, as the JAX one is: "
             "differentiate flash_attention, or pass the merged out and lse "
             "to flash_attention_bwd_chunk")


def flash_attention_fwd_lse(q, k, v, causal: bool = False, sm_scale=None,
                            q_position_offset: int = 0, block_q=None,
                            block_k=None):
    """Forward-only run returning ``(out, lse)``: out ``[B, H, S, hd]`` in
    q's dtype, lse float32 ``[B, H, S]``.  ``block_q`` / ``block_k`` keep
    the JAX signature; they only schedule the TPU grid, and the card uses
    the kernel's own tiles (bf16: 128 q rows, 128 keys at head_dim 64, 64
    at 128 and 256; float32: 64 q rows, 64 keys, 32 at head_dim 256).

    CPU tensors take :func:`flash_attention_fwd_lse_ref`.  CUDA tensors
    (float32 or bfloat16, head_dim 64, 128 or 256) launch the kernel on the
    current stream and add one to ``flash_attention.launches``; anything
    else raises.  Not differentiable on its own (as in JAX): with grad
    enabled and an input that requires grad it raises
    ``UnimplementedError``; :func:`flash_attention_bwd_chunk` is its
    backward."""
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise UnimplementedError(_FWD_ONLY)
    return _forward_op(q, k, v, bool(causal), _scale(q, sm_scale),
                       int(q_position_offset))


def flash_attention_bwd_chunk(q, k, v, out, lse, do, causal: bool = False,
                              sm_scale=None, q_position_offset: int = 0,
                              block_q=None, block_k=None, delta=None):
    """One chunk's flash-2 backward given the GLOBAL (merged) ``out`` /
    ``lse`` of the local q rows: returns this (q, kv-chunk) pair's additive
    contributions ``(dq_partial, dk, dv)`` — exact, since with ``p =
    exp(s - lse_global)`` the backward is linear over kv chunks.  Pass the
    loop-invariant ``delta = rowsum(do·out)`` to compute it once per ring,
    not once per step (``out`` is then not read).  ``block_q`` / ``block_k``
    keep the JAX signature and change nothing.

    CPU tensors take :func:`flash_attention_bwd_ref`; CUDA tensors launch
    the dq and dk / dv kernels (one each, counted on
    ``flash_attention_bwd_dq`` / ``flash_attention_bwd_dkv``); anything
    else raises, as for :func:`flash_attention_fwd_lse`."""
    _check(q, k, v)
    B, H, S, _ = q.shape
    given = [do] + ([out] if delta is None else [])
    stats = [lse] + ([] if delta is None else [delta])
    if any(t.shape != q.shape for t in given) or any(
            t.dim() != 3 or tuple(t.shape[:2]) != (B, H) or t.shape[2] < S
            for t in stats):
        raise InvalidArgumentError(
            f"flash_attention_bwd_chunk: out / do "
            f"{[tuple(t.shape) for t in given]} and lse / delta "
            f"{[tuple(t.shape) for t in stats]} do not fit q "
            f"{tuple(q.shape)}")
    if delta is None:
        delta = _delta(out, do)
    return _backward(q, k, v, lse, do, delta, bool(causal),
                     _scale(q, sm_scale), int(q_position_offset))


def flash_attention(q, k, v, causal: bool = False, sm_scale=None,
                    block_q=None, block_k=None, q_position_offset: int = 0):
    """Memory-efficient attention: q ``[B, H, S, hd]``, k / v ``[B, H, K,
    hd]`` (S may differ from K); returns out ``[B, H, S, hd]`` in q's
    dtype.  ``q_position_offset`` is the global position of q's first
    row for the causal mask.  See :func:`flash_attention_fwd_lse` for
    devices, dtypes and blocks.  Differentiable in q, k and v: the
    backward runs :func:`flash_attention_bwd_ref` for CPU tensors and the
    dq and dk / dv kernels for CUDA tensors (one launch each)."""
    _check(q, k, v)
    return _forward(q, k, v, bool(causal), _scale(q, sm_scale),
                    int(q_position_offset))[0]


#: kernel launches so far (CUDA tensors only; the CPU path never counts)
flash_attention.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
