"""Paged flash-decode attention — the page-table walk inside the kernel.

Port of ``paddle_tpu/ops/paged_attention.py``.  The paged serving path
(``GPTModel.forward_paged``) scatters each step's K/V into a shared page
pool ``[P+1, H, page, hd]`` and then attends, for every slot, over the
pages its table row ``[G]`` names.  On the card that is the hand-written
CUDA kernel ``ops/csrc/paged_attention.cu`` (``sm_90a``, built with nvcc
on first use, bound with ctypes): each page streams from the pool into
shared memory once, with an online softmax across pages, so the gathered
``[B, H, G*page, hd]`` view is never materialized.

:func:`paged_flash_decode_ref` is the plain PyTorch version of the same
function — gather, masked softmax in f32, zeros for fully-masked rows.  It
is the CPU path and the yardstick the kernel is held to on the card; the
wrapper takes it only for tensors that lie on the CPU.  A CUDA tensor
always goes to the kernel: a build or launch failure raises.

Semantics (identical on both paths): scores ``(q·k)/sqrt(hd)``; masked
keys filled with ``-1e30``; ``p = exp(s - max)·mask``; ``out = acc / l``
where ``l > 0`` else 0.  Unmapped table entries must be pre-clipped to a
valid page (their mask is 0).  Float pools only: int8/fp8 pools with
scale planes are not ported yet.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from ..framework.errors import InvalidArgumentError, UnimplementedError
from . import _build

__all__ = ["paged_flash_decode", "paged_flash_decode_ref"]

_NEG = -1e30  # mask fill; exp(_NEG - m) underflows to exactly 0.0 in f32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROWS_PER_BLOCK = 16          # query rows per block, as in the .cu source
_MAX_SMEM = 232448            # bytes of shared memory one block may use
_fn = None
_fn_lock = threading.Lock()


def _check(q, k_pool, v_pool, tables, mask):
    if q.dim() != 4 or k_pool.dim() != 4:
        raise InvalidArgumentError(
            f"paged_flash_decode: q {tuple(q.shape)} / pool "
            f"{tuple(k_pool.shape)} must be rank 4")
    B, H, T, hd = q.shape
    _, Hk, page, hdk = k_pool.shape
    G = tables.shape[1] if tables.dim() == 2 else -1
    if (Hk, hdk) != (H, hd) or v_pool.shape != k_pool.shape:
        raise InvalidArgumentError(
            f"paged_flash_decode: pool {tuple(k_pool.shape)}/"
            f"{tuple(v_pool.shape)} vs q {tuple(q.shape)}")
    if tables.shape != (B, G):
        raise InvalidArgumentError(
            f"paged_flash_decode: tables {tuple(tables.shape)} != [B={B}, G]")
    if mask.shape != (B, T, G * page):
        raise InvalidArgumentError(
            f"paged_flash_decode: mask {tuple(mask.shape)} != "
            f"{(B, T, G * page)}")
    if k_pool.dtype in (torch.int8, torch.float8_e4m3fn):
        raise UnimplementedError(
            "paged_flash_decode: quantized (int8/fp8) KV pools are not "
            "ported yet (ROADMAP queue A, quantized serving)")
    return B, H, T, hd, page, G


def paged_flash_decode_ref(q, k_pool, v_pool, tables, mask):
    """Plain PyTorch version: gather each slot's ``[H, G*page, hd]`` view
    through ``tables``, masked softmax in f32 with the kernel's ``-1e30``
    fill and ``·mask`` form, zeros for fully-masked rows.  Same signature
    and semantics as :func:`paged_flash_decode`; returns q's dtype."""
    B, H, T, hd, page, G = _check(q, k_pool, v_pool, tables, mask)
    tab = tables.long().clamp_min(0)
    k = k_pool[tab].float().permute(0, 2, 1, 3, 4).reshape(B, H, G * page, hd)
    v = v_pool[tab].float().permute(0, 2, 1, 3, 4).reshape(B, H, G * page, hd)
    m = mask.bool()[:, None]                                 # [B,1,T,C]
    s = torch.einsum("bhtd,bhcd->bhtc", q.float(), k) * (1.0 / math.sqrt(hd))
    s = s.masked_fill(~m, _NEG)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * m
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhtc,bhcd->bhtd", p, v)
    out = torch.where(l > 0, acc / l.clamp_min(1e-30), torch.zeros_like(acc))
    return out.to(q.dtype)


def _kernel_fn():
    """The C entry of the built library (see :func:`_build.entry`)."""
    global _fn
    with _fn_lock:
        if _fn is None:
            _fn = _build.entry("paged_attention", "paged_flash_decode",
                               [ctypes.c_int] + [ctypes.c_void_p] * 6
                               + [ctypes.c_int] * 7
                               + [ctypes.c_float, ctypes.c_void_p])
        return _fn


def paged_flash_decode(q, k_pool, v_pool, tables, mask):
    """Flash decode over a paged KV pool, page walk in-kernel.

    q: ``[B, H, T, hd]`` query block (T = 1, the speculative ``1+k``
    verify width, or the prompt bucket at admission); k_pool/v_pool:
    ``[P+1, H, page, hd]`` pools (f32 or bf16, q's dtype), ALREADY
    scattered with this step's K/V; tables: ``[B, G]`` int32 with unmapped
    entries pre-clipped to a valid page; mask: ``[B, T, G*page]`` bool.
    Returns the attention context ``[B, H, T, hd]`` in q's dtype.

    CPU tensors take :func:`paged_flash_decode_ref`.  CUDA tensors launch
    the kernel on the current stream (it does not synchronise) and add one
    to ``paged_flash_decode.launches``; anything the kernel does not take
    (dtype, layout, device) raises instead of falling back.
    """
    if q.device.type == "cpu":
        return paged_flash_decode_ref(q, k_pool, v_pool, tables, mask)
    B, H, T, hd, page, G = _check(q, k_pool, v_pool, tables, mask)
    if q.device.type != "cuda":
        raise InvalidArgumentError(
            f"paged_flash_decode: tensors on {q.device} (cpu or cuda only)")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("mask", mask)):
        if t.device != q.device:
            raise InvalidArgumentError(
                f"paged_flash_decode: {name} on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("mask", mask)):
        if not t.is_contiguous():
            raise InvalidArgumentError(
                f"paged_flash_decode: {name} must be contiguous")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise InvalidArgumentError(
            f"paged_flash_decode: q/k_pool/v_pool must share one of "
            f"float32/bfloat16, got {q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if tables.dtype != torch.int32:
        raise InvalidArgumentError(
            f"paged_flash_decode: tables must be int32, got {tables.dtype}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise InvalidArgumentError(
            f"paged_flash_decode: mask must be bool, got {mask.dtype}")
    smem = (2 * page * (hd + 1) + _ROWS_PER_BLOCK * hd) * 4
    if hd > 256 or smem > _MAX_SMEM:
        raise InvalidArgumentError(
            f"paged_flash_decode: head_dim {hd} / page {page} exceed the "
            f"kernel's limits (hd <= 256, {smem} > {_MAX_SMEM} smem bytes)")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        fn(_DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
           v_pool.data_ptr(), tables.data_ptr(),
           mask.view(torch.uint8).data_ptr(), out.data_ptr(),
           B, H, T, hd, page, G, k_pool.shape[0], 1.0 / math.sqrt(hd),
           stream)
    paged_flash_decode.launches += 1
    return out


#: kernel launches so far (CUDA tensors only; the CPU path never counts)
paged_flash_decode.launches = 0
