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
valid page (their mask is 0).  Quantized pools (int8 / float8_e4m3fn)
come with ``k_scale`` / ``v_scale`` ``[P+1, H, page]`` float32 planes, one
dequant multiplier per stored token per head: a page's rows are multiplied
by them as the page is read (``k_f32 = k_q * k_scale``), in the kernel
while the page is staged in shared memory, so a float K/V view never
exists in device memory; q stays float32 or bfloat16.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from ..framework.errors import InvalidArgumentError
from . import _build

__all__ = ["paged_flash_decode", "paged_flash_decode_ref",
           "paged_flash_eligible", "MAX_HEAD_DIM"]

_NEG = -1e30  # mask fill; exp(_NEG - m) underflows to exactly 0.0 in f32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_QUANT_DTYPES = {torch.int8: 2, torch.float8_e4m3fn: 3}  # pool-only codes
_ROWS_PER_BLOCK = 16          # query rows per block, as in the .cu source
_MAX_SMEM = 232448            # bytes of shared memory one block may use
#: the widest head the kernel holds in registers (32 lanes x 16 values)
MAX_HEAD_DIM = 512
_fn = None
_fn_lock = threading.Lock()


def paged_flash_eligible(head_dim: int, page_size: int) -> bool:
    """Should ``forward_paged`` take :func:`paged_flash_decode`?  The
    JAX gate's shape test (``paddle_tpu/ops/paged_attention.py``
    ``paged_flash_eligible``): head_dim and page size multiples of 8.
    Off it, ``forward_paged`` takes the gather-then-attend path, as the
    JAX package does."""
    return head_dim % 8 == 0 and page_size % 8 == 0


def _page_chunk(page: int, hd: int) -> int:
    """Rows of a page the kernel stages in shared memory at once: the
    whole page when its K and V fit beside the q tile, else the most rows
    that do, rounded down to a multiple of 32 (one key a lane)."""
    rows = (_MAX_SMEM // 4 - _ROWS_PER_BLOCK * hd) // (2 * (hd + 1))
    return page if page <= rows else max(32, rows // 32 * 32)


def _check(q, k_pool, v_pool, tables, mask, k_scale, v_scale):
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
    if (k_scale is None) != (v_scale is None):
        raise InvalidArgumentError(
            "paged_flash_decode: pass k_scale and v_scale together "
            "(or neither)")
    if v_pool.dtype != k_pool.dtype:
        raise InvalidArgumentError(
            f"paged_flash_decode: pools differ in dtype "
            f"({k_pool.dtype}/{v_pool.dtype})")
    if (k_pool.dtype in _QUANT_DTYPES) != (k_scale is not None):
        raise InvalidArgumentError(
            f"paged_flash_decode: a quantized (int8/float8_e4m3fn) pool "
            f"needs k_scale and v_scale, a float pool takes none (pool "
            f"{k_pool.dtype}, scales "
            f"{'given' if k_scale is not None else 'missing'})")
    if k_scale is not None:
        want = tuple(k_pool.shape[:3])
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(t.shape) != want or t.dtype != torch.float32:
                raise InvalidArgumentError(
                    f"paged_flash_decode: {name} must be float32 "
                    f"[P+1, H, page] = {want}, got {t.dtype} "
                    f"{tuple(t.shape)}")
    return B, H, T, hd, page, G


def paged_flash_decode_ref(q, k_pool, v_pool, tables, mask,
                           k_scale=None, v_scale=None):
    """Plain PyTorch version: gather each slot's ``[H, G*page, hd]`` view
    through ``tables`` (a quantized pool's rows times their gathered
    scales), masked softmax in f32 with the kernel's ``-1e30`` fill and
    ``·mask`` form, zeros for fully-masked rows.  Same signature and
    semantics as :func:`paged_flash_decode`; returns q's dtype."""
    B, H, T, hd, page, G = _check(q, k_pool, v_pool, tables, mask,
                                  k_scale, v_scale)
    tab = tables.long().clamp_min(0)

    def view(pool, scale):
        x = pool[tab].float()                                # [B,G,H,page,hd]
        if scale is not None:
            x = x * scale[tab][..., None]
        return x.permute(0, 2, 1, 3, 4).reshape(B, H, G * page, hd)

    k, v = view(k_pool, k_scale), view(v_pool, v_scale)
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
                               [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                               + [ctypes.c_int] * 8
                               + [ctypes.c_float, ctypes.c_void_p])
        return _fn


def paged_flash_decode(q, k_pool, v_pool, tables, mask,
                       k_scale=None, v_scale=None):
    """Flash decode over a paged KV pool, page walk in-kernel.

    q: ``[B, H, T, hd]`` query block (T = 1, the speculative ``1+k``
    verify width, or the prompt bucket at admission); k_pool/v_pool:
    ``[P+1, H, page, hd]`` pools (q's float dtype, or int8 /
    float8_e4m3fn under a float32 or bfloat16 q), ALREADY scattered with
    this step's K/V; tables: ``[B, G]`` int32 with unmapped entries
    pre-clipped to a valid page; mask: ``[B, T, G*page]`` bool;
    k_scale/v_scale: ``[P+1, H, page]`` float32 dequant multipliers of a
    quantized pool (both for a quantized pool, neither for a float one).
    Returns the attention context ``[B, H, T, hd]`` in q's dtype.

    CPU tensors take :func:`paged_flash_decode_ref`.  CUDA tensors launch
    the kernel on the current stream (it does not synchronise) and add one
    to ``paged_flash_decode.launches``; anything the kernel does not take
    (dtype, layout, device, head_dim > ``MAX_HEAD_DIM``) raises instead of
    falling back.  Any page size is taken: a page too large for shared
    memory is staged in row chunks.
    """
    if q.device.type == "cpu":
        return paged_flash_decode_ref(q, k_pool, v_pool, tables, mask,
                                      k_scale, v_scale)
    B, H, T, hd, page, G = _check(q, k_pool, v_pool, tables, mask,
                                  k_scale, v_scale)
    if q.device.type != "cuda":
        raise InvalidArgumentError(
            f"paged_flash_decode: tensors on {q.device} (cpu or cuda only)")
    named = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
             ("tables", tables), ("mask", mask)]
    if k_scale is not None:
        named += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in named:
        if t.device != q.device:
            raise InvalidArgumentError(
                f"paged_flash_decode: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise InvalidArgumentError(
                f"paged_flash_decode: {name} must be contiguous")
    pool_code = _QUANT_DTYPES.get(k_pool.dtype, _DTYPES.get(k_pool.dtype))
    if q.dtype not in _DTYPES or (k_scale is None
                                  and k_pool.dtype != q.dtype):
        raise InvalidArgumentError(
            f"paged_flash_decode: q must be float32 or bfloat16 and the "
            f"pools q's dtype, int8 or float8_e4m3fn, got "
            f"{q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if tables.dtype != torch.int32:
        raise InvalidArgumentError(
            f"paged_flash_decode: tables must be int32, got {tables.dtype}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise InvalidArgumentError(
            f"paged_flash_decode: mask must be bool, got {mask.dtype}")
    if hd > MAX_HEAD_DIM:
        raise InvalidArgumentError(
            f"paged_flash_decode: head_dim {hd} exceeds the kernel's "
            f"{MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        fn(_DTYPES[q.dtype], pool_code, q.data_ptr(), k_pool.data_ptr(),
           v_pool.data_ptr(),
           None if k_scale is None else k_scale.data_ptr(),
           None if v_scale is None else v_scale.data_ptr(),
           tables.data_ptr(), mask.view(torch.uint8).data_ptr(),
           out.data_ptr(),
           B, H, T, hd, page, _page_chunk(page, hd), G, k_pool.shape[0],
           1.0 / math.sqrt(hd), stream)
    paged_flash_decode.launches += 1
    return out


#: kernel launches so far (CUDA tensors only; the CPU path never counts)
paged_flash_decode.launches = 0
