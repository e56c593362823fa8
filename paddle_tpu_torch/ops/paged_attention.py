"""Paged flash-decode attention — the page-table walk inside the kernel.

Port of ``paddle_tpu/ops/paged_attention.py``.  The paged serving path
(``GPTModel.forward_paged``) scatters each step's K/V into a shared page
pool ``[P+1, H, page, hd]`` and then attends, for every slot, over the
pages its table row ``[G]`` names.  On the card that is the hand-written
CUDA source ``ops/csrc/paged_attention.cu`` (``sm_90a``, built with nvcc
on first use, bound with ctypes), which never materializes the gathered
``[B, H, G*page, hd]`` view.  It holds two designs, and :func:`_plan`
picks one by shape, up front:

* the split design (``paged_flash_decode_split``) for head_dim a multiple
  of 16 up to 256, a page a multiple of 16 and 16-byte-aligned tensors
  whose ring fits in shared memory (every serving engine's shapes): a
  cluster of up to 8 blocks shares each (slot, head, row tile); each block
  lists the pages some row of the tile can see (from the mask alone),
  takes a contiguous share of that list, streams it through an
  asynchronous ring (TMA bulk copies on mbarriers) into four consumer
  warps, and the partial softmax states are merged in a fixed order
  through the cluster's shared memory;
* the first design (``paged_flash_decode``) for every other shape — a
  page too large for shared memory (staged in row chunks), head_dim
  257-512, a page or head_dim off the 16 grid: one block per (slot,
  head, 16-row tile) walks all G table entries, a page at a time.

:func:`paged_flash_decode_ref` is the plain PyTorch version of the same
function — gather, masked softmax in f32, zeros for fully-masked rows.  It
is the CPU path and the yardstick the kernel is held to on the card; the
wrapper takes it only for tensors that lie on the CPU.  A CUDA tensor
always goes to a kernel: a build or launch failure raises.
:func:`paged_flash_decode_split_ref` is the split design's arithmetic in
plain PyTorch (per-share partials, merged in order), for the tests.

Semantics (identical on every path): scores ``(q·k)/sqrt(hd)``; masked
keys filled with ``-1e30``; ``p = exp(s - max)·mask``; ``out = acc / l``
where ``l > 0`` else 0.  Unmapped table entries must be pre-clipped to a
valid page (their mask is 0).  Quantized pools (int8 / float8_e4m3fn)
come with ``k_scale`` / ``v_scale`` ``[P+1, H, page]`` float32 planes, one
dequant multiplier per stored token per head: a page's rows are multiplied
by them as the page is read (``k_f32 = k_q * k_scale``), in the kernel's
registers or shared memory, so a float K/V view never exists in device
memory; q stays float32 or bfloat16.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from ..framework.errors import InvalidArgumentError
from . import _build

__all__ = ["paged_flash_decode", "paged_flash_decode_ref",
           "paged_flash_decode_split_ref", "paged_flash_eligible",
           "MAX_HEAD_DIM"]

_NEG = -1e30  # mask fill; exp(_NEG - m) underflows to exactly 0.0 in f32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_QUANT_DTYPES = {torch.int8: 2, torch.float8_e4m3fn: 3}  # pool-only codes
_ROWS_PER_BLOCK = 16          # query rows per block, as in the .cu source
_MAX_SMEM = 232448            # bytes of shared memory one block may use
#: the widest head the kernel holds in registers (32 lanes x 16 values)
MAX_HEAD_DIM = 512
# the split design, as in the .cu source
_SPLIT_MAX = 8                # blocks a cluster: the portable cluster size
_SPLIT_WARPS = 4              # consumer warps a block
_SPLIT_STAGES = 4             # the ring's depth
_SPLIT_MAX_HD = 256
_SPLIT_GRID = 16              # head_dim and page multiples of this
_BLOCKS_PER_SM = 5            # the most blocks a split puts on an SM
_fn = None
_split_fn = None
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


def _split_smem(rows: int, hd: int, page: int, G: int, kv_size: int) -> int:
    """Bytes of shared memory a split-design block takes (the .cu
    source's ``SplitSmem``)."""
    stage = 2 * page * hd * kv_size + (2 * page * 4 if kv_size == 1 else 0)
    q = _SPLIT_STAGES * (stage + 16) + 16
    bits = q + rows * hd * 4 + (_SPLIT_WARPS + 1) * rows * (hd + 2) * 4
    tab = bits + ((rows * G * page // _SPLIT_GRID * 2 + 15) & ~15)
    return tab + 2 * G * 4


def _tile_rows(T: int, hd: int) -> int:
    """Query rows a split-design block serves: one at decode, 8 for the
    1 + k verify step (and any tile at head_dim > 128, where 16 rows of
    accumulators would not fit in registers), 16 for prompt buckets."""
    if T == 1:
        return 1
    return 8 if T <= 8 or hd > 128 else 16


def _plan(B: int, H: int, T: int, hd: int, page: int, G: int,
          kv_size: int, sms: int, aligned: bool = True):
    """Which design serves a call, decided by shape before any launch.

    Returns ``("split", split, rows)`` when head_dim is a multiple of 16
    up to 256, the page a multiple of 16, every tensor 16-byte aligned
    (``aligned``: TMA's bulk copies and the mask's 16-byte loads) and the
    ring of 4 pages fits in shared memory beside the tile.  The cluster
    then takes ``split`` blocks: the largest power of two up to 8 that
    keeps B x H x row tiles x split within
    ``_BLOCKS_PER_SM`` blocks an SM (at least 1, at most G).  On an H100
    (132 SMs) at serving's B 8, H 12 that is 4 for decode, verify and the
    16-row bucket and 2 for the 48-row one, the fastest of 1-8 in
    ``tools/torch_kernel_ab.py paged_attention``.  Else ``("first",
    chunk)``: the first design, ``chunk`` page rows staged at once
    (:func:`_page_chunk`).  ``kv_size``: bytes of a pool element."""
    if (aligned and hd % _SPLIT_GRID == 0 and hd <= _SPLIT_MAX_HD
            and page % _SPLIT_GRID == 0):
        rows = _tile_rows(T, hd)
        if _split_smem(rows, hd, page, G, kv_size) <= _MAX_SMEM:
            base = B * H * -(-T // rows)
            split = _SPLIT_MAX
            while split > 1 and base * split > _BLOCKS_PER_SM * sms:
                split //= 2
            return ("split", min(split, G), rows)
    return ("first", _page_chunk(page, hd))


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


def _partial(q, k, v, valid, sm_scale):
    """Softmax state ``(m, l, acc)`` of q ``[H, R, hd]`` over keys
    ``[H, n, hd]`` with mask ``[R, n]``: m the largest valid score
    (``-1e30`` where there is none), l and acc relative to it."""
    H, R, hd = q.shape
    if k.shape[1] == 0:
        return (q.new_full((H, R), _NEG), q.new_zeros(H, R),
                q.new_zeros(H, R, hd))
    s = torch.einsum("hrd,hnd->hrn", q, k) * sm_scale
    s = s.masked_fill(~valid[None], _NEG)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None]) * valid[None]
    return m, p.sum(-1), torch.einsum("hrn,hnd->hrd", p, v)


def _merge(parts):
    """Partials merged in list order: ``M = max m_i``, ``l = sum l_i
    e^(m_i - M)``, ``acc`` likewise."""
    M = parts[0][0]
    for m, _, _ in parts[1:]:
        M = torch.maximum(M, m)
    l = torch.zeros_like(parts[0][1])
    acc = torch.zeros_like(parts[0][2])
    for m, li, ai in parts:
        scale = torch.exp(m - M)
        l = l + li * scale
        acc = acc + ai * scale[..., None]
    return M, l, acc


def paged_flash_decode_split_ref(q, k_pool, v_pool, tables, mask,
                                 k_scale=None, v_scale=None, *, split: int,
                                 rows: Optional[int] = None):
    """The split design's arithmetic in plain PyTorch: for each slot and
    tile of ``rows`` query rows (default :func:`_tile_rows`), the list of
    pages some row of the tile can see (the mask alone decides), cut into
    ``split`` contiguous shares; in a share, warp w's pages w, w + 4, ...
    give a partial ``(m, l, acc)``; the warps' partials are merged in warp
    order, the shares' in share order, and ``out = l > 0 ? acc / l : 0``.
    Same arguments and result as :func:`paged_flash_decode_ref` (up to the
    order of float32 sums); a loop over slots, for tests."""
    B, H, T, hd, page, G = _check(q, k_pool, v_pool, tables, mask,
                                  k_scale, v_scale)
    rows = rows or _tile_rows(T, hd)
    tab = tables.long().clamp(0, k_pool.shape[0] - 1)
    sm_scale = 1.0 / math.sqrt(hd)

    def keys(pool, scale, b, pages):
        idx = tab[b, pages]                                  # [n_pages]
        x = pool[idx].float()                                # [n,H,page,hd]
        if scale is not None:
            x = x * scale[idx][..., None]
        return x.permute(1, 0, 2, 3).reshape(H, len(pages) * page, hd)

    m4 = mask.bool().reshape(B, T, G, page)
    out = torch.zeros(B, H, T, hd)
    for b in range(B):
        for t0 in range(0, T, rows):
            tr = slice(t0, min(T, t0 + rows))
            seen = m4[b, tr].any(dim=2).any(dim=0)           # [G]
            pages = torch.nonzero(seen).flatten().tolist()
            n, shares = len(pages), []
            for r in range(split):
                share = pages[r * n // split:(r + 1) * n // split]
                warps = []
                for w in range(_SPLIT_WARPS):
                    mine = share[w::_SPLIT_WARPS]
                    valid = m4[b, tr][:, mine].reshape(tr.stop - t0, -1)
                    warps.append(_partial(
                        q[b, :, tr].float(), keys(k_pool, k_scale, b, mine),
                        keys(v_pool, v_scale, b, mine), valid, sm_scale))
                shares.append(_merge(warps))
            _, l, acc = _merge(shares)
            out[b, :, tr] = torch.where(l[..., None] > 0,
                                        acc / l.clamp_min(1e-30)[..., None],
                                        torch.zeros_like(acc))
    return out.to(q.dtype)


def _kernel_fn():
    """The first design's C entry (see :func:`_build.entry`)."""
    global _fn
    with _fn_lock:
        if _fn is None:
            _fn = _build.entry("paged_attention", "paged_flash_decode",
                               [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                               + [ctypes.c_int] * 8
                               + [ctypes.c_float, ctypes.c_void_p])
        return _fn


def _split_kernel_fn():
    """The split design's C entry."""
    global _split_fn
    with _fn_lock:
        if _split_fn is None:
            _split_fn = _build.entry(
                "paged_attention", "paged_flash_decode_split",
                [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                + [ctypes.c_int] * 7
                + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        return _split_fn


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
    one kernel on the current stream (it does not synchronise) and add one
    to ``paged_flash_decode.launches``; :func:`_plan` picks the design by
    shape before the launch (the split design at serving's shapes, the
    first design elsewhere).  Anything the kernels do not take (dtype,
    layout, device, head_dim > ``MAX_HEAD_DIM``) raises instead of falling
    back.  Any page size is taken: a page too large for shared memory goes
    to the first design, staged in row chunks.
    """
    if q.device.type in _build.PLAIN_DEVICES:
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
    ptrs = [t.data_ptr() for _, t in named if t is not tables] \
        + [out.data_ptr()]
    plan = _plan(B, H, T, hd, page, G, k_pool.element_size(),
                 _build.sm_count(q.device), all(p % 16 == 0 for p in ptrs))
    args = (_DTYPES[q.dtype], pool_code, q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(),
            None if k_scale is None else k_scale.data_ptr(),
            None if v_scale is None else v_scale.data_ptr(),
            tables.data_ptr(), mask.view(torch.uint8).data_ptr(),
            out.data_ptr(), B, H, T, hd, page)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if plan[0] == "split":
            _split_kernel_fn()(*args, G, k_pool.shape[0],
                               1.0 / math.sqrt(hd), *plan[1:], stream)
        else:
            _kernel_fn()(*args, plan[1], G, k_pool.shape[0],
                         1.0 / math.sqrt(hd), stream)
    paged_flash_decode.launches += 1
    return out


#: kernel launches so far (CUDA tensors only; the CPU path never counts)
paged_flash_decode.launches = 0
