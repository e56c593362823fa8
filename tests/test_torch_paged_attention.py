"""Port of the paged flash-decode kernel (paddle_tpu_torch/ops).

The port's plain version ``paged_flash_decode_ref`` — the CPU path and the
card-side yardstick of the CUDA kernel — is held against the JAX package's
``paged_flash_decode``, whose Pallas kernel runs in interpret mode on the
CPU exactly as tests/test_paged_attention.py runs it.  Inputs are numpy
arrays from a seed.  Quantized pools (int8 / fp8-e4m3 codes with
``[P+1, H, page]`` float32 scale planes) go through both the same way.
The split design's arithmetic in plain PyTorch
(``paged_flash_decode_split_ref``) is held against both for 1, 2, 3 and 8
shares, and the wrapper's choice of design and split is a decision table.
The CUDA kernels themselves are compared with the plain version only where
a card is present (``gpu`` marker).
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.paged_attention import (
    paged_flash_decode as jax_paged_flash_decode)
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.models.gpt import _quantize_kv
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops.paged_attention import (
    paged_flash_decode, paged_flash_decode_ref, paged_flash_decode_split_ref)

# rtol/atol 1e-5: both sides accumulate in f32; the Pallas kernel's online
# softmax reassociates across pages, the plain version does not
RTOL = ATOL = 1e-5


def _geometry(rng, B=3, H=4, hd=16, page=16, G=4, T=1, dtype=np.float32):
    """A ragged paged layout (copied from tests/test_paged_attention.py):
    slot b holds ``lengths[b]`` tokens across its first ceil(len/page)
    table entries; the rest are unmapped (-1)."""
    P = B * G  # enough physical pages for a 1:1 mapping + 1 drop page
    k_pool = rng.randn(P + 1, H, page, hd).astype(dtype)
    v_pool = rng.randn(P + 1, H, page, hd).astype(dtype)
    lengths = [G * page - 1 - 3 * b for b in range(B)]  # ragged, >= T
    tables = np.full((B, G), -1, np.int32)
    nxt = 0
    for b in range(B):
        for g in range(-(-lengths[b] // page)):
            tables[b, g] = nxt
            nxt += 1
    q = rng.randn(B, H, T, hd).astype(np.float32)
    kp = np.arange(G * page)
    mask = np.zeros((B, T, G * page), bool)
    for b in range(B):
        mapped = np.repeat(tables[b] >= 0, page)
        for t in range(T):
            mask[b, t] = mapped & (kp <= lengths[b] - T + t)
    return q, k_pool, v_pool, tables, mask


def _jax(q, kp, vp, tab, mask):
    return np.asarray(jax_paged_flash_decode(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.maximum(jnp.asarray(tab), 0), jnp.asarray(mask)), np.float32)


def _torch(fn, q, kp, vp, tab, mask):
    out = fn(torch.from_numpy(q), torch.from_numpy(kp),
             torch.from_numpy(vp), torch.from_numpy(np.maximum(tab, 0)),
             torch.from_numpy(mask))
    return out.float().numpy()


@pytest.mark.parametrize("T", [1, 5, 8])  # decode, 1 + k (k=4), a prefill
def test_plain_matches_jax_pallas_kernel(T):
    rng = np.random.RandomState(10 + T)
    q, kp, vp, tab, mask = _geometry(rng, T=T)
    mask[1, 0, :] = False  # a fully-masked query row (padding)
    tab[2, -1] = -1        # an unmapped entry (clipped to page 0, masked)
    mask[2, :, -16:] = False
    want = _jax(q, kp, vp, tab, mask)
    got = _torch(paged_flash_decode_ref, q, kp, vp, tab, mask)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[1, :, 0], 0.0)
    np.testing.assert_array_equal(want[1, :, 0], 0.0)


def test_plain_matches_jax_bf16():
    rng = np.random.RandomState(5)
    q, kp, vp, tab, mask = _geometry(rng, T=2)
    qb, kb, vb = (torch.from_numpy(a).bfloat16() for a in (q, kp, vp))
    got = paged_flash_decode_ref(qb, kb, vb,
                                 torch.from_numpy(np.maximum(tab, 0)),
                                 torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_paged_flash_decode(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), jnp.maximum(jnp.asarray(tab), 0),
        jnp.asarray(mask)), np.float32)
    # both round their output to bf16 (8 mantissa bits)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


def test_drop_page_and_unmapped_pages_never_contribute():
    rng = np.random.RandomState(3)
    q, kp, vp, tab, mask = _geometry(rng)
    out0 = _torch(paged_flash_decode_ref, q, kp, vp, tab, mask)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[-1] = vp2[-1] = 1e4  # the write-drop page
    used = set(tab[tab >= 0].ravel())
    for p in range(kp.shape[0] - 1):
        if p not in used:
            kp2[p] = vp2[p] = -1e4
    out1 = _torch(paged_flash_decode_ref, q, kp2, vp2, tab, mask)
    np.testing.assert_array_equal(out0, out1)


def test_cpu_tensors_take_the_plain_version_uncounted():
    rng = np.random.RandomState(4)
    q, kp, vp, tab, mask = _geometry(rng, T=3)
    before = paged_flash_decode.launches
    got = _torch(paged_flash_decode, q, kp, vp, tab, mask)
    want = _torch(paged_flash_decode_ref, q, kp, vp, tab, mask)
    np.testing.assert_array_equal(got, want)
    assert paged_flash_decode.launches == before


def test_rejects_bad_shapes_and_quantized_pools():
    rng = np.random.RandomState(6)
    q, kp, vp, tab, mask = _geometry(rng, T=2)
    tq, tk, tv, tt, tm = (torch.from_numpy(a) for a in
                          (q, kp, vp, np.maximum(tab, 0), mask))
    with pytest.raises(InvalidArgumentError):
        paged_flash_decode(tq, tk, tv, tt, tm[:, :1])
    with pytest.raises(InvalidArgumentError):
        paged_flash_decode(tq, tk, tv[:, :2], tt, tm)
    # a quantized pool needs both scale planes, f32, [P+1, H, page] ...
    k8, v8 = tk.to(torch.int8), tv.to(torch.int8)
    sc = torch.ones(tk.shape[:3])
    with pytest.raises(InvalidArgumentError, match="needs k_scale"):
        paged_flash_decode(tq, k8, v8, tt, tm)
    with pytest.raises(InvalidArgumentError, match="together"):
        paged_flash_decode(tq, k8, v8, tt, tm, sc)
    with pytest.raises(InvalidArgumentError, match="float32"):
        paged_flash_decode(tq, k8, v8, tt, tm, sc, sc.double())
    with pytest.raises(InvalidArgumentError, match="float32"):
        paged_flash_decode(tq, k8, v8, tt, tm, sc[:, :, :4], sc)
    with pytest.raises(InvalidArgumentError, match="differ in dtype"):
        paged_flash_decode(tq, k8, tv, tt, tm, sc, sc)
    # ... and a float pool takes none
    with pytest.raises(InvalidArgumentError, match="takes none"):
        paged_flash_decode(tq, tk, tv, tt, tm, sc, sc)
    assert paged_flash_decode(tq, k8, v8, tt, tm, sc, sc).shape == tq.shape


def _quantized_pools(kp, vp, qdt):
    """Quantize float pools as ``forward_paged`` writes them: one scale
    per stored token per head.  Returns torch (k, v, k_scale, v_scale)."""
    P1, H, page, hd = kp.shape
    out = []
    for pool in (kp, vp):
        rows = torch.from_numpy(pool).permute(0, 2, 1, 3).reshape(-1, H, hd)
        codes, sc = _quantize_kv(rows, qdt)  # [P1*page, H, hd], [P1*page, H]
        out.append((codes.reshape(P1, page, H, hd).permute(0, 2, 1, 3)
                    .contiguous(),
                    sc.reshape(P1, page, H).permute(0, 2, 1).contiguous()))
    (k, ks), (v, vs) = out
    return k, v, ks, vs


def _to_jax_codes(t):
    if t.dtype == torch.int8:
        return jnp.asarray(t.numpy())
    return jnp.asarray(t.view(torch.uint8).numpy().view(jnp.float8_e4m3fn))


@pytest.mark.parametrize("qdt", [torch.int8, torch.float8_e4m3fn],
                         ids=["int8", "fp8"])
@pytest.mark.parametrize("T", [1, 5])
def test_plain_matches_jax_pallas_kernel_quantized(T, qdt):
    rng = np.random.RandomState(30 + T)
    q, kp, vp, tab, mask = _geometry(rng, T=T)
    mask[1, 0, :] = False
    k, v, ks, vs = _quantized_pools(kp, vp, qdt)
    want = np.asarray(jax_paged_flash_decode(
        jnp.asarray(q), _to_jax_codes(k), _to_jax_codes(v),
        jnp.maximum(jnp.asarray(tab), 0), jnp.asarray(mask),
        jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy())), np.float32)
    args = (torch.from_numpy(q), k, v, torch.from_numpy(np.maximum(tab, 0)),
            torch.from_numpy(mask), ks, vs)
    got = paged_flash_decode_ref(*args).numpy()
    # atol 2e-5: dequantized rows are f32 products on both sides; the
    # Pallas online softmax reassociates across pages
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
    np.testing.assert_array_equal(got[1, :, 0], 0.0)
    # the dequantized pool is the quantization-noise neighbour of the
    # float one, and the CPU wrapper takes the plain version uncounted
    dense = _torch(paged_flash_decode_ref, q, kp, vp, tab, mask)
    assert np.abs(got - dense).max() < (0.05 if qdt == torch.int8 else 0.2)
    before = paged_flash_decode.launches
    np.testing.assert_array_equal(paged_flash_decode(*args).numpy(), got)
    assert paged_flash_decode.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 5, 48])
def test_kernel_matches_plain_on_card(dtype, T):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.RandomState(20 + T)
    q, kp, vp, tab, mask = _geometry(rng, B=8, H=12, hd=64, page=16, G=64,
                                     T=T)
    mask[1, 0, :] = False
    dt = getattr(torch, dtype)
    args = [torch.from_numpy(a).cuda() for a in
            (q, kp, vp, np.maximum(tab, 0), mask)]
    args[:3] = [a.to(dt) for a in args[:3]]
    before = paged_flash_decode.launches
    out = paged_flash_decode(*args)
    ref = paged_flash_decode_ref(*args)
    torch.cuda.synchronize()
    assert paged_flash_decode.launches == before + 1
    tol = (dict(rtol=1e-4, atol=2e-5) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    torch.testing.assert_close(out, ref, **tol)
    assert torch.all(out[1, :, 0] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("qdt", ["int8", "float8_e4m3fn"])
@pytest.mark.parametrize("qtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 5, 16, 48])
def test_kernel_matches_plain_on_card_quantized(T, qtype, qdt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.RandomState(40 + T)
    q, kp, vp, tab, mask = _geometry(rng, B=8, H=12, hd=64, page=16, G=64,
                                     T=T)
    mask[1, 0, :] = False
    k, v, ks, vs = _quantized_pools(kp, vp, getattr(torch, qdt))
    args = [torch.from_numpy(q).cuda().to(getattr(torch, qtype)), k.cuda(),
            v.cuda(), torch.from_numpy(np.maximum(tab, 0)).cuda(),
            torch.from_numpy(mask).cuda(), ks.cuda(), vs.cuda()]
    before = paged_flash_decode.launches
    out = paged_flash_decode(*args)
    ref = paged_flash_decode_ref(*args)
    torch.cuda.synchronize()
    assert paged_flash_decode.launches == before + 1
    tol = (dict(rtol=1e-4, atol=2e-5) if qtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    torch.testing.assert_close(out, ref, **tol)
    assert torch.all(out[1, :, 0] == 0)


# -- the split design ---------------------------------------------------------
# Its arithmetic in plain PyTorch (paged_flash_decode_split_ref: per-share
# partials, merged in a fixed order) against the plain version and the
# Pallas kernel in interpret mode.  The layout: ragged slots, an unmapped
# table entry, a query row masked everywhere (slot 1, row 0), and a short
# slot (slot 2, 2 valid pages of G = 7) whose shares past the second hold
# no valid key when the walk is split 3 or 8 ways.
def _split_layout(T, seed):
    rng = np.random.RandomState(seed)
    q, kp, vp, tab, mask = _geometry(rng, B=3, H=2, hd=16, page=16, G=7,
                                     T=T)
    mask[1, 0, :] = False
    tab[2, 2:] = -1
    mask[2, :, 2 * 16:] = False
    return q, kp, vp, tab, mask


@functools.lru_cache(maxsize=None)
def _split_case(pool, T):
    """(torch args, the JAX kernel's output) for one pool kind and T."""
    q, kp, vp, tab, mask = _split_layout(T, 70 + T)
    tt = (torch.from_numpy(q), torch.from_numpy(np.maximum(tab, 0)),
          torch.from_numpy(mask))
    if pool == "float":
        args = (tt[0], torch.from_numpy(kp), torch.from_numpy(vp), *tt[1:])
        want = _jax(q, kp, vp, tab, mask)
    else:
        k, v, ks, vs = _quantized_pools(
            kp, vp, dict(int8=torch.int8, fp8=torch.float8_e4m3fn)[pool])
        args = (tt[0], k, v, *tt[1:], ks, vs)
        want = np.asarray(jax_paged_flash_decode(
            jnp.asarray(q), _to_jax_codes(k), _to_jax_codes(v),
            jnp.maximum(jnp.asarray(tab), 0), jnp.asarray(mask),
            jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy())), np.float32)
    return args, want


@pytest.mark.parametrize("split", [1, 2, 3, 8])
@pytest.mark.parametrize("pool", ["float", "int8", "fp8"])
@pytest.mark.parametrize("T", [1, 5])
def test_split_walk_matches_plain_and_jax(T, pool, split):
    args, want = _split_case(pool, T)
    got = paged_flash_decode_split_ref(*args[:5], *args[5:], split=split)
    ref = paged_flash_decode_ref(*args)
    # the same float32 products, partials merged in another order
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-5)
    assert not torch.isnan(got).any()
    np.testing.assert_array_equal(got[1, :, 0].numpy(), 0.0)


def test_split_walk_row_tiles_and_an_empty_slot():
    """Tiles of 4 rows over T = 10 (the last tile short), and a slot with
    no valid page at all: every share of it is empty and it comes out 0."""
    q, kp, vp, tab, mask = _split_layout(10, 90)
    mask[0] = False
    args = [torch.from_numpy(a) for a in
            (q, kp, vp, np.maximum(tab, 0), mask)]
    ref = paged_flash_decode_ref(*args)
    for split in (1, 3, 8):
        got = paged_flash_decode_split_ref(*args, split=split, rows=4)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(got[0].numpy(), 0.0)


def test_plan_decision_table():
    """The design and split each call shape gets, decided up front.
    Columns: (B, H, T, hd, page, G, pool element bytes, SMs, aligned) ->
    plan."""
    table = [
        # serving: decode, verify, prompt buckets, float / int8 pools
        ((8, 12, 1, 64, 16, 64, 4, 132, True), ("split", 4, 1)),
        ((8, 12, 5, 64, 16, 64, 4, 132, True), ("split", 4, 8)),
        ((8, 12, 16, 64, 16, 64, 1, 132, True), ("split", 4, 16)),
        ((8, 12, 48, 64, 16, 64, 4, 132, True), ("split", 2, 16)),
        ((8, 12, 5, 64, 16, 64, 2, 132, True), ("split", 4, 8)),
        # a few slots: the cluster takes 8, but never more than G blocks
        ((1, 1, 1, 64, 16, 5, 4, 132, True), ("split", 5, 1)),
        ((2, 2, 1, 64, 16, 64, 4, 132, True), ("split", 8, 1)),
        # many slots fill the card with few blocks each
        ((64, 32, 1, 128, 16, 64, 4, 132, True), ("split", 1, 1)),
        ((16, 16, 1, 128, 16, 64, 4, 132, True), ("split", 2, 1)),
        # a smaller card: fewer blocks a cluster
        ((8, 12, 1, 64, 16, 64, 4, 66, True), ("split", 2, 1)),
        # head_dim 256: 8-row tiles
        ((2, 4, 16, 256, 16, 8, 4, 132, True), ("split", 8, 8)),
        # the first design: a page too large to stage whole, head_dim past
        # 256, off the 16 grid, unaligned tensors
        ((4, 4, 5, 64, 1024, 2, 4, 132, True), ("first", 416)),
        ((4, 4, 5, 320, 16, 16, 4, 132, True), ("first", 16)),
        ((4, 4, 5, 512, 16, 16, 4, 132, True), ("first", 16)),
        ((2, 2, 1, 24, 16, 4, 4, 132, True), ("first", 16)),
        ((2, 2, 1, 64, 8, 4, 4, 132, True), ("first", 8)),
        ((8, 12, 1, 64, 16, 64, 4, 132, False), ("first", 16)),
        # a ring that does not fit beside 16 rows of partials at hd 128
        ((2, 2, 16, 128, 64, 64, 4, 132, True), ("first", 64)),
    ]
    for args, want in table:
        assert pa._plan(*args) == want, (args, pa._plan(*args), want)
    assert [pa._tile_rows(T, 64) for T in (1, 2, 5, 8, 9, 48)] == \
        [1, 8, 8, 8, 16, 16]
    assert [pa._tile_rows(T, 256) for T in (1, 5, 48)] == [1, 8, 8]


# -- on the card: the split design's edges --------------------------------------
def _card(args):
    return [a.cuda() if isinstance(a, torch.Tensor) else a for a in args]


def _split_launch(args, split, rows):
    """One launch of the split design at a forced split (the wrapper's
    arguments otherwise)."""
    q, k, v, tab, mask = args[:5]
    ks, vs = (args[5], args[6]) if len(args) > 5 else (None, None)
    out = torch.empty_like(q)
    B, H, T, hd = q.shape
    pool = pa._QUANT_DTYPES.get(k.dtype, pa._DTYPES.get(k.dtype))
    pa._split_kernel_fn()(
        pa._DTYPES[q.dtype], pool, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(), tab.data_ptr(),
        mask.view(torch.uint8).data_ptr(), out.data_ptr(), B, H, T, hd,
        k.shape[2], tab.shape[1], k.shape[0], hd ** -0.5, split, rows,
        torch.cuda.current_stream().cuda_stream)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["float", "int8", "fp8"])
@pytest.mark.parametrize("T", [1, 5])
def test_split_kernel_edges_on_card(T, pool):
    """G = 7 (a multiple of none of the splits but 1), a slot with two
    valid pages (shares with no valid key), a row masked everywhere, a slot
    with no valid page; every split 1..8 against the plain version; two
    calls bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    args, _ = _split_case(pool, T)
    args = _card(args)
    args[4] = args[4].clone()
    args[4][0] = False  # slot 0: no valid page
    ref = paged_flash_decode_ref(*args)
    for split in range(1, 9):
        out = _split_launch(args, split, pa._tile_rows(T, 16))
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=2e-5)
        assert torch.all(out[0] == 0) and torch.all(out[1, :, 0] == 0)
    assert pa._plan(3, 2, T, 16, 16, 7, args[1].element_size(), 132)[0] \
        == "split"
    before = paged_flash_decode.launches
    a, b = paged_flash_decode(*args), paged_flash_decode(*args)
    torch.cuda.synchronize()
    assert paged_flash_decode.launches == before + 2
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    # (hd, page, G, T, q dtype, pool): the first design's instances
    (64, 1024, 2, 5, "float32", "float"),   # chunked: page 1024
    (512, 16, 4, 5, "float32", "float"),    # head_dim 512
    (512, 16, 4, 1, "bfloat16", "int8"),
    (64, 1024, 2, 1, "float32", "fp8"),
])
def test_first_design_shapes_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    hd, page, G, T, qdt, pool = case
    rng = np.random.RandomState(hd + page + T)
    q, kp, vp, tab, mask = _geometry(rng, B=2, H=2, hd=hd, page=page, G=G,
                                     T=T)
    mask[1, 0, :] = False
    assert pa._plan(2, 2, T, hd, page, G, 4, 132)[0] == "first"
    if pool == "float":
        args = [torch.from_numpy(a) for a in (q, kp, vp)]
        args[:3] = [a.to(getattr(torch, qdt)) for a in args[:3]]
    else:
        k, v, ks, vs = _quantized_pools(
            kp, vp, dict(int8=torch.int8, fp8=torch.float8_e4m3fn)[pool])
        args = [torch.from_numpy(q).to(getattr(torch, qdt)), k, v]
    args += [torch.from_numpy(np.maximum(tab, 0)), torch.from_numpy(mask)]
    if pool != "float":
        args += [ks, vs]
    args = _card(args)
    out = paged_flash_decode(*args)
    out2 = paged_flash_decode(*args)
    ref = paged_flash_decode_ref(*args)
    torch.cuda.synchronize()
    tol = (dict(rtol=1e-4, atol=2e-5) if qdt == "float32"
           else dict(rtol=1e-2, atol=1e-5))
    torch.testing.assert_close(out, ref, **tol)
    assert torch.equal(out, out2)
    assert torch.all(out[1, :, 0] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_bit_equal_at_serving_shapes_on_card(dtype):
    """The split design at decode and verify: two calls give the same
    bits (fixed-order merges, no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for T in (1, 5):
        rng = np.random.RandomState(60 + T)
        q, kp, vp, tab, mask = _geometry(rng, B=8, H=12, hd=64, page=16,
                                         G=64, T=T)
        dt = getattr(torch, dtype)
        args = _card([torch.from_numpy(a) for a in
                      (q, kp, vp, np.maximum(tab, 0), mask)])
        args[:3] = [a.to(dt) for a in args[:3]]
        a, b = paged_flash_decode(*args), paged_flash_decode(*args)
        torch.cuda.synchronize()
        assert torch.equal(a, b)
