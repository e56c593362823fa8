"""Port of the paged flash-decode kernel (paddle_tpu_torch/ops).

The port's plain version ``paged_flash_decode_ref`` — the CPU path and the
card-side yardstick of the CUDA kernel — is held against the JAX package's
``paged_flash_decode``, whose Pallas kernel runs in interpret mode on the
CPU exactly as tests/test_paged_attention.py runs it.  Inputs are numpy
arrays from a seed.  Quantized pools (int8 / fp8-e4m3 codes with
``[P+1, H, page]`` float32 scale planes) go through both the same way.
The CUDA kernel itself is compared with the plain version only where a
card is present (``gpu`` marker).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.paged_attention import (
    paged_flash_decode as jax_paged_flash_decode)
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.models.gpt import _quantize_kv
from paddle_tpu_torch.ops.paged_attention import (paged_flash_decode,
                                                  paged_flash_decode_ref)

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
