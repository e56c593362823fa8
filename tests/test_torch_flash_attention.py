"""Port of the flash-attention forward kernel (paddle_tpu_torch/ops).

The port's plain versions ``flash_attention_ref`` /
``flash_attention_fwd_lse_ref`` — the CPU path and the card-side yardstick
of the CUDA kernel — and the public wrappers on CPU tensors are held
against the JAX package's ``flash_attention`` / ``flash_attention_fwd_lse``,
whose Pallas kernel runs in interpret mode on the CPU with explicit blocks,
as tests/test_attention.py runs it.  Inputs are numpy arrays from a seed.
f32 at JAX's own tolerance, rtol 2e-4 / atol 2e-5 (the Pallas kernel's
online softmax reassociates across blocks, the plain version does not);
bf16 inputs at 1e-2 (both round a float32 result to bf16 once).  The CUDA
kernel is compared with the plain version only where a card is present
(``gpu`` marker).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
    flash_attention_fwd_lse as jax_flash_attention_fwd_lse)
from paddle_tpu_torch.framework.errors import (InvalidArgumentError,
                                               UnimplementedError)
from paddle_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_fwd_lse, flash_attention_fwd_lse_ref,
    flash_attention_ref)

# the module (``paddle_tpu_torch.ops.flash_attention`` is also the function)
fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
F32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)


def _qkv(seed, B=2, H=2, S=64, K=None, D=16, dtype=np.float32):
    rng = np.random.RandomState(seed)
    K = K or S
    return tuple(rng.randn(B, H, n, D).astype(dtype) for n in (S, K, K))


def _jax_lse(q, k, v, causal, off, dtype=jnp.float32, blocks=(16, 16)):
    out, lse = jax_flash_attention_fwd_lse(
        *(jnp.asarray(a, dtype) for a in (q, k, v)), causal=causal,
        q_position_offset=off, block_q=blocks[0], block_k=blocks[1])
    return np.asarray(out, np.float32), np.asarray(lse, np.float32)


def _torch_lse(fn, q, k, v, causal, off, dtype=torch.float32):
    out, lse = fn(*(torch.tensor(a, dtype=dtype) for a in (q, k, v)),
                  causal, q_position_offset=off)
    return out.float().numpy(), lse.numpy()


# (S, K, causal, q_position_offset): self-attention, K > S, block-aligned,
# non-aligned and negative offsets, ragged S and K
CASES = {
    "self": (64, 64, False, 0),
    "self_causal": (64, 64, True, 0),
    "k_longer": (16, 64, False, 0),
    "k_longer_causal_bottom": (16, 64, True, 48),
    "offset_aligned": (16, 64, True, 16),
    "offset_unaligned": (16, 64, True, 7),
    "offset_negative": (24, 40, True, -5),
    "ragged": (25, 40, False, 0),
    "ragged_causal": (25, 40, True, 7),
}


@pytest.mark.parametrize("fn", [flash_attention_fwd_lse,
                                flash_attention_fwd_lse_ref],
                         ids=["wrapper", "plain"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_out_and_lse_match_jax_pallas(case, fn):
    S, K, causal, off = CASES[case]
    q, k, v = _qkv(len(case), S=S, K=K)
    want_o, want_l = _jax_lse(q, k, v, causal, off)
    got_o, got_l = _torch_lse(fn, q, k, v, causal, off)
    assert got_o.shape == want_o.shape and got_l.shape == (2, 2, S)
    np.testing.assert_allclose(got_o, want_o, **F32)
    np.testing.assert_allclose(got_l, want_l, **F32)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_jax_with_its_default_blocks(causal):
    q, k, v = _qkv(1, S=40, K=40)
    want = np.asarray(jax_flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal))
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=causal).numpy()
    np.testing.assert_allclose(got, want, **F32)


def test_fully_masked_rows_give_zero_and_minus_inf():
    """Rows whose position lies before every key (a ring chunk ahead of
    the diagonal): out exactly 0, lse -inf, on both packages."""
    q, k, v = _qkv(2, S=24, K=40)
    want_o, want_l = _jax_lse(q, k, v, True, -10)
    got_o, got_l = _torch_lse(flash_attention_fwd_lse_ref, q, k, v, True,
                              -10)
    dead = np.arange(24) - 10 < 0
    assert np.all(got_o[:, :, dead] == 0) and np.all(want_o[:, :, dead] == 0)
    assert np.all(np.isneginf(got_l[:, :, dead]))
    assert np.all(np.isneginf(want_l[:, :, dead]))
    np.testing.assert_allclose(got_o, want_o, **F32)
    np.testing.assert_allclose(got_l, want_l, **F32)
    # a chunk wholly ahead of the diagonal: every row dead
    o, l = flash_attention_fwd_lse_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), True,
        q_position_offset=-100)
    assert torch.all(o == 0) and torch.all(torch.isneginf(l))


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_inputs_match_jax(causal):
    q, k, v = _qkv(3, S=32, K=48, D=32)
    want_o, want_l = _jax_lse(q, k, v, causal, 16, jnp.bfloat16)
    got_o, got_l = _torch_lse(flash_attention_fwd_lse_ref, q, k, v, causal,
                              16, torch.bfloat16)
    out = flash_attention_ref(*(torch.tensor(a, dtype=torch.bfloat16)
                                for a in (q, k, v)), causal,
                              q_position_offset=16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(got_o, want_o, **BF16)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5, atol=1e-5)


def test_sm_scale_and_blocks():
    """An explicit sm_scale is used as given; block_q / block_k change
    nothing."""
    q, k, v = _qkv(4, S=32)
    want = np.asarray(jax_flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=True, sm_scale=0.3,
        block_q=8, block_k=16))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True, sm_scale=0.3)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    again = flash_attention(tq, tk, tv, causal=True, sm_scale=0.3,
                            block_q=8, block_k=16)
    assert torch.equal(got, again)


def test_plain_version_chunks_q_rows_exactly(monkeypatch):
    """The plain version's q-row chunking (how the card runs it at
    S = 32768) gives the unchunked result, to float32 rounding: the BLAS
    blocks a product of another shape differently."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, S=50, K=70))
    whole = flash_attention_fwd_lse_ref(q, k, v, True, q_position_offset=3)
    monkeypatch.setattr(fa, "_REF_CHUNK_ELEMS", 2 * 2 * 70 * 7)  # 7 rows
    chunked = flash_attention_fwd_lse_ref(q, k, v, True,
                                          q_position_offset=3)
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_cpu_tensors_take_the_plain_version_uncounted():
    q, k, v = (torch.from_numpy(a) for a in _qkv(6, S=33, K=47))
    before = flash_attention.launches
    got = flash_attention_fwd_lse(q, k, v, True, q_position_offset=9)
    want = flash_attention_fwd_lse_ref(q, k, v, True, q_position_offset=9)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert flash_attention.launches == before


def test_grad_mode_raises_until_the_backward_kernels_land():
    """``flash_attention_fwd_lse`` stays forward-only under grad, as the
    JAX one is; ``flash_attention`` itself is differentiable now (its
    backward: tests/test_torch_flash_attention_bwd.py)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, S=16))
    with pytest.raises(UnimplementedError):
        flash_attention_fwd_lse(q, k, v.requires_grad_())
    with torch.no_grad():
        out = flash_attention(q, k, v, causal=True)
    assert not out.requires_grad
    q2, k2, v2 = (t.detach() for t in (q, k, v))
    torch.testing.assert_close(flash_attention(q2, k2, v2, causal=True), out)


def test_rejects_bad_shapes_and_dtypes():
    q, k, v = (torch.from_numpy(a) for a in _qkv(8, S=16))
    with pytest.raises(InvalidArgumentError):
        flash_attention(q, k[:, :1], v)
    with pytest.raises(InvalidArgumentError):
        flash_attention(q, k, v[..., :8])
    with pytest.raises(InvalidArgumentError):
        flash_attention(q[0], k[0], v[0])
    with pytest.raises(InvalidArgumentError):
        flash_attention(q, k.double(), v)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# the kernel's stated tolerances against the plain version on the card:
# float32 sums in another order; bf16 rounds P to bf16 for the P.V product
# (the plain version keeps it float32) and the output to bf16.  Long rows
# give small outputs, so bf16 is held to 2e-2 of each element (one output
# ulp) plus 2e-2 of its reference row's RMS (P's rounding), not to a fixed
# atol as large as the outputs themselves
CARD_TOL = {"float32": dict(rtol=1e-5, atol=2e-5),
            "bfloat16": dict(rtol=2e-2, row_rms=2e-2)}
LSE_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
           "bfloat16": dict(rtol=1e-5, atol=1e-3)}


def _assert_card_close(out, ref, dtype):
    tol = CARD_TOL[dtype]
    if "atol" in tol:
        torch.testing.assert_close(out.float(), ref.float(), **tol)
        return
    o, r = out.float(), ref.float()
    rms = r.pow(2).mean(-1, keepdim=True).sqrt()
    bad = (o - r).abs() > tol["rtol"] * r.abs() + tol["row_rms"] * rms
    assert not bool(bad.any()), (
        f"{int(bad.sum())} elements outside {tol}; max abs err "
        f"{float((o - r).abs().max()):.3e}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("S,K,causal,off", [(512, 512, True, 0),
                                            (300, 517, False, 0),
                                            (300, 517, True, 217),
                                            (333, 200, True, -70)])
def test_kernel_matches_plain_on_card(dtype, hd, S, K, causal, off):
    dev = _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(hd + S + K)
    q, k, v = (torch.randn(2, 3, n, hd, generator=gen).to(dev, dt)
               for n in (S, K, K))
    before = flash_attention.launches
    out, lse = flash_attention_fwd_lse(q, k, v, causal,
                                       q_position_offset=off)
    ref, ref_lse = flash_attention_fwd_lse_ref(q, k, v, causal,
                                               q_position_offset=off)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == dt and lse.dtype == torch.float32
    _assert_card_close(out, ref, dtype)
    dead = torch.isneginf(ref_lse)
    assert torch.equal(torch.isneginf(lse), dead)
    assert torch.all(out[dead] == 0)
    torch.testing.assert_close(lse[~dead], ref_lse[~dead], **LSE_TOL[dtype])


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take():
    dev = _card()
    q = torch.randn(1, 2, 128, 96, device=dev)
    with pytest.raises(InvalidArgumentError, match="head_dim"):
        flash_attention(q, q, q)
    q = torch.randn(1, 2, 128, 64, device=dev, dtype=torch.float16)
    with pytest.raises(InvalidArgumentError, match="float32 or bfloat16"):
        flash_attention(q, q, q)


@pytest.mark.gpu
def test_kernel_is_deterministic_and_takes_strided_views():
    dev = _card()
    gen = torch.Generator().manual_seed(1)
    qkv = torch.randn(2, 256, 3, 4, 64, generator=gen).to(dev, torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    a = flash_attention(q, k, v, causal=True)
    b = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=True)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# the bf16 kernel's 128-row q tiles (two warpgroups of 64): S below, at
# one row past, and ragged against the tile, at every head dim, with the
# causal offsets a chunked or decoding caller passes (0, the end-aligned
# K - S, a negative one whose first rows see no key)
@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("S", [1, 127, 129, 1000])
@pytest.mark.parametrize("off", ["zero", "end", "negative"])
def test_kernel_128_row_tile_edges_on_card(hd, S, off):
    dev = _card()
    K = S + 37
    q_off = {"zero": 0, "end": K - S, "negative": -5}[off]
    gen = torch.Generator().manual_seed(hd + S)
    q, k, v = (torch.randn(2, 3, n, hd, generator=gen).to(dev, torch.bfloat16)
               for n in (S, K, K))
    out, lse = flash_attention_fwd_lse(q, k, v, True, q_position_offset=q_off)
    ref, ref_lse = flash_attention_fwd_lse_ref(q, k, v, True,
                                               q_position_offset=q_off)
    torch.cuda.synchronize()
    _assert_card_close(out, ref, "bfloat16")
    dead = torch.isneginf(ref_lse)
    assert torch.equal(torch.isneginf(lse), dead)
    assert torch.all(out[dead] == 0)
    torch.testing.assert_close(lse[~dead], ref_lse[~dead],
                               **LSE_TOL["bfloat16"])
