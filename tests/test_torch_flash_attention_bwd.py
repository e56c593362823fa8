"""Port of the flash-attention backward kernels (paddle_tpu_torch/ops).

The port's plain backward ``flash_attention_bwd_ref`` — the CPU path and
the card-side yardstick of the dq and dk / dv CUDA kernels — and the
differentiable ``flash_attention`` on CPU tensors are held against
``jax.grad`` through the JAX package's ``flash_attention``, whose Pallas
forward and backward kernels run in interpret mode on the CPU with
explicit blocks, as tests/test_attention.py runs them; and
``flash_attention_bwd_chunk`` against the JAX one.  Inputs are numpy
arrays from a seed; the loss is ``sum(out ** 2)`` (cotangent ``2 out``).
Tolerances: float32 at rtol 1e-4 / atol 2e-5 — both sides work in
float32 and sum in other orders (the Pallas kernels block by block, the
plain version whole rows); the gradients here reach ~15, the largest
difference seen is ~6e-6.  bf16 inputs at 2e-2: both round a float32
gradient to bf16 once.  The CUDA kernels are compared with the plain
version only where a card is present (``gpu`` marker), under the rule of
``chip_smoke.py`` phase LT1 (``FLASH_BWD_TOL``).
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
    flash_attention_bwd_chunk as jax_flash_attention_bwd_chunk,
    flash_attention_fwd_lse as jax_flash_attention_fwd_lse)
from paddle_tpu_torch.framework.errors import (InvalidArgumentError,
                                               UnimplementedError)
from paddle_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd_chunk, flash_attention_bwd_dkv,
    flash_attention_bwd_dq, flash_attention_bwd_ref, flash_attention_fwd_lse,
    flash_attention_fwd_lse_ref)

# the module (``paddle_tpu_torch.ops.flash_attention`` is also the function)
fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
F32 = dict(rtol=1e-4, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
BLOCKS = dict(block_q=16, block_k=16)


def _qkv(seed, B=2, H=2, S=64, K=None, D=16, dtype=np.float32):
    rng = np.random.RandomState(seed)
    K = K or S
    return tuple(rng.randn(B, H, n, D).astype(dtype) for n in (S, K, K))


def _jax_grads(q, k, v, causal, off, sm_scale=None, dtype=jnp.float32):
    def loss(q, k, v):
        out = jax_flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                                  q_position_offset=off, **BLOCKS)
        return (out.astype(jnp.float32) ** 2).sum()

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, dtype) for a in (q, k, v)))
    return [np.asarray(g, np.float32) for g in grads]


def _plain_grads(q, k, v, causal, off, sm_scale=None):
    """The plain backward at the cotangent of sum(out ** 2)."""
    out, lse = flash_attention_fwd_lse_ref(q, k, v, causal, sm_scale, off)
    return flash_attention_bwd_ref(q, k, v, out, lse, 2 * out, causal,
                                   sm_scale, off)


def _autograd_grads(q, k, v, causal, off, sm_scale=None):
    """torch.autograd through the port's differentiable flash_attention."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = flash_attention(q, k, v, causal, sm_scale, q_position_offset=off)
    return torch.autograd.grad((out.float() ** 2).sum(), (q, k, v))


FNS = {"plain": _plain_grads, "autograd": _autograd_grads}

# (S, K, causal, q_position_offset, sm_scale): self-attention; ragged S != K
# (25 x 40, neither block-aligned); offsets 0, 7, -8 (rows before every
# key) and K - S (the bottom-right diagonal); an explicit sm_scale
CASES = {
    "self": (64, 64, False, 0, None),
    "self_causal": (64, 64, True, 0, None),
    "ragged": (25, 40, False, 0, None),
    "ragged_causal_offset_7": (25, 40, True, 7, None),
    "ragged_causal_offset_minus_8": (25, 40, True, -8, None),
    "ragged_causal_offset_k_minus_s": (25, 40, True, 15, None),
    "sm_scale": (32, 32, True, 0, 0.3),
}
_JAX = {}


def _case_jax(case):
    """JAX's gradients of one case (computed once per process)."""
    if case not in _JAX:
        S, K, causal, off, scale = CASES[case]
        q, k, v = _qkv(len(case), S=S, K=K)
        _JAX[case] = ((q, k, v), _jax_grads(q, k, v, causal, off, scale))
    return _JAX[case]


@pytest.mark.parametrize("fn", sorted(FNS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_jax_grad_through_pallas(case, fn):
    S, K, causal, off, scale = CASES[case]
    (q, k, v), want = _case_jax(case)
    got = FNS[fn](*(torch.from_numpy(a) for a in (q, k, v)), causal, off,
                  scale)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), w, err_msg=name, **F32)


@pytest.mark.parametrize("fn", sorted(FNS))
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_backward_matches_jax(causal, fn):
    q, k, v = _qkv(3, S=32, K=48, D=32)
    want = _jax_grads(q, k, v, causal, 16, dtype=jnp.bfloat16)
    got = FNS[fn](*(torch.tensor(a, dtype=torch.bfloat16) for a in (q, k, v)),
                  causal, 16)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16, name
        np.testing.assert_allclose(a.float().numpy(), w, err_msg=name,
                                   **BF16)


def test_rows_with_no_key_get_zero_gradient():
    """Rows whose position lies before every key: dq exactly 0 in both
    packages, and nothing anywhere is NaN."""
    q, k, v = _qkv(2, S=24, K=40)
    want = _jax_grads(q, k, v, True, -10)
    got = _plain_grads(*(torch.from_numpy(a) for a in (q, k, v)), True, -10)
    dead = np.arange(24) - 10 < 0
    assert np.all(want[0][:, :, dead] == 0)
    assert torch.all(got[0][:, :, dead] == 0)
    for a, w in zip(got, want):
        assert torch.isfinite(a).all() and np.isfinite(w).all()
        np.testing.assert_allclose(a.numpy(), w, **F32)
    # a chunk wholly ahead of the diagonal: every gradient exactly 0
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for g in _autograd_grads(tq, tk, tv, True, -100):
        assert torch.all(g == 0)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_equals_plain_and_dense_float64(causal):
    """The CPU autograd path is the plain backward, and both are the
    gradient of the dense softmax attention (autograd in float64)."""
    q, k, v = (torch.from_numpy(a).double() for a in _qkv(4, S=40, K=56))
    got = _autograd_grads(q, k, v, causal, 9)
    plain = _plain_grads(q, k, v, causal, 9)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if causal:
        pos = 9 + torch.arange(40)
        s = s.masked_fill(pos[:, None] < torch.arange(56)[None], -math.inf)
    out = torch.softmax(s, -1) @ v
    dense = torch.autograd.grad((out ** 2).sum(), (q, k, v))
    for a, b in zip(got, dense):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, **F32)


def _ring_inputs(seed, S=24, K=40, causal=True, off=16):
    """q rows at global positions off.., all K keys, and the merged (global)
    out / lse of the full forward, from JAX."""
    q, k, v = _qkv(seed, S=S, K=K)
    do = np.random.RandomState(seed + 1).randn(*q.shape).astype(np.float32)
    out, lse = jax_flash_attention_fwd_lse(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal,
        q_position_offset=off, **BLOCKS)
    return q, k, v, np.array(out), np.array(lse), do


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_chunk_matches_jax(causal):
    """One ring step: the local q rows against the second of two kv chunks
    (keys 16..39, so the chunk's offset is the rows' position - 16)."""
    q, k, v, out, lse, do = _ring_inputs(5, causal=causal)
    k2, v2 = k[:, :, 16:], v[:, :, 16:]
    want = jax_flash_attention_bwd_chunk(
        *(jnp.asarray(a) for a in (q, k2, v2, out, lse, do)),
        causal=causal, q_position_offset=0, **BLOCKS)
    got = flash_attention_bwd_chunk(
        *(torch.from_numpy(a) for a in (q, k2, v2, out, lse, do)),
        causal=causal, q_position_offset=0, block_q=8, block_k=8)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=name,
                                   **F32)


def test_bwd_chunk_partials_sum_to_the_full_gradient():
    """Linear over kv chunks: dq is the sum of the chunks' partials, dk / dv
    their concatenation; delta passed once gives the same as from out."""
    q, k, v, out, lse, do = (torch.from_numpy(a) for a in _ring_inputs(6))
    full = flash_attention_bwd_ref(q, k, v, out, lse, do, True,
                                   q_position_offset=16)
    delta = (do * out).sum(-1)
    parts = [flash_attention_bwd_chunk(q, k[:, :, a:b], v[:, :, a:b], None,
                                       lse, do, True,
                                       q_position_offset=16 - a, delta=delta)
             for a, b in ((0, 16), (16, 40))]
    torch.testing.assert_close(parts[0][0] + parts[1][0], full[0], **F32)
    for i in (1, 2):
        torch.testing.assert_close(torch.cat([p[i] for p in parts], 2),
                                   full[i], **F32)
    again = flash_attention_bwd_chunk(q, k[:, :, 16:], v[:, :, 16:], out,
                                      lse, do, True, q_position_offset=0)
    for a, b in zip(again, parts[1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_plain_backward_chunks_q_rows_exactly(monkeypatch):
    """The plain backward's q-row chunking (how the card runs it at
    S = 32768) gives the unchunked result, to float32 rounding: dk / dv are
    summed over the chunks, and the BLAS blocks products of other shapes
    differently."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, S=50, K=70))
    do = torch.from_numpy(np.random.RandomState(8).randn(2, 2, 50, 16)
                          .astype(np.float32))
    out, lse = flash_attention_fwd_lse_ref(q, k, v, True,
                                           q_position_offset=3)
    whole = flash_attention_bwd_ref(q, k, v, out, lse, do, True,
                                    q_position_offset=3)
    monkeypatch.setattr(fa, "_REF_CHUNK_ELEMS", 2 * 2 * 70 * 7)  # 7 rows
    chunked = flash_attention_bwd_ref(q, k, v, out, lse, do, True,
                                      q_position_offset=3)
    for a, b in zip(whole, chunked):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_fwd_lse_stays_forward_only():
    q, k, v = (torch.from_numpy(a) for a in _qkv(9, S=16))
    with pytest.raises(UnimplementedError, match="flash_attention_bwd_chunk"):
        flash_attention_fwd_lse(q.requires_grad_(), k, v, causal=True)
    with torch.no_grad():
        out, lse = flash_attention_fwd_lse(q, k, v, causal=True)
    assert not out.requires_grad and not lse.requires_grad


def test_cpu_backward_takes_the_plain_version_uncounted():
    q, k, v = (torch.from_numpy(a) for a in _qkv(10, S=33, K=47))
    counts = [f.launches for f in (flash_attention, flash_attention_bwd_dq,
                                   flash_attention_bwd_dkv)]
    got = _autograd_grads(q, k, v, True, 9)
    want = _plain_grads(q, k, v, True, 9)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    out, lse = flash_attention_fwd_lse_ref(q, k, v, True,
                                           q_position_offset=9)
    chunk = flash_attention_bwd_chunk(q, k, v, out, lse, 2 * out, True,
                                      q_position_offset=9)
    for a, b in zip(chunk, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert [f.launches for f in (flash_attention, flash_attention_bwd_dq,
                                 flash_attention_bwd_dkv)] == counts


def test_backward_rejects_cotangents_that_do_not_fit():
    q, k, v = (torch.from_numpy(a) for a in _qkv(11, S=16))
    out, lse = flash_attention_fwd_lse_ref(q, k, v)
    with pytest.raises(InvalidArgumentError, match="do not fit"):
        flash_attention_bwd_chunk(q, k, v, out, lse, out[:, :, :8])
    with pytest.raises(InvalidArgumentError, match="do not fit"):
        flash_attention_bwd_chunk(q, k, v, out, lse[:, :, :8], out)
    with pytest.raises(InvalidArgumentError):
        flash_attention_bwd_chunk(q, k[:, :1], v, out, lse, out)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _assert_grad_close(got, ref, dtype):
    """chip_smoke.py's rule: per element, rtol |ref| + row_rms * rms(ref
    row) + tensor_rms * rms(ref)."""
    import chip_smoke

    chip_smoke.grad_close(torch, got, ref, dtype)


def _bwd_tol(key):
    import chip_smoke

    return chip_smoke.FLASH_BWD_TOL["bfloat16"][key]


def _card_case(dev, dt, hd, S, K, seed, B=2, H=3):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(B, H, n, hd, generator=gen).to(dev, dt)
                 for n in (S, K, K, S))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("S,K,causal,off", [(1000, 1000, True, 0),
                                            (100, 300, False, 0),
                                            (100, 300, True, 37),
                                            (100, 300, True, 200),
                                            (300, 100, True, -64)])
def test_kernels_match_plain_on_card(dtype, hd, S, K, causal, off):
    dev = _card()
    dt = getattr(torch, dtype)
    q, k, v, do = _card_case(dev, dt, hd, S, K, hd + S + K)
    out, lse = flash_attention_fwd_lse(q, k, v, causal,
                                       q_position_offset=off)
    before = (flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
    got = flash_attention_bwd_chunk(q, k, v, out, lse, do, causal,
                                    q_position_offset=off)
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, causal,
                                   q_position_offset=off)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                  before[1] + 1)
    for a, w in zip(got, want):
        assert a.dtype == dt and a.shape == w.shape
        assert torch.isfinite(a).all()
        _assert_grad_close(a, w, dtype)
    dead = torch.isneginf(lse)
    assert torch.all(got[0][dead] == 0)


# The bf16 kernels' tile edges: 128-row q tiles (dq), 128-key blocks (dk /
# dv), 32-128-row stream tiles: S and K at 1, 127, 129 and 1000, K = S + 37
# and K < S; causal at offset 0, K - S and a negative one (the first rows
# see no key), and not causal.
EDGE_SK = [(1, 38), (1, 1), (127, 164), (127, 1), (129, 166), (129, 127),
           (1000, 1037), (1000, 129)]


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("S,K", EDGE_SK)
@pytest.mark.parametrize("mode", ["zero", "k_minus_s", "negative",
                                  "not_causal"])
def test_bf16_kernels_at_tile_edges(hd, S, K, mode):
    dev = _card()
    causal = mode != "not_causal"
    off = {"k_minus_s": K - S, "negative": -(S // 2 + 1)}.get(mode, 0)
    q, k, v, do = _card_case(dev, torch.bfloat16, hd, S, K,
                             7 * hd + 3 * S + K)
    out, lse = flash_attention_fwd_lse(q, k, v, causal,
                                       q_position_offset=off)
    runs = [flash_attention_bwd_chunk(q, k, v, out, lse, do, causal,
                                      q_position_offset=off)
            for _ in range(2)]
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, causal,
                                   q_position_offset=off)
    torch.cuda.synchronize()
    # every row seeing at most one key makes dq and dk exactly 0 (ds = p
    # (dp - delta) cancels): both sides then hold float32 noise alone, so
    # they are held to FLASH_BWD_TOL's tensor_rms share of dv's scale
    single = K == 1 or (S == 1 and mode == "zero")
    dv_rms = float(want[2].float().pow(2).mean().sqrt())
    for name, a, b, w in zip(("dq", "dk", "dv"), *runs, want):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape
        assert torch.equal(a, b), "two launches differ"
        if single and name != "dv":
            floor = _bwd_tol("tensor_rms") * dv_rms
            assert float(a.float().abs().max()) <= floor, name
            assert float(w.float().abs().max()) <= floor, name
        else:
            _assert_grad_close(a, w, "bfloat16")
    dead = torch.isneginf(lse)
    assert mode != "negative" or bool(dead.any())
    assert torch.all(runs[0][0][dead] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_are_deterministic_and_take_strided_views(dtype):
    dev = _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(1)
    qkv = torch.randn(2, 512, 3, 4, 64, generator=gen).to(dev, dt)
    q, k, v = (qkv[:, :, i].transpose(1, 2).requires_grad_()
               for i in range(3))
    do = torch.randn(2, 4, 512, 64, generator=gen).to(dev, dt)
    runs = []
    for _ in range(2):
        out = flash_attention(q, k, v, causal=True)
        runs.append(torch.autograd.grad(out, (q, k, v), do))
    qc, kc, vc = (t.detach().contiguous().requires_grad_()
                  for t in (q, k, v))
    out = flash_attention(qc, kc, vc, causal=True)
    runs.append(torch.autograd.grad(out, (qc, kc, vc),
                                    do.transpose(1, 2).contiguous()
                                    .transpose(1, 2)))
    torch.cuda.synchronize()
    for a, b, c in zip(*runs):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.gpu
def test_backward_kernels_reject_what_they_do_not_take():
    dev = _card()
    q = torch.randn(1, 2, 128, 96, device=dev)
    with pytest.raises(InvalidArgumentError, match="head_dim"):
        flash_attention_bwd_chunk(q, q, q, q, q[..., 0], q)
    q = torch.randn(1, 2, 128, 64, device=dev, dtype=torch.float16)
    with pytest.raises(InvalidArgumentError, match="float32 or bfloat16"):
        flash_attention_bwd_chunk(q, q, q, q, q[..., 0].float(), q)
    q = torch.randn(1, 2, 128, 64, device=dev)
    with pytest.raises(InvalidArgumentError, match="do on cpu"):
        flash_attention_bwd_chunk(q, q, q, q, q[..., 0], q.cpu(),
                                  delta=q[..., 0])
