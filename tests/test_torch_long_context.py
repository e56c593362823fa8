"""Long-context inference and training on the port, and the width / dtype
repairs.

``scaled_dot_product_attention`` (both routes) and a narrow GPT whose
attention goes through the flash route — forward, ``eval_batch`` and two
``train_batch`` steps — are held against the JAX package on the CPU: the
port runs its plain flash versions (forward and backward), JAX its Pallas
kernels in interpret mode.  Inputs and weights (``load_jax_params``) are numpy
from a seed.  Tolerances: the flash routes at JAX's own rtol 2e-4 / atol
2e-5 (online softmax reassociates); the dense route and the models at
rtol 2e-4 / atol 1e-5 (XLA's CPU exp is an approximation; see the verify
skill's gotchas).  The gates of both functions are checked as decision
tables; a ``cuda`` device is stood in by an object with the tensor's
attributes, since no card is present here.

The repairs: ``layernorm_residual`` at any width (the plain version
against JAX at D = 1024 and 1536; the kernel's wide variant on the card),
``forward_paged`` behind the JAX package's paged gate (gather-then-attend
off it, against JAX's own), ``paged_flash_decode`` at head_dim 320 and
page 1024 on the card, and the guard against an fp8 model cast to a float
dtype.
"""
import importlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.nn.functional.attention import (
    scaled_dot_product_attention as jax_sdpa)
from paddle_tpu.ops.fused_layernorm import (
    layernorm_residual as jax_layernorm_residual)
from paddle_tpu.ops.paged_attention import (
    paged_flash_eligible as jax_paged_flash_eligible)
import paddle_tpu_torch as tpt
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
from paddle_tpu_torch.nn.functional.attention import flash_eligible
from paddle_tpu_torch.ops.flash_attention import flash_attention
from paddle_tpu_torch.ops.fused_layernorm import (layernorm_residual,
                                                  layernorm_residual_ref)
from paddle_tpu_torch.ops.paged_attention import (paged_flash_decode,
                                                  paged_flash_decode_ref,
                                                  paged_flash_eligible)
from paddle_tpu_torch.slim import quantize_weights

FLASH = dict(rtol=2e-4, atol=2e-5)
DENSE = dict(rtol=2e-4, atol=1e-5)
fl = importlib.import_module("paddle_tpu_torch.ops.fused_layernorm")


def _bshd(seed, B=1, S=64, K=None, H=2, D=16):
    rng = np.random.RandomState(seed)
    K = K or S
    return tuple(rng.randn(B, n, H, D).astype(np.float32) for n in (S, K, K))


# -- scaled_dot_product_attention ---------------------------------------------
@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_flash_route_matches_jax_pallas(causal):
    q, k, v = _bshd(0, B=2, S=128, K=128)
    want = np.asarray(jax_sdpa(*(jnp.asarray(a) for a in (q, k, v)),
                               is_causal=causal, use_pallas=True))
    got = scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), is_causal=causal,
        use_pallas=True)
    assert got.shape == (2, 128, 2, 16)
    np.testing.assert_allclose(got.numpy(), want, **FLASH)


@pytest.mark.parametrize("s_q,s_k", [(8, 8), (8, 12), (12, 8)])
@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_dense_route_matches_jax(s_q, s_k, causal):
    q, k, v = _bshd(1, B=2, S=s_q, K=s_k)
    want = np.asarray(jax_sdpa(*(jnp.asarray(a) for a in (q, k, v)),
                               is_causal=causal, use_pallas=False))
    got = scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), is_causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **DENSE)


@pytest.mark.parametrize("kind", ["bool", "float"])
def test_sdpa_dense_route_masks_match_jax(kind):
    q, k, v = _bshd(2, B=2, S=6, K=10)
    rng = np.random.RandomState(3)
    if kind == "bool":
        mask = rng.rand(2, 2, 6, 10) > 0.3
        mask[0, 1, 2] = False  # a fully masked row: uniform over -1e30s
    else:
        mask = (rng.randn(2, 1, 6, 10) * 3).astype(np.float32)
    want = np.asarray(jax_sdpa(*(jnp.asarray(a) for a in (q, k, v)),
                               attn_mask=jnp.asarray(mask), is_causal=True))
    got = scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        attn_mask=torch.from_numpy(mask), is_causal=True)
    np.testing.assert_allclose(got.numpy(), want, **DENSE)


def test_sdpa_bf16_dense_route_casts_probs_like_jax():
    q, k, v = _bshd(4, S=16)
    want = np.asarray(jax_sdpa(*(jnp.asarray(a, jnp.bfloat16)
                                 for a in (q, k, v)), is_causal=True),
                      np.float32)
    got = scaled_dot_product_attention(
        *(torch.tensor(a, dtype=torch.bfloat16) for a in (q, k, v)),
        is_causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2,
                               atol=1e-2)


def test_sdpa_dropout_draws_from_the_device_generator():
    q, k, v = (torch.from_numpy(a) for a in _bshd(5, S=16))
    tpt.seed(11)
    a = scaled_dot_product_attention(q, k, v, dropout_p=0.5)
    tpt.seed(11)
    b = scaled_dot_product_attention(q, k, v, dropout_p=0.5)
    c = scaled_dot_product_attention(q, k, v, dropout_p=0.5, training=False)
    d = scaled_dot_product_attention(q, k, v)
    assert torch.equal(a, b) and not torch.equal(a, d)
    torch.testing.assert_close(c, d, rtol=0, atol=0)


def test_the_two_causal_conventions_differ_as_in_jax():
    """S_q != S_k, causal: the dense route masks bottom-right
    (``tril(k = s_k - s_q)``), the flash route top-left (``row >= key``).
    Each route matches its JAX counterpart; the flash route with
    ``q_position_offset = s_k - s_q`` is the dense one."""
    q, k, v = _bshd(6, S=16, K=48)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    dense = scaled_dot_product_attention(tq, tk, tv, is_causal=True,
                                         use_pallas=False)
    flash = scaled_dot_product_attention(tq, tk, tv, is_causal=True,
                                         use_pallas=True)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jax_sdpa(
        jq, jk, jv, is_causal=True, use_pallas=False)), **DENSE)
    np.testing.assert_allclose(flash.numpy(), np.asarray(jax_sdpa(
        jq, jk, jv, is_causal=True, use_pallas=True)), **FLASH)
    assert float((dense - flash).abs().max()) > 0.1
    shifted = flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                              tv.transpose(1, 2), causal=True,
                              q_position_offset=48 - 16).transpose(1, 2)
    torch.testing.assert_close(shifted, dense, rtol=1e-5, atol=1e-6)


def _t(device, shape, requires_grad=False):
    """A stand-in for a tensor on ``device`` (only what the gates read)."""
    return SimpleNamespace(device=torch.device(device), shape=shape,
                           requires_grad=requires_grad)


# (device, S_q, S_k, head_dim, mask, dropout_p, grad) -> flash?
SDPA_GATE = [
    (("cuda", 4096, 4096, 64, None, 0.0, False), True),
    (("cuda", 8192, 4096, 128, None, 0.0, False), True),
    (("cuda", 4096, 8192, 256, None, 0.0, False), True),
    (("cpu", 4096, 4096, 64, None, 0.0, False), False),
    (("cuda", 2048, 4096, 64, None, 0.0, False), False),
    (("cuda", 4224, 4096, 64, None, 0.0, False), True),
    (("cuda", 4100, 4096, 64, None, 0.0, False), False),
    (("cuda", 4096, 4100, 64, None, 0.0, False), False),
    (("cuda", 4096, 4096, 96, None, 0.0, False), False),
    (("cuda", 4096, 4096, 512, None, 0.0, False), False),
    (("cuda", 4096, 4096, 64, "mask", 0.0, False), False),
    (("cuda", 4096, 4096, 64, None, 0.1, False), False),
    # a gradient changes nothing: the flash route is differentiable
    (("cuda", 4096, 4096, 64, None, 0.0, True), True),
]


@pytest.mark.parametrize("args,want", SDPA_GATE)
def test_sdpa_gate_decision_table(args, want):
    dev, s_q, s_k, hd, mask, p, grad = args
    q = _t(dev, (1, s_q, 2, hd), grad)
    k = _t(dev, (1, s_k, 2, hd))
    assert flash_eligible(q, k, mask, p) is want
    if grad:
        with torch.no_grad():  # nor does recording none
            assert flash_eligible(q, k, mask, p) is want


def test_sdpa_gate_is_closed_for_cpu_tensors():
    q = torch.zeros(1, 4096, 1, 64)
    assert not flash_eligible(q, q)


# -- the GPT gate ------------------------------------------------------------
def _attn(hidden=128, heads=2, dropout=0.0):
    cfg = tgpt.GPTConfig(vocab_size=97, hidden_size=hidden, num_layers=1,
                         num_heads=heads, max_position=8, dropout=dropout)
    return tgpt.ParallelAttention(cfg)


# (hidden, heads, dropout, training, S, mask, device, x grad, no_grad) ->
# flash?
GPT_GATE = [
    ((128, 2, 0.0, False, 4096, None, "cuda", False, True), True),
    ((768, 12, 0.0, False, 8192, None, "cuda", False, True), True),
    ((1024, 8, 0.0, False, 4096, None, "cuda", False, True), True),
    ((2048, 8, 0.0, False, 4096, None, "cuda", False, True), True),
    ((128, 2, 0.0, False, 4096, None, "cpu", False, True), False),
    ((128, 2, 0.0, False, 2048, None, "cuda", False, True), False),
    ((128, 2, 0.0, False, 4100, None, "cuda", False, True), False),
    ((96, 2, 0.0, False, 4096, None, "cuda", False, True), False),
    ((128, 2, 0.0, False, 4096, "mask", "cuda", False, True), False),
    ((128, 2, 0.1, False, 4096, None, "cuda", False, True), True),
    ((128, 2, 0.1, True, 4096, None, "cuda", False, True), False),
    ((128, 2, 0.0, True, 4096, None, "cuda", False, True), True),
    # grad enabled: the parameters need a gradient (training); the flash
    # route is differentiable, so the gate opens as in JAX
    ((128, 2, 0.0, True, 4096, None, "cuda", False, False), True),
    ((128, 2, 0.0, False, 4096, None, "cuda", True, False), True),
]


@pytest.mark.parametrize("args,want", GPT_GATE)
def test_gpt_gate_decision_table(args, want):
    hidden, heads, p, training, S, mask, dev, xgrad, no_grad = args
    attn = _attn(hidden, heads, p).train(training)
    x = _t(dev, (1, S, hidden), xgrad)
    if no_grad:
        with torch.no_grad():
            assert attn._use_flash(S, mask, x) is want
    else:
        assert attn._use_flash(S, mask, x) is want


def test_gpt_gate_opens_without_parameter_gradients():
    attn = _attn().requires_grad_(False)
    assert attn._use_flash(4096, None, _t("cuda", (1, 4096, 128)))


# -- a narrow GPT through the flash route -------------------------------------
NARROW = dict(vocab_size=97, hidden_size=128, num_layers=2, num_heads=2,
              max_position=256, dropout=0.0)


@pytest.fixture(scope="module")
def narrow_pair():
    jpt.seed(5)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny(**NARROW))
    arrays = {k: np.asarray(p.value) for k, p in jm.named_parameters()}
    tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(**NARROW), device="cpu")
    load_jax_params(tm, arrays)
    ids = np.random.RandomState(8).randint(0, 97, size=(2, 256))
    return jm, tm, ids


@pytest.fixture
def gates_open(monkeypatch):
    """Both packages' GPT gates forced open (the tests only: here the
    backend is no TPU and the tensors lie on no card); the port's flash
    calls counted."""
    calls = []

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return flash_attention(*a, **kw)

    monkeypatch.setattr(jgpt.ParallelAttention, "_use_flash",
                        lambda self, S, attn_mask: True)
    monkeypatch.setattr(tgpt.ParallelAttention, "_use_flash",
                        lambda self, S, attn_mask, x: True)
    monkeypatch.setattr(tgpt, "flash_attention", counted)
    return calls


def test_narrow_gpt_flash_route_matches_jax_pallas(narrow_pair, gates_open):
    jm, tm, ids = narrow_pair
    jm.eval()
    tm.eval()
    want = np.asarray(jm(jnp.asarray(ids, jnp.int32)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    assert gates_open == [(2, 2, 256, 64)] * 2  # one call a layer
    np.testing.assert_allclose(got.numpy(), want, **FLASH)


def test_narrow_gpt_eval_batch_loss_matches_jax(narrow_pair, gates_open):
    jm, tm, ids = narrow_pair
    jl, _ = jpt.Model(jm, ["x"], ["y"]).prepare(loss=jm.loss).eval_batch(
        [ids], [ids])
    tl, _ = tpt.Model(tm, ["x"], ["y"]).prepare(loss=tm.loss).eval_batch(
        [ids], [ids])
    assert len(gates_open) == 2
    assert tl == pytest.approx(jl, rel=1e-5)
    preds = tpt.Model(tm).predict_batch([ids])
    assert preds.shape == (2, 256, 97) and len(gates_open) == 4


def test_flash_and_dense_routes_agree_in_the_port(narrow_pair, gates_open):
    _, tm, ids = narrow_pair
    tm.eval()
    with torch.no_grad():
        flash = tm(torch.from_numpy(ids))
    gates_open.clear()
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgpt.ParallelAttention, "_use_flash",
                   lambda self, S, attn_mask, x: False)
        dense = tm(torch.from_numpy(ids))
    assert gates_open == []
    torch.testing.assert_close(flash, dense, rtol=1e-4, atol=1e-5)


TRAIN_STEPS, TRAIN_LR = 2, 1e-3


def _key_bias(name, p):
    """Mask of the key third of an attention ``qkv.bias`` (else None): its
    gradient is zero in exact arithmetic (the softmax cancels a bias shared
    by a row's scores), so Adam moves it by rounding noise normalized to up
    to lr a step, in both frameworks alike."""
    if not name.endswith("attn.qkv.bias"):
        return None
    d = p.shape[0] // 3
    mask = np.zeros(p.shape, bool)
    mask[d:2 * d] = True
    return mask


def test_narrow_gpt_train_batch_through_flash_matches_jax(gates_open,
                                                          monkeypatch):
    """Two ``train_batch`` steps of ``AdamW(1e-3, weight_decay=0.01,
    multi_precision=True)`` with both gates open: JAX through its Pallas
    forward and backward kernels (interpret mode), the port through the
    plain flash forward and ``flash_attention_bwd_ref`` (each counted).
    Losses at rtol 1e-5; every parameter after step 2 within 1e-4 (f32
    gradients summed in other orders, normalized by Adam), the key bias
    within its lr bound (see ``_key_bias``)."""
    from paddle_tpu import optimizer as jopt

    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    bwd_ref = fa.flash_attention_bwd_ref
    bwd_calls = []

    def counted_bwd(*a, **kw):
        bwd_calls.append(tuple(a[0].shape))
        return bwd_ref(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention_bwd_ref", counted_bwd)
    jpt.seed(7)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny(**NARROW))
    init = {k: np.asarray(p.value) for k, p in jm.named_parameters()}
    tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(**NARROW), device="cpu")
    load_jax_params(tm, init)
    jmodel = jpt.Model(jm, ["x"], ["y"]).prepare(
        optimizer=jopt.AdamW(TRAIN_LR, weight_decay=0.01,
                             multi_precision=True), loss=jm.loss)
    tmodel = tpt.Model(tm, ["x"], ["y"]).prepare(
        optimizer=tpt.optimizer.AdamW(TRAIN_LR, weight_decay=0.01,
                                      multi_precision=True), loss=tm.loss)
    rng = np.random.RandomState(12)
    jl, tl = [], []
    for _ in range(TRAIN_STEPS):
        ids = rng.randint(0, 97, size=(2, 256))
        jl.append(jmodel.train_batch([ids], [ids])[0])
        tl.append(tmodel.train_batch([ids], [ids])[0])
    calls = TRAIN_STEPS * NARROW["num_layers"]
    assert gates_open == [(2, 2, 256, 64)] * calls
    assert bwd_calls == [(2, 2, 256, 64)] * calls
    assert all(np.isfinite(tl))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[1] != tl[0]
    jparams = {k: np.asarray(p.value) for k, p in jm.named_parameters()}
    for name, p in tm.named_parameters():
        got, want = p.detach().numpy(), jparams[name]
        key = _key_bias(name, got)
        if key is not None:
            start = init[name][key]
            for moved in (got[key], want[key]):
                assert np.abs(moved - start).max() <= \
                    TRAIN_STEPS * TRAIN_LR * 1.01
            got, want = got[~key], want[~key]
        np.testing.assert_allclose(got, want, err_msg=name, rtol=0,
                                   atol=1e-4)


# -- layernorm_residual at any width -----------------------------------------
@pytest.mark.parametrize("D", [1024, 1536])
@pytest.mark.parametrize("fn", [layernorm_residual, layernorm_residual_ref],
                         ids=["autograd_function", "plain"])
def test_wide_layernorm_residual_matches_jax(D, fn):
    rng = np.random.RandomState(D)
    x, r, ds, dy = (rng.randn(10, D).astype(np.float32) for _ in range(4))
    g = (1 + 0.1 * rng.randn(D)).astype(np.float32)
    b = (0.1 * rng.randn(D)).astype(np.float32)
    (js, jy), vjp = jax.vjp(
        lambda *a: jax_layernorm_residual(*a, block_m=8),
        *(jnp.asarray(a) for a in (x, r, g, b)))
    jgrads = vjp((jnp.asarray(ds), jnp.asarray(dy)))
    args = [torch.tensor(a, requires_grad=True) for a in (x, r, g, b)]
    s, y = fn(*args)
    grads = torch.autograd.grad([s, y], args, [torch.from_numpy(ds),
                                              torch.from_numpy(dy)])
    for name, a, w in zip(("s", "y", "dx", "dr", "dg", "db"),
                          (s, y, *grads), (js, jy, *jgrads)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [1024, 1536])
def test_wide_layernorm_backward_ref_matches_jax(D, dtype):
    """The plain backward at the wide widths (D = 1024: the backward
    kernel's widest row; 1536: past it, where the card runs this
    arithmetic) against ``jax.vjp`` of the JAX op."""
    rng = np.random.RandomState(D + 1)
    x, r, ds, dy = (rng.randn(10, D).astype(np.float32) for _ in range(4))
    g = (1 + 0.1 * rng.randn(D)).astype(np.float32)
    b = (0.1 * rng.randn(D)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda *a: jax_layernorm_residual(*a, block_m=8),
                     *(jnp.asarray(a, jdt) for a in (x, r, g, b)))
    jdx, _, jdg, jdb = (np.asarray(t, np.float32) for t in vjp(
        (jnp.asarray(ds, jdt), jnp.asarray(dy, jdt))))
    gt, bt = torch.tensor(g, dtype=tdt), torch.tensor(b, dtype=tdt)
    s, _, mean, rstd = fl._forward_ref(torch.tensor(x, dtype=tdt),
                                       torch.tensor(r, dtype=tdt), gt, bt,
                                       1e-5)
    got = fl._backward_ref(s, mean, rstd, gt, torch.tensor(ds, dtype=tdt),
                           torch.tensor(dy, dtype=tdt))
    assert fl._backward_plan(tdt, D, True) == ("vector" if D <= 1024
                                               else "plain")
    for name, a, w in zip(("ds", "dg", "db"), got, (jdx, jdg, jdb)):
        scale = 1.0 if dtype == "float32" else max(1.0, float(
            np.abs(w).max()))
        tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
               else dict(rtol=2e-2, atol=2e-2))
        np.testing.assert_allclose(a.float().numpy() / scale, w / scale,
                                   err_msg=name, **tol)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [1024, 1536])
def test_wide_layernorm_backward_on_card(dtype, D):
    """Phase W's [2048, 1024] through the backward kernel (one count, two
    calls bit-equal); D = 1536 through the plain arithmetic on the card,
    counting nothing."""
    dev = _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(D + 2)
    x, r, dy, ds = (torch.randn(2048, D, generator=gen).to(dev, dt)
                    for _ in range(4))
    g = (1 + 0.1 * torch.randn(D, generator=gen)).to(dev, dt)
    b = (0.1 * torch.randn(D, generator=gen)).to(dev, dt)
    s, _, mean, rstd = fl._forward_kernel(x, r, g, b, 1e-5)
    before = layernorm_residual.backward_launches
    got = fl._backward_kernel(s, mean, rstd, g, ds, dy)
    again = fl._backward_kernel(s, mean, rstd, g, ds, dy)
    want = fl._backward_ref(s, mean, rstd, g, ds, dy)
    torch.cuda.synchronize()
    assert layernorm_residual.backward_launches == before + (
        2 if D <= fl.MAX_REGISTER_FEATURES else 0)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    for a, a2, w in zip(got, again, want):
        assert torch.equal(a, a2)
        scale = max(1.0, float(w.float().abs().max()))
        torch.testing.assert_close(a.float() / scale, w.float() / scale,
                                   **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [769, 1024, 1536, 8192])
def test_wide_layernorm_kernel_matches_plain_on_card(dtype, D):
    dev = _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(D)
    x, r = (torch.randn(1000, D, generator=gen).to(dev, dt) for _ in range(2))
    g = (1 + 0.1 * torch.randn(D, generator=gen)).to(dev, dt)
    b = (0.1 * torch.randn(D, generator=gen)).to(dev, dt)
    before = layernorm_residual.launches
    got = fl._forward_kernel(x, r, g, b, 1e-5)
    want = fl._forward_ref(x, r, g, b, 1e-5)
    torch.cuda.synchronize()
    assert layernorm_residual.launches == before + 1
    assert torch.equal(got[0], want[0])
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    torch.testing.assert_close(got[1], want[1], **tol)
    for a, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_wide_gpt_and_bert_forward_and_train_on_card():
    """hidden 1024: a GPT-medium-width GPT and a BERT-large-width BERT
    (2 layers each) run forward and a train_batch on the card."""
    from paddle_tpu_torch.models import bert as tbert

    dev = _card()
    gpt = tgpt.GPTForCausalLM(tgpt.gpt_small(hidden_size=1024, num_heads=16,
                                             num_layers=2))
    ids = np.random.RandomState(0).randint(0, 50304, size=(2, 64))
    m = tpt.Model(gpt).prepare(optimizer=tpt.optimizer.AdamW(
        1e-4, multi_precision=True), loss=gpt.loss)
    before = layernorm_residual.launches
    loss, _ = m.train_batch([ids], [ids])
    assert np.isfinite(loss) and layernorm_residual.launches == before + 2
    bert = tbert.BertForPretraining(tbert.BertConfig(
        hidden_size=1024, num_layers=2, num_heads=16,
        intermediate_size=4096))
    with torch.no_grad():
        out = bert.bert(torch.as_tensor(ids[:, :32], device=dev) % 30522)
    assert torch.isfinite(out[0]).all()


# -- paged attention: the JAX gate, the gather path, wide kernels -------------
@pytest.mark.parametrize("hd", [8, 12, 16, 64, 100, 320, 512])
@pytest.mark.parametrize("page", [4, 8, 12, 16, 1024])
def test_paged_gate_mirrors_jax(hd, page):
    assert paged_flash_eligible(hd, page) == jax_paged_flash_eligible(
        hd, page, backend="tpu")


@pytest.mark.parametrize("hidden,heads,page", [(48, 4, 8), (64, 4, 12)],
                         ids=["head_dim_12", "page_12"])
def test_forward_paged_off_gate_gathers_like_jax(hidden, heads, page,
                                                 monkeypatch):
    """Off the gate ``forward_paged`` takes the gather-then-attend path —
    every row, padding rows' uniform softmax included, as JAX's — and
    never the paged kernel."""
    cfg = dict(vocab_size=61, hidden_size=hidden, num_layers=2,
               num_heads=heads, max_position=64)
    jpt.seed(9)
    jm = jgpt.GPTForCausalLM(jgpt.gpt_tiny(**cfg))
    tm = tgpt.GPTForCausalLM(tgpt.gpt_tiny(**cfg), device="cpu")
    load_jax_params(tm, {k: np.asarray(p.value)
                         for k, p in jm.named_parameters()})

    def no_kernel(*a, **kw):
        raise AssertionError("the paged kernel ran off the gate")

    monkeypatch.setattr(tgpt, "paged_flash_decode", no_kernel)
    rng = np.random.RandomState(2)
    table = np.array([[2, -1, -1], [0, 4, -1]], np.int32)
    lens = [5, 2 * page - 3]
    T = lens[1]
    ids = np.zeros((2, T), np.int32)
    pos = np.full((2, T), -1, np.int32)
    pos_map = np.full((2, 3 * page), -1, np.int32)
    for b, n in enumerate(lens):
        ids[b, :n] = rng.randint(0, 61, size=n)
        pos[b, :n] = np.arange(n)
        pos_map[b, :n] = np.arange(n)
    want, _ = jm.forward_paged(jnp.asarray(ids), jnp.asarray(pos),
                               jnp.asarray(pos_map), jnp.asarray(table),
                               jm.gpt.init_paged_cache(6, page))
    with torch.no_grad():
        got, _ = tm.forward_paged(
            torch.from_numpy(ids), torch.from_numpy(pos),
            torch.from_numpy(pos_map), torch.from_numpy(table),
            tm.gpt.init_paged_cache(6, page))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DENSE)


def _paged_case(dev, hd, page, G, T=3, B=2, H=2):
    gen = torch.Generator().manual_seed(hd + page)
    P = B * G
    lengths = [G * page - 1 - 37 * b for b in range(B)]
    tables = torch.full((B, G), -1, dtype=torch.int32)
    perm = torch.randperm(P, generator=gen).tolist()
    nxt = 0
    for b in range(B):
        for g in range(-(-lengths[b] // page)):
            tables[b, g] = perm[nxt]
            nxt += 1
    kp = torch.arange(G * page)
    mask = torch.zeros(B, T, G * page, dtype=torch.bool)
    for b in range(B):
        mapped = (tables[b] >= 0).repeat_interleave(page)
        for t in range(T):
            mask[b, t] = mapped & (kp <= lengths[b] - T + t)
    q = torch.randn(B, H, T, hd, generator=gen)
    pools = [torch.randn(P + 1, H, page, hd, generator=gen) for _ in "kv"]
    return (q.to(dev), *(p.to(dev) for p in pools),
            tables.clamp_min(0).to(dev), mask.to(dev))


def _quantized_pools(k_pool, v_pool, qdt):
    """Pools as ``forward_paged`` writes them: codes and one scale per
    stored token per head."""
    P1, H, page, hd = k_pool.shape
    out = []
    for pool in (k_pool, v_pool):
        codes, sc = tgpt._quantize_kv(
            pool.permute(0, 2, 1, 3).reshape(-1, H, hd), qdt)
        out += [codes.reshape(P1, page, H, hd).permute(0, 2, 1, 3)
                .contiguous(),
                sc.reshape(P1, page, H).permute(0, 2, 1).contiguous()]
    return out[0], out[2], out[1], out[3]


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype,pool", [("float32", None),
                                         ("float32", "int8"),
                                         ("float32", "fp8"),
                                         ("bfloat16", None),
                                         ("bfloat16", "int8"),
                                         ("bfloat16", "fp8")])
@pytest.mark.parametrize("hd,page,G", [(320, 16, 8), (512, 16, 4),
                                       (64, 1024, 2), (128, 1024, 2)])
def test_paged_kernel_wide_heads_and_large_pages_on_card(hd, page, G, qdtype,
                                                         pool):
    """Every (q dtype, pool) pair of the chunked instance; bf16 q rounds
    the same float32 result to bf16 on both sides (one ulp apart)."""
    dev = _card()
    q, k_pool, v_pool, tables, mask = _paged_case(dev, hd, page, G)
    dt = getattr(torch, qdtype)
    if pool is None:
        kv = (k_pool.to(dt), v_pool.to(dt), None, None)
    else:
        kv = _quantized_pools(k_pool, v_pool, dict(
            int8=torch.int8, fp8=torch.float8_e4m3fn)[pool])
    args = (q.to(dt), kv[0], kv[1], tables, mask, kv[2], kv[3])
    before = paged_flash_decode.launches
    out = paged_flash_decode(*args)
    ref = paged_flash_decode_ref(*args)
    torch.cuda.synchronize()
    assert paged_flash_decode.launches == before + 1
    tol = (dict(rtol=1e-4, atol=2e-5) if qdtype == "float32"
           else dict(rtol=1e-2, atol=1e-5))
    torch.testing.assert_close(out, ref, **tol)


# -- the fp8-cast guard -------------------------------------------------------
def test_fp8_model_cast_to_a_float_dtype_raises():
    """``Module.to(dtype)`` casts e4m3 weight codes (and their scales) to
    floats; the parallel linears then refuse to run on them."""
    m = tgpt.GPTForCausalLM(tgpt.gpt_tiny(), device="cpu")
    quantize_weights(m, "fp8")
    ids = torch.randint(0, 128, (1, 8))
    with torch.no_grad():
        assert torch.isfinite(m(ids)).all()
        m.to(torch.bfloat16)
        assert m.gpt.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
        with pytest.raises(InvalidArgumentError, match="weight_scale"):
            m(ids)
