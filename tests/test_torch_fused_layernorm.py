"""Port of the fused residual-add + LayerNorm kernel (paddle_tpu_torch/ops).

The port's ``layernorm_residual`` (its ``autograd.Function`` on the CPU
takes the plain arithmetic) and ``layernorm_residual_ref`` are held
against the JAX package's ``layernorm_residual``, whose Pallas kernel runs
in interpret mode on the CPU with an explicit ``block_m`` as
tests/test_autotune.py runs it: the forward ``(s, y)`` and the VJP
(dx, dr, dg, db through ``jax.vjp`` against ``torch.autograd.grad``).
Inputs are numpy arrays from a seed.  f32 at rtol/atol 1e-5 (both sides
take float32 statistics; they differ only in summation order); bf16 at
2e-2 (outputs round to 8 mantissa bits).  The CUDA kernel is compared
with the plain version only where a card is present (``gpu`` marker).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.fused_layernorm import (
    layernorm_residual as jax_layernorm_residual)
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.ops import fused_layernorm as fl
from paddle_tpu_torch.ops.fused_layernorm import (layernorm_residual,
                                                  layernorm_residual_ref)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _inputs(seed, shape=(3, 7, 32), dtype=np.float32):
    """x, r, g, b and the cotangents ds, dy; 21 rows: not a multiple of
    the JAX kernel's 8-row block."""
    rng = np.random.RandomState(seed)
    D = shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    r = (2.0 * rng.randn(*shape) + 0.5).astype(np.float32)
    g = (1.0 + 0.1 * rng.randn(D)).astype(np.float32)
    b = (0.1 * rng.randn(D)).astype(np.float32)
    ds = rng.randn(*shape).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    return x, r, g, b, ds, dy


def _jax(x, r, g, b, ds, dy, dtype, eps):
    args = [jnp.asarray(a, dtype) for a in (x, r, g, b)]
    (s, y), vjp = jax.vjp(
        lambda *a: jax_layernorm_residual(*a, epsilon=eps, block_m=8), *args)
    grads = vjp((jnp.asarray(ds, dtype), jnp.asarray(dy, dtype)))
    return [np.asarray(t, np.float32) for t in (s, y, *grads)]


def _torch(fn, x, r, g, b, ds, dy, dtype, eps):
    args = [torch.tensor(a, dtype=dtype, requires_grad=True)
            for a in (x, r, g, b)]
    s, y = fn(*args, epsilon=eps)
    grads = torch.autograd.grad(
        [s, y], args, [torch.tensor(ds, dtype=dtype),
                       torch.tensor(dy, dtype=dtype)])
    return [t.detach().float().numpy() for t in (s, y, *grads)]


@pytest.mark.parametrize("fn", [layernorm_residual, layernorm_residual_ref],
                         ids=["autograd_function", "plain"])
@pytest.mark.parametrize("eps", [1e-5, 1e-12])  # GPT's, BERT's
def test_forward_and_vjp_match_jax_f32(fn, eps):
    inp = _inputs(0)
    want = _jax(*inp, jnp.float32, eps)
    got = _torch(fn, *inp, torch.float32, eps)
    for name, a, w in zip(("s", "y", "dx", "dr", "dg", "db"), got, want):
        np.testing.assert_allclose(a, w, err_msg=name, **F32)


@pytest.mark.parametrize("fn", [layernorm_residual, layernorm_residual_ref],
                         ids=["autograd_function", "plain"])
def test_forward_and_vjp_match_jax_bf16(fn):
    inp = _inputs(1, shape=(5, 13, 64))
    want = _jax(*inp, jnp.bfloat16, 1e-5)
    got = _torch(fn, *inp, torch.bfloat16, 1e-5)
    # the rounded sum is exact in both (one f32 add, one rounding)
    np.testing.assert_array_equal(got[0], want[0])
    for name, a, w in zip(("y", "dx", "dr", "dg", "db"), got[1:], want[1:]):
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(a / scale, w / scale, err_msg=name,
                                   **BF16)


def test_normalizes_the_rounded_sum():
    """bf16: y is LayerNorm of s AS ROUNDED, not of the exact f32 sum."""
    x, r, g, b, _, _ = _inputs(2, shape=(16, 64))
    xt, rt, gt, bt = (torch.tensor(a, dtype=torch.bfloat16)
                      for a in (x, r, g, b))
    s, y = layernorm_residual(xt, rt, gt, bt)
    want = torch.nn.functional.layer_norm(
        s.float(), (64,), gt.float(), bt.float(), 1e-5).to(torch.bfloat16)
    torch.testing.assert_close(y, want, rtol=0, atol=0)


def test_only_y_used_backward_matches_plain():
    """Post-LN blocks (BERT) use only y: the s cotangent is absent."""
    x, r, g, b, _, dy = _inputs(3)
    grads = []
    for fn in (layernorm_residual, layernorm_residual_ref):
        args = [torch.tensor(a, requires_grad=True) for a in (x, r, g, b)]
        _, y = fn(*args)
        grads.append(torch.autograd.grad(y, args, torch.tensor(dy)))
    for a, w in zip(*grads):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-6)


def test_only_s_used_backward_passes_the_cotangent_through():
    x, r, g, b, ds, _ = _inputs(4)
    args = [torch.tensor(a, requires_grad=True) for a in (x, r, g, b)]
    s, _ = layernorm_residual(*args)
    dx, dr, dg, db = torch.autograd.grad(s, args, torch.tensor(ds),
                                         allow_unused=True)
    np.testing.assert_array_equal(dx.numpy(), ds)
    np.testing.assert_array_equal(dr.numpy(), ds)
    assert dg is None and db is None


def test_cpu_tensors_take_the_plain_version_uncounted():
    x, r, g, b, _, _ = _inputs(5)
    before = layernorm_residual.launches
    got = layernorm_residual(*(torch.from_numpy(a) for a in (x, r, g, b)))
    want = layernorm_residual_ref(*(torch.from_numpy(a)
                                    for a in (x, r, g, b)))
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    assert layernorm_residual.launches == before


def test_rejects_mismatched_shapes():
    x, r, g, b, _, _ = _inputs(6)
    xt, rt, gt, bt = (torch.from_numpy(a) for a in (x, r, g, b))
    with pytest.raises(InvalidArgumentError):
        layernorm_residual(xt, rt[:, :3], gt, bt)
    with pytest.raises(InvalidArgumentError):
        layernorm_residual(xt, rt, gt[:5], bt)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,M,D", [("bfloat16", 32768, 768),
                                       ("float32", 8192, 768),
                                       ("float32", 1000, 100)])
def test_kernel_matches_plain_on_card(dtype, M, D):
    """At BERT-base's (bf16) and GPT-small's (f32) path shapes, and a
    ragged D: s exactly equal, y / mean / rstd and the gradients through
    the autograd.Function against autograd of the plain version."""
    dev = _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(M)
    x, r = (torch.randn(M, D, generator=gen).to(dev, dt) for _ in range(2))
    g = (1 + 0.1 * torch.randn(D, generator=gen)).to(dev, dt)
    b = (0.1 * torch.randn(D, generator=gen)).to(dev, dt)
    before = layernorm_residual.launches
    s, y, mean, rstd = fl._forward_kernel(x, r, g, b, 1e-5)
    s0, y0, mean0, rstd0 = fl._forward_ref(x, r, g, b, 1e-5)
    torch.cuda.synchronize()
    assert layernorm_residual.launches == before + 1
    assert torch.equal(s, s0)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    torch.testing.assert_close(y, y0, **tol)
    torch.testing.assert_close(mean, mean0, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rstd, rstd0, rtol=1e-5, atol=1e-5)
    dy = torch.randn(M, D, generator=gen).to(dev, dt)
    grads = []
    for fn in (layernorm_residual, layernorm_residual_ref):
        args = [t.clone().requires_grad_() for t in (x, r, g, b)]
        _, yy = fn(*args)
        grads.append(torch.autograd.grad(yy, args, dy))
    for a, w in zip(*grads):
        scale = max(1.0, float(w.float().abs().max()))
        torch.testing.assert_close(a.float() / scale, w.float() / scale,
                                   **tol)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take():
    dev = _card()
    D = fl.MAX_WIDE_FEATURES + 8
    x = torch.randn(4, D, device=dev)
    g = torch.ones(D, device=dev)
    with pytest.raises(InvalidArgumentError, match="feature dim"):
        layernorm_residual(x, x, g, g)
    x = torch.randn(4, 64, device=dev)
    with pytest.raises(InvalidArgumentError, match="dtype|float32"):
        layernorm_residual(x, x, torch.ones(64, device=dev,
                                            dtype=torch.bfloat16),
                           torch.zeros(64, device=dev))
