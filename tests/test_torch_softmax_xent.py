"""Port of the fused softmax cross-entropy kernel (paddle_tpu_torch/ops).

The port's ``softmax_cross_entropy`` (its ``autograd.Function`` on the CPU
takes the plain arithmetic) and ``softmax_cross_entropy_ref`` are held
against the JAX package's ``softmax_cross_entropy``, whose Pallas kernel
runs in interpret mode on the CPU with explicit ``block_m=8`` /
``block_v=128``: per-row losses and the logits gradient.  Vocabularies of
200 and 130 (not multiples of the 128-wide block), labels at 0 and V-1,
an out-of-range label (-1: it contributes no logit, loss = lse, and no -1
in the gradient; the Pallas kernel gives that for any label outside its
padded vocabulary, while one inside the padding [V, Vp) picks the -inf
fill), bf16 logits.  f32 at rtol/atol 1e-5; bf16 logits are read
as bf16 and computed in f32 on both sides, so they compare at 1e-5 too.
The CUDA kernel is compared with the plain version only where a card is
present (``gpu`` marker).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.fused_softmax_xent import (
    softmax_cross_entropy as jax_softmax_cross_entropy)
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.ops import fused_softmax_xent as sx
from paddle_tpu_torch.ops.fused_softmax_xent import (
    softmax_cross_entropy, softmax_cross_entropy_ref)

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, M, V, out_of_range=True):
    rng = np.random.RandomState(seed)
    logits = (3.0 * rng.randn(M, V)).astype(np.float32)
    labels = rng.randint(0, V, size=M).astype(np.int32)
    labels[0], labels[1] = 0, V - 1
    if out_of_range:
        labels[2] = -1
    g = rng.rand(M).astype(np.float32)
    return logits, labels, g


def _jax(logits, labels, g, dtype):
    x = jnp.asarray(logits, dtype)
    loss, vjp = jax.vjp(
        lambda a: jax_softmax_cross_entropy(a, jnp.asarray(labels),
                                            block_m=8, block_v=128), x)
    (dx,) = vjp(jnp.asarray(g))
    return np.asarray(loss), np.asarray(dx, np.float32)


def _torch(fn, logits, labels, g, dtype):
    x = torch.tensor(logits, dtype=dtype, requires_grad=True)
    loss = fn(x, torch.from_numpy(labels).long())
    (dx,) = torch.autograd.grad(loss, x, torch.from_numpy(g))
    return loss.detach().numpy(), dx.float().numpy()


FNS = pytest.mark.parametrize(
    "fn", [softmax_cross_entropy, softmax_cross_entropy_ref],
    ids=["autograd_function", "plain"])


@FNS
@pytest.mark.parametrize("V", [200, 130])
def test_loss_and_grad_match_jax_f32(fn, V):
    inp = _inputs(V, 21, V)
    want_loss, want_dx = _jax(*inp, jnp.float32)
    got_loss, got_dx = _torch(fn, *inp, torch.float32)
    assert got_loss.dtype == np.float32
    np.testing.assert_allclose(got_loss, want_loss, **TOL)
    np.testing.assert_allclose(got_dx, want_dx, **TOL)


@FNS
def test_loss_and_grad_match_jax_bf16_logits(fn):
    inp = _inputs(7, 12, 200)
    want_loss, want_dx = _jax(*inp, jnp.bfloat16)
    got_loss, got_dx = _torch(fn, *inp, torch.bfloat16)
    np.testing.assert_allclose(got_loss, want_loss, **TOL)
    # the gradient is rounded to bf16 on both sides
    np.testing.assert_allclose(got_dx, want_dx, rtol=1e-2, atol=1e-3)


def test_out_of_range_label_gives_lse_and_no_onehot():
    logits, labels, g = _inputs(3, 4, 130)
    x = torch.tensor(logits, requires_grad=True)
    loss = softmax_cross_entropy(x, torch.from_numpy(labels))
    lse = torch.logsumexp(torch.from_numpy(logits), -1)
    torch.testing.assert_close(loss[2], lse[2], rtol=1e-6, atol=1e-6)
    (dx,) = torch.autograd.grad(loss.sum(), x)
    torch.testing.assert_close(dx[2], torch.softmax(x[2].detach(), -1))


def test_leading_dims_and_integer_label_dtypes():
    logits, labels, _ = _inputs(4, 12, 200, out_of_range=False)
    x = torch.from_numpy(logits).reshape(3, 4, 200)
    for lab in (torch.from_numpy(labels), torch.from_numpy(labels).long()):
        got = softmax_cross_entropy(x, lab.reshape(3, 4))
        assert got.shape == (3, 4) and got.dtype == torch.float32
        want = torch.nn.functional.cross_entropy(
            torch.from_numpy(logits), lab.long(), reduction="none")
        torch.testing.assert_close(got.reshape(-1), want)


def test_cpu_tensors_take_the_plain_version_uncounted():
    logits, labels, _ = _inputs(5, 9, 130)
    before = softmax_cross_entropy.launches
    x, lab = torch.from_numpy(logits), torch.from_numpy(labels)
    torch.testing.assert_close(softmax_cross_entropy(x, lab),
                               softmax_cross_entropy_ref(x, lab), rtol=0,
                               atol=0)
    assert softmax_cross_entropy.launches == before


def test_rejects_mismatched_shapes_and_float_labels():
    logits, labels, _ = _inputs(6, 9, 130)
    x = torch.from_numpy(logits)
    with pytest.raises(InvalidArgumentError):
        softmax_cross_entropy(x, torch.from_numpy(labels[:4]))
    with pytest.raises(InvalidArgumentError):
        softmax_cross_entropy(x, torch.from_numpy(labels).float())


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,M,V", [("bfloat16", 5120, 30522),
                                       ("float32", 8184, 50304),
                                       ("float32", 37, 130)])
def test_kernel_matches_plain_on_card(dtype, M, V):
    """At BERT-base's MLM (bf16) and GPT-small's LM (f32) path shapes and
    a small ragged vocabulary: loss and lse against the plain version,
    and the gradient through the autograd.Function against autograd of
    the plain version."""
    dev = _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(V)
    x = (3 * torch.randn(M, V, generator=gen)).to(dev, dt)
    lab = torch.randint(0, V, (M,), generator=gen)
    lab[0], lab[1], lab[2] = 0, V - 1, V + 3
    lab = lab.to(dev)
    before = softmax_cross_entropy.launches
    loss, lse = sx._forward_kernel(x, lab)
    loss0, lse0 = sx._forward_ref(x, lab)
    torch.cuda.synchronize()
    assert softmax_cross_entropy.launches == before + 1
    torch.testing.assert_close(loss, loss0, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(lse, lse0, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(loss[2], lse[2], rtol=0, atol=0)
    g = torch.rand(M, generator=gen).to(dev)
    grads = []
    for fn in (softmax_cross_entropy, softmax_cross_entropy_ref):
        xx = x.clone().requires_grad_()
        (d,) = torch.autograd.grad(fn(xx, lab), xx, g)
        grads.append(d.float())
    # bf16: both round the f32 gradient once, so at most one ulp apart
    tol = (dict(rtol=1e-4, atol=1e-6) if dtype == "float32"
           else dict(rtol=1e-2, atol=1e-5))
    torch.testing.assert_close(grads[0], grads[1], **tol)


@pytest.mark.gpu
def test_kernel_rejects_non_contiguous_logits():
    dev = _card()
    x = torch.randn(8, 300, device=dev)[:, :200]
    with pytest.raises(InvalidArgumentError, match="contiguous"):
        sx._forward_kernel(x, torch.zeros(8, dtype=torch.long, device=dev))
