"""Port of the fused residual-add + LayerNorm kernel (paddle_tpu_torch/ops).

The port's ``layernorm_residual`` (its ``autograd.Function`` on the CPU
takes the plain arithmetic) and ``layernorm_residual_ref`` are held
against the JAX package's ``layernorm_residual``, whose Pallas kernel runs
in interpret mode on the CPU with an explicit ``block_m`` as
tests/test_autotune.py runs it: the forward ``(s, y)`` and the VJP
(dx, dr, dg, db through ``jax.vjp`` against ``torch.autograd.grad``), and
the plain backward ``_backward_ref`` alone against ``jax.vjp`` in both
cotangent cases.  Inputs are numpy arrays from a seed.  f32 at rtol/atol
1e-5 (both sides take float32 statistics; they differ only in summation
order); bf16 at 2e-2 (outputs round to 8 mantissa bits), gradients
scaled by their largest magnitude.  The designs' plan tables are checked
here; the CUDA kernels (the Hopper forward and backward, the first
designs) are compared with the plain versions only where a card is
present (``gpu`` marker).

Mixed dtypes (what amp hands the op): x in bf16 or fp16 with the residual
and weight / bias each in x's dtype or float32.  The plain version and the
autograd Function are held against the JAX op in interpret mode: s
exactly, y and the gradients at the bf16 tolerance (fp16: 1e-2, its
rounding); x's and the residual's cotangents are ``ds`` rounded to x's
dtype in both packages (JAX hands a float32 residual that bf16 value,
autograd the same value in float32 — pinned exactly), the weight's and
bias's come back in their own dtype.  Any other mix raises, on the CPU
plan tables too.
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
# the card's kernel against the plain version on the same float16 inputs:
# both round float32 arithmetic once, one float16 step (2^-10 of the value)
# apart at most; 2e-3 holds two and fails a y rounded through bf16
F16_CARD = dict(rtol=2e-3, atol=2e-3)


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


@pytest.mark.parametrize("case", ["s_and_y", "y_only"])
@pytest.mark.parametrize("eps", [1e-5, 1e-12])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_ref_matches_jax_vjp(dtype, eps, case):
    """``_backward_ref`` (the CPU path and the kernel's yardstick) against
    ``jax.vjp`` of the JAX op: ds against dx (= dr), dg, db; with the s
    cotangent (pre-LN, GPT) and without it (post-LN, BERT: JAX sees
    zeros)."""
    x, r, g, b, ds_np, dy_np = _inputs(7, shape=(5, 13, 64))
    if case == "y_only":
        ds_np = np.zeros_like(ds_np)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, _, dx, dr, dg, db = _jax(x, r, g, b, ds_np, dy_np, jdt, eps)
    x2, r2 = (torch.tensor(a, dtype=tdt).reshape(-1, 64) for a in (x, r))
    gt, bt = torch.tensor(g, dtype=tdt), torch.tensor(b, dtype=tdt)
    s, _, mean, rstd = fl._forward_ref(x2, r2, gt, bt, eps)
    ds_out = (None if case == "y_only"
              else torch.tensor(ds_np, dtype=tdt).reshape(-1, 64))
    got = fl._backward_ref(s, mean, rstd, gt, ds_out,
                           torch.tensor(dy_np, dtype=tdt).reshape(-1, 64))
    np.testing.assert_array_equal(dx, dr)
    for name, a, w in zip(("ds", "dg", "db"), got,
                          (dx.reshape(-1, 64), dg, db)):
        assert a.dtype == tdt, name
        a = a.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(a, w, err_msg=name, **F32)
        else:
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(a / scale, w / scale, err_msg=name,
                                       **BF16)


@pytest.mark.parametrize("dtype,D,aligned,want", [
    ("bfloat16", 768, True, "vector"),     # BERT-base, long context
    ("float32", 768, True, "vector"),      # GPT-small
    ("float32", 1024, True, "vector"),     # phase W's hidden-1024 GPT
    ("bfloat16", 1024, True, "vector"),
    ("bfloat16", 8, True, "vector"),
    ("float32", 100, True, "vector"),      # 25 vectors
    ("bfloat16", 100, True, "first"),      # not whole 8-value vectors
    ("float32", 769, True, "first"),
    ("float32", 768, False, "first"),      # a misaligned tensor
    ("bfloat16", 1032, True, "first"),     # past the registers: wide
    ("float32", 1536, True, "first"),
])
def test_forward_plan_table(dtype, D, aligned, want):
    assert fl._forward_plan(getattr(torch, dtype), D, aligned) == want


@pytest.mark.parametrize("dtype,D,aligned,want", [
    ("bfloat16", 768, True, "vector"),
    ("float32", 768, True, "vector"),
    ("float32", 1024, True, "vector"),
    ("bfloat16", 1024, True, "vector"),
    ("float32", 100, True, "vector"),
    ("bfloat16", 100, True, "scalar"),
    ("float32", 769, True, "scalar"),
    ("bfloat16", 768, False, "scalar"),
    ("float32", 1, True, "scalar"),
    ("bfloat16", 1032, True, "plain"),     # no launch: the plain arithmetic
    ("float32", 8192, True, "plain"),
])
def test_backward_plan_table(dtype, D, aligned, want):
    assert fl._backward_plan(getattr(torch, dtype), D, aligned) == want


@pytest.mark.parametrize("D,want", [(1, 8), (256, 8), (257, 16), (512, 16),
                                    (768, 24), (769, 32), (1024, 32)])
def test_values_a_lane_cover_the_row(D, want):
    assert fl._vpl(D) == want and 32 * want >= D


@pytest.mark.parametrize("case", ["s_and_y", "y_only", "s_only"])
def test_cpu_tensors_never_count_forward_or_backward_launches(case):
    x, r, g, b, ds, dy = _inputs(8)
    before = (layernorm_residual.launches,
              layernorm_residual.backward_launches)
    args = [torch.tensor(a, requires_grad=True) for a in (x, r, g, b)]
    s, y = layernorm_residual(*args)
    outs, cts = {"s_and_y": ([s, y], [ds, dy]), "y_only": ([y], [dy]),
                 "s_only": ([s], [ds])}[case]
    torch.autograd.grad(outs, args, [torch.from_numpy(c) for c in cts],
                        allow_unused=True)
    assert (layernorm_residual.launches,
            layernorm_residual.backward_launches) == before


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _card_inputs(dev, dtype, M, D, seed):
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(seed)
    x, r, dy, ds = (torch.randn(M, D, generator=gen).to(dev, dt)
                    for _ in range(4))
    g = (1 + 0.1 * torch.randn(D, generator=gen)).to(dev, dt)
    b = (0.1 * torch.randn(D, generator=gen)).to(dev, dt)
    return x, r, g, b, dy, ds


def _hold_backward(s, mean, rstd, g, ds_out, dy, tol, design=None):
    """The backward kernel against ``_backward_ref`` on the same card
    tensors: ds within ``tol``, dg / db scaled by their largest magnitude;
    a second call bit-equal; one launch counted a call."""
    before = layernorm_residual.backward_launches
    got = fl._backward_kernel(s, mean, rstd, g, ds_out, dy, design=design)
    again = fl._backward_kernel(s, mean, rstd, g, ds_out, dy, design=design)
    want = fl._backward_ref(s, mean, rstd, g, ds_out, dy)
    torch.cuda.synchronize()
    assert layernorm_residual.backward_launches == before + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b), "two backward calls differ"
    torch.testing.assert_close(got[0], want[0], **tol)
    for a, w in zip(got[1:], want[1:]):
        assert a.dtype == w.dtype
        scale = max(1.0, float(w.float().abs().max()))
        torch.testing.assert_close(a.float() / scale, w.float() / scale,
                                   **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,M,D", [("bfloat16", 32768, 768),   # BERT
                                       ("float32", 8192, 768),     # GPT
                                       ("bfloat16", 16384, 768),   # long
                                       ("float32", 2048, 1024),    # W
                                       ("bfloat16", 2048, 1024)])
def test_hopper_designs_match_plain_on_card(dtype, M, D):
    """The Hopper forward (s exact, y / mean / rstd within tolerance) and
    the backward with and without the s cotangent, at the main paths'
    shapes (chip_smoke.py phases 6 and W)."""
    dev = _card()
    x, r, g, b, dy, ds = _card_inputs(dev, dtype, M, D, M + D)
    assert fl._forward_plan(x.dtype, D, True) == "vector"
    got = fl._forward_kernel(x, r, g, b, 1e-5)
    want = fl._forward_ref(x, r, g, b, 1e-5)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    torch.testing.assert_close(got[1], want[1], **tol)
    for a, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    s, _, mean, rstd = got
    for ds_out in (ds, None):
        _hold_backward(s, mean, rstd, g, ds_out, dy, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,M,D,offset", [
    ("bfloat16", 1000, 100, 0),    # D not whole vectors: first / scalar
    ("float32", 1000, 769, 0),
    ("float32", 999, 768, 1),      # misaligned by one element
    ("bfloat16", 333, 1024, 3),
    ("float32", 5, 1, 0)])
def test_first_designs_take_odd_and_misaligned_rows_on_card(dtype, M, D,
                                                            offset):
    dev = _card()
    x, r, g, b, dy, ds = _card_inputs(dev, dtype, M, D, 7 * M + D)
    if offset:  # contiguous views that start off the 16-byte grid
        x, r, dy, ds = (torch.cat([t.new_zeros(offset), t.flatten()])[
            offset:].view(M, D) for t in (x, r, dy, ds))
        assert x.data_ptr() % 16 != 0
    aligned = offset == 0
    assert fl._forward_plan(x.dtype, D, aligned) == "first"
    assert fl._backward_plan(x.dtype, D, aligned) == "scalar"
    got = fl._forward_kernel(x, r, g, b, 1e-5)
    want = fl._forward_ref(x, r, g, b, 1e-5)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    torch.testing.assert_close(got[1], want[1], **tol)
    s, _, mean, rstd = want
    for ds_out in (ds, None):
        _hold_backward(s, mean, rstd, g, ds_out, dy, tol)
    # the Hopper forward refuses what its plan does not give it
    with pytest.raises(InvalidArgumentError, match="design"):
        fl._forward_kernel(x, r, g, b, 1e-5, design="vector")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,M,D", [("bfloat16", 32768, 768),
                                       ("float32", 8192, 768),
                                       ("float32", 2048, 1024)])
def test_forced_first_and_scalar_designs_match_plain_on_card(dtype, M, D):
    """The first forward design and the backward's element layout, forced
    at shapes the plan gives the Hopper design."""
    dev = _card()
    x, r, g, b, dy, ds = _card_inputs(dev, dtype, M, D, 3 * M + D)
    got = fl._forward_kernel(x, r, g, b, 1e-5, design="first")
    want = fl._forward_ref(x, r, g, b, 1e-5)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == "float32"
           else dict(rtol=2e-2, atol=2e-2))
    torch.testing.assert_close(got[1], want[1], **tol)
    s, _, mean, rstd = want
    _hold_backward(s, mean, rstd, g, ds, dy, tol, design="scalar")


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


# (x, residual, weight / bias) dtypes amp hands the op
MIXES = [("bfloat16", "float32", "float32"), ("bfloat16", "bfloat16",
                                              "float32"),
         ("bfloat16", "float32", "bfloat16"), ("float16", "float32",
                                               "float32"),
         ("float16", "float16", "float32"), ("float16", "float16",
                                             "float16")]


def _mixed_jax(x, r, g, b, ds, dy, dts, eps):
    jdt = [getattr(jnp, d) for d in dts]
    args = [jnp.asarray(x, jdt[0]), jnp.asarray(r, jdt[1]),
            jnp.asarray(g, jdt[2]), jnp.asarray(b, jdt[2])]
    (s, y), vjp = jax.vjp(
        lambda *a: jax_layernorm_residual(*a, epsilon=eps, block_m=8), *args)
    grads = vjp((jnp.asarray(ds, jdt[0]), jnp.asarray(dy, jdt[0])))
    return (s, y, *grads)


@pytest.mark.parametrize("fn", [layernorm_residual, layernorm_residual_ref],
                         ids=["autograd_function", "plain"])
@pytest.mark.parametrize("dts", MIXES, ids=["-".join(m) for m in MIXES])
def test_mixed_dtypes_match_jax(fn, dts):
    x, r, g, b, ds, dy = _inputs(9, shape=(5, 13, 64))
    want = _mixed_jax(x, r, g, b, ds, dy, dts, 1e-12)
    tdt = [getattr(torch, d) for d in dts]
    args = [torch.tensor(a, dtype=dt, requires_grad=True)
            for a, dt in zip((x, r, g, b), tdt[:2] + [tdt[2]] * 2)]
    s, y = fn(*args, epsilon=1e-12)
    grads = torch.autograd.grad([s, y], args,
                                [torch.tensor(ds, dtype=tdt[0]),
                                 torch.tensor(dy, dtype=tdt[0])])
    got = (s, y, *grads)
    # output dtypes: s, y and dx in x's; dr in r's; dg, db in weight's
    want_dt = [tdt[0], tdt[0], tdt[0], tdt[1], tdt[2], tdt[2]]
    assert [t.dtype for t in got] == want_dt
    assert str(want[3].dtype) == dts[0]  # JAX: dr in x's dtype
    # the residual's cotangent is x's, exactly (upcast where r is f32)
    assert torch.equal(grads[1], grads[0].to(tdt[1]))
    np.testing.assert_array_equal(s.detach().float().numpy(),
                                  np.asarray(want[0], np.float32))
    tol = BF16 if dts[0] == "bfloat16" else dict(rtol=1e-2, atol=1e-2)
    for name, a, w in zip(("y", "dx", "dr", "dg", "db"), got[1:], want[1:]):
        a = a.detach().float().numpy()
        w = np.asarray(w, np.float32)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(a / scale, w / scale, err_msg=name, **tol)


@pytest.mark.parametrize("dts,D,aligned,want", [
    (("bfloat16", "float32", "float32"), 768, True, "vector"),   # amp O1
    (("bfloat16", "bfloat16", "float32"), 768, True, "vector"),
    (("float16", "float32", "float32"), 768, True, "vector"),
    (("float16", "float16", "float16"), 1024, True, "vector"),
    (("bfloat16", "float32", "float32"), 768, False, "first"),
    (("float16", "float32", "float32"), 100, True, "first"),
    (("bfloat16", "float32", "bfloat16"), 1536, True, "first"),
])
def test_forward_plan_table_mixed(dts, D, aligned, want):
    assert fl._forward_plan(tuple(getattr(torch, d) for d in dts), D,
                            aligned) == want


@pytest.mark.parametrize("dts,D,aligned,want", [
    (("bfloat16", "float32"), 768, True, "vector"),
    (("float16", "float32"), 768, True, "vector"),
    (("float16", "float16"), 768, True, "vector"),
    (("bfloat16", "float32"), 100, True, "scalar"),
    (("float16", "float32"), 768, False, "scalar"),
    (("bfloat16", "float32"), 1032, True, "plain"),
])
def test_backward_plan_table_mixed(dts, D, aligned, want):
    assert fl._backward_plan(tuple(getattr(torch, d) for d in dts), D,
                             aligned) == want


@pytest.mark.parametrize("dts", [
    ("float32", "bfloat16", "float32"),    # an f32 x takes f32 only
    ("float32", "float32", "float16"),
    ("bfloat16", "float16", "float32"),    # residual neither x's nor f32
    ("float16", "float16", "bfloat16"),
    ("float64", "float64", "float64"),
])
def test_plans_refuse_other_mixes(dts):
    dt = tuple(getattr(torch, d) for d in dts)
    with pytest.raises(InvalidArgumentError, match="layernorm_residual"):
        fl._forward_plan(dt, 768, True)
    if dts[2] in (dts[0], "float32") and dts[0] != "float64":
        return  # the backward reads no residual: (x, weight) is a mix it takes
    with pytest.raises(InvalidArgumentError, match="layernorm_residual"):
        fl._backward_plan((dt[0], dt[2]), 768, True)


def _mixed_card_inputs(dev, dts, M, D, seed):
    x, r, g, b, dy, ds = _card_inputs(dev, "float32", M, D, seed)
    dt = [getattr(torch, d) for d in dts]
    return (x.to(dt[0]), r.to(dt[1]), g.to(dt[2]), b.to(dt[2]),
            dy.to(dt[0]), ds.to(dt[0]))


@pytest.mark.gpu
@pytest.mark.parametrize("M,D", [(32768, 768), (1000, 100), (333, 1024),
                                 (64, 1536)])
@pytest.mark.parametrize("dts", MIXES, ids=["-".join(m) for m in MIXES])
def test_mixed_dtype_kernels_match_plain_on_card(dts, M, D):
    """Every design of the forward (the planned one and the first one)
    and of the backward (the planned layout and the element layout, with
    and without the s cotangent) at each mix: s exact, y within the x
    dtype's tolerance, ds / dg / db as in the single-dtype tests."""
    dev = _card()
    x, r, g, b, dy, ds = _mixed_card_inputs(dev, dts, M, D, M + D)
    want = fl._forward_ref(x, r, g, b, 1e-12)
    tol = BF16 if dts[0] == "bfloat16" else F16_CARD
    for design in (None, "first"):
        got = fl._forward_kernel(x, r, g, b, 1e-12, design=design)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]), design
        torch.testing.assert_close(got[1], want[1], **tol)
        for a, w in zip(got[2:], want[2:]):
            torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    s, _, mean, rstd = want
    # rows wider than the registers: the plain backward, nothing to hold
    plan = fl._backward_plan((s.dtype, g.dtype), D, True)
    for design in (() if plan == "plain" else (None, "scalar")):
        for ds_out in (ds, None):
            _hold_backward(s, mean, rstd, g, ds_out, dy, tol, design=design)


@pytest.mark.parametrize("dts", [m for m in MIXES if m[0] == "float16"],
                         ids=lambda m: "-".join(m))
def test_float16_card_tolerance_holds_one_step_and_fails_bf16_rounding(dts):
    """The float16 tolerance that chip_smoke.py's phase F1 and the card
    tests hold the kernel to: y computed in float64 and rounded once
    (one float16 step from the plain version's float32 arithmetic) passes
    it, the plain version's y rounded through bf16 fails it."""
    import chip_smoke

    assert chip_smoke.ln_tol("float16") == F16_CARD
    rng = np.random.RandomState(14)
    M, D = 4096, 768
    dt = [getattr(torch, d) for d in dts]
    x, r = (torch.tensor(rng.randn(M, D).astype(np.float32)) for _ in "xr")
    g = torch.tensor((1 + 0.1 * rng.randn(D)).astype(np.float32))
    b = torch.tensor((0.1 * rng.randn(D)).astype(np.float32))
    x, r, g, b = x.to(dt[0]), r.to(dt[1]), g.to(dt[2]), b.to(dt[2])
    s, y, _, _ = fl._forward_ref(x, r, g, b, 1e-12)
    sd = s.double()
    c = sd - sd.mean(-1, keepdim=True)
    y64 = (c * torch.rsqrt((c * c).mean(-1, keepdim=True) + 1e-12)
           * g.double() + b.double()).to(y.dtype)
    assert not torch.equal(y64, y)  # some elements one step apart
    torch.testing.assert_close(y64, y, **F16_CARD)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(y.to(torch.bfloat16).to(y.dtype), y,
                                   **F16_CARD)
