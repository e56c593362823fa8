"""Port of the vision ops and of the fused 1x1-conv + BatchNorm kernels
(``paddle_tpu_torch.nn.functional`` conv / pooling / norm and
``paddle_tpu_torch.ops.fused_conv1x1_bn``).

Every input is a numpy array from a seed, fed to the JAX function and to
its port:

* ``conv2d`` (NCHW and NHWC; int, per-dim, ``2n`` asymmetric and
  ``"SAME"`` / ``"VALID"`` padding; stride, dilation, groups),
  ``max_pool2d`` (-inf padding, ``ceil_mode``), ``adaptive_avg_pool2d``
  (even and uneven splits) and ``batch_norm`` (the float32 two-pass and the
  bf16 one-pass statistics, train and eval, the running statistics and
  their dtype) against the JAX package's functional ops.  float32 at rtol
  1e-5 / atol 1e-5 (the two frameworks sum in other orders); bf16 results
  at 2e-2 (8 mantissa bits).
* the port's plain ``conv1x1_bn_stats``, ``bn_apply_relu`` and
  ``conv1x1_bn_relu`` (the CPU path of each) against the JAX Pallas
  kernels in interpret mode, at ragged M and N: outputs, column sums, the
  unbiased running variance.
* the tail's gradients (the port's ``autograd.Function``, closed-form
  backward) against ``jax.grad`` of the JAX PLAIN tail
  ``relu(bn(conv1x1(x)) + identity)`` in train mode — the Pallas kernels
  have no VJP — in float32 at rtol 1e-4 (one-pass against two-pass
  variance, and other summation orders).

The wrappers' plan functions (which design a shape, dtype and weight
layout takes; that ResNet's transposed weight reaches the Hopper design
with no copy) are checked on the CPU.  The CUDA kernels are held against
the plain versions only where a card is present (``gpu`` marker): the four
conv3 shapes of ResNet-50 at batch 128, in both designs of each kernel, and
the Hopper stats design at ragged M and N, in both weight layouts.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.nn import functional as JF
from paddle_tpu.ops import fused_conv1x1_bn as jfcb
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import fused_conv1x1_bn as fcb

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _jnp(a, dtype=np.float32):
    return jnp.asarray(a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16"
                       else a)


def _tt(a, dtype=np.float32):
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


# -- conv2d --------------------------------------------------------------------
CONV_CASES = {  # name: (data_format, x shape, w shape, kwargs)
    "nchw_int_pad": ("NCHW", (2, 3, 9, 9), (4, 3, 3, 3),
                     dict(padding=1, stride=2)),
    "nhwc_int_pad": ("NHWC", (2, 9, 9, 3), (4, 3, 3, 3),
                     dict(padding=1, stride=2)),
    "nhwc_per_dim": ("NHWC", (2, 8, 10, 4), (6, 4, 3, 5),
                     dict(padding=[1, 2], stride=[1, 2])),
    "nhwc_asymmetric": ("NHWC", (2, 8, 8, 12), (8, 12, 4, 4),
                        dict(padding=[2, 1, 2, 1])),
    "nchw_asymmetric": ("NCHW", (2, 12, 8, 8), (8, 12, 4, 4),
                        dict(padding=[2, 1, 2, 1])),
    "nhwc_groups_dilation": ("NHWC", (2, 11, 11, 8), (8, 2, 3, 3),
                             dict(padding=2, dilation=2, groups=4)),
    "nchw_same_stride": ("NCHW", (1, 3, 10, 11), (5, 3, 3, 3),
                         dict(padding="SAME", stride=2)),
    "nhwc_valid": ("NHWC", (1, 10, 11, 3), (5, 3, 4, 2),
                   dict(padding="VALID", stride=[2, 3])),
    "nhwc_1x1_bias": ("NHWC", (2, 5, 5, 16), (32, 16, 1, 1),
                      dict(bias=True)),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv2d_matches_jax(case):
    fmt, xs, ws, kw = CONV_CASES[case]
    kw = dict(kw)
    rng = np.random.RandomState(list(CONV_CASES).index(case))
    x = rng.randn(*xs).astype(np.float32)
    w = rng.randn(*ws).astype(np.float32)
    b = rng.randn(ws[0]).astype(np.float32) if kw.pop("bias", False) else None
    want = JF.conv2d(jnp.asarray(x), jnp.asarray(w),
                     None if b is None else jnp.asarray(b), data_format=fmt,
                     **kw)
    got = TF.conv2d(_tt(x), _tt(w), None if b is None else _tt(b),
                    data_format=fmt, **kw)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-4)


def test_conv2d_nhwc_stays_channels_last_without_copies():
    x = torch.randn(2, 6, 6, 8)
    out = TF.conv2d(x, torch.randn(16, 8, 3, 3), padding=1,
                    data_format="NHWC")
    assert out.shape == (2, 6, 6, 16) and out.is_contiguous()


def test_conv2d_bf16_weights_cast_a_float_input():
    rng = np.random.RandomState(9)
    x = rng.randn(1, 6, 6, 3).astype(np.float32)
    w = rng.randn(4, 3, 3, 3).astype(np.float32)
    want = JF.conv2d(jnp.asarray(x), _jnp(w, "bfloat16"), padding=1,
                     data_format="NHWC")
    got = TF.conv2d(_tt(x), _tt(w, "bfloat16"), padding=1,
                    data_format="NHWC")
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


def test_conv2d_rejects_unknown_padding_and_format():
    x, w = torch.randn(1, 3, 4, 4), torch.randn(2, 3, 1, 1)
    with pytest.raises(InvalidArgumentError):
        TF.conv2d(x, w, padding="FULL")
    with pytest.raises(InvalidArgumentError):
        TF.conv2d(x, w, data_format="NDHWC")


# -- pooling -------------------------------------------------------------------
POOL_CASES = {  # name: (data_format, x shape, kwargs)
    "resnet_stem_nhwc": ("NHWC", (2, 16, 16, 4),
                         dict(kernel_size=3, stride=2, padding=1)),
    "resnet_stem_nchw": ("NCHW", (2, 4, 15, 15),
                         dict(kernel_size=3, stride=2, padding=1)),
    "ceil_mode": ("NCHW", (1, 2, 10, 11),
                  dict(kernel_size=3, stride=2, padding=0, ceil_mode=True)),
    "ceil_mode_nhwc_padded": ("NHWC", (1, 9, 12, 3),
                              dict(kernel_size=[2, 3], stride=[2, 2],
                                   padding=1, ceil_mode=True)),
    "no_stride": ("NHWC", (1, 7, 7, 2), dict(kernel_size=2)),
}


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_max_pool2d_matches_jax(case):
    fmt, xs, kw = POOL_CASES[case]
    x = np.random.RandomState(len(case)).randn(*xs).astype(np.float32)
    want = JF.max_pool2d(jnp.asarray(x), data_format=fmt, **kw)
    got = TF.max_pool2d(_tt(x), data_format=fmt, **kw)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_max_pool2d_return_mask_is_not_ported():
    """``return_mask`` is ported now: the mask is JAX's flat index into
    the unpadded plane (unique window maxima: a seeded permutation)."""
    x = np.random.RandomState(3).permutation(32).reshape(
        1, 2, 4, 4).astype(np.float32)
    want, wmask = JF.max_pool2d(jnp.asarray(x), 3, 2, 1, return_mask=True)
    got, mask = TF.max_pool2d(_tt(x), 3, 2, 1, return_mask=True)
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt,xs,size", [
    ("NHWC", (2, 7, 7, 16), (1, 1)),     # ResNet's head: even split
    ("NCHW", (2, 3, 8, 6), (4, 3)),      # even
    ("NCHW", (2, 3, 7, 5), (3, 2)),      # uneven windows
    ("NHWC", (1, 9, 10, 2), (4, None)),  # uneven, one dim kept
])
def test_adaptive_avg_pool2d_matches_jax(fmt, xs, size, dtype):
    x = np.random.RandomState(xs[2]).randn(*xs).astype(np.float32)
    want = JF.adaptive_avg_pool2d(_jnp(x, dtype), size, data_format=fmt)
    got = TF.adaptive_avg_pool2d(_tt(x, dtype), size, data_format=fmt)
    assert tuple(got.shape) == tuple(want.shape)
    assert got.dtype == _tt(x, dtype).dtype
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if dtype == "float32" else BF16))


# -- batch_norm ----------------------------------------------------------------
@pytest.mark.parametrize("stat_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("fmt", ["NHWC", "NCHW"])
def test_batch_norm_matches_jax(fmt, training, dtype, stat_dtype):
    rng = np.random.RandomState(7)
    C = 6
    shape = (4, 5, 3, C) if fmt == "NHWC" else (4, C, 5, 3)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    rm = (0.1 * rng.randn(C)).astype(np.float32)
    rv = (1 + 0.1 * rng.rand(C)).astype(np.float32)
    g = (1 + 0.1 * rng.randn(C)).astype(np.float32)
    b = (0.1 * rng.randn(C)).astype(np.float32)
    want = JF.batch_norm(_jnp(x, dtype), _jnp(rm, stat_dtype),
                         _jnp(rv, stat_dtype), _jnp(g, dtype), _jnp(b, dtype),
                         training=training, momentum=0.9, epsilon=1e-5,
                         data_format=fmt)
    got = TF.batch_norm(_tt(x, dtype), _tt(rm, stat_dtype),
                        _tt(rv, stat_dtype), _tt(g, dtype), _tt(b, dtype),
                        training=training, momentum=0.9, epsilon=1e-5,
                        data_format=fmt)
    tol = F32 if dtype == "float32" else BF16
    if not training:
        assert isinstance(got, torch.Tensor)
        np.testing.assert_allclose(_np(got), _np(want), **tol)
        return
    (out, nm, nv), (jout, jnm, jnv) = got, want
    assert out.dtype == _tt(x, dtype).dtype
    # the new running stats keep the declared dtype
    assert nm.dtype == nv.dtype == _tt(rm, stat_dtype).dtype
    assert jnm.dtype == (jnp.bfloat16 if stat_dtype == "bfloat16"
                         else jnp.float32)
    np.testing.assert_allclose(_np(out), _np(jout), **tol)
    stat_tol = F32 if stat_dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(nm), _np(jnm), **stat_tol)
    np.testing.assert_allclose(_np(nv), _np(jnv), **stat_tol)


@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_bf16_fold_rounds_like_jax(training):
    """bf16: scale and shift are computed in float32 and cast once, then
    ``x·scale + shift`` runs in bf16 — the same roundings as the JAX
    package, so the outputs agree bit for bit (a float32 fold rounded
    once at the end would not)."""
    rng = np.random.RandomState(7)
    C = 64
    x = (rng.randn(8, 5, 3, C) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.randn(C)).astype(np.float32)
    b = (0.1 * rng.randn(C)).astype(np.float32)
    rm, rv = np.zeros(C, np.float32), np.ones(C, np.float32)
    want = JF.batch_norm(_jnp(x, "bfloat16"), jnp.asarray(rm),
                         jnp.asarray(rv), _jnp(g, "bfloat16"),
                         _jnp(b, "bfloat16"), training=training,
                         data_format="NHWC")
    got = TF.batch_norm(_tt(x, "bfloat16"), _tt(rm), _tt(rv),
                        _tt(g, "bfloat16"), _tt(b, "bfloat16"),
                        training=training, data_format="NHWC")
    if training:
        want, got = want[0], got[0]
    np.testing.assert_array_equal(_np(got), _np(want))


def test_batch_norm_stores_the_biased_variance_with_paddle_momentum():
    x = torch.tensor([[1.0], [2.0], [3.0], [6.0]])   # [N, C] with C = 1
    out, nm, nv = TF.batch_norm(x, torch.zeros(1), torch.ones(1),
                                training=True, momentum=0.9,
                                data_format="NLC")
    batch_var = float(((x - 3.0) ** 2).mean())       # biased: 3.5
    assert float(nm) == pytest.approx(0.1 * 3.0)
    assert float(nv) == pytest.approx(0.9 + 0.1 * batch_var)
    assert float(out.mean()) == pytest.approx(0.0, abs=1e-6)


# -- the fused 1x1-conv + BN kernels' plain versions ---------------------------
def _tail_inputs(seed, M, K, N):
    rng = np.random.RandomState(seed)
    return (np.maximum(rng.randn(M, K), 0).astype(np.float32),
            (rng.randn(K, N) * np.sqrt(2.0 / K)).astype(np.float32),
            (1 + 0.1 * rng.randn(N)).astype(np.float32),
            (0.1 * rng.randn(N)).astype(np.float32),
            rng.randn(M, N).astype(np.float32))


@pytest.mark.parametrize("M,K,N", [(256, 64, 128), (77, 64, 200),
                                   (100, 40, 256)])
def test_conv1x1_bn_stats_plain_matches_pallas(M, K, N):
    x, w, _, _, _ = _tail_inputs(M, M, K, N)
    jy, js, jq = jfcb.conv1x1_bn_stats(jnp.asarray(x), jnp.asarray(w),
                                       block_m=64, block_n=128)
    for fn in (fcb.conv1x1_bn_stats, fcb.conv1x1_bn_stats_ref):
        y, s, q = fn(_tt(x), _tt(w))
        assert s.dtype == q.dtype == torch.float32
        np.testing.assert_allclose(_np(y), _np(jy), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(s), _np(js), rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(_np(q), _np(jq), rtol=1e-5, atol=1e-3)


def test_conv1x1_bn_stats_bf16_takes_stats_before_rounding():
    x, w, _, _, _ = _tail_inputs(3, 96, 64, 128)
    y, s, q = fcb.conv1x1_bn_stats(_tt(x, "bfloat16"), _tt(w, "bfloat16"))
    jy, js, jq = jfcb.conv1x1_bn_stats(_jnp(x, "bfloat16"),
                                       _jnp(w, "bfloat16"), block_m=32,
                                       block_n=128)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    yf = _tt(x, "bfloat16").float() @ _tt(w, "bfloat16").float()
    # the stats are the float32 product's, not the rounded y's
    np.testing.assert_allclose(_np(s), _np(yf.sum(0)), rtol=1e-6, atol=1e-4)
    assert not torch.equal(s, y.float().sum(0))
    np.testing.assert_allclose(_np(y), _np(jy), **BF16)
    np.testing.assert_allclose(_np(s), _np(js), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(_np(q), _np(jq), rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("M,N", [(64, 128), (77, 200)])
def test_bn_apply_relu_plain_matches_pallas(M, N, residual):
    rng = np.random.RandomState(M + N)
    y = rng.randn(M, N).astype(np.float32)
    sc = (1 + 0.1 * rng.randn(N)).astype(np.float32)
    sh = (0.1 * rng.randn(N)).astype(np.float32)
    r = rng.randn(M, N).astype(np.float32) if residual else None
    want = jfcb.bn_apply_relu(jnp.asarray(y), jnp.asarray(sc),
                              jnp.asarray(sh),
                              None if r is None else jnp.asarray(r),
                              block_m=32, block_n=128)
    for fn in (fcb.bn_apply_relu, fcb.bn_apply_relu_ref):
        got = fn(_tt(y), _tt(sc), _tt(sh), None if r is None else _tt(r))
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
        assert float(got.min()) == 0.0


@pytest.mark.parametrize("M,K,N", [(128, 64, 256), (77, 32, 200)])
def test_conv1x1_bn_relu_plain_matches_pallas(M, K, N):
    x, w, g, b, r = _tail_inputs(M + 1, M, K, N)
    rng = np.random.RandomState(5)
    rm = (0.1 * rng.randn(N)).astype(np.float32)
    rv = (1 + 0.1 * rng.rand(N)).astype(np.float32)
    want = jfcb.conv1x1_bn_relu(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(g), jnp.asarray(b),
        epsilon=1e-5, residual=jnp.asarray(r), momentum=0.9,
        running_mean=jnp.asarray(rm), running_var=jnp.asarray(rv),
        fused_epilogue=True, block_m=64, block_n=128)
    for fn in (fcb.conv1x1_bn_relu, fcb.conv1x1_bn_relu_ref):
        out, nm, nv = fn(_tt(x), _tt(w), _tt(g), _tt(b), epsilon=1e-5,
                         residual=_tt(r), momentum=0.9, running_mean=_tt(rm),
                         running_var=_tt(rv))
        np.testing.assert_allclose(_np(out), _np(want[0]), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(_np(nm), _np(want[1]), **F32)
        np.testing.assert_allclose(_np(nv), _np(want[2]), **F32)
    # the unbiased batch variance went into the running variance
    yf = _tt(x) @ _tt(w)
    unbiased = yf.var(0, correction=1)
    np.testing.assert_allclose(_np(nv), 0.9 * rv + 0.1 * _np(unbiased),
                               rtol=1e-4, atol=1e-5)


def test_conv1x1_bn_relu_running_stats_together_or_not_at_all():
    x, w, g, b, _ = (_tt(a) for a in _tail_inputs(0, 16, 8, 128))
    out, nm, nv = fcb.conv1x1_bn_relu(x, w, g, b)
    assert nm is None and nv is None and out.shape == (16, 128)
    with pytest.raises(InvalidArgumentError):
        fcb.conv1x1_bn_relu(x, w, g, b, running_mean=torch.zeros(128))


def _jax_plain_tail(x, w_oihw, g, b, r):
    """The JAX package's plain tail in train mode, NHWC:
    relu(batch_norm(conv2d_1x1(x)) + r)."""
    y = JF.conv2d(x, w_oihw, data_format="NHWC")
    out, _, _ = JF.batch_norm(y, jnp.zeros(w_oihw.shape[0]),
                              jnp.ones(w_oihw.shape[0]), g, b, training=True,
                              momentum=0.9, epsilon=1e-5, data_format="NHWC")
    return jax.nn.relu(out + r)


@pytest.mark.parametrize("shape", [(2, 6, 5, 32, 128), (3, 4, 4, 64, 256)])
def test_tail_gradients_match_jax_grad_of_the_plain_tail(shape):
    n, h, wd, cin, cout = shape
    M = n * h * wd
    x, w, g, b, r = _tail_inputs(cin, M, cin, cout)
    w_oihw = np.ascontiguousarray(w.T).reshape(cout, cin, 1, 1)
    dout = np.random.RandomState(11).randn(M, cout).astype(np.float32)
    x4, r4 = x.reshape(n, h, wd, cin), r.reshape(n, h, wd, cout)

    def loss(*a):
        return jnp.sum(_jax_plain_tail(*a) * dout.reshape(n, h, wd, cout))

    jargs = [jnp.asarray(a) for a in (x4, w_oihw, g, b, r4)]
    jout = _jax_plain_tail(*jargs)
    jgrads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*jargs)

    targs = [_tt(a).requires_grad_() for a in (x4, w_oihw, g, b, r4)]
    tx, tw, tg, tb, tr = targs
    out, _, _ = fcb.conv1x1_bn_relu(
        tx.reshape(M, cin), tw.reshape(cout, cin).t(), tg, tb,
        residual=tr.reshape(M, cout))
    tgrads = torch.autograd.grad(out, targs, _tt(dout))
    np.testing.assert_allclose(_np(out), _np(jout).reshape(M, cout),
                               rtol=1e-4, atol=1e-5)
    for name, a, want in zip(("dx", "dw", "dgamma", "dbeta", "dresidual"),
                             tgrads, jgrads):
        assert tuple(a.shape) == tuple(want.shape), name
        np.testing.assert_allclose(_np(a), _np(want), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=name)


def test_cpu_tensors_take_the_plain_versions_uncounted():
    x, w, g, b, r = (_tt(a) for a in _tail_inputs(1, 32, 16, 128))
    before = (fcb.conv1x1_bn_stats.launches, fcb.bn_apply_relu.launches)
    fcb.conv1x1_bn_relu(x, w, g, b, residual=r)
    got = fcb.bn_apply_relu(x @ w, g, b, r)
    assert torch.equal(got, fcb.bn_apply_relu_ref(x @ w, g, b, r))
    assert (fcb.conv1x1_bn_stats.launches,
            fcb.bn_apply_relu.launches) == before


def test_wrappers_reject_mismatches():
    x, w = torch.randn(8, 4), torch.randn(5, 16)
    with pytest.raises(InvalidArgumentError, match="shape mismatch"):
        fcb.conv1x1_bn_stats(x, w)
    with pytest.raises(InvalidArgumentError, match="dtype|float"):
        fcb.conv1x1_bn_stats(x, torch.randn(4, 16, dtype=torch.float64))
    y = torch.randn(8, 16)
    with pytest.raises(InvalidArgumentError, match="channels"):
        fcb.bn_apply_relu(y, torch.ones(8), torch.zeros(16))
    with pytest.raises(InvalidArgumentError, match="residual"):
        fcb.bn_apply_relu(y, torch.ones(16), torch.zeros(16), y[:4])


def test_gate_opens_only_for_cuda_activations_and_lane_channels():
    cpu = torch.zeros(2, 2)
    assert not fcb.fused_epilogues_eligible(256, cpu)
    if torch.cuda.is_available():
        card = cpu.cuda()
        assert fcb.fused_epilogues_eligible(256, card)
        assert not fcb.fused_epilogues_eligible(200, card)


# -- which design a call takes ------------------------------------------------
RESNET_TAILS = [(401408, 64, 256), (100352, 128, 512), (25088, 256, 1024),
                (6272, 512, 2048)]


def _weight(K, N, dtype, form):
    """A [K, N] weight as the caller holds it: ``"kn"`` contiguous, ``"t"``
    the .t() view of a contiguous [N, K] (ResNet's conv3 weight),
    ``"sliced"`` a column slice of a wider contiguous weight."""
    if form == "kn":
        return torch.zeros(K, N, dtype=dtype)
    if form == "t":
        return torch.zeros(N, K, dtype=dtype).t()
    return torch.zeros(K, N + 8, dtype=dtype)[:, :N]


@pytest.mark.parametrize("dtype,K,N,form,want", [
    *[("bfloat16", K, N, "t", ("wgmma", "k-major"))
      for _, K, N in RESNET_TAILS],
    *[("bfloat16", K, N, "kn", ("wgmma", "mn-major"))
      for _, K, N in RESNET_TAILS],
    ("bfloat16", 64, 136, "t", ("wgmma", "k-major")),    # N % 128 != 0
    ("bfloat16", 64, 200, "kn", ("wgmma", "mn-major")),  # R1's ragged N
    ("bfloat16", 256, 1024, "sliced", ("wgmma", "copy")),
    ("bfloat16", 100, 130, "kn", ("first", "mn-major")),  # K, N % 8 != 0
    ("bfloat16", 64, 196, "t", ("first", "copy")),        # N % 8 != 0
    ("bfloat16", 100, 256, "t", ("first", "copy")),       # K % 8 != 0
    ("float32", 256, 1024, "kn", ("first", "mn-major")),
    ("float32", 256, 1024, "t", ("first", "copy")),
])
def test_stats_plan_picks_the_design_by_shape_dtype_and_layout(dtype, K, N,
                                                               form, want):
    dt = getattr(torch, dtype)
    x = torch.zeros(8, K, dtype=dt)
    assert fcb._stats_plan(x, _weight(K, N, dt, form)) == want


def test_stats_plan_sends_an_unaligned_x_to_the_first_design():
    flat = torch.zeros(8 * 64 + 8, dtype=torch.bfloat16)
    x = flat[1:1 + 8 * 64].view(8, 64)   # 2 bytes past a 16-byte boundary
    assert fcb._stats_plan(x, _weight(64, 256, torch.bfloat16, "t")) == (
        "first", "copy")


def test_resnet_conv3_weight_reaches_the_kernel_k_major_with_no_copy(
        monkeypatch):
    """The bottleneck's fused tail hands conv1x1_bn_relu the .t() view of
    conv3's [Cout, Cin] weight: the Hopper design reads that storage as the
    K-major operand as it is, so the weight is never copied."""
    from paddle_tpu_torch.vision.models import resnet as tres

    blk = tres.BottleneckBlock(256, 64, data_format="NHWC").astype(
        "bfloat16")
    blk.train()
    seen = []
    tail = fcb.conv1x1_bn_relu

    def spy(x, w, *a, **kw):
        seen.append((x, w))
        return tail(x, w, *a, **kw)

    monkeypatch.setattr(fcb, "conv1x1_bn_relu", spy)
    monkeypatch.setattr(fcb, "fused_epilogues_eligible",
                        lambda feature_dim, x: True)
    blk(torch.randn(2, 4, 4, 256).to(torch.bfloat16))
    (x, w), = seen
    assert tuple(w.shape) == (64, 256)
    assert w.data_ptr() == blk.conv3.weight.data_ptr()
    assert fcb._stats_plan(x.contiguous(), w) == ("wgmma", "k-major")


def test_forcing_a_design_the_shape_does_not_take_raises():
    x = torch.zeros(16, 100, dtype=torch.bfloat16)
    with pytest.raises(InvalidArgumentError, match="design"):
        fcb._stats_kernel(x, torch.zeros(100, 128, dtype=torch.bfloat16),
                          design="wgmma")
    y = torch.zeros(16, 130, dtype=torch.bfloat16)
    with pytest.raises(InvalidArgumentError, match="design"):
        fcb._apply_kernel(y, torch.ones(130), torch.zeros(130), None,
                          design="resident")


@pytest.mark.parametrize("N,want", [
    *[(N, 256) for _, _, N in RESNET_TAILS], (768, 256), (136, 128),
    (200, 128), (384, 128), (128, 128)])
def test_stats_tile_is_256_columns_where_n_divides(N, want):
    assert fcb._stats_tile(N) == want


@pytest.mark.parametrize("M,N,tile_n,sms,want", [
    (401408, 256, 128, 132, 132), (6272, 2048, 256, 132, 132),
    (1000, 136, 128, 132, 16),   # 8 x 2 tiles: one block a tile
    (1000, 136, 256, 132, 8),
    (77, 200, 128, 132, 2), (1, 8, 128, 132, 1)])
def test_stats_blocks_one_an_sm_at_most_one_a_tile(M, N, tile_n, sms, want):
    assert fcb._stats_blocks(M, N, tile_n, sms) == want


@pytest.mark.parametrize("dtype,N,aligned,want", [
    *[("bfloat16", N, True, "resident") for _, _, N in RESNET_TAILS],
    ("bfloat16", 200, True, "resident"),
    ("bfloat16", 130, True, "first"),     # rows not whole 16-byte vectors
    ("bfloat16", 256, False, "first"),
    ("float32", 1024, True, "resident"),
    ("float32", 130, True, "first"),
    ("float32", 200, True, "resident"),
])
def test_apply_plan_picks_the_design(dtype, N, aligned, want):
    assert fcb._apply_plan(getattr(torch, dtype), N, aligned) == want


@pytest.mark.parametrize("M,N,itemsize,want", [
    (401408, 256, 2, 132 * 32),  # capped at 32 blocks an SM
    (100352, 512, 2, 3136),      # one turn of 8 rows a thread
    (25088, 1024, 2, 1568), (6272, 2048, 2, 784),
    (1000, 136, 2, 9),           # 125 turns of 17 chunks: 9 blocks
    (4, 8 * 4096, 2, 16),        # at least one thread a column chunk
])
def test_apply_blocks_fill_the_card_and_cover_every_chunk(M, N, itemsize,
                                                          want):
    blocks = fcb._apply_blocks(M, N, itemsize, 132)
    assert blocks == want
    assert blocks * 256 >= N * itemsize // 16


# -- on the card ---------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,M,K,N", [("bfloat16", *s) for s in
                                         RESNET_TAILS]
                         + [("float32", 25088, 256, 1024),
                            ("bfloat16", 77, 64, 200),
                            ("float32", 300, 100, 130)])
def test_kernels_match_plain_on_card(dtype, M, K, N):
    """ResNet-50's conv3 shapes at batch 128, and ragged ones: y within a
    bf16 ulp (float32: rtol 1e-5), the column sums within 3e-5 x sum|y|,
    the stats kernel deterministic; bn_apply_relu bit-equal to its plain
    version with and without the residual."""
    dev = _card()
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(M + N)
    x = torch.randn(M, K, generator=gen).relu_().to(dev, dt)
    w = (torch.randn(K, N, generator=gen) * (2.0 / K) ** 0.5).to(dev, dt)
    before = fcb.conv1x1_bn_stats.launches
    y, s, q = fcb.conv1x1_bn_stats(x, w)
    y2, s2, q2 = fcb.conv1x1_bn_stats(x, w)
    y0, s0, q0 = fcb.conv1x1_bn_stats_ref(x, w)
    yf = x.float() @ w.float()
    torch.cuda.synchronize()
    assert fcb.conv1x1_bn_stats.launches == before + 2
    assert torch.equal(y, y2) and torch.equal(s, s2) and torch.equal(q, q2)
    top = float(y0.float().abs().max())
    torch.testing.assert_close(
        y.float(), y0.float(), atol=1e-5 * top,
        rtol=2.0 ** -7 if dtype == "bfloat16" else 1e-5)
    assert float(((s - s0).abs() / yf.abs().sum(0)).max()) <= 3e-5
    assert float(((q - q0).abs() / q0).max()) <= 3e-5
    g = (1 + 0.1 * torch.randn(N, generator=gen)).to(dev, dt)
    b = (0.1 * torch.randn(N, generator=gen)).to(dev, dt)
    _, _, _, scale, shift = fcb._fold(s, q, M, g, b, 1e-5, dt)
    res = torch.randn(M, N, generator=gen).to(dev, dt)
    for r in (res, None):
        out = fcb.bn_apply_relu(y, scale, shift, r)
        assert torch.equal(out, fcb.bn_apply_relu_ref(y, scale, shift, r))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_tail_grads_match_plain_autograd_on_card(dtype, tol):
    """layer3's conv3 shape: the autograd.Function (kernels forward,
    closed-form backward) against autograd through the plain version; each
    tensor within ``tol`` of its largest entry.  In bf16 the two forwards
    round y apart by an ulp here and there, so a few outputs fall on
    opposite sides of 0: at most 1e-4 of the ReLU-mask entries may differ,
    and the cotangent is zeroed there so that no gradient sees them."""
    dev = _card()
    dt = getattr(torch, dtype)
    M, K, N = RESNET_TAILS[2]
    gen = torch.Generator().manual_seed(3)
    ins = [torch.randn(M, K, generator=gen).relu_(),
           torch.randn(K, N, generator=gen) * (2.0 / K) ** 0.5,
           1 + 0.1 * torch.randn(N, generator=gen),
           0.1 * torch.randn(N, generator=gen),
           torch.randn(M, N, generator=gen)]
    ins = [t.to(dev, dt) for t in ins]
    dout = torch.randn(M, N, generator=gen).to(dev, dt)
    rm, rv = torch.zeros(N, device=dev), torch.ones(N, device=dev)
    runs = []
    for fn in (fcb.conv1x1_bn_relu, fcb.conv1x1_bn_relu_ref):
        args = [t.clone().requires_grad_() for t in ins]
        out, nm, nv = fn(*args[:4], residual=args[4], running_mean=rm,
                         running_var=rv)
        runs.append((out, nm, nv, args))
    agree = (runs[0][0] > 0) == (runs[1][0] > 0)
    assert int((~agree).sum()) <= 1e-4 * agree.numel()
    got = [[out.detach(), nm, nv,
            *torch.autograd.grad(out, args, dout * agree)]
           for out, nm, nv, args in runs]
    for i, (a, b) in enumerate(zip(*got)):
        a, b = a.float(), b.float()
        assert float((a - b).abs().max()) <= tol * float(b.abs().max()), i


def _stats_check(x, w, y, s, q):
    """The Hopper stats kernel's tolerances against the plain version."""
    y0, s0, q0 = fcb.conv1x1_bn_stats_ref(x, w)
    yf = x.float() @ w.float()
    top = float(y0.float().abs().max())
    torch.testing.assert_close(y.float(), y0.float(), rtol=2.0 ** -7,
                               atol=1e-5 * top)
    assert float(((s - s0).abs() / yf.abs().sum(0).clamp_min(1e-30)).max()) \
        <= 3e-5
    assert float(((q - q0).abs() / q0.clamp_min(1e-30)).max()) <= 3e-5


@pytest.mark.gpu
@pytest.mark.parametrize("tile_n", [128, 256])
@pytest.mark.parametrize("M,K,N", RESNET_TAILS + [(1000, 64, 136),
                                                  (1000, 512, 136),
                                                  (77, 64, 200)])
def test_hopper_stats_kernel_matches_plain_in_both_layouts_on_card(M, K, N,
                                                                   tile_n):
    """bf16, tiles of 128 x 128 and 128 x 256: the conv3 shapes, an M that
    is not a multiple of the 128-row tile and an N that is a multiple of 8
    but not of 128.  The .t() view of a contiguous [N, K] weight (K-major,
    no copy) and a contiguous [K, N] one (MN-major) give bit-equal results,
    two calls give the same bits, and each is within the plain version's
    tolerances."""
    dev = _card()
    gen = torch.Generator().manual_seed(M + K + N)
    x = torch.randn(M, K, generator=gen).relu_().to(dev, torch.bfloat16)
    wt = (torch.randn(N, K, generator=gen) * (2.0 / K) ** 0.5).to(
        dev, torch.bfloat16)
    w_k, w_mn = wt.t(), wt.t().contiguous()
    assert fcb._stats_plan(x, w_k) == ("wgmma", "k-major")
    assert fcb._stats_plan(x, w_mn) == ("wgmma", "mn-major")
    before = fcb.conv1x1_bn_stats.launches
    got = [fcb._stats_kernel(x, w, tile_n=tile_n) for w in (w_k, w_k, w_mn)]
    torch.cuda.synchronize()
    assert fcb.conv1x1_bn_stats.launches == before + 3
    for other in got[1:]:
        for a, b in zip(got[0], other):
            assert torch.equal(a, b)
    _stats_check(x, w_mn, *got[0])


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [RESNET_TAILS[2], (300, 64, 136)])
def test_first_stats_design_is_still_reachable_and_right_on_card(M, K, N):
    """bf16 through the first design (``design="first"``) at layer3's conv3
    shape and a ragged one: deterministic and within the tolerances."""
    dev = _card()
    gen = torch.Generator().manual_seed(M + N)
    x = torch.randn(M, K, generator=gen).relu_().to(dev, torch.bfloat16)
    w = (torch.randn(K, N, generator=gen) * (2.0 / K) ** 0.5).to(
        dev, torch.bfloat16)
    a = fcb._stats_kernel(x, w, design="first")
    b = fcb._stats_kernel(x, w, design="first")
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    _stats_check(x, w, *a)


@pytest.mark.gpu
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("M,N", [(M, N) for M, _, N in RESNET_TAILS]
                         + [(1000, 136)])
def test_both_apply_designs_bit_equal_to_plain_on_card(M, N, residual):
    dev = _card()
    gen = torch.Generator().manual_seed(M + N + residual)
    y = torch.randn(M, N, generator=gen).to(dev, torch.bfloat16)
    scale = (1 + 0.1 * torch.randn(N, generator=gen)).to(dev, torch.bfloat16)
    shift = (0.1 * torch.randn(N, generator=gen)).to(dev, torch.bfloat16)
    r = (torch.randn(M, N, generator=gen).to(dev, torch.bfloat16)
         if residual else None)
    assert fcb._apply_plan(y.dtype, N, True) == "resident"
    want = fcb.bn_apply_relu_ref(y, scale, shift, r)
    # scale / shift in bf16 (as the tail folds them) and in float32
    for design, sc, sh in ((None, scale, shift),
                           (None, scale.float(), shift.float()),
                           ("first", scale, shift)):
        got = fcb._apply_kernel(y, sc, sh, r, design=design)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (design, sc.dtype)
