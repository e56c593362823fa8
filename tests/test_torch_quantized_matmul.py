"""Port of the quantized matmul (paddle_tpu_torch/ops/quantized_matmul.py)
and of the serving half of slim (paddle_tpu_torch/slim).

The same numpy inputs, made from a seed, go through the JAX package and
the port.  Quantization must give EQUAL codes and scales, not close ones
(tokens depend on the integers): ``quantize_activations`` and
``_quantize_weight`` are compared bit for bit.  The port's plain version
``quantized_linear_ref`` — the CPU path and the card-side yardstick of the
CUDA kernel — is held against the JAX package's Pallas kernel
``_qmm_pallas`` in interpret mode (as tests/test_quantized_serving.py runs
it) and against its public ``quantized_linear``.  The CUDA kernel itself is
compared with the plain version only where a card is present (``gpu``
marker).
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.slim import quantization as jslim
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.slim import quantization as tslim

# both ``ops`` packages export a function named like the module
jqm = importlib.import_module("paddle_tpu.ops.quantized_matmul")
tqm = importlib.import_module("paddle_tpu_torch.ops.quantized_matmul")

# both sides accumulate exactly (int8) or in f32 (fp8) and apply one f32
# epilogue; only the order of the fp8 sums differs
RTOL = ATOL = 1e-5
MODES = ["int8", "fp8"]
QDT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}
# ragged on purpose: no multiple of 4, 32 or 128 anywhere in the first
SHAPES = [(77, 30, 100), (8, 64, 96), (5, 129, 33)]


def _bits(t):
    """Raw storage of a quantized tensor/array as uint8 numpy."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


def _inputs(seed, M, K, N):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(K, N) * 0.1).astype(np.float32)
    b = (rng.randn(N) * 0.01).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(6, 4, 8), (77, 30), (3, 5, 7, 16)])
def test_quantize_activations_equal_codes_and_scale(mode, shape):
    rng = np.random.RandomState(len(shape))
    x = (rng.randn(*shape) * 3.0).astype(np.float32)
    x.flat[0] = 0.0
    jq, js = jqm.quantize_activations(jnp.asarray(x), mode)
    tq, ts = tqm.quantize_activations(torch.from_numpy(x), mode)
    assert tq.dtype == QDT[mode] and ts.dtype == torch.float32
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    assert np.float32(ts.item()) == np.float32(js)


@pytest.mark.parametrize("mode", MODES)
def test_quantize_weight_equal_codes_and_scales(mode):
    rng = np.random.RandomState(1)
    w = (rng.randn(48, 40) * 0.2).astype(np.float32)
    w[:, 3] = 0.0  # a dead channel: scale floors at 1e-9
    jq, js = jslim._quantize_weight(jnp.asarray(w), mode)
    tq, ts = tslim._quantize_weight(torch.from_numpy(w), mode)
    assert tq.dtype == QDT[mode] and tuple(ts.shape) == (40,)
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # per-tensor form of the public helpers too
    jq, js = getattr(jslim, f"quantize_to_{mode}")(jnp.asarray(w))
    tq, ts = getattr(tslim, f"quantize_to_{mode}")(torch.from_numpy(w))
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    assert np.float32(ts.item()) == np.float32(js)


def test_fp8_overflow_clips_not_nan():
    # e4m3fn has no inf: an unclipped cast of the abs-max element would
    # round past 448 and land on NaN
    x = torch.full((2, 4), 1e4)
    xq, _ = tqm.quantize_activations(x, "fp8")
    assert torch.isfinite(xq.float()).all()
    wq, _ = tslim.quantize_to_fp8(x, channel_axis=1)
    assert torch.isfinite(wq.float()).all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_plain_matches_jax_pallas_kernel(mode, M, K, N):
    x, w, b = _inputs(M + K + N, M, K, N)
    jwq, jws = jslim._quantize_weight(jnp.asarray(w), mode)
    jxq, jxs = jqm.quantize_activations(jnp.asarray(x), mode)
    want = np.asarray(jqm._qmm_pallas(
        jxq, jwq, (jws * jxs).astype(jnp.float32), jnp.asarray(b), 128, 128))
    twq, tws = tslim._quantize_weight(torch.from_numpy(w), mode)
    got = tqm.quantized_linear_ref(torch.from_numpy(x), twq, tws,
                                   torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_plain_matches_jax_quantized_linear(mode, M, K, N):
    x, w, b = _inputs(7 + M + N, M, K, N)
    jwq, jws = jslim._quantize_weight(jnp.asarray(w), mode)
    twq, tws = tslim._quantize_weight(torch.from_numpy(w), mode)
    for bias in (b, None):
        want = np.asarray(jqm.quantized_linear(
            jnp.asarray(x), jwq, jws,
            None if bias is None else jnp.asarray(bias)))
        got = tqm.quantized_linear_ref(
            torch.from_numpy(x), twq, tws,
            None if bias is None else torch.from_numpy(bias))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # close to the float product too: quantization noise only
    dense = x @ w + b
    tol = {"int8": 0.05, "fp8": 0.15}[mode] * np.abs(dense).max()
    got = tqm.quantized_linear_ref(torch.from_numpy(x), twq, tws,
                                   torch.from_numpy(b)).numpy()
    assert np.abs(got - dense).max() < tol


def test_int8_plain_accumulates_exactly_at_large_k():
    # sums near 3072 * 127 * 127 > 2^24: an f32 product of the codes rounds
    K = 3072
    rng = np.random.RandomState(9)
    xq = torch.from_numpy(rng.randint(100, 128, size=(4, K)).astype(np.int8))
    wq = torch.from_numpy(rng.randint(100, 128, size=(K, 8)).astype(np.int8))
    wq[:, 1] = -wq[:, 1]
    one, zero = torch.ones(8), torch.zeros(8)
    exact = torch.matmul(xq.long(), wq.long())  # int64 on the CPU
    assert int(exact.abs().max()) > 2 ** 24
    got = tqm._matmul_ref(xq, wq, one, zero)
    assert torch.equal(got, exact.float())  # one rounding, of the exact sum
    # ... which an f32 accumulation of the same codes does not give
    assert not torch.equal(torch.matmul(xq.float(), wq.float()).double(),
                           exact.double())


# Seeds whose inputs tell the JAX package's arithmetic from its natural
# neighbours: the other order (``x / amax * 127``; ``w * (127 / scale)``
# for weights) and, for activations, ``x * (127.0 / amax)`` written with a
# Python scalar, which torch evaluates as ``amax.reciprocal() * 127``.
# Each changes a code there, so equal codes show the port computes what
# the JAX package computes, IEEE division included.
ORDER_SEEDS = {("act", "int8"): 89, ("act", "fp8"): 35,
               ("w", "int8"): 3, ("w", "fp8"): 7}


def _codes(v, mode):
    top = 127.0 if mode == "int8" else 448.0
    v = torch.round(v) if mode == "int8" else v
    return _bits(torch.clamp(v, -top, top).to(QDT[mode]))


@pytest.mark.parametrize("mode", MODES)
def test_activation_codes_follow_the_jax_arithmetic(mode):
    rng = np.random.RandomState(ORDER_SEEDS["act", mode])
    x = (rng.randn(64, 1024) * 3).astype(np.float32)
    jq, js = jqm.quantize_activations(jnp.asarray(x), mode)
    tq, ts = tqm.quantize_activations(torch.from_numpy(x), mode)
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    assert np.float32(ts.item()) == np.float32(js)
    xf = torch.from_numpy(x)
    amax = xf.abs().max()
    top = 127.0 if mode == "int8" else 448.0
    # the input discriminates: either neighbour changes a code
    assert (_codes(xf / amax * top, mode) != _bits(tq)).sum() >= 1
    assert (_codes(xf * (top / amax), mode) != _bits(tq)).sum() >= 1


@pytest.mark.parametrize("mode", MODES)
def test_weight_codes_follow_the_jax_arithmetic(mode):
    rng = np.random.RandomState(ORDER_SEEDS["w", mode])
    w = (rng.randn(256, 512) * 0.2).astype(np.float32)
    jq, js = jslim._quantize_weight(jnp.asarray(w), mode)
    tq, ts = tslim._quantize_weight(torch.from_numpy(w), mode)
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    wf = torch.from_numpy(w)
    scale = wf.abs().amax(0, keepdim=True)
    top = torch.full_like(scale, 127.0 if mode == "int8" else 448.0)
    assert (_codes(wf * (top / scale), mode) != _bits(tq)).sum() >= 1


@pytest.mark.parametrize("mode", MODES)
def test_leading_dims_dtype_and_cpu_dispatch_uncounted(mode):
    x, w, b = _inputs(3, 12, 24, 20)
    twq, tws = tslim._quantize_weight(torch.from_numpy(w), mode)
    x3 = torch.from_numpy(x).reshape(3, 4, 24).bfloat16()
    before = tqm.quantized_linear.launches
    leg = tqm.quantized_matmul if mode == "int8" else tqm.fp8_matmul
    got = leg(x3, twq, tws, torch.from_numpy(b))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (3, 4, 20)
    want = tqm.quantized_linear_ref(x3, twq, tws, torch.from_numpy(b))
    assert torch.equal(got, want)
    assert tqm.quantized_linear.launches == before  # CPU never counts


def test_rejects_bad_dtypes_scales_and_shapes():
    x, w, b = _inputs(4, 4, 8, 6)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    wq, ws = tslim._quantize_weight(tw, "int8")
    fq, fs = tslim._quantize_weight(tw, "fp8")
    with pytest.raises(InvalidArgumentError, match="not int8 or"):
        tqm.quantized_linear(tx, tw, ws)
    with pytest.raises(InvalidArgumentError, match="weight_scale"):
        tqm.quantized_linear(tx, wq, None)
    with pytest.raises(InvalidArgumentError, match="not int8"):
        tqm.quantized_matmul(tx, fq, fs)
    with pytest.raises(InvalidArgumentError, match="not float8"):
        tqm.fp8_matmul(tx, wq, ws)
    with pytest.raises(InvalidArgumentError):
        tqm.quantize_activations(tx, "int4")
    with pytest.raises(InvalidArgumentError):
        tslim._quantize_weight(tw, "int4")
    with pytest.raises(InvalidArgumentError, match=r"\[M, K\] @ \[K, N\]"):
        tqm._matmul_ref(wq[:3].t().contiguous(), wq, ws, tb)
    with pytest.raises(InvalidArgumentError, match="scale"):
        tqm._matmul_ref(wq.t().contiguous()[:, :8], wq, ws[:3], tb)


# -- on the card: the CUDA kernel against its plain version ------------------
PATH_KN = [(768, 2304), (768, 768), (768, 3072), (3072, 768)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("M", [8, 40, 384])
def test_kernel_matches_plain_on_card_at_path_shapes(mode, M):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    for K, N in PATH_KN:
        x, w, b = _inputs(M + N, M, K, N)
        tx, tw, tb = (torch.from_numpy(a).cuda() for a in (x, w, b))
        wq, ws = tslim._quantize_weight(tw, mode)
        xq, xs = tqm.quantize_activations(tx, mode)
        scale = ws * xs
        before = tqm.quantized_linear.launches
        out = tqm._matmul_kernel(xq, wq, scale, tb)
        ref = tqm._matmul_ref(xq, wq, scale, tb)
        torch.cuda.synchronize()
        assert tqm.quantized_linear.launches == before + 1
        if mode == "int8":
            # exact int32 accumulator, same two f32 roundings after it
            assert torch.equal(out, ref), (K, N)
            one, zero = torch.ones_like(scale), torch.zeros_like(tb)
            assert torch.equal(tqm._matmul_kernel(xq, wq, one, zero),
                               tqm._matmul_ref(xq, wq, one, zero))
        else:
            # f32 sums of K products in another order than cuBLAS's
            torch.testing.assert_close(
                out, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))
        pub = tqm.quantized_linear(tx, wq, ws, tb)
        torch.testing.assert_close(
            pub, tqm.quantized_linear_ref(tx, wq, ws, tb), rtol=1e-4,
            atol=1e-4 * float(ref.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("M,K,N", SHAPES + [(1, 0, 5), (130, 257, 67)])
def test_kernel_matches_plain_on_card_ragged(mode, M, K, N):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.RandomState(M + K + N)
    xq = torch.from_numpy(rng.randint(-127, 128, size=(M, K)).astype(np.int8))
    wq = torch.from_numpy(rng.randint(-127, 128, size=(K, N)).astype(np.int8))
    if mode == "fp8":  # every finite e4m3 code (0x7f / 0xff are NaN)
        xq = (xq.view(torch.uint8) % 127).view(torch.float8_e4m3fn)
        wq = (wq.view(torch.uint8) % 127 + 128 * (wq < 0)).to(
            torch.uint8).view(torch.float8_e4m3fn)
    scale = torch.from_numpy(rng.rand(N).astype(np.float32) * 1e-3)
    bias = torch.from_numpy(rng.randn(N).astype(np.float32))
    args = [t.cuda() for t in (xq, wq, scale, bias)]
    out = tqm._matmul_kernel(*args)
    ref = tqm._matmul_ref(*args)
    torch.cuda.synchronize()
    if mode == "int8":
        assert torch.equal(out, ref)
    else:
        torch.testing.assert_close(
            out, ref, rtol=1e-4,
            atol=1e-4 * max(float(ref.abs().max()), 1e-6))


# the kernel splits K across a thread-block cluster where M is small (fc2's
# K = 3072 at decode: M = 1, 8, and 13, which takes two n8 tiles) and adds
# the partial sums in a fixed order, so two launches give the same bits in
# both modes; M = 384 splits K over the 64 x 64 tiles too
@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("M", [1, 8, 13, 384])
def test_kernel_split_k_matches_plain_and_repeats_bit_equal(mode, M):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    K, N = 3072, 768
    x, w, b = _inputs(7 * M, M, K, N)
    tx, tw, tb = (torch.from_numpy(a).cuda() for a in (x, w, b))
    wq, ws = tslim._quantize_weight(tw, mode)
    xq, xs = tqm.quantize_activations(tx, mode)
    scale = ws * xs
    out = tqm._matmul_kernel(xq, wq, scale, tb)
    again = tqm._matmul_kernel(xq, wq, scale, tb)
    ref = tqm._matmul_ref(xq, wq, scale, tb)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    if mode == "int8":
        assert torch.equal(out, ref)
    else:
        torch.testing.assert_close(
            out, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))
