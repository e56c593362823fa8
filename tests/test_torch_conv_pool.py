"""The port's convolutions and pools (``paddle_tpu_torch.nn.functional``'s
``conv1d`` / ``conv3d``, the three transposed convolutions, the average,
max and adaptive pools of rank 1-3, and their layers) against the JAX
package's, forward and backward.

Every input is a numpy array from a seed, fed to the JAX function and to
its port; the gradients are ``jax.grad`` / autograd of ``Σ out · c`` for
a seeded cotangent ``c``.  Tolerances: float32 convolutions at rtol /
atol 1e-4 (the two frameworks sum the products in other orders, up to
~300 of them); float32 pools at 1e-5; bf16 at 2e-2 (8 mantissa bits).
Max-pool outputs and masks are compared exactly, on inputs whose window
maxima are unique (a seeded permutation): XLA does not fix the order in
which it reduces a window, so a tie has no defined index in JAX.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.fluid.layers as jfl
import paddle_tpu.nn as jnn
from paddle_tpu.framework.errors import \
    InvalidArgumentError as JInvalidArgumentError
from paddle_tpu.nn import functional as JF
import paddle_tpu_torch.fluid.layers as tfl
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.nn import functional as TF
from torch_nn_pairs import bridged, check_pair

CONV_TOL = dict(rtol=1e-4, atol=1e-4)
POOL_TOL = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _unique(seed, *shape):
    """Distinct values: every window's maximum is unique."""
    n = int(np.prod(shape))
    return (np.random.RandomState(seed).permutation(n).reshape(shape)
            .astype(np.float32) / n)


def _last(x):
    """A channels-first array in the matching channels-last layout."""
    return np.ascontiguousarray(np.moveaxis(x, 1, -1))


def _fwd_bwd(jfn, tfn, arrays, tol, seed=1):
    """Forward of both on ``arrays``, then the gradients of ``Σ out · c``
    with respect to every array."""
    jin = [jnp.asarray(a) for a in arrays]
    tin = [torch.tensor(a, requires_grad=True) for a in arrays]
    jout, tout = jfn(*jin), tfn(*tin)
    assert tuple(tout.shape) == tuple(jout.shape)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **tol)
    cot = np.random.RandomState(seed).randn(*jout.shape).astype(np.float32)
    jg = jax.grad(lambda *xs: jnp.sum(jfn(*xs) * cot),
                  argnums=tuple(range(len(arrays))))(*jin)
    tg = torch.autograd.grad((tout * torch.from_numpy(cot)).sum(), tin)
    for i, (g, want) in enumerate(zip(tg, jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                   err_msg=f"d/d input {i}", **tol)
    return tout


# -- convolutions ------------------------------------------------------------
#: name: (function, channels-first x shape, weight shape, kwargs); every case
#: runs in both layouts
CONV_CASES = {
    "conv1d_int_pad_stride": ("conv1d", (2, 4, 11), (6, 4, 3),
                              dict(padding=1, stride=2)),
    "conv1d_same_dilation": ("conv1d", (2, 4, 10), (6, 4, 3),
                             dict(padding="SAME", dilation=2)),
    "conv1d_valid_stride": ("conv1d", (2, 4, 10), (6, 4, 4),
                            dict(padding="VALID", stride=3)),
    "conv1d_asymmetric_groups": ("conv1d", (2, 4, 9), (6, 2, 3),
                                 dict(padding=[2, 0], groups=2)),
    "conv3d_int_pad": ("conv3d", (2, 3, 5, 6, 7), (4, 3, 3, 3, 3),
                       dict(padding=1)),
    "conv3d_per_dim_stride": ("conv3d", (1, 4, 6, 7, 8), (6, 4, 3, 2, 3),
                              dict(padding=[1, 0, 2], stride=[2, 1, 2])),
    "conv3d_asymmetric": ("conv3d", (1, 2, 5, 5, 5), (4, 2, 2, 2, 2),
                          dict(padding=[1, 0, 0, 1, 1, 0])),
    "conv3d_same_groups_dilation": ("conv3d", (1, 4, 6, 6, 6),
                                    (4, 2, 3, 3, 3),
                                    dict(padding="SAME", groups=2,
                                         dilation=2, stride=2)),
    "conv1d_transpose_k4s2p1": ("conv1d_transpose", (2, 4, 7), (4, 6, 4),
                                dict(stride=2, padding=1)),
    "conv1d_transpose_output_padding": ("conv1d_transpose", (2, 4, 7),
                                        (4, 6, 3),
                                        dict(stride=2, padding=1,
                                             output_padding=1)),
    "conv1d_transpose_same": ("conv1d_transpose", (2, 4, 6), (4, 6, 3),
                              dict(stride=2, padding="SAME")),
    "conv2d_transpose_dcgan": ("conv2d_transpose", (2, 6, 4, 4),
                               (6, 4, 4, 4), dict(stride=2, padding=1)),
    "conv2d_transpose_dilation_groups": ("conv2d_transpose", (2, 4, 5, 6),
                                         (4, 3, 3, 3),
                                         dict(stride=[2, 3], padding=[1, 0],
                                              dilation=2, groups=2)),
    "conv2d_transpose_asymmetric": ("conv2d_transpose", (1, 3, 5, 5),
                                    (3, 2, 3, 3),
                                    dict(stride=2, padding=[0, 2, 1, 0])),
    "conv2d_transpose_valid_output_padding": ("conv2d_transpose",
                                              (1, 3, 4, 5), (3, 2, 3, 3),
                                              dict(stride=2, padding="VALID",
                                                   output_padding=1)),
    "conv2d_transpose_pad_beyond_kernel": ("conv2d_transpose", (1, 3, 6, 6),
                                           (3, 2, 3, 3),
                                           dict(stride=1, padding=3)),
    "conv3d_transpose_k3s2p1": ("conv3d_transpose", (1, 4, 3, 4, 5),
                                (4, 3, 3, 3, 3),
                                dict(stride=2, padding=1, output_padding=1)),
    "conv3d_transpose_groups_same": ("conv3d_transpose", (1, 4, 3, 3, 4),
                                     (4, 2, 2, 3, 2),
                                     dict(stride=2, padding="SAME",
                                          groups=2)),
}
_FORMATS = {1: ("NCL", "NLC"), 2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}


@pytest.mark.parametrize("channel_last", [False, True],
                         ids=["channels_first", "channels_last"])
@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv_matches_jax_forward_and_grad(case, channel_last):
    fn, xs, ws, kw = CONV_CASES[case]
    seed = list(CONV_CASES).index(case)
    x, w = _rand(seed, *xs), _rand(seed + 100, *ws)
    n = len(xs) - 2
    cout = ws[0] if "transpose" not in fn else ws[1] * kw.get("groups", 1)
    b = _rand(seed + 200, cout)
    fmt = _FORMATS[n][channel_last]
    if channel_last:
        x = _last(x)
    _fwd_bwd(lambda *a: getattr(JF, fn)(*a, data_format=fmt, **kw),
             lambda *a: getattr(TF, fn)(*a, data_format=fmt, **kw),
             [x, w, b], CONV_TOL, seed=seed)


@pytest.mark.parametrize("channel_last", [False, True])
@pytest.mark.parametrize("fn,xs,ws,size", [
    ("conv1d_transpose", (2, 4, 5), (4, 3, 4), [8]),
    ("conv2d_transpose", (1, 4, 4, 4), (4, 2, 4, 4), [7, 6]),
    ("conv2d_transpose", (1, 4, 4, 4), (4, 2, 4, 4), [20, 5]),
    ("conv3d_transpose", (1, 2, 3, 3, 3), (2, 2, 3, 3, 3), [4, 5, 6]),
])
def test_transposed_output_size_only_crops(fn, xs, ws, size, channel_last):
    """``output_size`` slices ``[:t]`` and never grows the output (a
    target past the natural size leaves that dim as it is), as in JAX."""
    x, w = _rand(1, *xs), _rand(2, *ws)
    fmt = _FORMATS[len(xs) - 2][channel_last]
    if channel_last:
        x = _last(x)
    out = _fwd_bwd(
        lambda a, b: getattr(JF, fn)(a, b, stride=2, padding=1,
                                     output_size=size, data_format=fmt),
        lambda a, b: getattr(TF, fn)(a, b, stride=2, padding=1,
                                     output_size=size, data_format=fmt),
        [x, w], CONV_TOL)
    natural = getattr(TF, fn)(torch.tensor(x), torch.tensor(w), stride=2,
                              padding=1, data_format=fmt)
    spatial = slice(1, -1) if channel_last else slice(2, None)
    assert list(out.shape[spatial]) == [
        min(t, s) for t, s in zip(size, natural.shape[spatial])]


@pytest.mark.parametrize("fn,xs,ws,kw", [
    ("conv1d", (2, 9, 4), (6, 4, 3), dict(padding=1, data_format="NLC")),
    ("conv3d", (1, 3, 4, 5, 6), (4, 3, 3, 3, 3), dict(padding=1)),
    ("conv1d_transpose", (2, 4, 6), (4, 3, 3), dict(stride=2)),
    ("conv2d_transpose", (1, 5, 5, 4), (4, 3, 4, 4),
     dict(stride=2, padding=1, data_format="NHWC")),
    ("conv3d_transpose", (1, 4, 3, 3, 3), (4, 2, 3, 3, 3), dict(stride=2)),
])
def test_bf16_weights_cast_a_float_input(fn, xs, ws, kw):
    """The AMP convention: a float32 input meeting bf16 weights computes
    in bf16, in both packages."""
    x, w = _rand(3, *xs), _rand(4, *ws)
    want = getattr(JF, fn)(jnp.asarray(x),
                           jnp.asarray(w.astype(ml_dtypes.bfloat16)), **kw)
    got = getattr(TF, fn)(torch.tensor(x),
                          torch.tensor(w).to(torch.bfloat16), **kw)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("fn", ["conv1d", "conv3d", "conv1d_transpose",
                                "conv3d_transpose"])
def test_conv_rejects_unknown_padding_and_format(fn):
    n = 1 if fn.startswith("conv1d") else 3
    x, w = torch.randn(1, 2, *(4,) * n), torch.randn(2, 2, *(1,) * n)
    with pytest.raises(InvalidArgumentError):
        getattr(TF, fn)(x, w, padding="FULL")
    with pytest.raises(InvalidArgumentError):
        getattr(TF, fn)(x, w, data_format="NCHW")


#: layer: (constructor args, kwargs, channels-first input shape)
CONV_LAYERS = [
    ("Conv1D", (4, 6, 3), dict(stride=2, padding=1), (2, 4, 9)),
    ("Conv1D", (4, 6, 3), dict(padding="SAME", data_format="NLC",
                               bias_attr=False), (2, 4, 9)),
    ("Conv2D", (4, 6, 3), dict(padding=1, groups=2), (2, 4, 6, 6)),
    ("Conv3D", (3, 4, 3), dict(padding=1, stride=[1, 2, 2]),
     (1, 3, 4, 6, 6)),
    ("Conv3D", (3, 4, 2), dict(data_format="NDHWC"), (1, 3, 4, 5, 5)),
    ("Conv1DTranspose", (4, 6, 4), dict(stride=2, padding=1), (2, 4, 7)),
    ("Conv2DTranspose", (4, 6, 4), dict(stride=2, padding=1,
                                        data_format="NHWC"), (2, 4, 4, 4)),
    ("Conv2DTranspose", (4, 6, 3), dict(stride=2, padding=1, groups=2,
                                        output_padding=1), (1, 4, 5, 5)),
    ("Conv3DTranspose", (4, 2, 3), dict(stride=2, padding=1, dilation=2),
     (1, 4, 3, 3, 3)),
]


@pytest.mark.parametrize("name,args,kw,xs", CONV_LAYERS, ids=[
    f"{c[0]}-{i}" for i, c in enumerate(CONV_LAYERS)])
def test_conv_layer_as_jax(name, args, kw, xs):
    jpt.seed(5)
    jl, tl = getattr(jnn, name)(*args, **kw), getattr(tnn, name)(*args, **kw)
    assert list(tl.state_dict()) == list(jl.state_dict())
    assert [tuple(p.shape) for p in tl.parameters()] == [
        tuple(p.value.shape) for p in jl.parameters()]
    x = _rand(7, *xs)
    if kw.get("data_format", "NC")[1] != "C":
        x = _last(x)
    check_pair(jl, bridged(jl, tl), [x], **CONV_TOL)


@pytest.mark.parametrize("name", ["Conv1D", "Conv2D", "Conv3D"])
@pytest.mark.parametrize("mode", ["reflect", "replicate", "circular"])
def test_padding_mode_is_accepted_and_ignored_as_in_jax(name, mode):
    """The JAX ``_ConvNd`` never reads ``padding_mode``: every mode pads
    with zeros, the same result as ``"zeros"``."""
    n = int(name[4])
    jpt.seed(2)
    jl = getattr(jnn, name)(3, 4, 3, padding=1, padding_mode=mode)
    tl = bridged(jl, getattr(tnn, name)(3, 4, 3, padding=1,
                                        padding_mode=mode))
    zeros = bridged(jl, getattr(tnn, name)(3, 4, 3, padding=1))
    assert tl.padding_mode == mode
    x = _rand(8, 2, 3, *(5,) * n)
    check_pair(jl, tl, [x], **CONV_TOL)
    with torch.no_grad():
        torch.testing.assert_close(tl(torch.tensor(x)),
                                   zeros(torch.tensor(x)), rtol=0, atol=0)


@pytest.mark.parametrize("name,fn", [
    ("Conv1DTranspose", "conv1d_transpose"),
    ("Conv2DTranspose", "conv2d_transpose"),
    ("Conv3DTranspose", "conv3d_transpose")])
def test_transposed_layer_output_size_and_weight_layout(name, fn):
    """The layer's weight is ``[Cin, Cout / groups, *k]`` and its
    ``output_size`` crops as the functional does."""
    n = int(name[4])
    jpt.seed(3)
    jl = getattr(jnn, name)(4, 6, 3, stride=2, groups=2)
    tl = bridged(jl, getattr(tnn, name)(4, 6, 3, stride=2, groups=2))
    assert tuple(tl.weight.shape) == (4, 3) + (3,) * n
    x = _rand(9, 1, 4, *(3,) * n)
    size = [5] * n
    check_pair(jl, tl, [x], kwargs=dict(output_size=size), **CONV_TOL)
    out = tl(torch.tensor(x), output_size=size)
    assert list(out.shape[2:]) == size


def test_conv_layer_initializer_is_normal_with_fan_in():
    """N(0, 2 / fan_in), fan_in = Cin / groups · prod(k), for both
    weight layouts (the statistics only: parity tests never compare
    initialization)."""
    torch.manual_seed(0)
    for layer, fan_in in ((tnn.Conv3D(16, 32, 3, groups=2), 8 * 27),
                          (tnn.Conv2DTranspose(16, 32, 4, groups=4),
                           4 * 16),
                          (tnn.Conv1D(64, 64, 5), 64 * 5)):
        w = layer.weight.detach()
        assert abs(float(w.std()) - (2.0 / fan_in) ** 0.5) < 0.1 * (
            2.0 / fan_in) ** 0.5
        assert torch.equal(layer.bias.detach(), torch.zeros_like(layer.bias))


# -- pools -------------------------------------------------------------------
#: (kernel, stride, padding) windows at odd sizes, where ceil_mode adds
#: padding and the last window may lie in it
WINDOWS = [(2, None, 0), (3, 2, 1), (3, 2, 0), (2, 2, 1), (4, 3, 2)]
POOL_SHAPES = {1: (2, 3, 11), 2: (2, 3, 7, 9), 3: (1, 2, 5, 6, 7)}


def _pool_input(n, channel_last, seed):
    x = _unique(seed, *POOL_SHAPES[n])
    return _last(x) if channel_last else x


@pytest.mark.parametrize("channel_last", [False, True])
@pytest.mark.parametrize("exclusive", [True, False])
@pytest.mark.parametrize("ceil_mode", [False, True])
@pytest.mark.parametrize("window", WINDOWS, ids=str)
@pytest.mark.parametrize("n", [1, 2, 3])
def test_avg_pool_matches_jax(n, window, ceil_mode, exclusive,
                              channel_last):
    k, s, p = window
    kw = dict(kernel_size=k, stride=s, padding=p, ceil_mode=ceil_mode,
              exclusive=exclusive, data_format=_FORMATS[n][channel_last])
    fn = f"avg_pool{n}d"
    _fwd_bwd(lambda a: getattr(JF, fn)(a, **kw),
             lambda a: getattr(TF, fn)(a, **kw),
             [_pool_input(n, channel_last, n)], POOL_TOL)


@pytest.mark.parametrize("ceil_mode", [False, True])
@pytest.mark.parametrize("n", [2, 3])
def test_avg_pool_divisor_override_matches_jax(n, ceil_mode):
    kw = dict(kernel_size=3, stride=2, padding=1, ceil_mode=ceil_mode,
              divisor_override=4)
    fn = f"avg_pool{n}d"
    _fwd_bwd(lambda a: getattr(JF, fn)(a, **kw),
             lambda a: getattr(TF, fn)(a, **kw),
             [_pool_input(n, False, 5)], POOL_TOL)


def test_overhanging_ceil_window_divides_by_the_kernel_as_jax():
    """``exclusive=False`` divides a window that overhangs the ceil
    padding by ``prod(kernel)`` (torch's ``count_include_pad`` would
    divide by the clipped window)."""
    x = np.ones((1, 1, 5, 5), np.float32)
    got = TF.avg_pool2d(torch.tensor(x), 2, 2, ceil_mode=True,
                        exclusive=False)
    want = JF.avg_pool2d(jnp.asarray(x), 2, 2, ceil_mode=True,
                         exclusive=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got[0, 0, -1, -1]) == 0.25  # one input element of four


@pytest.mark.parametrize("channel_last", [False, True])
@pytest.mark.parametrize("ceil_mode", [False, True])
@pytest.mark.parametrize("window", WINDOWS, ids=str)
@pytest.mark.parametrize("n", [1, 2, 3])
def test_max_pool_and_mask_match_jax(n, window, ceil_mode, channel_last):
    k, s, p = window
    kw = dict(kernel_size=k, stride=s, padding=p, ceil_mode=ceil_mode,
              data_format=_FORMATS[n][channel_last])
    fn = f"max_pool{n}d"
    x = _pool_input(n, channel_last, 10 + n)
    out = _fwd_bwd(lambda a: getattr(JF, fn)(a, **kw),
                   lambda a: getattr(TF, fn)(a, **kw), [x], POOL_TOL)
    want, wmask = getattr(JF, fn)(jnp.asarray(x), return_mask=True, **kw)
    got, mask = getattr(TF, fn)(torch.tensor(x), return_mask=True, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), out.detach().numpy())
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))


def test_max_pool_mask_of_a_window_in_the_padding_is_minus_one():
    """A ceil window that holds only padding is -inf with index -1 in
    JAX (its reducer starts from (-inf, -1)); so here."""
    x = _unique(0, 1, 1, 5)
    want, wmask = JF.max_pool1d(jnp.asarray(x), 2, 2, 1, return_mask=True,
                                ceil_mode=True)
    got, mask = TF.max_pool1d(torch.tensor(x), 2, 2, 1, return_mask=True,
                              ceil_mode=True)
    assert int(mask[0, 0, -1]) == -1 and float(got[0, 0, -1]) == -np.inf
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))


@pytest.mark.parametrize("fn", ["avg_pool1d", "avg_pool2d", "avg_pool3d",
                                "max_pool1d", "max_pool2d", "max_pool3d"])
def test_pool_string_padding_raises_as_jax(fn):
    n = int(fn[-2])
    x = _unique(0, 1, 1, *(4,) * n)
    with pytest.raises(JInvalidArgumentError):
        getattr(JF, fn)(jnp.asarray(x), 2, padding="SAME")
    with pytest.raises(InvalidArgumentError, match="string padding"):
        getattr(TF, fn)(torch.tensor(x), 2, padding="SAME")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", ["avg_pool2d", "max_pool3d", "avg_pool1d"])
def test_pool_bf16_matches_jax(fn, dtype):
    n = int(fn[-2])
    x = _unique(4, *POOL_SHAPES[n])
    jx = jnp.asarray(x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16"
                     else x)
    tx = torch.tensor(x).to(getattr(torch, dtype))
    kw = dict(kernel_size=3, stride=2, padding=1, ceil_mode=True)
    want, got = getattr(JF, fn)(jx, **kw), getattr(TF, fn)(tx, **kw)
    assert got.dtype == tx.dtype and str(want.dtype) == dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(BF16 if dtype == "bfloat16" else POOL_TOL))


#: (rank, output_size): non-divisible bins, even splits, None keeps a dim
ADAPTIVE = [(1, 4), (1, 3), (2, 3), (2, (4, None)), (2, (2, 5)),
            (3, 2), (3, (3, 4, 5))]


@pytest.mark.parametrize("op", ["avg", "max"])
@pytest.mark.parametrize("n,size", ADAPTIVE, ids=str)
def test_adaptive_pool_matches_jax(n, size, op):
    fn = f"adaptive_{op}_pool{n}d"
    x = _unique(20 + n, *POOL_SHAPES[n])
    _fwd_bwd(lambda a: getattr(JF, fn)(a, size),
             lambda a: getattr(TF, fn)(a, size), [x], POOL_TOL)


@pytest.mark.parametrize("n", [2, 3])
def test_adaptive_avg_pool_channels_last_matches_jax(n):
    fmt = _FORMATS[n][1]
    x = _last(_unique(30, *POOL_SHAPES[n]))
    fn = f"adaptive_avg_pool{n}d"
    _fwd_bwd(lambda a: getattr(JF, fn)(a, 3, data_format=fmt),
             lambda a: getattr(TF, fn)(a, 3, data_format=fmt), [x],
             POOL_TOL)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_adaptive_max_pool_mask_is_none_as_in_jax(n):
    fn = f"adaptive_max_pool{n}d"
    x = _unique(40, *POOL_SHAPES[n])
    want, wmask = getattr(JF, fn)(jnp.asarray(x), 3, return_mask=True)
    got, mask = getattr(TF, fn)(torch.tensor(x), 3, return_mask=True)
    assert wmask is None and mask is None
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_adaptive_avg_pool_bf16_means_in_float32_as_jax():
    x = _rand(41, 2, 3, 7, 5)
    bx = x.astype(ml_dtypes.bfloat16)
    want = JF.adaptive_avg_pool2d(jnp.asarray(bx), (3, 2))
    got = TF.adaptive_avg_pool2d(torch.tensor(x).to(torch.bfloat16), (3, 2))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


#: layer: (kwargs, channels-first input rank)
POOL_LAYERS = [
    ("AvgPool1D", dict(kernel_size=3, stride=2, padding=1, ceil_mode=True),
     1),
    ("AvgPool1D", dict(kernel_size=2, exclusive=False, data_format="NLC"),
     1),
    ("AvgPool2D", dict(kernel_size=3, stride=2, padding=1, exclusive=False),
     2),
    ("AvgPool2D", dict(kernel_size=2, divisor_override=3, ceil_mode=True),
     2),
    ("AvgPool3D", dict(kernel_size=2, stride=2, ceil_mode=True,
                       data_format="NDHWC"), 3),
    ("MaxPool1D", dict(kernel_size=3, stride=2, padding=1), 1),
    ("MaxPool2D", dict(kernel_size=3, stride=2, ceil_mode=True,
                       data_format="NHWC"), 2),
    ("MaxPool3D", dict(kernel_size=2, stride=2, padding=1), 3),
    ("AdaptiveAvgPool1D", dict(output_size=4), 1),
    ("AdaptiveAvgPool2D", dict(output_size=(3, 4), data_format="NHWC"), 2),
    ("AdaptiveAvgPool3D", dict(output_size=3), 3),
    ("AdaptiveMaxPool1D", dict(output_size=4), 1),
    ("AdaptiveMaxPool2D", dict(output_size=(3, 4)), 2),
    ("AdaptiveMaxPool3D", dict(output_size=(2, 3, 3)), 3),
]


@pytest.mark.parametrize("name,kw,n", POOL_LAYERS, ids=[
    f"{c[0]}-{i}" for i, c in enumerate(POOL_LAYERS)])
def test_pool_layer_as_jax(name, kw, n):
    jl, tl = getattr(jnn, name)(**kw), getattr(tnn, name)(**kw)
    x = _unique(50 + n, *POOL_SHAPES[n])
    if kw.get("data_format", "NC")[1] != "C":
        x = _last(x)
    check_pair(jl, tl, [x], **POOL_TOL)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_max_pool_layer_return_mask_as_jax(n):
    name = f"MaxPool{n}D"
    kw = dict(kernel_size=3, stride=2, padding=1, return_mask=True,
              ceil_mode=True)
    jl, tl = getattr(jnn, name)(**kw), getattr(tnn, name)(**kw)
    x = _unique(60 + n, *POOL_SHAPES[n])
    want, wmask = jl(jnp.asarray(x))
    got, mask = tl(torch.tensor(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_adaptive_max_pool_layer_return_mask_as_jax(n):
    name = f"AdaptiveMaxPool{n}D"
    jl = getattr(jnn, name)(3, return_mask=True)
    tl = getattr(tnn, name)(3, return_mask=True)
    x = _unique(70 + n, *POOL_SHAPES[n])
    (want, wmask), (got, mask) = jl(jnp.asarray(x)), tl(torch.tensor(x))
    assert wmask is None and mask is None
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pool_names_are_the_jax_names():
    for name in jnn.pooling.__all__ + jnn.conv.__all__:
        assert name in tnn.__all__ and hasattr(tnn, name), name
    for name in JF.pooling.__all__ + JF.conv.__all__:
        assert name in TF.__all__ and hasattr(TF, name), name


# -- the 1.x pools -----------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(pool_size=3, pool_type="avg", pool_stride=2, pool_padding=1),
    dict(pool_size=2, pool_type="avg", pool_stride=2, ceil_mode=True,
         exclusive=False),
    dict(pool_size=3, pool_type="avg", ceil_mode=True, exclusive=True,
         data_format="NHWC"),
    dict(pool_size=2, pool_type="max", pool_stride=2, ceil_mode=True),
], ids=str)
def test_windowed_pool2d_layer_as_jax(kw):
    jl, tl = jnn.Pool2D(**kw), tnn.Pool2D(**kw)
    x = _unique(80, 2, 3, 7, 9)
    if kw.get("data_format") == "NHWC":
        x = _last(x)
    check_pair(jl, tl, [x], **POOL_TOL)


@pytest.mark.parametrize("kw", [
    dict(pool_size=2, pool_type="max", pool_stride=2),
    dict(pool_size=3, pool_type="avg", pool_stride=2, pool_padding=1,
         ceil_mode=True),
    dict(pool_size=2, pool_type="avg", exclusive=False,
         data_format="NDHWC"),
    dict(pool_type="max", global_pooling=True),
    dict(pool_type="avg", global_pooling=True, data_format="NDHWC"),
], ids=str)
def test_fluid_pool3d_as_jax(kw):
    x = _unique(90, 1, 2, 5, 6, 7)
    if kw.get("data_format") == "NDHWC":
        x = _last(x)
    _fwd_bwd(lambda a: jfl.pool3d(a, **kw), lambda a: tfl.pool3d(a, **kw),
             [x], POOL_TOL)
