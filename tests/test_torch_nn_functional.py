"""The port's ``nn.functional`` (activations, common ops, norms, losses,
extension ops) held against the JAX package's on the CPU.

Inputs come from a seeded numpy generator and go through both packages'
function; the outputs must agree at rtol 2e-4 / atol 2e-5 (XLA's CPU
transcendentals are approximations: tanh, exp and log differ from torch's
at ~1e-6 relative), and so must the gradients of ``sum(out · c)`` for a
seeded cotangent ``c`` with respect to every floating input the case
names.  Functions that draw random numbers are held to invariants: the
JAX package draws from its own keys.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as tpt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.framework.errors import InvalidArgumentError

TOL = dict(rtol=2e-4, atol=2e-5)


def _f32(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _probs(rng, *shape):
    return rng.uniform(0.05, 0.95, size=shape).astype(np.float32)


def _check(name, inputs, kwargs=None, grad=(0,), tol=TOL, seed=1,
           call=None, module=None):
    """Both packages' ``name`` on ``inputs`` (numpy), forward and the
    gradients of ``sum(out · c)`` with respect to ``inputs[i]`` for ``i``
    in ``grad``.  ``call(fn, *inputs, **kwargs)`` calls the function (by
    default ``fn(*inputs, **kwargs)``); ``module`` names the submodule of
    ``nn.functional`` that holds it (default: ``nn.functional``)."""
    kwargs = kwargs or {}
    call = call or (lambda fn, *a, **k: fn(*a, **k))
    JM, TM = ((JF, TF) if module is None else
              (getattr(JF, module), getattr(TF, module)))
    jfn = lambda *a, **k: call(getattr(JM, name), *a, **k)  # noqa: E731
    tfn = lambda *a, **k: call(getattr(TM, name), *a, **k)  # noqa: E731
    jin = [jnp.asarray(a) for a in inputs]
    tin = [torch.tensor(a, requires_grad=i in grad)
           for i, a in enumerate(inputs)]
    jo = np.asarray(jfn(*jin, **kwargs))
    to = tfn(*tin, **kwargs)
    np.testing.assert_allclose(to.detach().numpy(), jo, err_msg=name, **tol)
    assert to.dtype == torch.from_numpy(np.zeros(0, jo.dtype)).dtype or (
        jo.dtype == np.float64 and to.dtype == torch.float32), (to.dtype,
                                                                jo.dtype)
    if not grad:
        return
    cot = np.asarray(np.random.RandomState(seed).randn(*jo.shape),
                     jo.dtype)

    def jloss(*diff):
        args = list(jin)
        for i, d in zip(grad, diff):
            args[i] = d
        return jnp.sum(jfn(*args, **kwargs) * cot)

    jg = jax.grad(jloss, argnums=tuple(range(len(grad))))(
        *[jin[i] for i in grad])
    tg = torch.autograd.grad((to * torch.from_numpy(cot)).sum(),
                             [tin[i] for i in grad])
    for i, a, b in zip(grad, tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   err_msg=f"{name} d/d input {i}", **tol)


# -- activations ---------------------------------------------------------------
ACTIVATIONS = [
    ("relu", {}), ("relu6", {}), ("relu_", {}), ("elu", dict(alpha=0.7)),
    ("selu", {}), ("celu", dict(alpha=1.3)), ("gelu", {}),
    ("gelu", dict(approximate=True)), ("silu", {}), ("swish", {}),
    ("leaky_relu", dict(negative_slope=0.2)), ("hardshrink", {}),
    ("hardsigmoid", {}), ("hardswish", {}), ("hardtanh", dict(min=-0.5,
                                                             max=0.7)),
    ("log_sigmoid", {}), ("log_softmax", dict(axis=1)),
    ("softmax", dict(axis=-1)), ("softmax_", {}), ("mish", {}),
    ("softplus", dict(beta=2.0, threshold=3.0)), ("softshrink", {}),
    ("softsign", {}), ("tanhshrink", {}),
    ("thresholded_relu", dict(threshold=0.3)), ("glu", dict(axis=1)),
    ("sigmoid", {}), ("tanh", {}),
]


@pytest.mark.parametrize("name,kw", ACTIVATIONS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(ACTIVATIONS)])
def test_activation_forward_and_grad_as_jax(name, kw):
    x = _f32(np.random.RandomState(0), 3, 4, 6, scale=3.0)
    _check(name, [x], kw)


@pytest.mark.parametrize("per_channel", [False, True])
def test_prelu_as_jax(per_channel):
    rng = np.random.RandomState(1)
    x = _f32(rng, 2, 3, 4, 4)
    w = (rng.rand(3 if per_channel else 1) * 0.5).astype(np.float32)
    _check("prelu", [x, w], grad=(0, 1))


def test_maxout_and_integer_inputs_as_jax():
    _check("maxout", [_f32(np.random.RandomState(2), 2, 6, 3)],
           dict(groups=3, axis=1))
    ints = np.arange(-4, 8).reshape(3, 4).astype(np.int64)
    for name in ("relu", "relu6", "sigmoid", "softmax"):
        _check(name, [ints], grad=())


def test_log_softmax_dtype_as_jax():
    _check("log_softmax", [_f32(np.random.RandomState(3), 4, 5)],
           dict(dtype="float64"), grad=())


def test_rrelu_eval_as_jax_and_training_slopes_in_range():
    x = _f32(np.random.RandomState(4), 6, 50, scale=2.0)
    _check("rrelu", [x], dict(training=False))
    tpt.seed(5)
    out = TF.rrelu(torch.from_numpy(x), 0.1, 0.3, training=True).numpy()
    neg = x < 0
    ratio = out[neg] / x[neg]
    assert ((ratio >= 0.1) & (ratio < 0.3)).all()
    assert np.array_equal(out[~neg], x[~neg])
    assert len(np.unique(ratio)) > 100  # one slope per element


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_invariants(hard):
    x = torch.tensor(_f32(np.random.RandomState(6), 8, 10), requires_grad=True)
    tpt.seed(3)
    y = TF.gumbel_softmax(x, temperature=0.5, hard=hard)
    torch.testing.assert_close(y.sum(-1), torch.ones(8))
    if hard:
        assert set(y.detach().unique().tolist()) <= {0.0, 1.0}
    tpt.seed(3)
    again = TF.gumbel_softmax(x, temperature=0.5, hard=hard)
    assert torch.equal(y, again)  # the port's generator, reseeded
    (g,) = torch.autograd.grad((y * torch.arange(10.0)).sum(), x)
    assert torch.isfinite(g).all() and g.abs().sum() > 0


# -- common ops ------------------------------------------------------------------
def test_linear_as_jax():
    rng = np.random.RandomState(7)
    _check("linear", [_f32(rng, 3, 5, 4), _f32(rng, 4, 6), _f32(rng, 6)],
           grad=(0, 1, 2))


def test_npu_identity_as_jax():
    _check("npu_identity", [_f32(np.random.RandomState(31), 3, 4)])


def test_one_hot_and_sequence_mask_as_jax():
    ids = np.array([[0, 3, 5], [4, -1, 2]], np.int64)  # -1 and 5: zero rows
    _check("one_hot", [ids], dict(num_classes=5), grad=())
    lengths = np.array([3, 0, 5, 1], np.int64)
    _check("sequence_mask", [lengths], {}, grad=())
    _check("sequence_mask", [lengths], dict(maxlen=7, dtype="float32"),
           grad=())
    assert TF.sequence_mask(torch.tensor(lengths)).dtype == torch.int64


INTERP = [
    ((2, 3, 5, 7), dict(size=[8, 11], mode="nearest")),
    ((2, 3, 8, 6), dict(scale_factor=0.5, mode="nearest")),
    ((2, 3, 5, 7), dict(size=[9, 4], mode="bilinear")),
    ((2, 3, 5, 7), dict(size=[9, 4], mode="bilinear", align_corners=True)),
    ((2, 3, 5, 7), dict(size=[9, 4], mode="bilinear", align_mode=1)),
    ((2, 4, 7), dict(size=12, mode="linear")),
    ((1, 2, 3, 4, 5), dict(size=[5, 6, 3], mode="trilinear")),
    ((2, 5, 7, 3), dict(size=[10, 5], mode="bilinear",
                        data_format="NHWC")),
    ((2, 3, 5, 7), dict(size=[9, 14], mode="bicubic")),
    ((2, 3, 12, 10), dict(size=[5, 4], mode="bicubic")),
    ((2, 3, 12, 10), dict(size=[4, 5], mode="area")),
    ((2, 3, 12, 10), dict(size=[5, 3], mode="area")),
]


@pytest.mark.parametrize("shape,kw", INTERP, ids=[str(i) for i in
                                                   range(len(INTERP))])
def test_interpolate_as_jax(shape, kw):
    x = _f32(np.random.RandomState(8), *shape)
    _check("interpolate", [x], kw)
    _check("upsample", [x], kw)


SHUFFLES = [
    ("pixel_shuffle", (2, 8, 3, 4), dict(upscale_factor=2)),
    ("pixel_shuffle", (2, 3, 4, 9), dict(upscale_factor=3,
                                          data_format="NHWC")),
    ("pixel_unshuffle", (2, 3, 4, 6), dict(downscale_factor=2)),
    ("pixel_unshuffle", (2, 4, 6, 3), dict(downscale_factor=2,
                                            data_format="NHWC")),
    ("channel_shuffle", (2, 6, 3, 3), dict(groups=3)),
    ("channel_shuffle", (2, 3, 3, 6), dict(groups=2, data_format="NHWC")),
    ("temporal_shift", (6, 8, 3, 3), dict(seg_num=3, shift_ratio=0.25)),
]


@pytest.mark.parametrize("name,shape,kw", SHUFFLES,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(SHUFFLES)])
def test_shuffles_as_jax(name, shape, kw):
    _check(name, [_f32(np.random.RandomState(9), *shape)], kw)


@pytest.mark.parametrize("kw", [
    dict(kernel_sizes=3), dict(kernel_sizes=[2, 3], strides=2, paddings=1),
    dict(kernel_sizes=2, strides=[1, 2], paddings=[1, 0, 2, 1],
         dilations=2)], ids=["k3", "strided", "dilated"])
def test_unfold_and_fold_as_jax(kw):
    rng = np.random.RandomState(10)
    x = _f32(rng, 2, 3, 7, 8)
    _check("unfold", [x], kw)
    cols = np.asarray(JF.unfold(jnp.asarray(x), **kw))
    _check("fold", [cols], dict(output_sizes=[7, 8], **kw))


@pytest.mark.parametrize("mode", ["constant", "reflect", "replicate",
                                  "circular"])
def test_pad_as_jax(mode):
    x = _f32(np.random.RandomState(11), 2, 3, 5, 6)
    _check("pad", [x], dict(pad=[1, 2, 2, 1], mode=mode, value=0.5))


def test_bilinear_as_jax():
    rng = np.random.RandomState(12)
    _check("bilinear", [_f32(rng, 4, 3), _f32(rng, 4, 5), _f32(rng, 6, 3, 5),
                        _f32(rng, 6)], grad=(0, 1, 2, 3))


@pytest.mark.parametrize("align", [True, False])
def test_affine_grid_and_grid_sample_as_jax(align):
    rng = np.random.RandomState(13)
    theta = (np.eye(2, 3)[None] + 0.2 * rng.randn(2, 2, 3)).astype(
        np.float32)
    _check("affine_grid", [theta], dict(out_shape=[2, 3, 5, 6],
                                        align_corners=align))
    x = _f32(rng, 2, 3, 6, 7)
    grid = rng.uniform(-1.2, 1.2, size=(2, 4, 5, 2)).astype(np.float32)
    for mode in ("bilinear", "nearest"):
        for pad in ("zeros", "border"):
            _check("grid_sample", [x, grid],
                   dict(mode=mode, padding_mode=pad, align_corners=align),
                   grad=(0,))


def test_dropouts_in_eval_and_at_zero_as_jax():
    x = _f32(np.random.RandomState(14), 2, 3, 4, 4)
    _check("dropout", [x], dict(p=0.3, training=False))
    _check("dropout", [x], dict(p=0.3, training=False,
                                mode="downscale_in_infer"))
    _check("dropout", [x], dict(p=0.0))
    _check("alpha_dropout", [x], dict(p=0.3, training=False))
    for name in ("dropout2d", "dropout3d"):
        shape = (2, 3, 4, 4) if name == "dropout2d" else (2, 3, 2, 4, 4)
        _check(name, [_f32(np.random.RandomState(15), *shape)],
               dict(p=0.4, training=False))


def test_dropout_masks_in_training():
    x = torch.ones(4, 6, 5, 5)
    tpt.seed(2)
    out = TF.dropout(x, p=0.4)
    scale = float(torch.tensor(1.0) / 0.6)  # one float32 division
    assert set(out.unique().tolist()) <= {0.0, scale}
    tpt.seed(2)
    assert torch.equal(out, TF.dropout(x, p=0.4))
    ch = TF.dropout2d(x, p=0.5)  # one draw per (sample, channel)
    assert (ch.flatten(2).std(-1) == 0).all()
    down = TF.dropout(x, p=0.4, mode="downscale_in_infer")
    assert set(down.unique().tolist()) <= {0.0, 1.0}
    axis = TF.dropout(x, p=0.5, axis=1)
    assert (axis.amax((0, 2, 3)) == axis.amin((0, 2, 3))).all()
    alpha = TF.alpha_dropout(torch.zeros(1000), p=0.5)
    assert len(alpha.unique()) == 2


# -- norms -------------------------------------------------------------------------
def test_layer_norm_as_jax():
    rng = np.random.RandomState(16)
    _check("layer_norm", [_f32(rng, 2, 3, 8), _f32(rng, 3, 8),
                          _f32(rng, 3, 8)], dict(epsilon=1e-5),
           grad=(0, 1, 2), call=lambda fn, x, w, b, **k: fn(x, [3, 8], w, b,
                                                           **k))
    with pytest.raises(InvalidArgumentError):
        TF.layer_norm(torch.zeros(2, 4), [5])


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_instance_and_group_norm_as_jax(fmt):
    rng = np.random.RandomState(17)
    x = _f32(rng, 2, 6, 5, 4) if fmt == "NCHW" else _f32(rng, 2, 5, 4, 6)
    w, b = _f32(rng, 6), _f32(rng, 6)
    _check("instance_norm", [x], dict(data_format=fmt, eps=1e-5))
    jin = [jnp.asarray(v) for v in (x, w, b)]
    tin = [torch.tensor(v) for v in (x, w, b)]
    np.testing.assert_allclose(
        TF.instance_norm(tin[0], weight=tin[1], bias=tin[2],
                         data_format=fmt).numpy(),
        np.asarray(JF.instance_norm(jin[0], weight=jin[1], bias=jin[2],
                                    data_format=fmt)), **TOL)
    _check("group_norm", [x], dict(num_groups=3, data_format=fmt))
    np.testing.assert_allclose(
        TF.group_norm(tin[0], 2, 1e-5, tin[1], tin[2], fmt).numpy(),
        np.asarray(JF.group_norm(jin[0], 2, 1e-5, jin[1], jin[2], fmt)),
        **TOL)


def test_norms_of_bf16_keep_dtype_as_jax():
    x = _f32(np.random.RandomState(18), 2, 4, 3, 3)
    for name, kw in (("layer_norm", dict(normalized_shape=[3])),
                     ("group_norm", dict(num_groups=2)),
                     ("instance_norm", {})):
        t = getattr(TF, name)(torch.tensor(x).bfloat16(), **kw)
        j = getattr(JF, name)(jnp.asarray(x, jnp.bfloat16), **kw)
        assert t.dtype == torch.bfloat16
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(j, np.float32), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("kw", [dict(size=3), dict(size=4, alpha=1e-2,
                                                   beta=0.5, k=2.0),
                                dict(size=5, data_format="NHWC")])
def test_local_response_norm_as_jax(kw):
    _check("local_response_norm",
           [_f32(np.random.RandomState(19), 2, 7, 3, 4)], kw)


@pytest.mark.parametrize("p,axis", [(2, 1), (1, -1), (3, 0)])
def test_normalize_as_jax(p, axis):
    _check("normalize", [_f32(np.random.RandomState(20), 3, 4, 5)],
           dict(p=p, axis=axis))


# -- losses --------------------------------------------------------------------------
def _loss_cases():
    rng = np.random.RandomState(21)
    logits = _f32(rng, 6, 5)
    p = _probs(rng, 6, 5)
    y01 = (rng.rand(6, 5) > 0.5).astype(np.float32)
    lbl = rng.randint(0, 5, size=(6,)).astype(np.int64)
    lbl[2] = -100
    logp = np.asarray(jax.nn.log_softmax(logits, -1))
    sign = np.where(rng.rand(6) > 0.5, 1.0, -1.0).astype(np.float32)
    a, b, c = _f32(rng, 6, 4), _f32(rng, 6, 4), _f32(rng, 6, 4)
    w5 = _probs(rng, 5)
    cases = []
    for red in ("mean", "sum", "none"):
        cases += [
            ("binary_cross_entropy", [p, y01], dict(reduction=red), (0,)),
            ("binary_cross_entropy_with_logits", [logits, y01],
             dict(reduction=red), (0,)),
            ("mse_loss", [a, b], dict(reduction=red), (0, 1)),
            ("l1_loss", [a, b], dict(reduction=red), (0, 1)),
            ("nll_loss", [logp, lbl], dict(reduction=red), (0,)),
            ("smooth_l1_loss", [a, b], dict(reduction=red, delta=0.7),
             (0, 1)),
            ("margin_ranking_loss", [a[:, 0], b[:, 0], sign],
             dict(margin=0.1, reduction=red), (0, 1)),
            ("cosine_embedding_loss", [a, b, sign],
             dict(margin=0.2, reduction=red), (0, 1)),
            ("hinge_embedding_loss", [a, np.sign(b)],
             dict(margin=0.5, reduction=red), (0,)),
            ("triplet_margin_loss", [a, b, c], dict(reduction=red), (0, 1, 2)),
            ("kl_div", [logp, p / p.sum(-1, keepdims=True)],
             dict(reduction=red), (0, 1)),
        ]
    cases += [
        ("binary_cross_entropy", [p, y01], dict(weight=w5), (0,)),
        ("binary_cross_entropy_with_logits", [logits, y01],
         dict(weight=w5, pos_weight=w5 * 2), (0,)),
        ("nll_loss", [logp, lbl], dict(weight=w5), (0,)),
        ("kl_div", [logp, p / p.sum(-1, keepdims=True)],
         dict(reduction="batchmean"), (0,)),
        ("triplet_margin_loss", [a, b, c], dict(p=1.0, swap=True), (0, 1, 2)),
        ("cross_entropy", [logits, lbl], dict(weight=w5), (0,)),
        ("cross_entropy", [logits, lbl], dict(label_smoothing=0.1), (0,)),
        ("label_smooth", [y01], dict(epsilon=0.2), (0,)),
        ("label_smooth", [y01], dict(prior_dist=w5), (0,)),
        ("square_error_cost", [a, b], {}, (0, 1)),
        ("log_loss", [p, y01], {}, (0,)),
        ("sigmoid_focal_loss", [logits, y01], dict(module="loss"), (0,)),
        ("sigmoid_focal_loss", [logits, y01],
         dict(normalizer=np.float32(3.0), reduction="mean", gamma=1.5,
              module="loss"), (0,)),
        ("sigmoid_focal_loss", [logits, np.array(
            [[0], [1], [5], [-1], [3], [2]], np.int64), np.float32(2.0)],
         {}, (0,)),
        ("dice_loss", [p / p.sum(-1, keepdims=True),
                       rng.randint(0, 5, size=(6, 1)).astype(np.int64)],
         {}, (0,)),
        ("npair_loss", [a, b, rng.randint(0, 3, size=(6,)).astype(
            np.float32)], {}, (0, 1)),
        ("cosine_similarity", [a, b], dict(axis=1), (0, 1)),
        ("cosine_similarity", [a, b], dict(axis=0), (0, 1)),
    ]
    return cases


LOSSES = _loss_cases()


@pytest.mark.parametrize("case", LOSSES, ids=[
    f"{c[0]}-{i}" for i, c in enumerate(LOSSES)])
def test_loss_as_jax(case):
    name, inputs, kw, grad = case
    kw = dict(kw)
    module = kw.pop("module", None)
    _check(name, inputs, kw, grad=grad, module=module)


def test_loss_reduction_errors_as_jax():
    with pytest.raises(InvalidArgumentError):
        TF.mse_loss(torch.zeros(3), torch.zeros(3), reduction="avg")


@pytest.mark.parametrize("reduction,norm", [("mean", False), ("sum", False),
                                            ("none", True)])
def test_ctc_loss_as_jax(reduction, norm):
    rng = np.random.RandomState(22)
    T, N, C, S = 12, 3, 6, 4
    logp = np.asarray(jax.nn.log_softmax(_f32(rng, T, N, C), -1))
    labels = rng.randint(1, C, size=(N, S)).astype(np.int64)
    labels[1, 2] = labels[1, 1]  # a repeat: the blank between is required
    in_len = np.array([12, 9, 7], np.int64)
    lab_len = np.array([4, 3, 2], np.int64)
    _check("ctc_loss", [logp, labels, in_len, lab_len],
           dict(blank=0, reduction=reduction, norm_by_times=norm))


@pytest.mark.parametrize("num_classes", [2, 5, 8, 13])
def test_hsigmoid_loss_default_tree_as_jax(num_classes):
    rng = np.random.RandomState(23)
    x = _f32(rng, 7, 4)
    label = rng.randint(0, num_classes, size=(7,)).astype(np.int64)
    w = _f32(rng, num_classes - 1, 4)
    b = _f32(rng, num_classes - 1)
    _check("hsigmoid_loss", [x, label, w, b], grad=(0, 2, 3),
           call=lambda fn, x, lbl, w, b: fn(x, lbl, num_classes, w, b))


def _hsig(module, x, label, w, b, **kw):
    return module.hsigmoid_loss(x, label, 6, w, b, **kw)


def test_hsigmoid_loss_custom_tree_as_jax():
    rng = np.random.RandomState(24)
    x, w, b = _f32(rng, 4, 3), _f32(rng, 6, 3), _f32(rng, 6)
    label = np.array([0, 1, 2, 3], np.int64)
    table = np.array([[0, 2, -1], [0, 3, 5], [1, -1, -1], [1, 4, 5]],
                     np.int64)
    code = (rng.rand(4, 3) > 0.5).astype(np.float32)
    j = _hsig(JF, *map(jnp.asarray, (x, label, w, b)),
              path_table=jnp.asarray(table), path_code=jnp.asarray(code))
    t = _hsig(TF, *map(torch.tensor, (x, label, w, b)),
              path_table=torch.tensor(table), path_code=torch.tensor(code))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    with pytest.raises(InvalidArgumentError):
        TF.hsigmoid_loss(torch.tensor(x), torch.tensor(label), 6,
                         torch.tensor(w), path_table=torch.tensor(table))


# -- extension ops ---------------------------------------------------------------
@pytest.mark.parametrize("act", [None, "relu", "tanh"])
def test_row_conv_as_jax(act):
    rng = np.random.RandomState(25)
    _check("row_conv", [_f32(rng, 2, 7, 4), _f32(rng, 3, 4)],
           dict(act=act), grad=(0, 1))


@pytest.mark.parametrize("shape,kw", [
    ((3,), {}), ((2, 4), dict(offset=1)), ((2, 3, 4), dict(offset=-2)),
    ((2, 3), dict(dim1=0, dim2=2)), ((2, 3), dict(offset=1, dim1=-1,
                                                  dim2=0))])
def test_diag_embed_as_jax(shape, kw):
    _check("diag_embed", [_f32(np.random.RandomState(26), *shape)], kw)


def test_gather_tree_as_jax():
    rng = np.random.RandomState(27)
    T, B, W = 6, 3, 4
    ids = rng.randint(0, 50, size=(T, B, W)).astype(np.int64)
    parents = rng.randint(0, W, size=(T, B, W)).astype(np.int64)
    got = TF.gather_tree(torch.tensor(ids), torch.tensor(parents))
    want = np.asarray(JF.gather_tree(jnp.asarray(ids), jnp.asarray(parents)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(InvalidArgumentError):
        TF.gather_tree(torch.zeros(3, 4, dtype=torch.int64),
                       torch.zeros(3, 4, dtype=torch.int64))
