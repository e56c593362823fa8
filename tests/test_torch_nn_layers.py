"""The port's ``nn`` layers (activations, common layers, norms, losses,
containers, weight norm) held against the JAX package's on the CPU.

Each case builds the JAX layer and the port's with the same arguments,
bridges the JAX weights by dotted name (``load_jax_params``, which also
holds the names and shapes 1:1), and compares the outputs and the
gradients with respect to every parameter and the first input at rtol /
atol 2e-5 (float32; the transcendental-heavy activations at 2e-4, XLA's
CPU approximations).  Layers that draw random numbers run in eval mode
here (their training draws are held in ``test_torch_nn_functional.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.nn as jnn
from paddle_tpu.nn import functional_call
import paddle_tpu_torch as tpt
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.framework.errors import (InvalidArgumentError,
                                               UnimplementedError)
from paddle_tpu_torch.nn.initializer import fills_its_layers
from torch_nn_pairs import bridged, check_pair, jax_params

TOL = dict(rtol=2e-5, atol=2e-5)
LOOSE = dict(rtol=2e-4, atol=2e-5)


def _x(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _pair(name, *args, **kw):
    jpt.seed(5)
    jl = getattr(jnn, name)(*args, **kw)
    tl = getattr(tnn, name)(*args, **kw)
    jl.eval()
    return jl, bridged(jl, tl)


# -- activation layers ---------------------------------------------------------
ACT_LAYERS = [
    ("ReLU", (), {}), ("ReLU6", (), {}), ("ELU", (0.5,), {}), ("SELU", (), {}),
    ("CELU", (), dict(alpha=0.8)), ("GELU", (), {}),
    ("GELU", (), dict(approximate=True)), ("Silu", (), {}), ("Swish", (), {}),
    ("LeakyReLU", (0.1,), {}), ("RReLU", (), {}), ("Hardshrink", (0.3,), {}),
    ("Hardsigmoid", (), {}), ("Hardswish", (), {}), ("Hardtanh", (-2.0, 1.5),
                                                    {}),
    ("LogSigmoid", (), {}), ("LogSoftmax", (1,), {}), ("Softmax", (), {}),
    ("Maxout", (2,), dict(axis=1)), ("Mish", (), {}),
    ("Softplus", (), dict(beta=1.5, threshold=4.0)), ("Softshrink", (), {}),
    ("Softsign", (), {}), ("Tanhshrink", (), {}),
    ("ThresholdedReLU", (), dict(threshold=0.2)), ("GLU", (1,), {}),
    ("Sigmoid", (), {}), ("Tanh", (), {}),
]


@pytest.mark.parametrize("name,args,kw", ACT_LAYERS, ids=[
    f"{n}-{i}" for i, (n, _, _) in enumerate(ACT_LAYERS)])
def test_activation_layer_as_jax(name, args, kw):
    jl, tl = _pair(name, *args, **kw)
    check_pair(jl, tl, [_x(2, 4, 3, 5, scale=2.0)], **LOOSE)


@pytest.mark.parametrize("n", [1, 4])
def test_prelu_layer_as_jax(n):
    jl, tl = _pair("PReLU", num_parameters=n, init=0.3)
    assert list(tl.state_dict()) == ["weight"]
    check_pair(jl, tl, [_x(2, 4, 3, 3)], **TOL)


# -- common layers -------------------------------------------------------------
COMMON = [
    ("Identity", (3,), {}, [(2, 3)]),
    ("Linear", (4, 3), {}, [(2, 5, 4)]),
    ("Linear", (4, 3), dict(bias_attr=False), [(2, 4)]),
    ("Flatten", (), {}, [(2, 3, 4, 5)]),
    ("Flatten", (), dict(start_axis=0, stop_axis=1), [(2, 3, 4)]),
    ("Unflatten", (1, [2, 3]), {}, [(4, 6, 2)]),
    ("Upsample", (), dict(size=[5, 7], mode="bilinear"), [(2, 3, 4, 4)]),
    ("Upsample", (), dict(scale_factor=2, mode="nearest"), [(2, 3, 4, 4)]),
    ("UpsamplingBilinear2D", (), dict(size=[6, 5]), [(2, 3, 4, 4)]),
    ("UpsamplingNearest2D", (), dict(scale_factor=3), [(2, 3, 2, 3)]),
    ("Pad1D", ([1, 2],), dict(mode="reflect"), [(2, 3, 6)]),
    ("Pad2D", (1,), dict(value=0.3), [(2, 3, 4, 4)]),
    ("Pad3D", ([1, 0, 2, 1, 0, 1],), dict(mode="replicate"),
     [(1, 2, 3, 4, 4)]),
    ("ZeroPad2D", ([1, 2, 0, 1],), {}, [(2, 3, 4, 4)]),
    ("CosineSimilarity", (), dict(axis=1), [(4, 5), (4, 5)]),
    ("Bilinear", (3, 4, 5), {}, [(6, 3), (6, 4)]),
    ("PixelShuffle", (2,), {}, [(2, 8, 3, 3)]),
    ("PixelUnshuffle", (2,), {}, [(2, 2, 4, 6)]),
    ("ChannelShuffle", (2,), {}, [(2, 4, 3, 3)]),
    ("Fold", ([5, 6], 2), dict(strides=1), [(2, 12, 20)]),
    ("Unfold", (3,), dict(paddings=1), [(2, 3, 5, 5)]),
    ("PairwiseDistance", (), dict(p=2.0), [(4, 6), (4, 6)]),
    ("PairwiseDistance", (), dict(p=1.0, keepdim=True), [(4, 6), (4, 6)]),
    ("RowConv", (4, 2), {}, [(2, 6, 4)]),
    ("RowConv", (4, 2), dict(activation="relu"), [(2, 6, 4)]),
    ("BilinearTensorProduct", (3, 4, 5), dict(act="tanh"), [(6, 3), (6, 4)]),
    ("Pool2D", (2,), dict(pool_stride=2), [(2, 3, 6, 6)]),
    ("Pool2D", (), dict(global_pooling=True), [(2, 3, 5, 5)]),
    ("Pool2D", (), dict(global_pooling=True, pool_type="avg"),
     [(2, 3, 5, 5)]),
    ("Dropout", (0.4,), {}, [(3, 5)]),
    ("Dropout", (0.4,), dict(mode="downscale_in_infer"), [(3, 5)]),
    ("Dropout2D", (0.3,), {}, [(2, 3, 4, 4)]),
    ("Dropout3D", (0.3,), {}, [(2, 3, 2, 4, 4)]),
    ("AlphaDropout", (0.3,), {}, [(3, 5)]),
]


@pytest.mark.parametrize("name,args,kw,shapes", COMMON, ids=[
    f"{c[0]}-{i}" for i, c in enumerate(COMMON)])
def test_common_layer_as_jax(name, args, kw, shapes):
    jl, tl = _pair(name, *args, **kw)
    assert list(tl.state_dict()) == list(jl.state_dict())
    check_pair(jl, tl, [_x(*s, seed=i) for i, s in enumerate(shapes)],
               **TOL)


def test_embedding_layer_as_jax():
    jl, tl = _pair("Embedding", 10, 4, padding_idx=2)
    ids = np.array([[1, 2, 9], [0, 2, 5]], np.int64)
    check_pair(jl, tl, [ids], grad_inputs=(), **TOL)


def test_pool2d_errors():
    with pytest.raises(InvalidArgumentError):
        tnn.Pool2D(pool_type="min", pool_size=2)
    with pytest.raises(InvalidArgumentError):
        tnn.Pool2D()
    # a windowed average pool is ported: avg_pool2d with the layer's
    # exclusive and ceil_mode
    x = torch.arange(25.0).reshape(1, 1, 5, 5)
    torch.testing.assert_close(
        tnn.Pool2D(2, pool_type="avg", pool_stride=2, ceil_mode=True,
                   exclusive=False)(x),
        tnn.functional.avg_pool2d(x, 2, 2, ceil_mode=True, exclusive=False))


# -- norm layers -----------------------------------------------------------------
NORMS = [
    ("LayerNorm", (6,), {}, (2, 3, 6)),
    ("LayerNorm", ([3, 6],), dict(weight_attr=False), (2, 3, 6)),
    ("GroupNorm", (2, 6), {}, (2, 6, 3, 3)),
    ("GroupNorm", (3, 6), dict(data_format="NHWC"), (2, 3, 3, 6)),
    ("GroupNorm", (2, 4), dict(bias_attr=False), (2, 4, 5)),
    ("InstanceNorm1D", (4,), {}, (2, 4, 7)),
    ("InstanceNorm2D", (4,), {}, (2, 4, 3, 5)),
    ("InstanceNorm3D", (4,), dict(epsilon=1e-3), (2, 4, 2, 3, 3)),
    ("LocalResponseNorm", (3,), {}, (2, 5, 3, 3)),
    ("BatchNorm", (4,), dict(act="sigmoid"), (3, 4, 2, 2)),
]


@pytest.mark.parametrize("name,args,kw,shape", NORMS, ids=[
    f"{c[0]}-{i}" for i, c in enumerate(NORMS)])
def test_norm_layer_as_jax(name, args, kw, shape):
    jl, tl = _pair(name, *args, **kw)
    assert list(tl.state_dict()) == list(jl.state_dict())
    check_pair(jl, tl, [_x(*shape)], **TOL)


@pytest.mark.parametrize("dim,iters", [(0, 1), (1, 3)])
def test_spectral_norm_as_jax(dim, iters):
    jl = jnn.SpectralNorm([4, 3, 2], dim=dim, power_iters=iters)
    tl = tnn.SpectralNorm([4, 3, 2], dim=dim, power_iters=iters)
    assert list(tl.state_dict()) == list(jl.state_dict()) == []
    assert [n for n, _ in tl.named_buffers()] == ["weight_u", "weight_v"]
    bridged(jl, tl, buffers=True)
    w = _x(4, 3, 2, seed=3)
    cot = _x(4, 3, 2, seed=4)
    # the JAX gradient from the stored vectors (return_buffers restores them)
    jg = jax.grad(lambda v: jnp.sum(functional_call(
        jl, {}, v, return_buffers=True)[0] * cot))(jnp.asarray(w))
    tw = torch.tensor(w, requires_grad=True)
    for call in range(2):  # each call iterates from the stored vectors
        out = tl(tw)
        np.testing.assert_allclose(out.detach().numpy(),
                                   np.asarray(jl(jnp.asarray(w))), **TOL)
        if call == 0:
            (g,) = torch.autograd.grad((out * torch.tensor(cot)).sum(), tw)
            np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)
        np.testing.assert_allclose(tl.weight_u.numpy(),
                                   np.asarray(jl.weight_u.value), **TOL)
        np.testing.assert_allclose(tl.weight_v.numpy(),
                                   np.asarray(jl.weight_v.value), **TOL)


def test_sync_batch_norm_raises_naming_its_item():
    with pytest.raises(UnimplementedError, match="distributed execution"):
        tnn.SyncBatchNorm(4)


# -- loss layers -------------------------------------------------------------------
def _loss_inputs():
    rng = np.random.RandomState(9)
    logits = rng.randn(6, 5).astype(np.float32)
    lbl = rng.randint(0, 5, size=(6,)).astype(np.int64)
    logp = np.log(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True))
    p = rng.uniform(0.05, 0.95, size=(6, 5)).astype(np.float32)
    y = (rng.rand(6, 5) > 0.5).astype(np.float32)
    a, b, c = (rng.randn(6, 4).astype(np.float32) for _ in range(3))
    sign = np.where(rng.rand(6) > 0.5, 1.0, -1.0).astype(np.float32)
    return [
        ("CrossEntropyLoss", {}, [logits, lbl]),
        ("CrossEntropyLoss", dict(label_smoothing=0.2, reduction="sum"),
         [logits, lbl]),
        ("MSELoss", {}, [a, b]), ("L1Loss", dict(reduction="sum"), [a, b]),
        ("NLLLoss", {}, [logp.astype(np.float32), lbl]),
        ("BCELoss", {}, [p, y]), ("BCEWithLogitsLoss", {}, [logits, y]),
        ("KLDivLoss", dict(reduction="batchmean"),
         [logp.astype(np.float32), p]),
        ("SmoothL1Loss", dict(delta=0.5), [a, b]),
        ("MarginRankingLoss", dict(margin=0.1), [a[:, 0], b[:, 0], sign]),
        ("CosineEmbeddingLoss", dict(margin=0.1), [a, b, sign]),
        ("HingeEmbeddingLoss", {}, [a, np.sign(b)]),
        ("TripletMarginLoss", dict(swap=True), [a, b, c]),
    ]


LOSS_LAYERS = _loss_inputs()


@pytest.mark.parametrize("name,kw,inputs", LOSS_LAYERS, ids=[
    f"{c[0]}-{i}" for i, c in enumerate(LOSS_LAYERS)])
def test_loss_layer_as_jax(name, kw, inputs):
    jl, tl = _pair(name, **kw)
    check_pair(jl, tl, inputs, **LOOSE)


def test_ctc_loss_layer_as_jax():
    rng = np.random.RandomState(10)
    x = rng.randn(10, 2, 5).astype(np.float32)
    logp = (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)
    labels = np.array([[1, 2, 2], [3, 4, 0]], np.int64)
    jl, tl = _pair("CTCLoss", blank=0)
    check_pair(jl, tl, [logp, labels, np.array([10, 8], np.int64),
                        np.array([3, 2], np.int64)], **LOOSE)


@pytest.mark.parametrize("custom", [False, True])
def test_hsigmoid_loss_layer_as_jax(custom):
    jl, tl = _pair("HSigmoidLoss", 4, 6, is_custom=custom)
    assert list(tl.state_dict()) == ["weight", "bias"]
    assert tuple(tl.weight.shape) == (6 if custom else 5, 4)
    x = _x(5, 4, seed=11)
    label = np.array([0, 3, 5, 2, 1], np.int64)
    kw = {}
    if custom:
        table = np.array([[0, 1, -1], [0, 2, 4], [3, 5, -1], [1, -1, -1],
                          [2, 4, 5]], np.int64)
        code = (np.random.RandomState(12).rand(5, 3) > 0.5).astype(np.float32)
        kw = dict(path_table=table, path_code=code)
        jo = jl(jnp.asarray(x), jnp.asarray(label),
                **{k: jnp.asarray(v) for k, v in kw.items()})
        to = tl(torch.tensor(x), torch.tensor(label),
                **{k: torch.tensor(v) for k, v in kw.items()})
        np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **TOL)
        with pytest.raises(InvalidArgumentError):
            tl(torch.tensor(x), torch.tensor(label))
        return
    check_pair(jl, tl, [x, label], **TOL)


# -- containers --------------------------------------------------------------------
def test_layer_list_dict_parameter_list_names_as_jax():
    jpt.seed(1)
    jl = jnn.LayerList([jnn.Linear(2, 3), jnn.Linear(3, 4)])
    jl.append(jnn.Linear(4, 1)).insert(1, jnn.ReLU())
    tl = tnn.LayerList([tnn.Linear(2, 3), tnn.Linear(3, 4)])
    tl.append(tnn.Linear(4, 1)).insert(1, tnn.ReLU())
    assert list(tl.state_dict()) == list(jl.state_dict())
    assert len(tl) == 4 and isinstance(tl[1], tnn.ReLU)
    assert isinstance(tl[-1], tnn.Linear) and len(tl[1:3]) == 2
    bridged(jl, tl)
    x = _x(3, 2)
    jx, tx = jnp.asarray(x), torch.tensor(x)
    for jm, tm in zip(jl, tl):
        jx, tx = jm(jx), tm(tx)
    np.testing.assert_allclose(tx.detach().numpy(), np.asarray(jx), **TOL)

    jd = jnn.LayerDict({"enc": jnn.Linear(2, 2), "dec": jnn.Linear(2, 3)})
    td = tnn.LayerDict({"enc": tnn.Linear(2, 2), "dec": tnn.Linear(2, 3)})
    jd["head"], td["head"] = jnn.Linear(3, 1), tnn.Linear(3, 1)
    assert list(td.state_dict()) == list(jd.state_dict())
    assert list(td.keys()) == ["enc", "dec", "head"] and "dec" in td
    assert isinstance(td.pop("dec"), tnn.Linear) and len(td) == 2

    w = [_x(2, 3, seed=1), _x(4, seed=2)]
    jp = jnn.ParameterList(w)
    tp = tnn.ParameterList(w)
    assert list(tp.state_dict()) == list(jp.state_dict()) == ["0", "1"]
    tp.append(torch.zeros(5))
    assert len(tp) == 3 and isinstance(tp[2], torch.nn.Parameter)
    np.testing.assert_array_equal(tp[0].detach().numpy(), w[0])


def test_sequential_setitem_and_iteration():
    seq = tnn.Sequential(tnn.Linear(2, 2), tnn.ReLU())
    seq[1] = tnn.Tanh()
    assert [type(m).__name__ for m in seq] == ["Linear", "Tanh"]


# -- construction-time fills -----------------------------------------------------
@pytest.mark.parametrize("make", [
    lambda: tnn.Bilinear(3, 4, 5), lambda: tnn.PReLU(3),
    lambda: tnn.RowConv(4, 2), lambda: tnn.GroupNorm(2, 4),
    lambda: tnn.HSigmoidLoss(3, 5), lambda: tnn.LSTMCell(3, 4),
    lambda: tnn.MultiHeadAttention(8, 2)],
    ids=["Bilinear", "PReLU", "RowConv", "GroupNorm", "HSigmoidLoss",
         "LSTMCell", "MultiHeadAttention"])
def test_layers_fill_from_the_seed_and_skip_inside_fills_its_layers(make):
    tpt.seed(4)
    a = make()
    tpt.seed(4)
    b = make()
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n

    @fills_its_layers
    def build():
        return make()

    gen = tpt.framework.random.default_generator()
    before = gen.get_state()
    build()
    assert torch.equal(gen.get_state(), before)  # nothing drawn


# -- weight norm -------------------------------------------------------------------
@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_as_jax(dim):
    jpt.seed(2)
    jl = jnn.Sequential(jnn.Linear(4, 3))
    tl = tnn.Sequential(tnn.Linear(4, 3))
    bridged(jl, tl)
    jnn.weight_norm(jl[0], dim=dim)
    tnn.weight_norm(tl[0], dim=dim)
    assert sorted(tl.state_dict()) == sorted(jl.state_dict()) == [
        "0.bias", "0.weight", "0.weight_g", "0.weight_v"]
    assert sorted(n for n, _ in tl.named_parameters()) == [
        "0.bias", "0.weight_g", "0.weight_v"]
    np.testing.assert_allclose(tl[0].weight_g.detach().numpy(),
                               np.asarray(jl[0].weight_g.value), **TOL)
    jp = {k: v for k, v in jax_params(jl).items() if k != "0.weight"}
    for n, p in tl.named_parameters():
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.asarray(jp[n] * 1.3)))
        jl[0]._parameters[n.split(".")[1]].value = jnp.asarray(jp[n] * 1.3)
    x = _x(5, 4)
    out = tl(torch.tensor(x))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jl(jnp.asarray(x))), **TOL)
    out.sum().backward()
    assert tl[0].weight_g.grad is not None and tl[0].weight_v.grad is not None
    with pytest.raises(InvalidArgumentError):
        tnn.weight_norm(tl[0], dim=dim)
    tnn.remove_weight_norm(tl[0])
    jnn.remove_weight_norm(jl[0])
    assert sorted(tl.state_dict()) == ["0.bias", "0.weight"]
    np.testing.assert_allclose(tl[0].weight.detach().numpy(),
                               np.asarray(jl[0].weight.value), **TOL)
    assert tl[0].weight.requires_grad
    with pytest.raises(InvalidArgumentError):
        tnn.remove_weight_norm(tl[0])


def test_weight_norm_hook_module_and_clip_exports():
    assert tnn.weight_norm_hook.weight_norm is tnn.weight_norm
    x = torch.tensor([3.0, 4.0])
    np.testing.assert_allclose(tnn.clip_by_norm(x, 1.0).numpy(),
                               np.asarray(jnn.clip_by_norm(
                                   jnp.asarray([3.0, 4.0]), 1.0)), **TOL)
    assert tnn.ClipGradByGlobalNorm is tpt.optimizer.ClipGradByGlobalNorm
    assert tnn.vision.PixelShuffle is tnn.PixelShuffle
    assert tnn.functional.extension.gather_tree is tnn.functional.gather_tree


# -- fluid.layers / static.nn: the names this slice's modules resolve ----------
RESOLVED_FLUID = (
    "selu", "elu", "relu6", "swish", "mish", "prelu", "leaky_relu", "maxout",
    "log_loss", "dice_loss", "npair_loss", "mse_loss", "label_smooth",
    "kldiv_loss", "huber_loss", "warpctc", "row_conv", "gather_tree",
    "sequence_mask", "temporal_shift", "sigmoid_focal_loss", "pixel_shuffle",
    "unfold", "BeamSearchDecoder", "Decoder", "dynamic_decode", "RNNCell",
    "GRUCell", "LSTMCell", "clip_by_norm", "DecodeHelper", "TrainingHelper",
    "GreedyEmbeddingHelper", "SampleEmbeddingHelper", "BasicDecoder", "rnn",
    "birnn", "instance_norm", "group_norm", "spectral_norm",
    "bilinear_tensor_product", "hsigmoid")
RESOLVED_STATIC = ("row_conv", "instance_norm", "group_norm", "spectral_norm",
                   "prelu", "bilinear_tensor_product", "hsigmoid")


@pytest.mark.parametrize("module,name", [("fluid.layers", n) for n in
                                         RESOLVED_FLUID]
                         + [("static.nn", n) for n in RESOLVED_STATIC])
def test_fluid_and_static_names_resolve_to_the_ported_ones(module, name):
    import importlib

    mod = importlib.import_module(f"paddle_tpu_torch.{module}")
    obj = getattr(mod, name)
    assert not getattr(obj, "__shim__", False), name
    assert callable(obj)


def test_fluid_wrappers_as_jax():
    import paddle_tpu.fluid.layers as jL
    import paddle_tpu_torch.fluid.layers as tL

    rng = np.random.RandomState(30)
    a, b = _x(4, 5, seed=1), _x(4, 5, seed=2)
    logp = np.log(np.exp(a) / np.exp(a).sum(-1, keepdims=True)).astype(
        np.float32)
    p = np.exp(logp)
    for name, args in (("kldiv_loss", (logp, p)), ("huber_loss", (a, b, 0.7)),
                       ("relu6", (a * 4,)), ("selu", (a,)),
                       ("label_smooth", (p,))):
        j = getattr(jL, name)(*[jnp.asarray(v) if isinstance(v, np.ndarray)
                                else v for v in args])
        t = getattr(tL, name)(*[torch.tensor(v) if isinstance(v, np.ndarray)
                                else v for v in args])
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=name,
                                   **LOOSE)
    T, N, C = 8, 2, 5
    lp = np.log(rng.dirichlet(np.ones(C), size=(T, N))).astype(np.float32)
    lab = np.array([[1, 2], [3, 0]], np.int64)
    il, ll = np.array([8, 6], np.int64), np.array([2, 1], np.int64)
    j = jL.warpctc(jnp.asarray(lp), jnp.asarray(lab), input_length=il,
                   label_length=ll)
    t = tL.warpctc(torch.tensor(lp), torch.tensor(lab),
                   input_length=torch.tensor(il),
                   label_length=torch.tensor(ll))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **LOOSE)
    jpt.seed(3)
    jc, tc = jnn.GRUCell(3, 4), tnn.GRUCell(3, 4)
    bridged(jc, tc)
    x = _x(2, 5, 3)
    for fn in ("rnn",):
        jo, jh = getattr(jL, fn)(jc, jnp.asarray(x))
        to, th = getattr(tL, fn)(tc, torch.tensor(x))
        np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                                   **TOL)
    jo, _ = jL.birnn(jc, jc, jnp.asarray(x))
    to, _ = tL.birnn(tc, tc, torch.tensor(x))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **TOL)


def test_static_builders_of_this_slice_as_jax():
    import paddle_tpu.fluid as jfluid
    import paddle_tpu_torch.fluid as tfluid
    from paddle_tpu.static.graph import reset_default_programs as jreset
    from paddle_tpu_torch.bridge import load_jax_program
    from paddle_tpu_torch.framework import device as tdevice
    from paddle_tpu_torch.static.graph import reset_default_programs as treset

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.data("x", [-1, 4, 3, 3])
            h = fluid.layers.group_norm(x, groups=2)
            h = fluid.layers.instance_norm(h)
            flat = fluid.layers.reshape(h, [-1, 36])
            w = fluid.data("w", [36, 5])
            s = fluid.layers.spectral_norm(w, power_iters=2)
            out = fluid.layers.matmul(flat, s)
        return main, startup, out

    saved = tdevice._chosen
    tdevice.set_device("cpu")
    try:
        jreset()
        treset()
        jpt.seed(0)
        tpt.seed(0)
        jmain, jstart, jout = build(jfluid)
        tmain, tstart, tout = build(tfluid)
        jexe, texe = jfluid.Executor(), tfluid.Executor(tfluid.CPUPlace())
        jexe.run(jstart)
        texe.run(tstart)
        load_jax_program(tmain,
                         {k: np.asarray(v) for k, v in jmain.scope.items()},
                         {k: np.asarray(v) for k, v in jmain.buffers.items()})
        feed = {"x": _x(2, 4, 3, 3, seed=4), "w": _x(36, 5, seed=5)}
        j, = jexe.run(jmain, feed=feed, fetch_list=[jout])
        t, = texe.run(tmain, feed=feed, fetch_list=[tout])
        np.testing.assert_allclose(np.asarray(t), np.asarray(j), **LOOSE)
    finally:
        jreset()
        treset()
        tdevice._chosen = saved


def test_bilinear_tensor_product_builder_runs_where_jax_raises():
    """The JAX builder passes ``weight_attr=`` to a layer that takes
    ``param_attr=`` and raises TypeError (ROADMAP §C); the port's builds
    the layer and runs it."""
    import paddle_tpu.fluid as jfluid
    import paddle_tpu_torch.fluid as tfluid
    from paddle_tpu.static.graph import reset_default_programs as jreset
    from paddle_tpu_torch.framework import device as tdevice
    from paddle_tpu_torch.static.graph import reset_default_programs as treset

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.data("x", [-1, 3])
            y = fluid.data("y", [-1, 4])
            out = fluid.layers.bilinear_tensor_product(x, y, 5, act="tanh")
        return main, startup, out

    saved = tdevice._chosen
    tdevice.set_device("cpu")
    try:
        jreset()
        with pytest.raises(TypeError, match="weight_attr"):
            build(jfluid)
        treset()
        tpt.seed(0)
        main, startup, out = build(tfluid)
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        x, y = _x(6, 3, seed=1), _x(6, 4, seed=2)
        got, = exe.run(main, feed={"x": x, "y": y}, fetch_list=[out])
        w = [v for k, v in main.scope.items() if ".weight" in k][0]
        b = [v for k, v in main.scope.items() if ".bias" in k][0]
        want = torch.tanh(tnn.functional.bilinear(
            torch.tensor(x), torch.tensor(y), w, b))
        np.testing.assert_allclose(np.asarray(got), want.detach().numpy(),
                                   **TOL)
    finally:
        jreset()
        treset()
        tdevice._chosen = saved
