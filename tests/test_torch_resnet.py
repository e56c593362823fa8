"""Port of ResNet training (``paddle_tpu_torch.vision.models.resnet``,
``bridge.load_jax_params(..., buffers)``, ``Model.train_batch`` with bf16
numpy batches, ``optimizer.Momentum`` on bf16 BatchNorm parameters).

Parameters AND buffers (BatchNorm ``_mean`` / ``_variance``) cross from the
JAX model into the port with ``load_jax_params``; inputs are numpy arrays
from a seed.

* A ``BottleneckBlock`` with the fused-tail gate forced open on both sides
  (JAX: Pallas in interpret mode; port: the ``autograd.Function`` through
  the kernels' plain versions): the output at rtol/atol 3e-5 and bn3's
  running mean and UNBIASED running variance at rtol 1e-4.
* ``resnet50(data_format="NHWC", stem_space_to_depth=True,
  num_classes=10)`` at 64 x 64, batch 2, float32: the train-mode logits
  and every ``_mean`` / ``_variance`` after that forward (rtol 1e-4), and
  ``_stem_s2d`` against the plain stem (atol 1e-5).
* Two ``Model.train_batch`` steps of ``Momentum(0.1, 0.9,
  multi_precision=True, weight_decay=1e-4)``: losses, every parameter and
  every ``_mean`` / ``_variance`` against JAX's ``Model.train_batch``.
  These run in FLOAT64.  The float32 gradient of this network at
  initialization is ill-conditioned: on the CPU it sits up to 50% (in the
  worst tensor; 1.5-3.6% in L2 over all parameters) from the float64
  gradient, and two float32 runs whose inputs differ by 1e-7 differ as
  much (``tools/torch_resnet_conditioning.py``), so no two float32
  implementations agree after a step.  In float64 the test holds the
  losses at rtol 1e-6, every parameter within 1e-5 and every buffer within
  1e-6 of each tensor's largest entry, and asserts every parameter moved
  by more than its tolerance, so a skipped update fails it.  The eval-mode logits after the steps (running stats
  in use) are held at rtol 1e-5.
"""
import copy

import jax  # noqa: F401  (conftest: JAX on the CPU, highest precision)
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.nn as jnn
import paddle_tpu.ops.autotune as jat
import paddle_tpu_torch as tpt
from paddle_tpu import optimizer as jopt
from paddle_tpu.vision.models import resnet as jres
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.framework.errors import (InvalidArgumentError,
                                               NotFoundError, UnavailableError)
from paddle_tpu_torch.ops import fused_conv1x1_bn as fcb
from paddle_tpu_torch.vision.models import resnet as tres

STEPS = 2


def _params(net):
    return {k: np.asarray(p.value) for k, p in net.named_parameters()}


def _buffers(net):
    return {k: np.asarray(b.value) for k, b in net.named_buffers()}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.fixture(scope="module")
def jax_resnet50():
    """The JAX model and its pristine parameters and buffers."""
    torch.set_num_threads(4)
    jpt.seed(0)
    net = jres.resnet50(data_format="NHWC", stem_space_to_depth=True,
                        num_classes=10)
    return net, _params(net), _buffers(net)


def _port_resnet50(params, buffers, dtype=torch.float32):
    net = tres.resnet50(data_format="NHWC", stem_space_to_depth=True,
                        num_classes=10, device="cpu").to(dtype)
    return load_jax_params(net, params, buffers)


# -- the block with the fused tail ---------------------------------------------
def test_bottleneck_fused_tail_matches_jax(monkeypatch):
    jpt.seed(1)
    jblk = jres.BottleneckBlock(
        256, 64, data_format="NHWC",
        norm_layer=lambda c: jnn.BatchNorm2D(c, data_format="NHWC"))
    tblk = tres.BottleneckBlock(256, 64, data_format="NHWC")
    load_jax_params(tblk, _params(jblk), _buffers(jblk))
    x = np.random.RandomState(6).randn(2, 8, 8, 256).astype(np.float32)
    tx = torch.from_numpy(x)
    # closed on the CPU on both sides
    assert jblk._fused_tail(x, x) is None and tblk._fused_tail(tx, tx) is None
    monkeypatch.setattr(jat, "fused_epilogues_eligible",
                        lambda feature_dim=None: True)
    monkeypatch.setattr(fcb, "fused_epilogues_eligible",
                        lambda feature_dim, x: True)
    jout = jblk(x)                       # Pallas, interpret mode
    before = (fcb.conv1x1_bn_stats.launches, fcb.bn_apply_relu.launches)
    tout = tblk(tx)                      # the autograd.Function on the CPU
    assert (fcb.conv1x1_bn_stats.launches,
            fcb.bn_apply_relu.launches) == before
    np.testing.assert_allclose(_np(tout), np.asarray(jout), rtol=3e-5,
                               atol=3e-5)
    for name in ("_mean", "_variance"):
        want = np.asarray(getattr(jblk.bn3, name).value)
        got = getattr(tblk.bn3, name)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    tblk.zero_grad()
    tout.sum().backward()               # the gradient flows through it
    assert tblk.conv3.weight.grad is not None \
        and tblk.bn3.weight.grad is not None


# -- the whole model -----------------------------------------------------------
def test_resnet50_forward_and_buffers_match_jax(jax_resnet50):
    jsrc, params, buffers = jax_resnet50
    jnet = copy.deepcopy(jsrc)
    tnet = _port_resnet50(params, buffers)
    assert sorted(n for n, _ in tnet.named_buffers()) == sorted(buffers)
    x = np.random.RandomState(0).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    jnet.train()
    tnet.train()
    want = np.asarray(jnet(x))
    got = tnet(torch.from_numpy(x))
    assert got.shape == (2, 10)
    np.testing.assert_allclose(_np(got), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    jb = _buffers(jnet)
    for name, b in tnet.named_buffers():
        np.testing.assert_allclose(_np(b), jb[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)
        assert not np.array_equal(jb[name], buffers[name]), name


def test_stem_space_to_depth_is_the_plain_stem(jax_resnet50):
    _, params, buffers = jax_resnet50
    tnet = _port_resnet50(params, buffers)
    x = torch.from_numpy(np.random.RandomState(2).uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32))
    s2d = tnet._stem_s2d(x)
    plain = tnet.conv1(x)
    assert s2d.shape == plain.shape == (2, 16, 16, 64)
    np.testing.assert_allclose(_np(s2d), _np(plain), rtol=1e-5, atol=1e-5)
    # the 4x4 kernel is gathered from the canonical weight on every
    # forward, so the gradient reaches conv1.weight as the plain stem's
    g = torch.randn(s2d.shape, generator=torch.Generator().manual_seed(0))
    gs = torch.autograd.grad(tnet._stem_s2d(x), tnet.conv1.weight, g)[0]
    gp = torch.autograd.grad(tnet.conv1(x), tnet.conv1.weight, g)[0]
    np.testing.assert_allclose(_np(gs), _np(gp), rtol=1e-4, atol=1e-4)
    # odd sizes take the plain stem
    xo = torch.randn(1, 31, 31, 3)
    assert torch.equal(tnet._stem_s2d(xo), tnet.conv1(xo))


def test_two_train_steps_match_jax_in_float64(jax_resnet50):
    jsrc, params, buffers = jax_resnet50
    jnet = copy.deepcopy(jsrc)
    jnet.set_state_dict({**params, **buffers})
    jnet.astype("float64")
    tnet = _port_resnet50(params, buffers, torch.float64)
    rng = np.random.RandomState(1)
    batches = [(rng.uniform(-1, 1, (2, 64, 64, 3)),
                rng.randint(0, 10, (2, 1)).astype(np.int32))
               for _ in range(STEPS)]
    jm = jpt.Model(jnet, inputs=1, labels=1)
    jm.prepare(optimizer=jopt.Momentum(
        learning_rate=0.1, momentum=0.9, multi_precision=True,
        weight_decay=1e-4, parameters=jnet.parameters()),
        loss=jpt.nn.CrossEntropyLoss())
    tm = tpt.Model(tnet, inputs=1, labels=1).prepare(
        optimizer=tpt.optimizer.Momentum(
            learning_rate=0.1, momentum=0.9, multi_precision=True,
            weight_decay=1e-4),
        loss=tpt.nn.CrossEntropyLoss())
    for x, y in batches:
        want = jm.train_batch([x], [y])[0]
        got = tm.train_batch([x], [y])[0]
        assert got == pytest.approx(want, rel=1e-6)
    jp = _params(jnet)
    for name, p in tnet.named_parameters():
        assert p.dtype == torch.float64
        tol = 1e-5 * float(np.abs(jp[name]).max())
        np.testing.assert_allclose(p.detach().numpy(), jp[name], rtol=0,
                                   atol=tol, err_msg=name)
        moved = float(np.abs(jp[name] - params[name]).max())
        assert moved > tol, (name, moved, tol)
    jb = _buffers(jnet)
    for name, b in tnet.named_buffers():
        tol = 1e-6 * float(np.abs(jb[name]).max())
        np.testing.assert_allclose(b.numpy(), jb[name], rtol=0, atol=tol,
                                   err_msg=name)
    want = np.asarray(jm.predict_batch([batches[0][0]]))
    got = tm.predict_batch([batches[0][0]])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# -- the pieces around it ------------------------------------------------------
def test_bridge_copies_float_buffers_and_rejects_strangers():
    net = tpt.nn.BatchNorm2D(4)
    arrays = {"weight": np.full(4, 2.0, np.float32),
              "bias": np.zeros(4, np.float32)}
    mean = np.array([0.1, 0.2, 0.3, 1 / 3], np.float32)
    net.astype("bfloat16")
    load_jax_params(net, arrays, {"_mean": mean.astype(ml_dtypes.bfloat16),
                                  "_variance": np.ones(4, np.float32)})
    assert net._mean.dtype == torch.bfloat16   # the buffer's own dtype
    np.testing.assert_array_equal(
        _np(net._mean), mean.astype(ml_dtypes.bfloat16).astype(np.float32))
    with pytest.raises(InvalidArgumentError, match="neither"):
        load_jax_params(net, arrays, {"_running": np.zeros(4, np.float32)})
    with pytest.raises(InvalidArgumentError, match="shape"):
        load_jax_params(net, arrays, {"_mean": np.zeros(5, np.float32)})


def test_train_batch_takes_numpy_bfloat16_bit_exact():
    x = np.random.RandomState(3).randn(2, 3).astype(ml_dtypes.bfloat16)
    model = tpt.Model(tpt.nn.Linear(3, 2).to(torch.bfloat16))
    (t,) = model._batch([x], None)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  x.view(np.int16))


def test_resnet_bf16_trains_from_numpy_bf16_batches():
    """A small NHWC ResNet in bf16 (the config-2 recipe on resnet18 at
    32 x 32) through Model.train_batch on numpy bf16 images: finite
    losses, bf16 buffers that move, float32 master slots."""
    tpt.seed(0)
    net = tres.resnet18(data_format="NHWC", num_classes=10,
                        device="cpu").astype("bfloat16")
    xent = tpt.nn.CrossEntropyLoss()
    opt = tpt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                 multi_precision=True, weight_decay=1e-4)
    model = tpt.Model(net, inputs=1, labels=1).prepare(
        optimizer=opt, loss=lambda logits, y: xent(logits.float(), y))
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(ml_dtypes.bfloat16)
    y = rng.randint(0, 10, (2, 1)).astype(np.int32)
    before = net.bn1._mean.clone()
    losses = [model.train_batch([x], [y])[0] for _ in range(2)]
    assert all(np.isfinite(losses))
    assert net.bn1._mean.dtype == torch.bfloat16
    assert not torch.equal(net.bn1._mean, before)
    masters = [v for k, v in opt.state_dict().items()
               if k.endswith(".master")]
    assert len(masters) == len(list(net.parameters()))
    assert all(m.dtype == torch.float32 for m in masters)


def test_momentum_decays_bf16_batchnorm_params_through_f32_masters():
    """Config 2's optimizer on a bf16 BatchNorm weight and bias: the L2
    decay is added to the gradient of the float32 master, as JAX does;
    masters tight, parameters exactly their masters rounded."""
    rng = np.random.RandomState(4)
    params = {"bn.weight": (1 + 0.1 * rng.randn(8)).astype(np.float32),
              "bn.bias": (0.1 * rng.randn(8)).astype(np.float32)}
    grads = [{k: rng.randn(8).astype(np.float32) for k in params}
             for _ in range(3)]
    kw = dict(learning_rate=0.1, momentum=0.9, multi_precision=True,
              weight_decay=1e-4)
    jo, to = jopt.Momentum(**kw), tpt.optimizer.Momentum(**kw)
    jp = {k: np.asarray(v).astype(ml_dtypes.bfloat16) for k, v in
          params.items()}
    import jax.numpy as jnp
    jp = {k: jnp.asarray(v) for k, v in jp.items()}
    tp = {k: torch.tensor(v).to(torch.bfloat16) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update({k: jnp.asarray(v.astype(ml_dtypes.bfloat16))
                            for k, v in g.items()}, js, jp,
                           lr=jnp.asarray(0.1, jnp.float32))
        tp, ts = to.update({k: torch.tensor(v).to(torch.bfloat16)
                            for k, v in g.items()}, ts, tp)
    for k in params:
        tm_, jm_ = ts["slots"][k]["master"], js["slots"][k]["master"]
        assert tm_.dtype == torch.float32
        np.testing.assert_allclose(_np(tm_), np.asarray(jm_), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
        assert torch.equal(tp[k], tm_.to(torch.bfloat16))
        # the decay moved the master: without it the result differs
        plain = tpt.optimizer.Momentum(0.1, 0.9, multi_precision=True)
        pp, ps = {k: torch.tensor(params[k]).to(torch.bfloat16)}, None
        ps = plain.init(pp)
        for g in grads:
            pp, ps = plain.update({k: torch.tensor(g[k]).to(torch.bfloat16)},
                                  ps, pp)
        assert not torch.equal(ps["slots"][k]["master"], tm_)


def test_model_surface():
    # pretrained=<path> loads a checkpoint: a missing one raises
    with pytest.raises(NotFoundError, match="nonexistent"):
        tres.resnet50(pretrained="/nonexistent.pdparams", device="cpu")
    with pytest.raises(InvalidArgumentError):
        tres.resnet50(pretrained=True, device="cpu")
    with pytest.raises(InvalidArgumentError, match="NHWC"):
        tres.resnet50(stem_space_to_depth=True, device="cpu")
    names = [n for n, _ in tres.resnet50(num_classes=0, device="cpu",
                                         with_pool=False).named_buffers()]
    assert "layer1.0.downsample.1._mean" in names
    assert set(tpt.vision.models.__all__) >= {"resnet50", "ResNet"}
    if not torch.cuda.is_available():
        with pytest.raises(UnavailableError):
            tres.resnet18()


def test_cpu_runs_the_plain_tail_uncounted():
    tpt.seed(0)
    net = tres.resnet50(data_format="NHWC", num_classes=10, device="cpu")
    net.train()
    before = (fcb.conv1x1_bn_stats.launches, fcb.bn_apply_relu.launches)
    calls = []
    orig = tres.BottleneckBlock._fused_tail

    def spy(self, out, identity):
        r = orig(self, out, identity)
        calls.append(r is None)
        return r

    tres.BottleneckBlock._fused_tail = spy
    try:
        net(torch.randn(1, 32, 32, 3))
    finally:
        tres.BottleneckBlock._fused_tail = orig
    assert calls == [True] * 16    # 16 bottleneck blocks, gate closed
    assert (fcb.conv1x1_bn_stats.launches,
            fcb.bn_apply_relu.launches) == before


# -- on the card ---------------------------------------------------------------
@pytest.mark.gpu
def test_resnet50_bf16_train_step_launches_both_kernels_per_block():
    """bench.py config 2's model and optimizer at batch 8 x 224: one
    train_batch launches each kernel 16 times (once per bottleneck block),
    bn3 buffers stay bf16 and move, the loss is finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    tpt.seed(0)
    net = tres.resnet50(data_format="NHWC",
                        stem_space_to_depth=True).astype("bfloat16")
    xent = tpt.nn.CrossEntropyLoss()
    model = tpt.Model(net, inputs=1, labels=1).prepare(
        optimizer=tpt.optimizer.Momentum(0.1, 0.9, multi_precision=True,
                                         weight_decay=1e-4),
        loss=lambda logits, y: xent(logits.float(), y))
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (8, 224, 224, 3)).astype(ml_dtypes.bfloat16)
    y = rng.randint(0, 1000, (8, 1)).astype(np.int32)
    bn3 = net.layer4[2].bn3._variance.clone()
    fcb.conv1x1_bn_stats.launches = fcb.bn_apply_relu.launches = 0
    loss = model.train_batch([x], [y])[0]
    torch.cuda.synchronize()
    assert (fcb.conv1x1_bn_stats.launches, fcb.bn_apply_relu.launches) \
        == (16, 16)
    assert np.isfinite(loss)
    assert net.layer4[2].bn3._variance.dtype == torch.bfloat16
    assert not torch.equal(net.layer4[2].bn3._variance, bn3)
