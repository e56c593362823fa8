"""The port's vision models beside ResNet — LeNet, VGG, MobileNet v1 / v2
(``paddle_tpu_torch.vision.models``) — held against the JAX package's.

On the CPU at small inputs, parameters and BatchNorm buffers bridged from
the JAX model (``load_jax_params``): the same dotted names and shapes, and
the same forward (eval, and train mode with its batch statistics and the
running buffers it leaves) in NCHW and NHWC, float32 at rtol / atol 1e-4
(up to 28 convolutions deep: float32 sums in other orders).  VGG runs
without its classifier (``num_classes=0``: the 25088 x 4096 head is a
full-size weight), its trunk with and without BatchNorm.  Then the
``pretrained`` refusals and the exported names.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jpt
from paddle_tpu.framework.errors import NotFoundError as JNotFoundError
from paddle_tpu.vision import models as jvm
from paddle_tpu_torch.bridge import load_jax_params
from paddle_tpu_torch.framework.errors import (InvalidArgumentError,
                                               NotFoundError)
from paddle_tpu_torch.vision import models as tvm

TOL = dict(rtol=1e-4, atol=1e-4)

CASES = {
    "lenet": (lambda m, fmt: m.LeNet(data_format=fmt), (1, 28, 28)),
    "vgg11": (lambda m, fmt: m.vgg11(num_classes=0, data_format=fmt),
              (3, 32, 32)),
    "vgg13_bn": (lambda m, fmt: m.vgg13(batch_norm=True, num_classes=0,
                                        data_format=fmt), (3, 32, 32)),
    "mobilenet_v1": (lambda m, fmt: m.mobilenet_v1(
        scale=0.5, num_classes=10, data_format=fmt), (3, 32, 32)),
    "mobilenet_v2": (lambda m, fmt: m.mobilenet_v2(
        num_classes=10, data_format=fmt), (3, 32, 32)),
}


def _pair(name, fmt, batch=2, hw=None):
    build, chw = CASES[name]
    jpt.seed(3)
    jm = build(jvm, fmt)
    tm = build(_Cpu(), fmt)
    load_jax_params(
        tm, {k: np.asarray(p.value) for k, p in jm.named_parameters()},
        {k: np.asarray(b.value) for k, b in jm.named_buffers()})
    c, h, w = chw[0], hw or chw[1], hw or chw[2]
    x = np.random.RandomState(4).uniform(
        -1, 1, (batch, c, h, w) if fmt == "NCHW" else (batch, h, w, c)).astype(
            np.float32)
    return jm, tm, x


class _Cpu:
    """``tvm`` with ``device="cpu"`` on every constructor."""

    def __getattr__(self, name):
        ctor = getattr(tvm, name)
        return lambda *a, **k: ctor(*a, device="cpu", **k)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_names_and_forward_as_jax(name, fmt):
    jm, tm, x = _pair(name, fmt)
    assert [(k, tuple(p.shape)) for k, p in tm.named_parameters()] == [
        (k, tuple(p.value.shape)) for k, p in jm.named_parameters()]
    assert [k for k, _ in tm.named_buffers()] == [
        k for k, _ in jm.named_buffers()]
    jm.eval()
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm(jnp.asarray(x))),
                               **TOL)


@pytest.mark.parametrize("name", ["vgg13_bn", "mobilenet_v1",
                                  "mobilenet_v2"])
def test_train_mode_forward_and_running_stats_as_jax(name):
    """The models with BatchNorm in training mode (batch statistics, the
    running buffers updated), every Dropout at p = 0 in both packages
    (the frameworks draw different masks), at 4 x 64 x 64: at 2 x 32 x 32
    the last BatchNorms normalize over 2 values, where float32 sums in
    another order already flip outputs."""
    jm, tm, x = _pair(name, "NCHW", batch=4, hw=64)
    for pkg_model in (jm, tm):
        for _, layer in pkg_model.named_sublayers():
            if type(layer).__name__ == "Dropout":
                layer.p = 0.0
    jm.train()
    tm.train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm(jnp.asarray(x))),
                               **TOL)
    jbuf = {k: np.asarray(b.value) for k, b in jm.named_buffers()}
    for k, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), jbuf[k], err_msg=k, **TOL)


@pytest.mark.parametrize("ctor", ["vgg11", "vgg16", "mobilenet_v1",
                                  "mobilenet_v2", "resnet18"])
def test_pretrained_refusals(ctor):
    # a path is loaded now: a missing file raises as in JAX
    with pytest.raises(NotFoundError, match="weights.pdparams"):
        getattr(tvm, ctor)(pretrained="weights.pdparams", device="cpu")
    with pytest.raises(JNotFoundError):
        getattr(jvm, ctor)(pretrained="weights.pdparams")
    with pytest.raises(InvalidArgumentError, match="download"):
        getattr(tvm, ctor)(pretrained=True, device="cpu")


def test_exports_the_jax_names():
    assert set(jvm.__all__) <= set(tvm.__all__)
    for name in jvm.__all__:
        assert hasattr(tvm, name), name


def test_models_are_built_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only refusal")
    from paddle_tpu_torch.framework.errors import UnavailableError

    with pytest.raises(UnavailableError):
        tvm.LeNet()


# -- pretrained=<path> -----------------------------------------------------------
PRETRAINED = {
    "resnet18": (lambda m, **k: m.resnet18(num_classes=10, **k), (3, 32, 32)),
    "resnet50_nhwc_s2d": (lambda m, **k: m.resnet50(
        num_classes=10, data_format="NHWC", stem_space_to_depth=True, **k),
        (32, 32, 3)),
    "vgg11_bn": (lambda m, **k: m.vgg11(batch_norm=True, num_classes=0, **k),
                 (3, 32, 32)),
    "mobilenet_v1": (lambda m, **k: m.mobilenet_v1(scale=0.5, num_classes=10,
                                                   **k), (3, 32, 32)),
    "mobilenet_v2": (lambda m, **k: m.mobilenet_v2(num_classes=10, **k),
                     (3, 32, 32)),
}


@pytest.mark.parametrize("name", list(PRETRAINED))
def test_pretrained_path_loads_a_jax_checkpoint(name, tmp_path):
    """``ctor(pretrained=path)`` over a state dict the JAX package saved
    with ``paddle_tpu.save``: every parameter and buffer bit-equal to the
    JAX model's, and eval logits equal to those of JAX's own
    ``ctor(pretrained=path)`` (rtol / atol 1e-4, float32 sums in other
    orders)."""
    build, shape = PRETRAINED[name]
    jpt.seed(11)
    donor = build(jvm)
    path = str(tmp_path / f"{name}.pdparams")
    jpt.save(donor.state_dict(), path)
    jpt.seed(12)  # another init: the load must overwrite it
    jm = build(jvm, pretrained=path)
    tm = build(tvm, pretrained=path, device="cpu")
    want = {k: np.asarray(v.value) for k, v in
            list(jm.named_parameters()) + list(jm.named_buffers())}
    got = dict(list(tm.named_parameters()) + list(tm.named_buffers()))
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.detach().numpy(), want[k],
                                      err_msg=k)
    x = np.random.RandomState(13).uniform(-1, 1, (2,) + shape).astype(
        np.float32)
    jm.eval()
    tm.eval()
    with torch.no_grad():
        logits = tm(torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(jm(jnp.asarray(x))), **TOL)


def test_pretrained_path_round_trips_the_ports_own_checkpoint(tmp_path):
    """A network the port saved with ``paddle_tpu_torch.save`` rebuilt by
    ``resnet18(pretrained=path)``: eval logits bit for bit."""
    import paddle_tpu_torch as tpt

    net = tvm.resnet18(num_classes=5, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    path = str(tmp_path / "r18.pdparams")
    tpt.save(net.state_dict(), path)
    again = tvm.resnet18(num_classes=5, device="cpu", pretrained=path)
    x = torch.from_numpy(np.random.RandomState(5).uniform(
        -1, 1, (2, 3, 32, 32)).astype(np.float32))
    net.eval()
    again.eval()
    with torch.no_grad():
        assert torch.equal(again(x), net(x))

