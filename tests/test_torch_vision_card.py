"""The vision slice on the card (``gpu`` marker; skipped without one):
``chip_smoke.py``'s V1 and V3 at small sizes, held to the port's own CPU
results (this file imports no JAX).

* V1: every new convolution and pool layer on the card against its copy
  on the CPU, float32 with TF32 off, on one seeded input: the output and
  the gradients of ``Σ out · c`` for the input and every parameter
  within 2e-3 of the CPU result's rms (cuDNN's algorithms sum in other
  orders), masks equal (inputs with unique window maxima).
* V3: a bf16 NHWC ResNet-50 saved on the card and rebuilt with
  ``resnet50(pretrained=path)``: eval logits bit for bit.

Run on the card: ``python -m pytest -m gpu tests/test_torch_vision_card.py``.
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpt
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.vision import models as tvm

TOL = 2e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the vision ops against the CPU")
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


def _err(got, ref):
    got, ref = got.detach().double().cpu(), ref.detach().double()
    rms = float(ref.pow(2).mean().sqrt()) or 1.0
    return float((got - ref).abs().max()) / rms


def _unique(shape, seed):
    n = int(np.prod(shape))
    g = torch.Generator().manual_seed(seed)
    return (torch.randperm(n, generator=g).float() - n / 2).reshape(shape)


LAYERS = {  # name: (layer, channels-first input shape, call kwargs)
    "conv2d_transpose_dcgan": (lambda: tnn.Conv2DTranspose(
        64, 32, 4, stride=2, padding=1), (8, 64, 8, 8), {}),
    "conv2d_transpose_output_size": (lambda: tnn.Conv2DTranspose(
        64, 3, 4, stride=2, padding=1), (8, 64, 8, 8),
        dict(output_size=[15, 13])),
    "conv3d_c3d": (lambda: tnn.Conv3D(16, 32, 3, padding=1),
                   (2, 16, 4, 14, 14), {}),
    "conv3d_transpose": (lambda: tnn.Conv3DTranspose(
        16, 8, 3, stride=2, padding=1, output_padding=1), (2, 16, 3, 5, 5),
        {}),
    "conv1d": (lambda: tnn.Conv1D(64, 64, 3, padding=1), (4, 64, 128), {}),
    "conv1d_transpose": (lambda: tnn.Conv1DTranspose(
        64, 64, 4, stride=2, padding=1), (4, 64, 128), {}),
    "conv1d_nlc": (lambda: tnn.Conv1D(64, 64, 3, padding=1,
                                      data_format="NLC"), (4, 64, 128), {}),
    "conv1d_transpose_nlc": (lambda: tnn.Conv1DTranspose(
        64, 32, 4, stride=2, padding=1, data_format="NLC"), (4, 64, 128),
        {}),
    "conv3d_ndhwc": (lambda: tnn.Conv3D(16, 32, 3, padding=1,
                                        data_format="NDHWC"),
                     (2, 16, 4, 14, 14), {}),
    "conv3d_transpose_ndhwc": (lambda: tnn.Conv3DTranspose(
        16, 8, 2, stride=2, data_format="NDHWC"), (2, 16, 3, 5, 5), {}),
    "conv2d_nhwc_groups": (lambda: tnn.Conv2D(
        32, 32, 3, padding="SAME", groups=4, data_format="NHWC"),
        (4, 32, 15, 15), {}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(LAYERS))
def test_conv_layer_card_vs_cpu(card, name):
    build, shape, kw = LAYERS[name]
    layer = build()
    layer.reset_parameters(torch.Generator().manual_seed(1))
    x = torch.randn(shape, generator=torch.Generator().manual_seed(2))
    if layer.data_format[1] != "C":
        x = x.movedim(1, -1).contiguous()
    _pair(layer, x, card, kw)


def _pair(layer, x, card, kw=None):
    kw = kw or {}
    dev = copy.deepcopy(layer).to(card)
    xc, xd = x.clone().requires_grad_(True), x.to(card).requires_grad_(True)
    oc, od = layer(xc, **kw), dev(xd, **kw)
    (oc, mc), (od, md) = [o if isinstance(o, tuple) else (o, None)
                          for o in (oc, od)]
    cot = torch.randn(oc.shape, generator=torch.Generator().manual_seed(3))
    gc = torch.autograd.grad((oc * cot).sum(), [xc, *layer.parameters()])
    gd = torch.autograd.grad((od * cot.to(card)).sum(),
                             [xd, *dev.parameters()])
    assert _err(od, oc) <= TOL
    for a, b in zip(gd, gc):
        assert _err(a, b) <= TOL
    if mc is not None or md is not None:
        assert torch.equal(mc, md.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("channel_last", [False, True])
@pytest.mark.parametrize("exclusive", [True, False])
@pytest.mark.parametrize("ceil_mode", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_pools_card_vs_cpu(card, n, ceil_mode, exclusive, channel_last):
    formats = {1: ("NCL", "NLC"), 2: ("NCHW", "NHWC"),
               3: ("NCDHW", "NDHWC")}[n]
    fmt = formats[channel_last]
    x = _unique({1: (4, 8, 100), 2: (4, 8, 22, 19),
                 3: (2, 4, 8, 11, 12)}[n], seed=n)
    if channel_last:
        x = x.movedim(1, -1).contiguous()
    _pair(getattr(tnn, f"AvgPool{n}D")(3, 2, 1, ceil_mode=ceil_mode,
                                       exclusive=exclusive,
                                       data_format=fmt), x, card)
    _pair(getattr(tnn, f"MaxPool{n}D")(3, 2, 1, ceil_mode=ceil_mode,
                                       return_mask=True, data_format=fmt),
          x, card)


@pytest.mark.gpu
@pytest.mark.parametrize("n,size", [(1, 7), (2, (5, 3)), (3, (2, 3, 4))])
def test_adaptive_pools_card_vs_cpu(card, n, size):
    x = _unique({1: (4, 8, 101), 2: (4, 8, 23, 19),
                 3: (2, 4, 9, 11, 13)}[n], seed=10 + n)
    _pair(getattr(tnn, f"AdaptiveMaxPool{n}D")(size, return_mask=True), x,
          card)
    _pair(getattr(tnn, f"AdaptiveAvgPool{n}D")(size), x, card)


@pytest.mark.gpu
def test_pretrained_path_on_the_card_bit_for_bit(card, tmp_path):
    """A bf16 NHWC ResNet-50 saved on the card and rebuilt with
    ``pretrained=path`` gives the saved network's eval logits bit for
    bit, on the card."""
    kw = dict(num_classes=10, data_format="NHWC", stem_space_to_depth=True)
    net = tvm.resnet50(generator=torch.Generator().manual_seed(1),
                       **kw).astype("bfloat16")
    path = str(tmp_path / "r50.pdparams")
    tpt.save(net.state_dict(), path)
    again = tvm.resnet50(pretrained=path, **kw).astype("bfloat16")
    assert next(again.parameters()).device.type == "cuda"
    x = torch.from_numpy(np.random.RandomState(2).uniform(
        -1, 1, (8, 64, 64, 3)).astype(np.float32)).to(card, torch.bfloat16)
    net.eval()
    again.eval()
    with torch.no_grad():
        assert torch.equal(again(x), net(x))
