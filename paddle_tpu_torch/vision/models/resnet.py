"""ResNet family — port of ``paddle_tpu/vision/models/resnet.py``.

The same modules, names and layouts as the JAX package (OIHW conv
weights, BatchNorm buffers ``_mean`` / ``_variance``, ``Sequential``
children ``"0"``, ``"1"``, …), so ``bridge.load_jax_params`` maps
parameters and buffers 1:1.  NHWC models run their convolutions on
channels_last views (``nn.functional.conv2d``).

Two paths of the JAX model carry over as they are:

* ``stem_space_to_depth=True`` (NHWC only): the 7x7 stride-2 stem conv on
  3 channels re-expressed as the equivalent 4x4 stride-1 conv on the 2x2
  space-to-depth input (12 channels).  The 4x4 kernel is gathered from
  the canonical OIHW 7x7 weight on every forward (one ``index_select``),
  so the gradient reaches the canonical weight and checkpoints keep its
  layout.
* the fused conv3 → bn3 → +identity → relu tail of ``BottleneckBlock``
  (``ops.fused_conv1x1_bn.conv1x1_bn_relu``: the hand-written
  ``conv1x1_bn_stats`` and ``bn_apply_relu`` CUDA kernels).  Its gate is
  the JAX block's — training, NHWC, a 1x1 stride-1 conv with groups 1 and
  no bias, a BatchNorm with weight and bias and batch statistics — and
  ``fused_epilogues_eligible`` of the port, which reads "a real TPU
  backend" as "the activation is a CUDA tensor".  On the card the fused
  route always runs; on the CPU the plain tail runs, as the JAX package's
  does off the TPU.

Models are built on ``cuda:0`` unless ``device=`` says otherwise, with
every weight drawn from ``generator`` (default: the CPU generator that
``paddle_tpu_torch.seed`` reseeds) on the CPU in module order.  No
``pretrained=<path>`` loads a local checkpoint (``_pretrained``).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ... import nn
from ...framework.device import resolve_device
from ...framework.errors import InvalidArgumentError
from ...framework.random import default_generator
from ...nn import functional as F
from ...nn.initializer import fills_its_layers
from ...ops import fused_conv1x1_bn as _fcb

__all__ = ["ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152"]


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW"):
        super().__init__()
        if norm_layer is None:
            norm_layer = functools.partial(nn.BatchNorm2D,
                                           data_format=data_format)
        if groups != 1 or base_width != 64:
            raise InvalidArgumentError(
                "BasicBlock only supports groups=1, base_width=64")
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                               bias_attr=False, data_format=data_format)
        self.bn1 = norm_layer(planes)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                               data_format=data_format)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW"):
        super().__init__()
        if norm_layer is None:
            norm_layer = functools.partial(nn.BatchNorm2D,
                                           data_format=data_format)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False,
                               data_format=data_format)
        self.bn1 = norm_layer(width)
        self.conv2 = nn.Conv2D(width, width, 3, stride=stride,
                               padding=dilation, groups=groups,
                               dilation=dilation, bias_attr=False,
                               data_format=data_format)
        self.bn2 = norm_layer(width)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1,
                               bias_attr=False, data_format=data_format)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = nn.ReLU()
        self.downsample = downsample
        self.stride = stride

    def _fused_tail(self, out, identity):
        """conv3 (1x1) → train-mode bn3 → +identity → relu through the
        hand-written kernel pair (``conv1x1_bn_stats`` + ``bn_apply_relu``),
        updating bn3's running statistics in place (rounded to the
        buffers' dtype).  Returns None where the gate is closed — the
        caller's plain path is the reference."""
        cv, bn = self.conv3, self.bn3
        if not (self.training and cv.data_format == "NHWC"
                and cv.kernel_size == (1, 1) and cv.stride == 1
                and cv.groups == 1 and cv.bias is None
                and bn.weight is not None and bn.bias is not None
                and not bn.use_global_stats):
            return None
        cout = cv.out_channels
        if not _fcb.fused_epilogues_eligible(cout, out):
            return None
        n, h, w_, cin = out.shape
        w = cv.weight.reshape(cout, cin).t()  # [Cin, Cout]
        y, nrm, nrv = _fcb.conv1x1_bn_relu(
            out.reshape(-1, cin), w, bn.weight, bn.bias,
            epsilon=bn.epsilon, momentum=bn.momentum,
            residual=identity.reshape(-1, cout), running_mean=bn._mean,
            running_var=bn._variance)
        with torch.no_grad():
            bn._mean.copy_(nrm)
            bn._variance.copy_(nrv)
        return y.reshape(n, h, w_, cout)

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        if self.downsample is not None:
            identity = self.downsample(x)
        fused = self._fused_tail(out, identity)
        if fused is not None:
            return fused
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


def _s2d_taps(d):
    """(4x4 kernel tap, 7x7 kernel row) pairs of block parity ``d``."""
    return [(a + 2, 2 * a + d + 3) for a in (-2, -1, 0, 1)
            if 0 <= 2 * a + d + 3 <= 6]


def _s2d_index(C: int) -> torch.Tensor:
    """For each entry ``(c', a, b)`` of the 4x4 kernel's ``[4C, 4, 4]``, its
    source in the flat ``[C·49 + 1]`` row of one output channel of the 7x7
    weight (index ``C·49`` is an appended zero): packed channel
    ``c' = dy·2C + dx·C + c`` takes tap ``(kh, kw)`` of parity ``(dy, dx)``."""
    idx = np.full((4 * C, 4, 4), C * 49, np.int64)
    for dy in (0, 1):
        for dx in (0, 1):
            lo = dy * 2 * C + dx * C
            for ai, kh in _s2d_taps(dy):
                for bi, kw in _s2d_taps(dx):
                    idx[lo:lo + C, ai, bi] = np.arange(C) * 49 + kh * 7 + kw
    return torch.from_numpy(idx.reshape(-1))


class ResNet(nn.Layer):
    """ResNet from "Deep Residual Learning for Image Recognition": ``block``
    class, ``depth`` in {18, 34, 50, 101, 152}, ``num_classes`` (≤ 0 drops
    the fc head), ``with_pool``, ``data_format``, ``stem_space_to_depth``
    (NHWC only); ``device`` (None = the card) and ``generator``."""

    _layer_cfg = {
        18: [2, 2, 2, 2],
        34: [3, 4, 6, 3],
        50: [3, 4, 6, 3],
        101: [3, 4, 23, 3],
        152: [3, 8, 36, 3],
    }

    @fills_its_layers
    def __init__(self, block, depth, num_classes=1000, with_pool=True,
                 data_format="NCHW", stem_space_to_depth=False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        layers = self._layer_cfg[depth]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.data_format = data_format
        if stem_space_to_depth and data_format != "NHWC":
            raise InvalidArgumentError(
                "stem_space_to_depth is an NHWC-layout optimization; use "
                "data_format='NHWC' or drop the flag")
        self.stem_space_to_depth = bool(stem_space_to_depth)
        self._s2d_idx = {}  # (C, device) -> _s2d_index(C) on that device
        self._norm_layer = functools.partial(nn.BatchNorm2D,
                                             data_format=data_format)
        self.inplanes = 64
        self.dilation = 1

        self.conv1 = nn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                               bias_attr=False, data_format=data_format)
        self.bn1 = self._norm_layer(self.inplanes)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(kernel_size=3, stride=2, padding=1,
                                    data_format=data_format)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1),
                                                data_format=data_format)
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes)
        _materialize(self, device, generator)

    def _make_layer(self, block, planes, blocks, stride=1, dilate=False):
        norm_layer = self._norm_layer
        downsample = None
        previous_dilation = self.dilation
        if dilate:
            self.dilation *= stride
            stride = 1
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False,
                          data_format=self.data_format),
                norm_layer(planes * block.expansion),
            )
        layers = [block(self.inplanes, planes, stride, downsample, 1, 64,
                        previous_dilation, norm_layer,
                        data_format=self.data_format)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, norm_layer=norm_layer,
                                data_format=self.data_format))
        return nn.Sequential(*layers)

    def _stem_s2d(self, x):
        """The stem on the 2x2 space-to-depth input: ``out[i, j, o] =
        Σ W[kh, kw, c] X[2i + kh - 3, 2j + kw - 3, c]`` re-indexed in 2x2
        blocks (``kh - 3 = 2a + dy``: tap ``a`` in -2..1, a 4-wide kernel
        padded (2, 1)), packed channel ``dy·2C + dx·C + c``."""
        B, H, W, C = x.shape
        if H % 2 or W % 2:
            # odd size: no 2x2 block re-layout; the standard stem (same
            # result, slower)
            return self.conv1(x)
        x2 = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(
            0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C)
        w = self.conv1.weight                                  # [O, C, 7, 7]
        O = w.shape[0]
        flat = torch.cat([w.reshape(O, C * 49), w.new_zeros(O, 1)], dim=1)
        idx = self._s2d_idx.get((C, w.device))
        if idx is None:
            idx = self._s2d_idx[(C, w.device)] = _s2d_index(C).to(w.device)
        w2 = flat.index_select(1, idx).reshape(O, 4 * C, 4, 4)
        return F.conv2d(x2, w2, stride=1, padding=[2, 1, 2, 1],
                        data_format="NHWC")

    def forward(self, x):
        if self.stem_space_to_depth:
            x = self.relu(self.bn1(self._stem_s2d(x)))
        else:
            x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.reshape(x.shape[0], -1)
            x = self.fc(x)
        return x


def _materialize(model: torch.nn.Module, device,
                 generator: Optional[torch.Generator]):
    """Draw every weight from ``generator`` (default: the CPU generator
    :func:`paddle_tpu_torch.seed` reseeds) in module order on the CPU,
    then move the model to ``device`` (None = the card)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else default_generator()
    for m in model.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(gen)
    model.to(device=dev)


def _pretrained(build, pretrained, kwargs):
    """Every model constructor's ``pretrained`` argument, the JAX rule: a
    path is a local checkpoint (``paddle_tpu_torch.load``, the JAX
    package's format too) loaded with ``set_state_dict`` into the model
    built on the CPU, which then moves to ``device`` (None = the card);
    any other true value raises, since nothing is downloaded."""
    if not pretrained:
        return build(**kwargs)
    if not isinstance(pretrained, str):
        raise InvalidArgumentError(
            "no pretrained-weight download in this environment: pass a "
            "local .pdparams path as `pretrained`")
    from ...framework.serialization import load

    device = kwargs.pop("device", None)
    model = build(device="cpu", **kwargs)
    model.set_state_dict(load(pretrained))
    return model.to(device=resolve_device(device))


def _resnet(Block, depth, pretrained, **kwargs):
    return _pretrained(functools.partial(ResNet, Block, depth), pretrained,
                       kwargs)


def resnet18(pretrained=False, **kwargs):
    """ResNet-18."""
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    """ResNet-34."""
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    """ResNet-50 (``bench.py``'s config 2: ``resnet50(data_format="NHWC",
    stem_space_to_depth=True).astype("bfloat16")``)."""
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    """ResNet-101."""
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    """ResNet-152."""
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)
