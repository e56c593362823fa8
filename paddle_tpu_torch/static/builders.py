"""1.x parameter-creating op builders over the recorded graph (port of
``paddle_tpu.static.builders``).

Each builder makes its eager Layer ONCE at build time, registers the
Layer's parameters and buffers in the current Program's scope and records
an op that runs the Layer with the scope's tensors in their place
(``torch.func.functional_call``): the build-once / run-many split of the
reference's ``fluid.layers`` builders.  ``layer_op`` is the shared
machinery, and the way to put a whole model into a Program (bench.py's
configs 2 and 3).

The builders need graph mode (a symbolic Variable input); called with
tensors they raise, naming the eager Layer.  Ported: ``fc``,
``embedding``, ``conv2d``, ``conv2d_transpose``, ``conv3d``,
``conv3d_transpose``, ``pool2d``, ``batch_norm``, ``layer_norm``,
``instance_norm``, ``group_norm``, ``spectral_norm``, ``prelu``,
``bilinear_tensor_product``, ``hsigmoid``, ``multi_box_head``,
``deformable_conv`` and ``layer_op``.  The other
builders of the JAX module raise ``UnimplementedError`` naming the
ROADMAP queue-A item that ports their layers.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from ..framework.errors import InvalidArgumentError, UnimplementedError
from .graph import Variable, default_main_program, record_call

__all__ = ["fc", "embedding", "conv2d", "conv2d_transpose", "conv3d",
           "conv3d_transpose", "pool2d", "batch_norm",
           "layer_norm", "instance_norm", "group_norm", "spectral_norm",
           "prelu", "bilinear_tensor_product", "hsigmoid", "multi_box_head",
           "deformable_conv", "layer_op"]

#: the activations a builder's ``act=`` names
_ACTS = {
    "relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "softmax": lambda t: torch.softmax(t, dim=-1),
    "gelu": torch.nn.functional.gelu,
    "relu6": lambda t: torch.clamp(t, 0.0, 6.0),
    "leaky_relu": lambda t: torch.nn.functional.leaky_relu(t, 0.01),
    "elu": torch.nn.functional.elu,
}


def _require_var(x, builder, eager):
    if not isinstance(x, Variable):
        raise InvalidArgumentError(
            f"fluid.layers.{builder} creates parameters in a Program and "
            f"needs graph mode: build under fluid.program_guard + run with "
            f"fluid.Executor (static/graph.py), or use the eager {eager}")
    return x


def _act(out, act):
    if not act:
        return out
    fn = _ACTS.get(act)
    if fn is None:
        raise InvalidArgumentError(f"unknown activation {act!r}")
    return fn(out)


def _register_layer_state(layer, prefix):
    """Register a build-time Layer's parameters and buffers in the current
    Program's scope; returns the (scope name → layer name) maps."""
    prog = default_main_program()
    pmap, bmap = {}, {}
    for ln, p in layer.named_parameters():
        sname = prog.unique_name(f"{prefix}.{ln.replace('.', '_')}")
        prog.register_param(sname, p, trainable=p.requires_grad)
        pmap[sname] = ln
    for ln, b in layer.named_buffers():
        sname = prog.unique_name(f"{prefix}.{ln.replace('.', '_')}")
        prog.register_buffer(sname, b)
        bmap[sname] = ln
    return pmap, bmap


@contextlib.contextmanager
def _mode(modules, training: bool):
    """Every module of ``modules`` in ``training`` mode for the call, its
    own mode restored after."""
    saved = [m.training for m in modules]
    for m in modules:
        m.training = training
    try:
        yield
    finally:
        for m, t in zip(modules, saved):
            m.training = t


def layer_op(layer, x, *, prefix: str, act: Optional[str] = None,
             post=None, extra_args=(), force_training: Optional[bool] = None):
    """Register ``layer``'s parameters and buffers in the current program
    and record an op that runs it over them: ``layer(x, *extra_args)``,
    then ``post``, then ``act``.  ``force_training`` pins the layer's mode
    whatever the run's (``batch_norm(is_test=True)``).  The layer itself
    keeps its values; its buffers' updates (BatchNorm statistics) land in
    the scope's buffers."""
    pmap, bmap = _register_layer_state(layer, prefix)
    has_buf = bool(bmap)
    modules = list(layer.modules())

    def fn(pv, bv, xx, *extra, training=False):
        if force_training is not None:
            training = force_training
        tensors = {pmap[n]: v for n, v in pv.items()}
        tensors.update({bmap[n]: v for n, v in bv.items()})
        with _mode(modules, training):
            out = torch.func.functional_call(layer, tensors, (xx, *extra))
        if post is not None:
            out = post(out)
        out = _act(out, act)
        if has_buf:  # the buffers were written in place
            return out, dict(bv)
        return out

    return record_call(fn, x, *extra_args, prefix=prefix,
                       param_names=tuple(pmap), buffer_names=tuple(bmap),
                       writes_buffers=has_buf)


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """ref: fluid/layers/nn.py:354 — flattens the dims from
    ``num_flatten_dims`` on, applies xW+b, restores the leading dims."""
    x = _require_var(input, "fc", "paddle.nn.Linear")
    from .. import nn

    k = num_flatten_dims if num_flatten_dims >= 0 \
        else len(x.shape) + num_flatten_dims
    tail = x.shape[k:]
    if any(d is None for d in tail):
        raise InvalidArgumentError(
            f"fc: flattened feature dims {tail} must be static")
    in_features = int(np.prod(tail)) if tail else 1
    layer = nn.Linear(in_features, size, weight_attr=param_attr,
                      bias_attr=bias_attr)

    pre = record_call(lambda t: t.reshape(-1, in_features), x,
                      prefix="fc_flat")
    out = layer_op(layer, pre, prefix=name or "fc", act=act)
    if k != 1:
        out = record_call(
            lambda t, orig: t.reshape(tuple(orig.shape[:k]) + (size,)),
            out, x, prefix="fc_unflat")
    return out


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32", name=None):
    """ref: fluid/layers/nn.py:584 (lookup_table_v2)."""
    x = _require_var(input, "embedding", "paddle.nn.Embedding")
    from .. import nn

    layer = nn.Embedding(size[0], size[1], padding_idx=padding_idx,
                         sparse=is_sparse, weight_attr=param_attr)
    return layer_op(layer, x, prefix=name or "embedding")


def _conv_builder(cls, builder, input, num_filters, filter_size, stride,
                  padding, dilation, groups, param_attr, bias_attr, act,
                  name, data_format):
    x = _require_var(input, builder, f"paddle.nn.{cls}")
    from .. import nn

    in_ch = x.shape[1] if data_format.startswith("NC") else x.shape[-1]
    layer = getattr(nn, cls)(
        int(in_ch), num_filters, filter_size, stride=stride, padding=padding,
        dilation=dilation, groups=groups or 1, weight_attr=param_attr,
        bias_attr=bias_attr, data_format=data_format)
    return layer_op(layer, x, prefix=name or builder, act=act)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    """ref: fluid/layers/nn.py conv2d — creates the filter and bias."""
    return _conv_builder("Conv2D", "conv2d", input, num_filters,
                         filter_size, stride, padding, dilation, groups,
                         param_attr, bias_attr, act, name, data_format)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True, data_format="NCHW"):
    """ref: fluid/layers/nn.py pool2d — stateless, but kept here so the
    classic conv → pool build chains stay in one import."""
    x = _require_var(input, "pool2d", "nn.functional.max_pool2d/avg_pool2d")
    if pool_type not in ("max", "avg"):
        raise InvalidArgumentError(f"pool2d: pool_type {pool_type!r}")
    from ..nn import functional as F

    def fn(xx):
        if global_pooling:
            axes = (2, 3) if data_format == "NCHW" else (1, 2)
            if pool_type == "max":
                return torch.amax(xx, dim=axes, keepdim=True)
            return torch.mean(xx, dim=axes, keepdim=True)
        if pool_type == "max":
            return F.max_pool2d(xx, pool_size, stride=pool_stride,
                                padding=pool_padding, ceil_mode=ceil_mode,
                                data_format=data_format)
        return F.avg_pool2d(xx, pool_size, stride=pool_stride,
                            padding=pool_padding, ceil_mode=ceil_mode,
                            exclusive=exclusive, data_format=data_format)

    return record_call(fn, x, prefix=name or "pool2d")


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=True,
               use_global_stats=False):
    """ref: fluid/layers/nn.py batch_norm — the scale / shift parameters
    and the moving mean / variance buffers; the statistics update on
    training runs and stay on evaluation runs (``is_test`` /
    ``use_global_stats`` pin evaluation mode)."""
    x = _require_var(input, "batch_norm", "paddle.nn.BatchNorm2D")
    from .. import nn

    ch = x.shape[1] if data_layout == "NCHW" else x.shape[-1]
    layer = nn.BatchNorm2D(int(ch), momentum=momentum, epsilon=epsilon,
                           weight_attr=param_attr, bias_attr=bias_attr,
                           data_format=data_layout)
    frozen = True if (use_global_stats or is_test) else None
    return layer_op(layer, x, prefix=name or "batch_norm", act=act,
                    force_training=False if frozen else None)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    """ref: fluid/layers/nn.py layer_norm — normalizes over the dims from
    ``begin_norm_axis`` on."""
    x = _require_var(input, "layer_norm", "paddle.nn.LayerNorm")
    from .. import nn

    normalized = [int(d) for d in x.shape[begin_norm_axis:]]
    layer = nn.LayerNorm(normalized, epsilon=epsilon,
                         weight_attr=param_attr if scale else False,
                         bias_attr=bias_attr if shift else False)
    return layer_op(layer, x, prefix=name or "layer_norm", act=act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    """ref: fluid/layers/nn.py instance_norm (4-D NCHW input)."""
    x = _require_var(input, "instance_norm", "paddle.nn.InstanceNorm2D")
    from .. import nn

    layer = nn.InstanceNorm2D(int(x.shape[1]), epsilon=epsilon,
                              weight_attr=param_attr, bias_attr=bias_attr)
    return layer_op(layer, x, prefix=name or "instance_norm")


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    """ref: fluid/layers/nn.py group_norm."""
    x = _require_var(input, "group_norm", "paddle.nn.GroupNorm")
    from .. import nn

    ch = x.shape[1] if data_layout == "NCHW" else x.shape[-1]
    layer = nn.GroupNorm(groups, int(ch), epsilon=epsilon,
                         weight_attr=param_attr, bias_attr=bias_attr,
                         data_format=data_layout)
    return layer_op(layer, x, prefix=name or "group_norm", act=act)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """ref: fluid/layers/nn.py spectral_norm: a weight Variable over its
    largest singular value (power iteration)."""
    x = _require_var(weight, "spectral_norm", "paddle.nn.SpectralNorm")
    from .. import nn

    layer = nn.SpectralNorm([int(d) for d in x.shape], dim=dim,
                            power_iters=power_iters, eps=eps)
    return layer_op(layer, x, prefix=name or "spectral_norm")


def prelu(x, mode="all", param_attr=None, data_format="NCHW", name=None):
    """ref: fluid/layers/nn.py prelu: a learnable negative slope, one
    (``all``), one a channel (``channel``) or one an element
    (``element``)."""
    v = _require_var(x, "prelu", "paddle.nn.PReLU")
    from .. import nn

    if mode == "all":
        num = 1
    elif mode == "channel":
        num = int(v.shape[1] if data_format == "NCHW" else v.shape[-1])
    else:
        num = int(np.prod(v.shape[1:]))
    layer = nn.PReLU(num_parameters=num, weight_attr=param_attr,
                     data_format=data_format)
    return layer_op(layer, v, prefix=name or "prelu")


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    """ref: fluid/layers/nn.py bilinear_tensor_product."""
    xv = _require_var(x, "bilinear_tensor_product",
                      "paddle.nn.BilinearTensorProduct")
    from .. import nn

    layer = nn.BilinearTensorProduct(int(xv.shape[-1]), int(y.shape[-1]),
                                     size, param_attr=param_attr,
                                     bias_attr=bias_attr)
    return layer_op(layer, xv, prefix=name or "bilinear_tensor_product",
                    act=act, extra_args=(y,))


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None, path_table=None, path_code=None, is_custom=False,
             is_sparse=False):
    """ref: fluid/layers/nn.py hsigmoid: the hierarchical sigmoid loss
    over ``paddle.nn.HSigmoidLoss`` (which holds the tree's weights)."""
    x = _require_var(input, "hsigmoid", "paddle.nn.HSigmoidLoss")
    from .. import nn

    layer = nn.HSigmoidLoss(int(x.shape[-1]), num_classes,
                            weight_attr=param_attr, bias_attr=bias_attr,
                            is_custom=is_custom, is_sparse=is_sparse)
    extra = (label,) if path_table is None else (label, path_table,
                                                 path_code)
    return layer_op(layer, x, prefix=name or "hsigmoid", extra_args=extra)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None, data_format="NCHW"):
    """ref: fluid/layers/nn.py conv2d_transpose (``output_size`` unused,
    as in the JAX builder)."""
    return _conv_builder("Conv2DTranspose", "conv2d_transpose", input,
                         num_filters, filter_size, stride, padding, dilation,
                         groups, param_attr, bias_attr, act, name,
                         data_format)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCDHW"):
    """ref: fluid/layers/nn.py conv3d."""
    return _conv_builder("Conv3D", "conv3d", input, num_filters,
                         filter_size, stride, padding, dilation, groups,
                         param_attr, bias_attr, act, name, data_format)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None, data_format="NCDHW"):
    """ref: fluid/layers/nn.py conv3d_transpose (``output_size`` unused,
    as in the JAX builder)."""
    return _conv_builder("Conv3DTranspose", "conv3d_transpose", input,
                         num_filters, filter_size, stride, padding, dilation,
                         groups, param_attr, bias_attr, act, name,
                         data_format)


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """ref: fluid/layers/detection.py multi_box_head — the SSD head: one
    location conv, one confidence conv and one prior_box per feature map,
    gathered into (mbox_locs, mbox_confs, boxes, variances).  The convs
    are ``conv2d`` builders; min / max sizes follow the reference's ratio
    interpolation when not given."""
    from ..nn import functional as F

    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    for v in inputs:
        _require_var(v, "multi_box_head", "compose nn.Conv2D + prior_box")
    n_maps = len(inputs)
    if min_sizes is None:
        if n_maps < 3:
            raise InvalidArgumentError(
                "multi_box_head: the min/max-ratio interpolation needs at "
                "least 3 feature maps (it divides by n_maps-2, "
                "detection.py); pass explicit min_sizes/max_sizes for "
                "fewer maps")
        step_r = int((max_ratio - min_ratio) / (n_maps - 2))
        min_sizes, max_sizes = [], []
        for r in range(int(min_ratio), int(max_ratio) + 1, max(step_r, 1)):
            min_sizes.append(base_size * r / 100.0)
            max_sizes.append(base_size * (r + step_r) / 100.0)
        min_sizes = [base_size * 0.10] + min_sizes
        max_sizes = [base_size * 0.20] + max_sizes
    min_sizes = [list(s) if isinstance(s, (list, tuple)) else [s]
                 for s in min_sizes]
    max_sizes = [list(s) if isinstance(s, (list, tuple)) else [s]
                 for s in (max_sizes or [None] * n_maps)]

    locs, confs, boxes_all, vars_all = [], [], [], []
    for i, feat in enumerate(inputs):
        ar = aspect_ratios[i]
        ar = list(ar) if isinstance(ar, (list, tuple)) else [ar]
        step = steps[i] if steps else 0.0
        sw = step_w[i] if step_w else step
        sh = step_h[i] if step_h else step

        def prior(fv, img, i=i, ar=ar, sw=sw, sh=sh):
            b, v = F.prior_box(
                fv, img, min_sizes=min_sizes[i],
                max_sizes=[m for m in max_sizes[i] if m] or None,
                aspect_ratios=ar, variance=list(variance), flip=flip,
                clip=clip, steps=[sw, sh], offset=offset,
                min_max_aspect_ratios_order=min_max_aspect_ratios_order)
            return b.reshape(-1, 4), v.reshape(-1, 4)

        b, v = record_call(prior, feat, image, prefix="prior_box")
        boxes_all.append(b)
        vars_all.append(v)
        # the per-position prior count from prior_box's recorded shape
        n_priors = int(b.shape[0]) // (int(feat.shape[2])
                                       * int(feat.shape[3]))
        loc = conv2d(feat, n_priors * 4, kernel_size, stride=stride,
                     padding=pad, name=f"{name or 'mbox'}_loc{i}")
        conf = conv2d(feat, n_priors * num_classes, kernel_size,
                      stride=stride, padding=pad,
                      name=f"{name or 'mbox'}_conf{i}")

        def to_last(t, ch):
            return t.permute(0, 2, 3, 1).reshape(t.shape[0], -1, ch)

        locs.append(record_call(to_last, loc, 4, prefix="mbox_reshape"))
        confs.append(record_call(to_last, conf, num_classes,
                                 prefix="mbox_reshape"))

    def cat(vs, dim):
        return record_call(lambda *ts: torch.cat(ts, dim=dim), *vs,
                           prefix="mbox_cat")

    return (cat(locs, 1), cat(confs, 1), cat(boxes_all, 0),
            cat(vars_all, 0))


def deformable_conv(input, offset, mask, num_filters, filter_size,
                    stride=1, padding=0, dilation=1, groups=1,
                    deformable_groups=1, im2col_step=1, param_attr=None,
                    bias_attr=None, modulated=True, name=None):
    """ref: fluid/layers/nn.py deformable_conv (DCN v1 / v2): creates the
    filter (Xavier normal) and bias in the Program and runs
    ``nn.functional.deform_conv2d``; ``modulated=False`` is v1 (no
    mask)."""
    x = _require_var(input, "deformable_conv",
                     "paddle.nn.functional.deform_conv2d")
    from .. import nn
    from ..nn import initializer as I

    in_ch = int(x.shape[1])
    ks = (tuple(filter_size) if isinstance(filter_size, (list, tuple))
          else (filter_size, filter_size))

    class _DCN(nn.Layer):
        def __init__(self):
            super().__init__()
            self.weight = self.create_parameter(
                (num_filters, in_ch // (groups or 1), ks[0], ks[1]),
                attr=param_attr, default_initializer=I.XavierNormal())
            self.bias = (self.create_parameter(
                (num_filters,), attr=bias_attr, is_bias=True)
                if bias_attr is not False else None)

        def forward(self, xx, off, msk=None):
            from ..nn import functional as F

            return F.deform_conv2d(
                xx, off, self.weight, bias=self.bias, stride=stride,
                padding=padding, dilation=dilation,
                deformable_groups=deformable_groups, groups=groups or 1,
                mask=msk if modulated else None)

    if modulated and mask is None:
        raise InvalidArgumentError(
            "deformable_conv(modulated=True) is DCNv2 and requires the "
            "mask input; pass modulated=False for DCNv1")
    extra = (offset, mask) if modulated else (offset,)
    return layer_op(_DCN(), x, prefix=name or "deformable_conv",
                    extra_args=extra)


#: the JAX module's other builders → the queue-A item that ports them
UNPORTED = {
    **{n: "static graph and the long tail" for n in (
        "nce", "center_loss", "sequence_conv", "inplace_abn", "lstm",
        "data_norm", "gru_unit", "lstm_unit", "dynamic_lstm",
        "dynamic_lstmp", "dynamic_gru")},
}


def unported(qualname: str, item: str):
    """A function of the JAX package's name that raises
    ``UnimplementedError`` naming the ROADMAP queue-A item that ports
    it."""
    name = qualname.rsplit(".", 1)[-1]

    def shim(*args, **kwargs):
        raise UnimplementedError(
            f"{qualname} is not ported yet (ROADMAP queue A, {item})")

    shim.__name__ = shim.__qualname__ = name
    shim.__doc__ = f"Not ported yet: ROADMAP queue A, {item}."
    shim.__shim__ = True
    return shim


for _name, _item in UNPORTED.items():
    globals()[_name] = unported(f"paddle.static.nn.{_name}", _item)
del _name, _item
