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
tensors they raise, naming the eager Layer.  Every builder of the JAX
module is here: ``fc``, ``embedding``, ``conv2d``, ``conv2d_transpose``,
``conv3d``, ``conv3d_transpose``, ``pool2d``, ``batch_norm``,
``layer_norm``, ``instance_norm``, ``group_norm``, ``spectral_norm``,
``prelu``, ``bilinear_tensor_product``, ``hsigmoid``, ``multi_box_head``,
``deformable_conv``, the CTR / loss builders ``nce``, ``center_loss``,
``data_norm`` and ``inplace_abn``, ``sequence_conv``, and the 1.x RNN
builders ``lstm`` (``nn.LSTM`` through ``nn.functional_call``),
``gru_unit`` / ``dynamic_gru`` (``fluid.dygraph.GRUUnit``), ``lstm_unit``,
``dynamic_lstm`` and ``dynamic_lstmp``; and ``layer_op``.

The 1.x RNN builders take pre-projected input and run over all T steps
with no lengths, as the JAX dense form does: a reverse direction starts in
the padding (a standing difference from 1.x LoD).  Their recurrences are
time loops on the device, a few launches a step.  ``center_loss`` and
``data_norm`` update their buffers on training runs, in place.  ``nce``
draws its negatives from the device's generator; a nonzero ``seed`` draws
them from a CPU generator of that seed instead (the same ids on every
device, in eager runs: under a CUDA graph capture it raises).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from ..framework.errors import InvalidArgumentError, UnimplementedError
from ..framework.random import generator_for
from .graph import Variable, default_main_program, record_call

__all__ = ["fc", "embedding", "conv2d", "conv2d_transpose", "conv3d",
           "conv3d_transpose", "pool2d", "batch_norm",
           "layer_norm", "instance_norm", "group_norm", "spectral_norm",
           "prelu", "bilinear_tensor_product", "hsigmoid", "multi_box_head",
           "deformable_conv", "nce", "center_loss", "sequence_conv",
           "inplace_abn", "lstm", "data_norm", "gru_unit", "lstm_unit",
           "dynamic_lstm", "dynamic_lstmp", "dynamic_gru", "layer_op"]

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


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=5, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False):
    """ref: fluid/layers/nn.py nce — noise-contrastive estimation over
    ``num_neg_samples`` uniform negatives: a sample's loss is
    ``softplus(−s_pos) + Σ softplus(s_neg)`` (``[B, 1]``), with the
    ``[num_classes, D]`` weight and ``[num_classes]`` bias in the Program.
    Only ``sampler='uniform'`` (as in JAX)."""
    x = _require_var(input, "nce", "sampled softmax "
                     "(fluid.layers.sampled_softmax_with_cross_entropy)")
    if sampler != "uniform" or custom_dist is not None:
        raise InvalidArgumentError(
            "nce: only sampler='uniform' is implemented (log-uniform / "
            "custom_dist sampling is a documented deviation)")
    from .. import nn

    D = int(x.shape[-1])
    host_gen = torch.Generator().manual_seed(int(seed)) if seed else None

    class _NCE(nn.Layer):
        def __init__(self):
            super().__init__()
            self.weight = self.create_parameter(
                (num_total_classes, D), attr=param_attr)
            self.bias = self.create_parameter(
                (num_total_classes,), attr=bias_attr, is_bias=True)

        def _negatives(self, B, device):
            shape = (B, int(num_neg_samples))
            if device.type == "meta":
                return torch.zeros(shape, dtype=torch.int64, device=device)
            if host_gen is None:
                return torch.randint(0, num_total_classes, shape,
                                     generator=generator_for(device),
                                     device=device)
            if device.type == "cuda" and \
                    torch.cuda.is_current_stream_capturing():
                raise InvalidArgumentError(
                    "nce(seed=...) draws its negatives on the host: a "
                    "captured run would replay one draw; use seed=0 (the "
                    "device generator) under run_steps")
            return torch.randint(0, num_total_classes, shape,
                                 generator=host_gen).to(device)

        def forward(self, xx, lbl):
            lbl = lbl.reshape(-1).to(torch.int64)
            s_pos = (xx * self.weight[lbl]).sum(-1) + self.bias[lbl]
            neg = self._negatives(xx.shape[0], xx.device)
            s_neg = torch.einsum("bd,bsd->bs", xx, self.weight[neg]) \
                + self.bias[neg]
            loss = torch.nn.functional.softplus(-s_pos) \
                + torch.nn.functional.softplus(s_neg).sum(-1)
            return loss[:, None]

    return layer_op(_NCE(), x, prefix=name or "nce", extra_args=(label,))


def center_loss(input, label, num_classes, alpha, param_attr=None,
                update_center=True, name=None):
    """ref: fluid/layers/loss.py center_loss — ``0.5·||x − c[label]||²``
    (``[B, 1]``); training runs move the touched centers by
    ``c ← c − α·Σ(c − x)/(1 + n)`` (the ``[num_classes, D]`` centers
    buffer, updated in place)."""
    x = _require_var(input, "center_loss",
                     "a Layer holding a centers buffer")
    from .. import nn

    D = int(x.shape[-1])

    class _CenterLoss(nn.Layer):
        def __init__(self):
            super().__init__()
            self.register_buffer("centers", torch.zeros(num_classes, D))

        def forward(self, xx, lbl):
            lbl = lbl.reshape(-1).to(torch.int64)
            c = self.centers
            diff = xx.to(torch.float32) - c[lbl]
            loss = 0.5 * diff.square().sum(-1, keepdim=True)
            if self.training and update_center:
                with torch.no_grad():
                    d = diff.detach()
                    counts = torch.zeros(num_classes, dtype=torch.float32,
                                         device=c.device).index_add_(
                        0, lbl, torch.ones_like(d[:, 0]))
                    sums = torch.zeros_like(c).index_add_(0, lbl, -d)
                    c.sub_(alpha * sums / (1.0 + counts)[:, None])
            return loss

    return layer_op(_CenterLoss(), x, prefix=name or "center_loss",
                    extra_args=(label,))


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, padding_start=None, bias_attr=None,
                  param_attr=None, act=None, name=None):
    """ref: fluid/layers/nn.py sequence_conv — a context-window projection
    over the time dim of ``[B, T, D]``: each position projects the concat
    of its ``filter_size`` context rows (zeros past either end) through a
    ``[filter_size·D, num_filters]`` weight."""
    x = _require_var(input, "sequence_conv",
                     "conv1d over padded batches with sequence_mask")
    from .. import nn

    D = int(x.shape[-1])
    start = (-(filter_size // 2) if padding_start is None
             else int(padding_start))

    class _SeqConv(nn.Layer):
        def __init__(self):
            super().__init__()
            self.weight = self.create_parameter(
                (filter_size * D, num_filters), attr=param_attr)
            self.bias = (self.create_parameter(
                (num_filters,), attr=bias_attr, is_bias=True)
                if bias_attr is not False else None)

        def forward(self, xx):
            T = xx.shape[1]
            t = torch.arange(T, device=xx.device)
            cols = []
            for j in range(filter_size):
                off = start + j
                rolled = torch.roll(xx, -off, dims=1)
                inside = ((t + off >= 0) & (t + off < T))[None, :, None]
                cols.append(torch.where(inside, rolled,
                                        torch.zeros_like(rolled)))
            out = torch.cat(cols, dim=-1) @ self.weight
            return out if self.bias is None else out + self.bias

    return layer_op(_SeqConv(), x, prefix=name or "sequence_conv", act=act)


def inplace_abn(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
                param_attr=None, bias_attr=None, data_layout="NCHW",
                name=None, act_alpha=1.0, **kw):
    """ref: fluid/layers/nn.py inplace_abn — ``batch_norm`` with its
    activation (the in-place memory trick is the allocator's business)."""
    return batch_norm(input, act=act, is_test=is_test, momentum=momentum,
                      epsilon=epsilon, param_attr=param_attr,
                      bias_attr=bias_attr, data_layout=data_layout,
                      name=name or "inplace_abn")


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1):
    """ref: fluid/layers/rnn.py lstm (the cudnn-style multi-layer LSTM):
    ``nn.LSTM`` on dense ``[B, T, D]`` input run through
    ``nn.functional_call`` over the scope's parameters; returns
    ``(out, last_h, last_c)``."""
    x = _require_var(input, "lstm", "paddle.nn.LSTM")
    from .. import nn

    if x.shape[-1] is None:
        raise InvalidArgumentError(
            "lstm: the input feature dim must be static (it sizes the "
            "gate weights); declare it instead of -1")
    layer = nn.LSTM(int(x.shape[-1]), hidden_size, num_layers=num_layers,
                    direction="bidirect" if is_bidirec else "forward",
                    dropout=dropout_prob)
    pmap, _ = _register_layer_state(layer, name or "lstm")

    def fn(pv, bv, xx, h0, c0, *, training=False):
        if is_test:  # evaluation whatever the run's mode
            training = False
        params = {pmap[n]: v for n, v in pv.items()}
        out, (h, c) = nn.functional_call(layer, params, xx, (h0, c0),
                                         training=training)
        return out, h, c

    return record_call(fn, x, init_h, init_c, prefix=name or "lstm",
                       param_names=tuple(pmap), scoped=True)


def data_norm(input, act=None, epsilon=1e-5, param_attr=None,
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=True, slot_dim=-1,
              sync_stats=False, summary_decay_rate=0.9999999,
              enable_scale_and_shift=False):
    """ref: fluid/layers/nn.py:3220 data_norm — global-statistics
    normalization of ``[batch, C]`` CTR features: ``mean = batch_sum /
    batch_size``, ``scale = sqrt(batch_size / batch_square_sum)``; the
    three summaries (started at 1e4, 0, 1e4: an initial scale of 1) are
    buffers that training runs decay and accumulate in place."""
    x = _require_var(input, "data_norm", "paddle.nn.BatchNorm1D")
    from .. import nn

    if len(x.shape) != 2:
        raise InvalidArgumentError(
            "data_norm normalizes 2-D [batch, C] CTR feature slots (the "
            "reference's primary use); for image tensors use batch_norm")
    C = int(x.shape[-1])

    class _DataNorm(nn.Layer):
        def __init__(self):
            super().__init__()
            self.register_buffer("batch_size", torch.full((C,), 1e4))
            self.register_buffer("batch_sum", torch.zeros(C))
            self.register_buffer("batch_square_sum", torch.full((C,), 1e4))
            if enable_scale_and_shift:
                self.scale_w = self.create_parameter((C,), attr=param_attr)
                self.bias = self.create_parameter((C,), is_bias=True)

        def forward(self, xx):
            xf = xx.to(torch.float32).reshape(-1, C)
            size = self.batch_size
            mean = self.batch_sum / size
            scale = torch.sqrt(size / self.batch_square_sum)
            out = (xf - mean) * scale
            if enable_scale_and_shift:
                out = out * self.scale_w + self.bias
            if self.training:
                with torch.no_grad():
                    d = summary_decay_rate
                    xd = xf.detach()
                    self.batch_sum.mul_(d).add_(xd.sum(0))
                    self.batch_square_sum.mul_(d).add_(xd.square().sum(0))
                    self.batch_size.mul_(d).add_(float(xf.shape[0]))
            return out.reshape(xx.shape).to(xx.dtype)

    return layer_op(_DataNorm(), x, prefix=name or "data_norm", act=act)


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid",
             origin_mode=False):
    """ref: fluid/layers/nn.py gru_unit — one GRU step over pre-projected
    input ``[B, 3·hidden]`` (``size`` = 3 × hidden, the fused width);
    returns ``(new_hidden, reset_hidden_prev, gate)``, over
    ``fluid.dygraph.GRUUnit``."""
    x = _require_var(input, "gru_unit", "paddle.nn.GRUCell")
    if size % 3:
        raise InvalidArgumentError(
            f"gru_unit: size ({size}) is the FUSED gate width and must be "
            f"3 x hidden (1.x convention)")
    if x.shape[-1] is not None and int(x.shape[-1]) != int(size):
        raise InvalidArgumentError(
            f"gru_unit: input width {x.shape[-1]} must equal size {size} "
            f"(the input arrives pre-projected to the fused 3*hidden "
            f"layout)")
    from ..fluid.dygraph import GRUUnit

    layer = GRUUnit(size, param_attr=param_attr, bias_attr=bias_attr,
                    activation=activation, gate_activation=gate_activation,
                    origin_mode=origin_mode)
    return layer_op(layer, x, prefix="gru_unit", extra_args=(hidden,))


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """ref: fluid/layers/nn.py lstm_unit — gates {i, f (+forget_bias), o,
    g} from ``fc([x, h]) → 4·D``: ``c' = f·c + i·g``, ``h' = o·tanh(c')``;
    returns ``(hidden, cell)``."""
    x = _require_var(x_t, "lstm_unit", "paddle.nn.LSTMCell")
    from .. import nn

    if len(x.shape) != 2 or len(hidden_t_prev.shape) != 2 \
            or len(cell_t_prev.shape) != 2:
        raise InvalidArgumentError(
            "lstm_unit expects rank-2 x_t/hidden_t_prev/cell_t_prev "
            "(reference constraint)")
    if hidden_t_prev.shape[-1] != cell_t_prev.shape[-1]:
        raise InvalidArgumentError(
            f"lstm_unit: hidden dim {hidden_t_prev.shape[-1]} != cell "
            f"dim {cell_t_prev.shape[-1]}")
    Dx, Dh = int(x.shape[-1]), int(hidden_t_prev.shape[-1])

    class _LSTMUnit(nn.Layer):
        def __init__(self):
            super().__init__()
            self.weight = self.create_parameter((Dx + Dh, 4 * Dh),
                                                attr=param_attr)
            self.bias = (self.create_parameter((4 * Dh,), attr=bias_attr,
                                               is_bias=True)
                         if bias_attr is not False else None)

        def forward(self, xx, h, c):
            z = torch.cat([xx, h], dim=-1) @ self.weight
            if self.bias is not None:
                z = z + self.bias
            i = torch.sigmoid(z[:, :Dh])
            f = torch.sigmoid(z[:, Dh:2 * Dh] + forget_bias)
            o = torch.sigmoid(z[:, 2 * Dh:3 * Dh])
            g = torch.tanh(z[:, 3 * Dh:])
            c_new = f * c + i * g
            return o * torch.tanh(c_new), c_new

    return layer_op(_LSTMUnit(), x, prefix=name or "lstm_unit",
                    extra_args=(hidden_t_prev, cell_t_prev))


#: the 1.x RNN builders' activations (``hard_sigmoid`` is JAX's
#: ``relu6(x + 3) / 6``, not paddle's ``0.2x + 0.5``)
_RNN_ACTS = {
    "sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
    "hard_sigmoid": lambda v: torch.clamp(v + 3.0, 0.0, 6.0) / 6.0,
    "identity": lambda v: v,
}


def _rnn_act(name):
    if name not in _RNN_ACTS:
        raise InvalidArgumentError(
            f"dynamic_lstm/lstmp: unsupported activation {name!r} "
            f"(supported: {sorted(_RNN_ACTS)})")
    return _RNN_ACTS[name]


def _lstm_scan(x_seq, w, b_gates, peep, h0, c0, gate_act, cell_act,
               cand_act, is_reverse, proj=None, proj_act=None,
               cell_clip=None, proj_clip=None):
    """The recurrence of dynamic_lstm / dynamic_lstmp over pre-projected
    ``[B, T, 4H]``: gate chunks {c, i, f, o} (the 1.x fused layout),
    ``peep`` = (W_ic, W_fc, W_oc) or None, ``proj`` ``[H, P]`` or None
    (lstmp: the recurrent state is the projection).  Returns the hidden
    and cell sequences ``[B, T, ·]``."""
    H = w.shape[1] // 4
    ga, ca, cda = _rnn_act(gate_act), _rnn_act(cell_act), _rnn_act(cand_act)
    pa = _rnn_act(proj_act) if proj_act else None
    T = x_seq.shape[1]
    h, c = h0, c0
    hs, cs = [], []
    for t in (range(T - 1, -1, -1) if is_reverse else range(T)):
        z = x_seq[:, t] + h @ w + b_gates
        zc, zi, zf, zo = (z[:, :H], z[:, H:2 * H], z[:, 2 * H:3 * H],
                          z[:, 3 * H:])
        if peep is not None:
            i, f = ga(zi + peep[0] * c), ga(zf + peep[1] * c)
        else:
            i, f = ga(zi), ga(zf)
        c = f * c + i * cda(zc)
        if cell_clip is not None:
            c = torch.clamp(c, -cell_clip, cell_clip)
        o = ga(zo + peep[2] * c) if peep is not None else ga(zo)
        h = o * ca(c)
        if proj is not None:
            h = h @ proj
            if pa is not None:
                h = pa(h)
            if proj_clip is not None:
                h = torch.clamp(h, -proj_clip, proj_clip)
        hs.append(h)
        cs.append(c)
    if is_reverse:
        hs, cs = hs[::-1], cs[::-1]
    return torch.stack(hs, dim=1), torch.stack(cs, dim=1)


def _check_fused(x, size, builder, gates):
    if size % gates:
        raise InvalidArgumentError(
            f"{builder}: size ({size}) must be {gates} x hidden")
    if x.shape[-1] is not None and int(x.shape[-1]) != int(size):
        raise InvalidArgumentError(
            f"{builder}: input width {x.shape[-1]} must equal size "
            f"{size} (pre-projected fused layout)")


def _lstm_inits(builder, h_0, c_0):
    if (h_0 is None) != (c_0 is None):
        raise InvalidArgumentError(
            f"{builder}: h_0 and c_0 must be given together (the "
            f"reference allows None only for both)")
    return (h_0, c_0) if h_0 is not None else ()


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """ref: fluid/layers/rnn.py dynamic_lstm — the fused LSTM over
    pre-projected ``[B, T, 4·hidden]``: recurrent weight ``[hidden,
    4·hidden]`` in the {c, i, f, o} chunk order, bias ``[1, 4H]`` (``[1,
    7H]`` with the peepholes in its tail).  Returns (hidden, cell), each
    ``[B, T, H]``, over all T steps."""
    x = _require_var(input, "dynamic_lstm", "paddle.nn.LSTM")
    _check_fused(x, size, "dynamic_lstm", 4)
    H = size // 4
    from .. import nn

    class _DynLSTM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.weight = self.create_parameter((H, 4 * H), attr=param_attr,
                                                dtype=dtype)
            self.bias = self.create_parameter(
                (1, 7 * H if use_peepholes else 4 * H), attr=bias_attr,
                dtype=dtype, is_bias=True)

        def forward(self, xx, *inits):
            B = xx.shape[0]
            h0 = inits[0] if inits else xx.new_zeros((B, H))
            c0 = inits[1] if len(inits) > 1 else xx.new_zeros((B, H))
            b = self.bias[0]
            peep = ((b[4 * H:5 * H], b[5 * H:6 * H], b[6 * H:])
                    if use_peepholes else None)
            return _lstm_scan(xx, self.weight, b[:4 * H], peep, h0, c0,
                              gate_activation, cell_activation,
                              candidate_activation, is_reverse)

    return layer_op(_DynLSTM(), x, prefix=name or "dynamic_lstm",
                    extra_args=_lstm_inits("dynamic_lstm", h_0, c_0))


def dynamic_lstmp(input, size, proj_size, h_0=None, c_0=None,
                  param_attr=None, bias_attr=None, use_peepholes=True,
                  is_reverse=False, gate_activation="sigmoid",
                  cell_activation="tanh", candidate_activation="tanh",
                  proj_activation="tanh", dtype="float32", name=None,
                  cell_clip=None, proj_clip=None):
    """ref: fluid/layers/rnn.py dynamic_lstmp — the projected LSTM: the
    recurrent state is ``proj_act(h @ W_proj)`` with ``W_proj [hidden,
    proj_size]`` and a recurrent weight ``[proj_size, 4H]``.  Returns
    (projection ``[B, T, P]``, cell ``[B, T, H]``)."""
    x = _require_var(input, "dynamic_lstmp", "paddle.nn.LSTM")
    _check_fused(x, size, "dynamic_lstmp", 4)
    H, P = size // 4, int(proj_size)
    from .. import nn

    class _DynLSTMP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.weight = self.create_parameter((P, 4 * H), attr=param_attr,
                                                dtype=dtype)
            self.proj_weight = self.create_parameter((H, P),
                                                     attr=param_attr,
                                                     dtype=dtype)
            self.bias = self.create_parameter(
                (1, 7 * H if use_peepholes else 4 * H), attr=bias_attr,
                dtype=dtype, is_bias=True)

        def forward(self, xx, *inits):
            B = xx.shape[0]
            h0 = inits[0] if inits else xx.new_zeros((B, P))
            c0 = inits[1] if len(inits) > 1 else xx.new_zeros((B, H))
            b = self.bias[0]
            peep = ((b[4 * H:5 * H], b[5 * H:6 * H], b[6 * H:])
                    if use_peepholes else None)
            return _lstm_scan(xx, self.weight, b[:4 * H], peep, h0, c0,
                              gate_activation, cell_activation,
                              candidate_activation, is_reverse,
                              proj=self.proj_weight,
                              proj_act=proj_activation,
                              cell_clip=cell_clip, proj_clip=proj_clip)

    return layer_op(_DynLSTMP(), x, prefix=name or "dynamic_lstmp",
                    extra_args=_lstm_inits("dynamic_lstmp", h_0, c_0))


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None,
                origin_mode=False, name=None):
    """ref: fluid/layers/rnn.py dynamic_gru — the fused GRU over
    pre-projected ``[B, T, 3·hidden]`` (``size`` is the HIDDEN width
    here, unlike ``gru_unit``'s), stepping ``fluid.dygraph.GRUUnit``'s
    parameters (``[hidden, 3·hidden]``: update | reset, then the
    candidate).  Returns the hidden sequence ``[B, T, H]``."""
    x = _require_var(input, "dynamic_gru", "paddle.nn.GRU")
    H = int(size)
    if x.shape[-1] is not None and int(x.shape[-1]) != 3 * H:
        raise InvalidArgumentError(
            f"dynamic_gru: input width {x.shape[-1]} must be 3*size "
            f"({3 * H}; size is the HIDDEN width here, unlike gru_unit)")
    from .. import nn
    from ..fluid.dygraph import GRUUnit

    class _DynGRU(nn.Layer):
        def __init__(self):
            super().__init__()
            self.unit = GRUUnit(3 * H, param_attr=param_attr,
                                bias_attr=bias_attr,
                                activation=candidate_activation,
                                gate_activation=gate_activation,
                                origin_mode=origin_mode)

        def forward(self, xx, *inits):
            T = xx.shape[1]
            h = inits[0] if inits else xx.new_zeros((xx.shape[0], H))
            hs = []
            for t in (range(T - 1, -1, -1) if is_reverse else range(T)):
                h = self.unit.step(xx[:, t], h)
                hs.append(h)
            return torch.stack(hs[::-1] if is_reverse else hs, dim=1)

    return layer_op(_DynGRU(), x, prefix=name or "dynamic_gru",
                    extra_args=(h_0,) if h_0 is not None else ())


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
