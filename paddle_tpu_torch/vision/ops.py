"""paddle.vision.ops — port of ``paddle_tpu.vision.ops``: the detection
ops and ``deform_conv2d`` of ``nn.functional`` under their 2.0 names, and
the SSD ``MultiBoxHead`` layer (built on first access, as in the JAX
package)."""
from ..nn.functional.deform_conv import deform_conv2d  # noqa: F401
from ..nn.functional.detection import (  # noqa: F401
    box_coder, multiclass_nms, nms, prior_box, roi_align, roi_pool,
    sigmoid_focal_loss, yolo_box,
)

__all__ = ["box_coder", "nms", "multiclass_nms", "prior_box", "roi_align",
           "roi_pool", "sigmoid_focal_loss", "yolo_box", "deform_conv2d",
           "MultiBoxHead"]

_multi_box_head_cls = None


def _listed(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _build_multi_box_head():
    """The MultiBoxHead Layer class, made once."""
    global _multi_box_head_cls
    if _multi_box_head_cls is None:
        import math

        import torch

        from .. import nn
        from ..framework.errors import InvalidArgumentError
        from ..nn import functional as F

        class MultiBoxHead(nn.Layer):
            """SSD multi-box head as an eager Layer: per feature map, a
            location conv and a confidence conv, and prior boxes on the
            same grid; everything concatenated across maps
            (``in_channels`` declares each map's channels).

            Call with (inputs: list of ``[N, Ci, Hi, Wi]``, image) →
            (mbox_locs ``[N, total, 4]``, mbox_confs ``[N, total,
            classes]``, boxes ``[total, 4]``, variances ``[total, 4]``)."""

            def __init__(self, in_channels, base_size, num_classes,
                         aspect_ratios, min_ratio=None, max_ratio=None,
                         min_sizes=None, max_sizes=None, steps=None,
                         step_w=None, step_h=None, offset=0.5,
                         variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                         clip=False, kernel_size=1, pad=0, stride=1,
                         min_max_aspect_ratios_order=False):
                super().__init__()
                num_layer = len(in_channels)
                if num_layer <= 2:
                    if min_sizes is None or max_sizes is None:
                        raise InvalidArgumentError(
                            "<=2 inputs need explicit min_sizes/max_sizes")
                elif min_sizes is None and max_sizes is None:
                    min_sizes, max_sizes = [], []
                    step = int(math.floor((max_ratio - min_ratio)
                                          / (num_layer - 2)))
                    for ratio in range(min_ratio, max_ratio + 1, step):
                        min_sizes.append(base_size * ratio / 100.0)
                        max_sizes.append(base_size * (ratio + step) / 100.0)
                    min_sizes = [base_size * 0.10] + min_sizes
                    max_sizes = [base_size * 0.20] + max_sizes
                if len(aspect_ratios) != num_layer:
                    raise InvalidArgumentError(
                        "aspect_ratios must match the number of inputs")
                if steps is not None:
                    step_w = step_h = steps
                for nm, val in (("steps", steps), ("step_w", step_w),
                                ("step_h", step_h)):
                    if val is not None and (
                            not isinstance(val, (list, tuple))
                            or len(val) != num_layer):
                        raise InvalidArgumentError(
                            f"{nm} must be a list/tuple with one entry per "
                            f"input ({num_layer}), got {val!r}")
                self._cfg = dict(
                    min_sizes=min_sizes, max_sizes=max_sizes,
                    aspect_ratios=aspect_ratios, variance=tuple(variance),
                    flip=flip, clip=clip, offset=offset,
                    step_w=step_w, step_h=step_h,
                    mmaro=min_max_aspect_ratios_order)
                self.num_classes = int(num_classes)
                self.loc_convs = nn.LayerList()
                self.conf_convs = nn.LayerList()
                for i, cin in enumerate(in_channels):
                    npb = self._num_priors(i)
                    self.loc_convs.append(nn.Conv2D(
                        cin, npb * 4, kernel_size, stride=stride,
                        padding=pad))
                    self.conf_convs.append(nn.Conv2D(
                        cin, npb * self.num_classes, kernel_size,
                        stride=stride, padding=pad))

            def _num_priors(self, i):
                # prior_box's aspect-ratio dedup: [1] + new ratios (+ their
                # flips); K = len(min)·len(ars) + min(len(min), len(max))
                cfg = self._cfg
                ms = _listed(cfg["min_sizes"][i])
                mx = _listed(cfg["max_sizes"][i])
                ars = [1.0]
                for a in _listed(cfg["aspect_ratios"][i]):
                    a = float(a)
                    if not any(abs(a - e) < 1e-6 for e in ars):
                        ars.append(a)
                        if cfg["flip"]:
                            ars.append(1.0 / a)
                return len(ms) * len(ars) + min(len(ms), len(mx))

            def forward(self, inputs, image):
                cfg = self._cfg
                locs, confs, boxes, vars_ = [], [], [], []
                for i, feat in enumerate(inputs):
                    step = (cfg["step_w"][i] if cfg["step_w"] else 0.0,
                            cfg["step_h"][i] if cfg["step_h"] else 0.0)
                    box, var = F.prior_box(
                        feat, image, _listed(cfg["min_sizes"][i]),
                        _listed(cfg["max_sizes"][i]),
                        _listed(cfg["aspect_ratios"][i]), cfg["variance"],
                        cfg["flip"], cfg["clip"], step, cfg["offset"],
                        min_max_aspect_ratios_order=cfg["mmaro"])
                    boxes.append(box.reshape(-1, 4))
                    vars_.append(var.reshape(-1, 4))
                    loc = self.loc_convs[i](feat)
                    N = loc.shape[0]
                    locs.append(loc.permute(0, 2, 3, 1).reshape(N, -1, 4))
                    conf = self.conf_convs[i](feat).permute(0, 2, 3, 1)
                    confs.append(conf.reshape(N, -1, self.num_classes))
                return (torch.cat(locs, 1), torch.cat(confs, 1),
                        torch.cat(boxes, 0), torch.cat(vars_, 0))

        MultiBoxHead.__module__ = __name__
        MultiBoxHead.__qualname__ = "MultiBoxHead"
        _multi_box_head_cls = MultiBoxHead
    return _multi_box_head_cls


def __getattr__(name):
    if name == "MultiBoxHead":
        return _build_multi_box_head()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
