"""paddle.static.nn — the op builders over the recorded graph (port of
``paddle_tpu.static.nn``): ``fc``, ``embedding``, ``conv2d``,
``conv2d_transpose``, ``conv3d``, ``conv3d_transpose``, ``pool2d``,
``batch_norm``, ``layer_norm``, ``instance_norm``, ``group_norm``,
``spectral_norm``, ``prelu``, ``bilinear_tensor_product``, ``hsigmoid``,
``multi_box_head`` and ``deformable_conv`` are ported
(``static/builders.py``), ``row_conv`` and ``deform_conv2d`` are the
functional ops;
``create_parameter`` is ``static.create_parameter``.  Every other name of
the JAX module raises ``UnimplementedError`` naming the ROADMAP queue-A
item that ports it: the control flow (``cond``, ``while_loop``, ``case``,
``switch_case``), ``py_func`` and the eager-only functionals are static
graph and the long tail; the builders over layers still to port name
their items (``builders.UNPORTED``).
"""
from __future__ import annotations

from . import create_parameter, py_func  # noqa: F401
from .builders import (  # noqa: F401
    UNPORTED, batch_norm, bilinear_tensor_product, conv2d, conv2d_transpose,
    conv3d, conv3d_transpose, deformable_conv, embedding, fc, group_norm,
    hsigmoid, instance_norm, layer_norm, multi_box_head, pool2d, prelu,
    spectral_norm, unported,
)
from ..nn.functional import (  # noqa: F401  (stateless: eager is it)
    deform_conv2d, row_conv,
)

_ITEM8 = "static graph and the long tail"
for _name in ("cond", "while_loop", "case", "switch_case", "crf_decoding",
              "sparse_embedding"):
    globals()[_name] = unported(f"paddle.static.nn.{_name}", _ITEM8)
for _name in UNPORTED:
    globals()[_name] = unported(f"paddle.static.nn.{_name}", UNPORTED[_name])
del _name

__all__ = sorted(
    ["fc", "embedding", "conv2d", "conv2d_transpose", "conv3d",
     "conv3d_transpose", "pool2d", "batch_norm", "layer_norm",
     "instance_norm", "group_norm", "spectral_norm", "prelu",
     "bilinear_tensor_product", "hsigmoid", "multi_box_head",
     "deformable_conv", "cond", "while_loop", "case", "switch_case",
     "crf_decoding", "row_conv", "deform_conv2d", "py_func", "create_parameter",
     "sparse_embedding"] + list(UNPORTED))
