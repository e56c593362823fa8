"""paddle.static.nn — the op builders over the recorded graph (port of
``paddle_tpu.static.nn``): every builder of ``static/builders.py`` (the
JAX module's and the 1.x RNN / loss builders ``center_loss``,
``inplace_abn``, ``lstm``, ``gru_unit``, ``lstm_unit``, ``dynamic_lstm``,
``dynamic_lstmp`` and ``dynamic_gru``), the stateless functionals
``row_conv``, ``deform_conv2d`` and ``crf_decoding`` (eager is the
implementation; ``crf_decoding`` records when given symbolic Variables),
and ``create_parameter`` (``static.create_parameter``).  The control flow
(``cond``, ``while_loop``, ``case``, ``switch_case``), ``py_func`` and
``sparse_embedding`` raise ``UnimplementedError`` naming ROADMAP queue A's
static graph and the long tail.
"""
from __future__ import annotations

from . import create_parameter, py_func  # noqa: F401
from .builders import (  # noqa: F401
    batch_norm, bilinear_tensor_product, center_loss, conv2d,
    conv2d_transpose, conv3d, conv3d_transpose, data_norm, deformable_conv,
    dynamic_gru, dynamic_lstm, dynamic_lstmp, embedding, fc, group_norm,
    gru_unit, hsigmoid, inplace_abn, instance_norm, layer_norm, lstm,
    lstm_unit, multi_box_head, nce, pool2d, prelu, sequence_conv,
    spectral_norm, unported,
)
from .graph import maybe_record as _maybe_record
from ..nn.functional import (  # noqa: F401  (stateless: eager is it)
    deform_conv2d, row_conv,
)
from ..nn.functional import crf_decoding as _crf_decoding

crf_decoding = _maybe_record(_crf_decoding)

_ITEM8 = "static graph and the long tail"
for _name in ("cond", "while_loop", "case", "switch_case",
              "sparse_embedding"):
    globals()[_name] = unported(f"paddle.static.nn.{_name}", _ITEM8)
del _name

__all__ = sorted(
    ["fc", "embedding", "conv2d", "conv2d_transpose", "conv3d",
     "conv3d_transpose", "pool2d", "batch_norm", "layer_norm",
     "instance_norm", "group_norm", "spectral_norm", "prelu",
     "bilinear_tensor_product", "hsigmoid", "multi_box_head",
     "deformable_conv", "cond", "while_loop", "case", "switch_case",
     "crf_decoding", "row_conv", "deform_conv2d", "py_func",
     "create_parameter", "sparse_embedding", "nce", "center_loss",
     "sequence_conv", "inplace_abn", "lstm", "data_norm", "gru_unit",
     "lstm_unit", "dynamic_lstm", "dynamic_lstmp", "dynamic_gru"])
