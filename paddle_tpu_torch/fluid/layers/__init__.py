"""paddle.fluid.layers — the 1.x functional surface (port of
``paddle_tpu.fluid.layers``).

Three tiers, as in the JAX module:

* the tensor functions under their 1.x names (the port's
  ``paddle_tpu_torch.tensor`` has every name of the JAX package's) and
  1.x calling-convention wrappers (``input`` / ``dim`` / ``keep_dim``
  argument names, ``elementwise_*``'s ``axis`` broadcast, ``act=``) over
  the port's implementations — no second implementation;
* ``nn.functional``'s activations, losses, extension and detection ops
  (``retinanet_detection_output`` is the JAX package's eager host-side
  post-processor) and ``nn``'s
  RNN cells and decoders under the JAX module's names (``RNNCell`` is
  ``RNNCellBase``; ``kldiv_loss``, ``huber_loss``, ``warpctc``, ``rnn``
  and ``birnn`` are thin 1.x wrappers over them);
* the parameter-creating builders of ``static.builders`` (``fc``,
  ``embedding``, ``conv2d``, ``conv2d_transpose``, ``conv3d``,
  ``conv3d_transpose``, ``pool2d``, ``batch_norm``, ``layer_norm``,
  ``instance_norm``, ``group_norm``, ``spectral_norm``, ``prelu``,
  ``bilinear_tensor_product``, ``hsigmoid``, ``multi_box_head``,
  ``deformable_conv``)
  and ``data``, ``assign(output=)``, ``fill_constant`` and
  ``autoincreased_step_counter`` in graph mode;
* the sequence tagging family: ``linear_chain_crf`` / ``crf_decoding``,
  the fourteen dense ``sequence_*`` ops, the 1.x RNN and loss builders
  (``dynamic_gru``, ``dynamic_lstm``, ``dynamic_lstmp``, ``gru_unit``,
  ``lstm_unit``, ``lstm``, ``nce``, ``center_loss``, ``data_norm``,
  ``inplace_abn``, ``sequence_conv``), the 1.x beam-search ops
  (``beam_search`` records only with a static ``batch·beam`` dim,
  ``beam_search_decode`` takes the parents in the scores slot),
  ``filter_by_instag`` (eager only: a data-dependent row count),
  ``similarity_focus``, ``sampled_softmax_with_cross_entropy``, ``hash``
  (JAX's uint64 splitmix mix, bit for bit, on int64 tensors) and
  ``crop_tensor``; the resize names (``image_resize``, ``resize_*``,
  ``image_resize_short``), ``pad2d``, ``grid_sampler`` and
  ``random_crop`` over ``interpolate`` / ``grid_sample`` / ``pad``.  The
  random ops draw from a ``torch.Generator`` seeded with a nonzero
  ``seed``, else from the device's (``framework.random``): they cannot
  reproduce ``jax.random``'s bits;
* every other name of the JAX module resolves to a function (or class)
  that raises ``UnimplementedError`` naming the ROADMAP queue-A item that
  ports it: the control flow (``control_flow.py``), the readers, the LoD
  machinery and the other Program-only names are static graph and the
  long tail — never a bare ``AttributeError``.

Every public function here is graph-capable: called with a symbolic
Variable it records into the current Program (``static.graph
.maybe_record``), with tensors it runs.
"""
from __future__ import annotations

import math as _math
from builtins import range as _range, round as _round

import numpy as np
import torch

from ... import tensor as _t
from ...framework.dtype import convert_dtype as _convert_dtype
from ...framework.errors import UnimplementedError  # noqa: F401
from ...framework.random import generator_for as _generator_for
from ...metric import accuracy, chunk_eval as _chunk_eval  # noqa: F401
from ...metric import mean_iou as _mean_iou
from ...nn.functional import cross_entropy as _cross_entropy
from ...nn.functional.loss import softmax_with_cross_entropy  # noqa: F401
from ...static import create_global_var, create_parameter  # noqa: F401
from ...static.builders import (  # noqa: F401
    _act, batch_norm, bilinear_tensor_product, center_loss, conv2d,
    conv2d_transpose, conv3d, conv3d_transpose, data_norm, dynamic_gru,
    dynamic_lstm, dynamic_lstmp, embedding, fc, group_norm, gru_unit,
    hsigmoid, inplace_abn, instance_norm, layer_norm, lstm, lstm_unit, nce,
    pool2d, prelu, sequence_conv, spectral_norm, unported as _unported,
)
from ...static.graph import (
    Variable as _GraphVar, data as _graph_data, default_main_program as _dmp,
    in_program_guard as _in_program_guard, maybe_record as _maybe_record,
    record_call as _record_call,
)

# -- direct re-exports: same name, compatible signature -----------------
from ...tensor import (  # noqa: F401
    cast, concat, argmin, argmax, argsort, ones, zeros, reverse,
    isfinite, linspace, zeros_like, ones_like, diag, eye, triu,
    gather, gather_nd, scatter, scatter_nd_add, scatter_nd, slice,
    strided_slice, shape, rank, sign, where, unbind, unique,
    shard_index, stack, unstack, flatten, squeeze, unsqueeze, transpose,
    clip, log, pow, abs, exp, sqrt, rsqrt, ceil,
    floor, cos, sin, tanh, round, reciprocal, square, cumsum,
    less_equal, greater_than, greater_equal,
    equal, not_equal, logical_and, logical_or, logical_xor, logical_not,
    is_empty, mean,
)

from ...nn.functional import (  # noqa: F401
    selu, elu, relu6, swish, mish, leaky_relu, maxout, log_loss,
    dice_loss, npair_loss, mse_loss, label_smooth, row_conv, gather_tree,
    sequence_mask, pixel_shuffle, unfold, temporal_shift, sigmoid_focal_loss,
    iou_similarity, ssd_loss, prior_box, bipartite_match, target_assign,
    detection_output, box_coder, box_clip, multiclass_nms, roi_align,
    roi_pool, yolo_box, yolov3_loss, matrix_nms, density_prior_box,
    anchor_generator, generate_proposals, box_decoder_and_assign,
    distribute_fpn_proposals, collect_fpn_proposals, psroi_pool,
    locality_aware_nms, linear_chain_crf, crf_decoding, sequence_pool,
    sequence_softmax, sequence_reverse, sequence_pad, sequence_unpad,
    sequence_first_step, sequence_last_step, sequence_expand,
    sequence_expand_as, sequence_enumerate, sequence_concat, sequence_slice,
    sequence_scatter, sequence_reshape,
)
from ...nn import (  # noqa: F401
    BeamSearchDecoder, Decoder, dynamic_decode, RNNCellBase as RNNCell,
    GRUCell, LSTMCell, clip_by_norm, DecodeHelper, TrainingHelper,
    GreedyEmbeddingHelper, SampleEmbeddingHelper, BasicDecoder,
    RNN as _RNN, BiRNN as _BiRNN,
)
from ...nn.functional import (
    ctc_loss as _ctc_loss, gather_tree as _gather_tree,
    grid_sample as _grid_sample, interpolate as _interpolate,
    kl_div as _kl_div, smooth_l1_loss as _smooth_l1_loss,
)
from ...nn.functional.detection import _nms_keep
from ...nn.functional.extras import _generator as _seeded_generator


# -- 1.x calling-convention wrappers ------------------------------------
def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _t.sum(input, axis=dim, keepdim=keep_dim)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _t.mean(input, axis=dim, keepdim=keep_dim)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _t.max(input, axis=dim, keepdim=keep_dim)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _t.min(input, axis=dim, keepdim=keep_dim)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _t.prod(input, axis=dim, keepdim=keep_dim)


def reduce_all(input, dim=None, keep_dim=False, name=None):
    return _t.all(input, axis=dim, keepdim=keep_dim)


def reduce_any(input, dim=None, keep_dim=False, name=None):
    return _t.any(input, axis=dim, keepdim=keep_dim)


def softmax(input, use_cudnn=False, name=None, axis=-1):
    return torch.softmax(input, dim=axis)


def relu(x, name=None):
    return torch.relu(x)


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    if transpose_x:
        x = x.transpose(-1, -2)
    if transpose_y:
        y = y.transpose(-1, -2)
    out = x @ y
    return out if alpha == 1.0 else out * alpha


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    """1.x mul op: x and y flattened to 2-D around the given split dims,
    then a matmul (ref: operators/mul_op.cc)."""
    xs = x.reshape(int(np.prod(x.shape[:x_num_col_dims])), -1)
    ys = y.reshape(int(np.prod(y.shape[:y_num_col_dims])), -1)
    out = xs @ ys
    return out.reshape(tuple(x.shape[:x_num_col_dims])
                       + tuple(y.shape[y_num_col_dims:]))


def topk(input, k, name=None):
    return _t.topk(input, k)


def one_hot(input, depth, allow_out_of_range=False):
    """float32 one-hot; a trailing size-1 axis of ``input`` is dropped."""
    if input.dim() > 1 and input.shape[-1] == 1:
        input = input.squeeze(-1)
    return torch.nn.functional.one_hot(input.long(), depth).to(
        torch.float32)


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    dt = _convert_dtype(dtype)
    shape = tuple(int(s) for s in shape)
    if _in_program_guard():
        # under program_guard the constant is a named graph Variable,
        # made on the device the program runs on
        from ...static.graph import current_device

        return _record_call(
            lambda: torch.full(shape, value, dtype=dt,
                               device=current_device()),
            prefix="fill_constant")
    return _t.full(shape, value, dtype=dt)


def create_tensor(dtype, name=None, persistable=False):
    return _t.zeros((), dtype=_convert_dtype(dtype))


def sums(input, out=None):
    return _t.add_n(list(input))


def range(start, end, step, dtype, name=None):
    return _t.arange(_scalar(start), _scalar(end), _scalar(step),
                     dtype=_convert_dtype(dtype))


def _scalar(v):
    return v if isinstance(v, (int, float)) else float(np.asarray(
        v.cpu() if isinstance(v, torch.Tensor) else v))


def has_inf(x):
    return torch.isinf(x).any()


def has_nan(x):
    return torch.isnan(x).any()


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    """1.x dropout: ``downgrade_in_infer`` keeps the kept values unscaled
    in training and scales by ``1 - p`` at inference;
    ``upscale_in_train`` scales by ``1 / (1 - p)`` in training.  The mask
    draws from the device generator."""
    p = float(dropout_prob)
    upscale = dropout_implementation != "downgrade_in_infer"
    if is_test:
        return x if upscale else x * (1.0 - p)
    if p == 0.0:
        return x
    gen = None if x.device.type == "meta" else _generator_for(x.device)
    keep = torch.empty_like(x).bernoulli_(1.0 - p, generator=gen)
    out = x * keep
    return out / (1.0 - p) if upscale else out


def split(input, num_or_sections, dim=-1, name=None):
    return _t.split(input, num_or_sections, axis=dim)


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    return _act(_t.reshape(x, shape), act)


def expand(x, expand_times, name=None):
    return _t.tile(x, expand_times)


def expand_as(x, target_tensor, name=None):
    return _t.expand_as(x, target_tensor)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    out = x * scale + bias if bias_after_scale else (x + bias) * scale
    return _act(out, act)


def _bcast(x, y, axis, op):
    """1.x elementwise broadcast: y's dims align to x's from ``axis`` on
    (ref: operators/elementwise/elementwise_op_function.h)."""
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    if axis != -1 and y.dim() < x.dim():
        y = y.reshape(tuple(y.shape) + (1,) * (x.dim() - axis - y.dim()))
    return op(x, y)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _act(_bcast(x, y, axis, torch.add), act)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _act(_bcast(x, y, axis, torch.sub), act)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _act(_bcast(x, y, axis, torch.mul), act)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _act(_bcast(x, y, axis, torch.div), act)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _act(_bcast(x, y, axis, torch.maximum), act)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _act(_bcast(x, y, axis, torch.minimum), act)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _act(_bcast(x, y, axis, torch.pow), act)


def elementwise_mod(x, y, axis=-1, act=None, name=None):
    return _act(_bcast(x, y, axis, torch.remainder), act)


def elementwise_floordiv(x, y, axis=-1, act=None, name=None):
    return _act(_bcast(x, y, axis, torch.floor_divide), act)


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    n = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    return x / torch.clamp(n, min=epsilon)


def cos_sim(X, Y):
    Y = Y.to(X.dtype)
    dot = torch.sum(X * Y, dim=-1)
    n1 = torch.sqrt(torch.sum(X * X, dim=-1))
    n2 = torch.sqrt(torch.sum(Y * Y, dim=-1))
    return (dot / torch.clamp(n1 * n2, min=1e-8))[..., None]


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    """1.x cross_entropy over probabilities (no softmax): the per-row loss
    with a trailing size-1 axis."""
    return _cross_entropy(input, label, soft_label=soft_label,
                          ignore_index=ignore_index, reduction="none",
                          use_softmax=False)[..., None]


def square_error_cost(input, label):
    """``(input - label)²`` elementwise (legacy fluid.layers)."""
    d = input - label
    return d * d


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      name=None, normalize=False):
    lab = label.to(x.dtype)
    out = torch.clamp(x, min=0.0) - x * lab + torch.log1p(
        torch.exp(-torch.abs(x)))
    mask = label != ignore_index
    out = torch.where(mask, out, torch.zeros_like(out))
    if normalize:
        out = out / torch.clamp(mask.sum(), min=1)
    return out


def kldiv_loss(x, target, reduction="mean", name=None):
    return _kl_div(x, target, reduction=reduction)


def huber_loss(input, label, delta):
    return _smooth_l1_loss(input, label, reduction="none", delta=delta)


def warpctc(input, label, blank=0, norm_by_times=False, input_length=None,
            label_length=None):
    """CTC loss over dense time-major logits ``[T, B, C]`` with explicit
    lengths (``nn.functional.ctc_loss``, unreduced)."""
    if input_length is None or label_length is None:
        raise UnimplementedError(
            "warpctc needs input_length / label_length (the dense padding "
            "policy replaces LoD inputs)")
    return _ctc_loss(input, label, input_length, label_length, blank=blank,
                     reduction="none")


def rnn(cell, inputs, initial_states=None, sequence_length=None,
        time_major=False, is_reverse=False, **kwargs):
    """A cell over a sequence (``nn.RNN``)."""
    return _RNN(cell, is_reverse=is_reverse, time_major=time_major)(
        inputs, initial_states, sequence_length)


def birnn(cell_fw, cell_bw, inputs, initial_states=None,
          sequence_length=None, time_major=False, **kwargs):
    return _BiRNN(cell_fw, cell_bw, time_major=time_major)(
        inputs, initial_states, sequence_length)


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    """1.x smooth_l1 op (ref: operators/smooth_l1_loss_op.cc): per-row
    summed smooth-L1 with optional elementwise weights; ``sigma`` scales
    the quadratic window."""
    y = y.to(x.dtype)
    s2 = (1.0 if sigma is None else float(sigma)) ** 2
    d = x - y
    if inside_weight is not None:
        d = d * inside_weight.to(x.dtype)
    ad = torch.abs(d)
    loss = torch.where(ad < 1.0 / s2, 0.5 * s2 * d * d, ad - 0.5 / s2)
    if outside_weight is not None:
        loss = loss * outside_weight.to(x.dtype)
    return loss.reshape(loss.shape[0], -1).sum(-1, keepdim=True)


def mean_iou(input, label, num_classes):
    return _mean_iou(input, label, num_classes)


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None):
    return _chunk_eval(input, label, chunk_scheme, num_chunk_types,
                       excluded_chunk_types, seq_length)


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    from ...metric import Auc

    m = Auc(curve=curve, num_thresholds=num_thresholds)
    m.update(input, label)
    return torch.tensor(m.accumulate(), dtype=torch.float32), None, None


def pad_constant_like(x, y, pad_value=0.0, name=None):
    pads = []
    for xs, ys in zip(reversed(x.shape), reversed(y.shape)):
        pads += [0, int(xs - ys)]
    return torch.nn.functional.pad(y, pads, value=pad_value)


def unique_with_counts(x, dtype="int32"):
    return _t.unique(x, return_inverse=True, return_counts=True)


def ctc_greedy_decoder(input, blank, input_length=None, padding_value=0,
                       name=None):
    """Greedy CTC decoding, dense-padded (ref: ctc_align_op): argmax per
    step, merge repeats, drop blanks.  ``input`` ``[B, T, C]``; returns
    (decoded ``[B, T]`` padded with ``padding_value``, lengths
    ``[B, 1]``); on the host, as the reference's kernel."""
    probs = input.detach().float().cpu().numpy()
    if probs.ndim != 3:
        raise UnimplementedError(
            "dense ctc_greedy_decoder expects [batch, time, classes]")
    B, T, _ = probs.shape
    lens = (np.asarray(input_length.cpu()).reshape(B)
            if input_length is not None else np.full(B, T))
    out = np.full((B, T), padding_value, np.int64)
    out_lens = np.zeros((B, 1), np.int64)
    for b in _range(B):
        path = probs[b, : lens[b]].argmax(-1)
        prev, k = -1, 0
        for t in path:
            if t != prev and t != blank:
                out[b, k] = t
                k += 1
            prev = t
        out_lens[b, 0] = k
    return (torch.from_numpy(out).to(input.device),
            torch.from_numpy(out_lens).to(input.device))


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    """Levenshtein distance per pair (ref: operators/edit_distance_op):
    dense ``[B, T]`` int sequences and lengths, on the host."""
    a = input.cpu().numpy()
    b = label.cpu().numpy()
    if a.ndim == 1:
        a, b = a[None], b[None]
    B = a.shape[0]
    la = (input_length.cpu().numpy().reshape(B)
          if input_length is not None else np.full(B, a.shape[1]))
    lb = (label_length.cpu().numpy().reshape(B)
          if label_length is not None else np.full(B, b.shape[1]))
    ignored = set(ignored_tokens or ())
    out = np.zeros((B, 1), np.float32)
    for i in _range(B):
        s1 = [t for t in a[i, : la[i]] if t not in ignored]
        s2 = [t for t in b[i, : lb[i]] if t not in ignored]
        n = len(s2)
        dp = np.arange(n + 1, dtype=np.int64)
        for r in _range(1, len(s1) + 1):
            prev = dp.copy()
            dp[0] = r
            for c in _range(1, n + 1):
                dp[c] = min(prev[c] + 1, dp[c - 1] + 1,
                            prev[c - 1] + (s1[r - 1] != s2[c - 1]))
        d = float(dp[n])
        out[i, 0] = d / n if (normalized and n) else d
    return (torch.from_numpy(out).to(input.device),
            torch.tensor([B], dtype=torch.int64, device=input.device))


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    """1.x hard_sigmoid keeps its slope / offset knobs."""
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hard_swish(x, threshold=6.0, scale=6.0, offset=3.0, name=None):
    return x * torch.clamp(x + offset, 0.0, threshold) / scale


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    """Bounded relu (ref: activation_op BRelu)."""
    return torch.clamp(x, t_min, t_max)


def soft_relu(x, threshold=40.0, name=None):
    """``log(1 + e^clip(x, ±threshold))`` (ref: activation_op SoftRelu)."""
    return torch.log1p(torch.exp(torch.clamp(x, -threshold, threshold)))


def size(input):
    """Element count as a tensor (ref: size_op)."""
    return _t.numel(input)


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0,
                   name=None):
    return _t.uniform(shape, dtype=dtype, min=min, max=max, seed=seed)


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32",
                    name=None):
    out = _t.randn(list(shape))
    return (out * std + mean).to(_convert_dtype(dtype))


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    """ref: operators/teacher_student_sigmoid_loss_op.cc:107 — the CTR
    distillation loss (label in {-1} ∪ [0, 1] ∪ (1, 2] picks the term)."""
    x = torch.clamp(input.float().reshape(-1), soft_max_lower_bound,
                    soft_max_up_bound)
    z = label.float().reshape(-1)
    log1pex = torch.log1p(torch.exp(-torch.abs(x))) + torch.clamp(x, min=0)
    soft = log1pex - x * z
    stud = (log1pex - x) * (z - 1.0) + log1pex
    loss = torch.where(z < 0.0, log1pex, torch.where(z <= 1.0, soft, stud))
    return loss.reshape(tuple(input.shape[:-1]) + (1,))


def merge_selected_rows(x, name=None):
    """ref: operators/merge_selected_rows_op — the duplicate rows of a
    SelectedRows gradient summed."""
    from ...framework.selected_rows import SelectedRows

    if not isinstance(x, SelectedRows):
        raise UnimplementedError(
            "merge_selected_rows expects a SelectedRows gradient (from "
            "Embedding(sparse=True) in a sparse-aware train step)")
    return x.merged()


def get_tensor_from_selected_rows(x, name=None):
    """ref: operators/get_tensor_from_selected_rows_op — the row values."""
    from ...framework.selected_rows import SelectedRows

    if not isinstance(x, SelectedRows):
        raise UnimplementedError(
            "get_tensor_from_selected_rows expects a SelectedRows gradient")
    return x.values


# --- 1.x learning-rate decay functions (learning_rate_scheduler.py) ---------
# Each returns the matching lr scheduler with the 1.x per-step formula:
# pass it as ``learning_rate`` and step it once per optimizer step.
def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    from ...optimizer import lr as _lr

    return _lr.NoamDecay(d_model, warmup_steps, learning_rate)


def _step_lambda(decay_steps, staircase, fn):
    def lam(step):
        d = step / decay_steps
        if staircase:
            d = _math.floor(d)
        return fn(d)

    return lam


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    from ...optimizer import lr as _lr

    if not staircase:
        return _lr.ExponentialDecay(learning_rate,
                                    gamma=decay_rate ** (1.0 / decay_steps))
    return _lr.LambdaDecay(learning_rate, _step_lambda(
        decay_steps, staircase, lambda d: decay_rate ** d))


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    from ...optimizer import lr as _lr

    if not staircase:
        return _lr.NaturalExpDecay(learning_rate,
                                   gamma=decay_rate / decay_steps)
    return _lr.LambdaDecay(learning_rate, _step_lambda(
        decay_steps, staircase, lambda d: _math.exp(-decay_rate * d)))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    from ...optimizer import lr as _lr

    if not staircase:
        return _lr.InverseTimeDecay(learning_rate,
                                    gamma=decay_rate / decay_steps)
    return _lr.LambdaDecay(learning_rate, _step_lambda(
        decay_steps, staircase, lambda d: 1.0 / (1.0 + decay_rate * d)))


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    from ...optimizer import lr as _lr

    return _lr.PolynomialDecay(learning_rate, decay_steps,
                               end_lr=end_learning_rate, power=power,
                               cycle=cycle)


def piecewise_decay(boundaries, values):
    from ...optimizer import lr as _lr

    return _lr.PiecewiseDecay(boundaries, values)


def cosine_decay(learning_rate, step_each_epoch, epochs):
    """``lr · ½(cos(epoch·π/epochs) + 1)``, epoch = ⌊step /
    step_each_epoch⌋ (learning_rate_scheduler.py:442)."""
    from ...optimizer import lr as _lr

    def lam(step):
        epoch = _math.floor(step / step_each_epoch)
        return 0.5 * (_math.cos(epoch * _math.pi / epochs) + 1.0)

    return _lr.LambdaDecay(learning_rate, lam)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """A linear warm-up from ``start_lr`` to ``end_lr`` over
    ``warmup_steps``, then ``learning_rate`` (a float or a scheduler)."""
    from ...optimizer import lr as _lr

    return _lr.LinearWarmup(learning_rate, warmup_steps, start_lr, end_lr)


# -- resize, crop and grid sampling (over interpolate / grid_sample / pad)
def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    t, b, l, r = [int(p) for p in paddings]
    pad = ([0, 0, 0, 0, t, b, l, r] if data_format == "NCHW"
           else [0, 0, t, b, l, r, 0, 0])
    return _t.pad(input, pad, mode="replicate" if mode == "edge" else mode,
                  value=pad_value)


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR", actual_shape=None, align_corners=True,
                 align_mode=1, data_format="NCHW"):
    mode = {"BILINEAR": "bilinear", "NEAREST": "nearest",
            "TRILINEAR": "trilinear", "LINEAR": "linear",
            "BICUBIC": "bicubic"}[resample]
    return _interpolate(input, size=out_shape, scale_factor=scale,
                        mode=mode, align_corners=align_corners,
                        align_mode=align_mode, data_format=data_format)


def resize_bilinear(input, out_shape=None, scale=None, name=None,
                    actual_shape=None, align_corners=True, align_mode=1,
                    data_format="NCHW"):
    return image_resize(input, out_shape, scale, name, "BILINEAR",
                        actual_shape, align_corners, align_mode, data_format)


def resize_nearest(input, out_shape=None, scale=None, name=None,
                   actual_shape=None, align_corners=True,
                   data_format="NCHW"):
    return image_resize(input, out_shape, scale, name, "NEAREST",
                        actual_shape, align_corners, 1, data_format)


def resize_linear(input, out_shape=None, scale=None, name=None,
                  actual_shape=None, align_corners=True, align_mode=1,
                  data_format="NCW"):
    return _interpolate(input, size=out_shape, scale_factor=scale,
                        mode="linear", align_corners=align_corners,
                        align_mode=align_mode, data_format=data_format)


def resize_trilinear(input, out_shape=None, scale=None, name=None,
                     actual_shape=None, align_corners=True, align_mode=1,
                     data_format="NCDHW"):
    return _interpolate(input, size=out_shape, scale_factor=scale,
                        mode="trilinear", align_corners=align_corners,
                        align_mode=align_mode, data_format=data_format)


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """Resize keeping the aspect ratio so that the SHORT side is
    ``out_short_len``."""
    h, w = input.shape[2], input.shape[3]
    short, long_ = (h, w) if h < w else (w, h)
    ratio = out_short_len / float(short)
    out_shape = ([out_short_len, int(long_ * ratio)] if h < w
                 else [int(long_ * ratio), out_short_len])
    return image_resize(input, out_shape=out_shape, resample=resample)


def grid_sampler(x, grid, name=None):
    return _grid_sample(x, grid)


def crop_tensor(x, shape=None, offsets=None, name=None):
    """Legacy alias of ``crop``."""
    return _t.crop(x, shape=shape, offsets=offsets)


def random_crop(x, shape, seed=None):
    """An independent random crop offset for each leading-dim instance,
    cropping the trailing ``len(shape)`` dims to ``shape``."""
    shape = tuple(int(s) for s in shape)
    k = len(shape)
    single = x.dim() == k
    flat = x.reshape((-1,) + tuple(x.shape[-k:]))
    n, dev = flat.shape[0], flat.device
    gen = _seeded_generator(seed, dev)
    out = flat
    for i in _range(k):
        axis = 1 + i
        hi = int(flat.shape[axis]) - shape[i] + 1
        start = torch.randint(0, hi, (n,), generator=gen, device=dev)
        idx = start[:, None] + torch.arange(shape[i], device=dev)[None]
        view = [n] + [1] * k
        view[axis] = shape[i]
        want = list(out.shape)
        want[axis] = shape[i]
        out = torch.gather(out, axis, idx.reshape(view).expand(want))
    return out[0] if single else out.reshape(tuple(x.shape[:-k]) + shape)


# -- hashing and sampled losses ---------------------------------------------
_U64 = (1 << 64) - 1


def _s64(c):
    """The int64 with the bits of the uint64 ``c``."""
    c &= _U64
    return c - (1 << 64) if c >> 63 else c


def _shr(v, k):
    """Logical right shift of int64 bits."""
    return (v >> k) & ((1 << (64 - k)) - 1)


def _mix(v, seed):
    v = v ^ _s64(seed * 0x9E3779B97F4A7C15)
    v = (v ^ _shr(v, 30)) * _s64(0xBF58476D1CE4E5B9)
    v = (v ^ _shr(v, 27)) * _s64(0x94D049BB133111EB)
    return v ^ _shr(v, 31)


def hash(input, hash_size, num_hash=1, name=None):
    """The JAX package's hash (a splitmix64-style mix in place of the
    reference's XXH64): the last dim's elements folded into one key a row,
    then mixed ``num_hash`` times with different seeds, ``% hash_size``.
    uint64 arithmetic on int64 bits (wrapping products, logical shifts, an
    unsigned remainder): the ids equal JAX's bit for bit, keys above 2^63
    (given as uint64 arrays or as their int64 bits) too."""
    from ...tensor._common import t as _as_tensor

    if isinstance(input, np.ndarray) and input.dtype == np.uint64:
        input = input.view(np.int64)
    x = _as_tensor(input)
    if x.dtype == torch.uint64:
        x = x.view(torch.int64)
    x = x.to(torch.int64)
    key = x.reshape(tuple(x.shape[:-1]) + (-1,))
    row = key[..., 0]
    for j in _range(1, key.shape[-1]):
        row = _mix(row, 1) + key[..., j]
    m = int(hash_size)
    wrap = (1 << 64) % m  # 2^64 mod m: a negative int64 is that much more
    outs = []
    for s in _range(num_hash):
        v = _mix(row, s + 1)
        r = torch.remainder(v, m)
        outs.append(torch.where(v < 0, torch.remainder(r + wrap, m), r))
    return torch.stack(outs, dim=-1)


def sampled_softmax_with_cross_entropy(logits, label, num_samples,
                                       num_true=1, remove_accidental_hits=True,
                                       use_customized_samples=False,
                                       customized_samples=None,
                                       customized_probabilities=None,
                                       seed=0):
    """Softmax cross-entropy over the true classes and ``num_samples``
    uniform negatives (the sampled-softmax estimator); an accidental hit
    of a true class moves to ``(id + 1) % classes``.  ``[B, num_true]``."""
    B, n_cls = logits.shape[0], logits.shape[-1]
    label = label.reshape(B, num_true).to(torch.int64)
    gen = _seeded_generator(seed, logits.device)
    neg = torch.randint(0, n_cls, (B, int(num_samples)), generator=gen,
                        device=logits.device)
    if remove_accidental_hits:
        hit = (neg[..., None] == label[:, None, :]).any(-1)
        neg = torch.where(hit, (neg + 1) % n_cls, neg)
    picked = torch.gather(logits, 1, torch.cat([label, neg], dim=1))
    lse = torch.logsumexp(picked, dim=1, keepdim=True)
    return (lse - picked[:, :num_true]).reshape(B, num_true)


# -- the 1.x beam-search ops -------------------------------------------------
def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None,
                return_parent_idx=False):
    """One pruning step: from each batch's ``beam_size × K`` candidates
    keep the top ``beam_size`` (ties: the lower position first, as
    ``lax.top_k``).  ``ids`` / ``scores`` ``[batch·beam, K]``; returns
    ``(selected_ids, selected_scores[, parent_idx])``, each
    ``[batch·beam, 1]`` (``parent_idx`` ``[batch·beam]``, global across
    the batch).  A finished beam (``pre_ids == end_id``) keeps its score
    and re-emits ``end_id``; ``is_accumulated=False`` takes
    ``log(clip(scores, 1e-20)) + pre_scores``."""
    from ...tensor._common import t as _as_tensor

    ids = _as_tensor(ids)
    scores = _as_tensor(scores, ids)
    pre_ids = _as_tensor(pre_ids, ids).reshape(-1)
    pre_scores = _as_tensor(pre_scores, ids).reshape(-1)
    if ids.dim() != 2 or scores.dim() != 2 or ids.shape != scores.shape:
        raise UnimplementedError(
            "beam_search(dense) expects matching ids/scores "
            "[batch*beam, K]")
    BK, K = scores.shape
    W = int(beam_size)
    if BK % W:
        raise UnimplementedError(
            f"beam_search: leading dim {BK} is not a multiple of "
            f"beam_size {beam_size} — in graph mode declare the "
            f"batch*beam dim statically (not -1)")
    batch = BK // W
    if not is_accumulated:
        scores = torch.log(torch.clamp(scores, min=1e-20)) \
            + pre_scores[:, None]
    finished = (pre_ids == end_id)[:, None]
    first = torch.zeros((BK, K), dtype=torch.bool, device=scores.device)
    first[:, 0] = True
    kept = torch.where(first, pre_scores[:, None].to(scores.dtype),
                       torch.full((), -float("inf"), dtype=scores.dtype,
                                  device=scores.device))
    scores = torch.where(finished, kept, scores)
    ids = torch.where(finished, torch.full_like(ids, end_id), ids)
    flat_s = scores.reshape(batch, W * K)
    order = torch.sort(flat_s, dim=1, descending=True, stable=True)[1]
    top_pos = order[:, :W]
    top_s = torch.gather(flat_s, 1, top_pos)
    sel = torch.gather(ids.reshape(batch, W * K), 1, top_pos)
    parent = (top_pos // K + torch.arange(batch, device=ids.device)[:, None]
              * W).reshape(-1)
    out = (sel.reshape(-1, 1).to(torch.int64), top_s.reshape(-1, 1))
    return out + (parent,) if return_parent_idx else out


def beam_search_decode(ids, scores, beam_size=None, end_id=0, name=None):
    """Back-trace per-step ``[T, batch, beam]`` ids through the parent
    indices passed in the scores slot (ints: float scores carry no
    ancestry in the dense form) with ``gather_tree``; returns
    ``(sequences, scores)``."""
    ids = torch.stack(list(ids)) if isinstance(ids, (list, tuple)) else ids
    scores = (torch.stack(list(scores)) if isinstance(scores, (list, tuple))
              else scores)
    if ids.dim() != 3:
        raise UnimplementedError(
            "beam_search_decode expects dense [T, batch, beam] step ids "
            "(collect them from the decode loop; LoD beams are replaced "
            "by dense padding here)")
    if scores.is_floating_point():
        raise UnimplementedError(
            "beam_search_decode(dense): pass the per-step PARENT indices "
            "(int) in the scores argument, or use "
            "paddle.nn.functional.gather_tree(ids, parents) / "
            "paddle.nn.BeamSearchDecoder which track ancestry explicitly")
    return _gather_tree(ids, scores.to(torch.int64)), scores


def filter_by_instag(ins, ins_tag, filter_tag, is_lod=True,
                     out_val_if_empty=0):
    """Keep the rows of ``ins`` whose tags meet ``filter_tag``
    (``ins_tag`` ``[N]`` or ``[N, K]`` padded with -1): ``(rows, kept
    indices, loss weights)``.  An empty match gives one placeholder row of
    ``out_val_if_empty`` with loss weight 0.  Eager only: the row count is
    data-dependent."""
    if any(isinstance(a, _GraphVar) for a in (ins, ins_tag, filter_tag)):
        raise UnimplementedError(
            "filter_by_instag produces a data-dependent row count and "
            "cannot record into a Program; call it eagerly on host arrays "
            "(e.g. at feed time) and feed the filtered batch")
    from ...tensor._common import t as _as_tensor

    ins = _as_tensor(ins)
    tags = _as_tensor(ins_tag, ins)
    if tags.dim() == 1:
        tags = tags[:, None]
    want = _as_tensor(filter_tag, ins).reshape(-1).to(tags.device)
    keep = (tags[..., None] == want[None, None, :]).any(-1).any(-1)
    idx = torch.nonzero(keep).reshape(-1)
    out = ins[idx]
    if out.shape[0] == 0:
        out = torch.full((1,) + tuple(ins.shape[1:]), out_val_if_empty,
                         dtype=ins.dtype, device=ins.device)
        idx = torch.zeros(1, dtype=torch.int64, device=ins.device)
        weight = torch.zeros((1, 1), dtype=torch.float32, device=ins.device)
    else:
        weight = torch.ones((out.shape[0], 1), dtype=torch.float32,
                            device=ins.device)
    return out, idx.to(torch.int64), weight


def similarity_focus(input, axis, indexes, name=None):
    """For each index slice along ``axis`` (1, 2 or 3 of a 4-D tensor),
    mark ``min(B, C)`` maxima greedily — each round the first maximum of
    the slice's rows and columns not yet used — OR the masks over
    ``indexes`` and broadcast them along ``axis``.  The rounds run on the
    device, every instance and index at once."""
    from ...tensor._common import t as _as_tensor

    input = _as_tensor(input)
    if input.dim() != 4:
        raise UnimplementedError(
            "similarity_focus expects a 4-D tensor (ref op constraint)")
    if axis not in (1, 2, 3):
        raise UnimplementedError("similarity_focus: axis must be 1, 2 or 3")
    if not len(indexes):
        raise UnimplementedError(
            "similarity_focus: indexes must be non-empty")
    A = input.shape[axis]
    for i in indexes:
        if not 0 <= int(i) < A:
            raise UnimplementedError(
                f"similarity_focus: index {i} out of range for axis {axis} "
                f"with size {A}")
    perm = [0, axis] + [d for d in _range(1, 4) if d != axis]
    xt = input.permute(perm)  # [N, A, B, C]
    N, _, Bd, Cd = xt.shape
    sel = xt[:, [int(i) for i in indexes]].to(torch.float32)  # [N, I, B, C]
    dev = input.device
    mask = torch.zeros_like(sel)
    used_r = torch.zeros(sel.shape[:3], dtype=torch.bool, device=dev)
    used_c = torch.zeros(sel.shape[:2] + (Cd,), dtype=torch.bool, device=dev)
    ninf = torch.full((), -float("inf"), device=dev)
    for _ in _range(min(Bd, Cd)):
        blocked = used_r[..., :, None] | used_c[..., None, :]
        f = torch.argmax(torch.where(blocked, ninf, sel).flatten(2), dim=-1)
        r, c = f // Cd, f % Cd
        mask.flatten(2).scatter_(2, f[..., None], 1.0)
        used_r.scatter_(2, r[..., None], True)
        used_c.scatter_(2, c[..., None], True)
    out = mask.amax(dim=1)[:, None].expand(N, A, Bd, Cd)
    return out.permute([perm.index(i) for i in _range(4)]).to(input.dtype)


# -- graph mode ---------------------------------------------------------
def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         type=None, stop_gradient=True):
    """1.x fluid.layers.data (ref: fluid/layers/io.py:54): unlike
    ``fluid.data``, prepends the implicit -1 batch dim unless the shape
    already leads with -1 or ``append_batch_size=False``."""
    shape = list(shape)
    if append_batch_size and (not shape or shape[0] != -1):
        shape = [-1] + shape
    return _graph_data(name, shape, dtype)


def assign(input, output=None):
    """1.x assign with the ``output=`` out-parameter: in graph mode the
    value is written to output's NAME; eagerly ``tensor.assign``."""
    if isinstance(output, _GraphVar):
        return _record_call(lambda v: v.clone(), input,
                            out_names=[output.name], prefix="assign")
    if isinstance(input, _GraphVar):
        return _record_call(lambda v: v.clone(), input, prefix="assign")
    return _t.assign(input) if output is None else _t.assign(input, output)


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """ref: fluid/layers/nn.py autoincreased_step_counter — a persistable
    int64 counter advanced by ``step`` on every executor run: a Program
    buffer updated in place by the recorded op (a test clone's copy
    stays frozen)."""
    if not _in_program_guard():
        raise UnimplementedError(
            "autoincreased_step_counter is Program state: use it under "
            "program_guard / enable_static, or track the step in your "
            "train-loop state eagerly")
    prog = _dmp()
    bname = counter_name or prog.unique_name("step_counter")
    prog.register_buffer(bname, torch.tensor(begin - step,
                                             dtype=torch.int64))

    def fn(pv, bv, *, training=False):
        bv[bname].add_(step)
        return bv[bname].clone(), {bname: bv[bname]}

    return _record_call(fn, buffer_names=(bname,), writes_buffers=True,
                        scoped=True, prefix="step_counter")


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True, data_format="NCDHW"):
    """ref: fluid/layers/nn.py pool3d: global max / mean over the spatial
    axes (kept), else ``max_pool3d`` / ``avg_pool3d``."""
    from ...nn import functional as _F
    from ...tensor._common import t as _as_tensor

    x = _as_tensor(input)
    if global_pooling:
        axes = (2, 3, 4) if data_format == "NCDHW" else (1, 2, 3)
        if pool_type == "max":
            return torch.amax(x, dim=axes, keepdim=True)
        return torch.mean(x, dim=axes, keepdim=True)
    if pool_type == "max":
        return _F.max_pool3d(x, pool_size, stride=pool_stride,
                             padding=pool_padding, ceil_mode=ceil_mode,
                             data_format=data_format)
    return _F.avg_pool3d(x, pool_size, stride=pool_stride,
                         padding=pool_padding, ceil_mode=ceil_mode,
                         exclusive=exclusive, data_format=data_format)


from ...framework.serialization import load  # noqa: E402,F401
from ...static.builders import (  # noqa: E402,F401
    deformable_conv, multi_box_head,
)

# -- every public function is graph-capable: called with symbolic
# Variables it records into the current Program; the builders and the
# graph-mode names handle their own dispatch
import types as _types  # noqa: E402

_NO_WRAP = {"fc", "embedding", "conv2d", "conv2d_transpose", "conv3d",
            "conv3d_transpose", "batch_norm", "layer_norm",
            "pool2d", "instance_norm", "group_norm", "spectral_norm",
            "prelu", "bilinear_tensor_product", "hsigmoid", "multi_box_head",
            "deformable_conv", "assign", "data",
            "load", "fill_constant", "nce", "center_loss", "sequence_conv",
            "inplace_abn", "lstm", "data_norm", "gru_unit", "lstm_unit",
            "dynamic_lstm", "dynamic_lstmp", "dynamic_gru", "beam_search",
            "filter_by_instag",
            "autoincreased_step_counter", "create_parameter",
            "create_global_var", "accuracy"}
for _n, _v in list(globals().items()):
    if (isinstance(_v, _types.FunctionType) and not _n.startswith("_")
            and _n not in _NO_WRAP):
        globals()[_n] = _maybe_record(_v)
del _n, _v


def retinanet_detection_output(bboxes, scores, anchors, im_info,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.3,
                               nms_eta=1.0):
    """ref: fluid/layers/detection.py:3100 retinanet_detection_output —
    per FPN level: threshold (0.0 for the highest level), the nms_top_k
    best (anchor, class) pairs, center-size decode against the level's
    anchors (+1 pixel, / im_scale, clipped to the rounded original image);
    then per-class greedy NMS with eta adaptation over the merged levels,
    keep_top_k overall.

    An eager host-side post-processor, as in the JAX package: a list of
    per-image numpy arrays ``[No_i, 6]`` of ``[label (1-based), score, x1,
    y1, x2, y2]`` (the dense replacement of the LoD output)."""
    def host(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().float().numpy()
        return np.asarray(a, np.float32)

    bboxes = [host(b) for b in bboxes]
    scores = [host(s) for s in scores]
    anchors = [host(a) for a in anchors]
    im_info = host(im_info).reshape(-1, 3)
    N = bboxes[0].shape[0]
    C = scores[0].shape[-1]
    L = len(scores)

    out = []
    for n in _range(N):
        imh, imw, im_scale = im_info[n]
        imh = _round(float(imh) / float(im_scale))
        imw = _round(float(imw) / float(im_scale))
        preds = {c: [] for c in _range(C)}
        for lv in _range(L):
            sc = scores[lv][n].reshape(-1)
            thr = score_threshold if lv < L - 1 else 0.0
            idx = np.nonzero(sc > thr)[0]
            if nms_top_k >= 0 and idx.size > nms_top_k:
                idx = idx[np.argsort(-sc[idx])[:int(nms_top_k)]]
            for i in idx:
                a_i, c_i = divmod(int(i), C)
                anc = anchors[lv][a_i]
                d = bboxes[lv][n, a_i]
                aw = anc[2] - anc[0] + 1
                ah = anc[3] - anc[1] + 1
                cx = d[0] * aw + anc[0] + aw / 2
                cy = d[1] * ah + anc[1] + ah / 2
                w = np.exp(d[2]) * aw
                h = np.exp(d[3]) * ah
                box = np.array([cx - w / 2, cy - h / 2,
                                cx + w / 2 - 1, cy + h / 2 - 1]) / im_scale
                box[0::2] = np.clip(box[0::2], 0, imw - 1)
                box[1::2] = np.clip(box[1::2], 0, imh - 1)
                preds[c_i].append((float(sc[i]), box))
        # per-class greedy NMS (+1-pixel IoU), the classes as the
        # instances of one sweep, padded with -inf scores
        width = max(len(cand) for cand in preds.values())
        sc_c = torch.full((C, width), -_math.inf)
        box_c = torch.zeros((C, width, 4))
        for c_i, cand in preds.items():
            for j, (s_v, b_v) in enumerate(cand):
                sc_c[c_i, j] = s_v
                box_c[c_i, j] = torch.from_numpy(b_v)
        keep = (_nms_keep(box_c, sc_c, -_math.inf, -1, nms_threshold,
                          nms_eta, False) if width else sc_c.isfinite())
        order = torch.sort(sc_c, dim=1, descending=True, stable=True)[1]
        dets = [(c_i, float(sc_c[c_i, j]), preds[c_i][j][1])
                for c_i in _range(C) for j in order[c_i].tolist()
                if bool(keep[c_i, j])]
        dets.sort(key=lambda t_: -t_[1])
        if keep_top_k >= 0:  # -1 = keep all (1.x convention)
            dets = dets[:int(keep_top_k)]
        out.append(np.array([[c_i + 1, s_v, *b_v] for c_i, s_v, b_v in dets],
                            np.float32).reshape(-1, 6))
    return out


def _beam_search_graph_dispatch(fn):
    """``beam_search`` records into a Program only with a static
    ``batch·beam`` leading dim (the pruning factorizes it; the shape probe
    would see 1)."""
    import functools

    @functools.wraps(fn)
    def wrapped(pre_ids, pre_scores, ids, scores, beam_size, end_id, **kw):
        from ...static.graph import in_graph_mode

        if in_graph_mode(pre_ids, pre_scores, ids, scores):
            for v in (ids, scores):
                if isinstance(v, _GraphVar) and v.shape[0] is None:
                    raise UnimplementedError(
                        "beam_search in graph mode needs a STATIC "
                        "batch*beam leading dim (declare it instead of "
                        "-1: the pruning factorizes that dim)")
            return _record_call(fn, pre_ids, pre_scores, ids, scores,
                                beam_size, end_id, **kw)
        return fn(pre_ids, pre_scores, ids, scores, beam_size, end_id, **kw)

    return wrapped


beam_search = _beam_search_graph_dispatch(beam_search)


# -- the rest of the JAX module: not ported yet --------------------------
_ITEM8 = "static graph and the long tail"
UNPORTED = {
    # control flow, readers, LoD and the other Program-only names (item 8)
    n: _ITEM8 for n in (
        "cond", "while_loop", "case", "switch_case", "While", "StaticRNN",
        "increment", "less_than", "array_write", "array_read",
        "array_length", "create_array", "tensor_array_to_tensor", "Assert",
        "Switch", "IfElse", "DynamicRNN", "reorder_lod_tensor_by_rank",
        "lod_reset", "lod_append", "Send", "Recv", "py_reader",
        "create_py_reader_by_data", "read_file", "double_buffer", "Print",
        "py_func", "maxout_legacy", "warpctc_lod")
}
for _n, _item in UNPORTED.items():
    globals()[_n] = _unported(f"fluid.layers.{_n}", _item)
del _n, _item


def __getattr__(name):
    """A 2.0 tensor or functional name used through fluid.layers."""
    from ... import nn as _nn

    for ns in (_t, _nn.functional):
        if hasattr(ns, name):
            return getattr(ns, name)
    raise AttributeError(
        f"module 'paddle_tpu_torch.fluid.layers' has no attribute {name!r}")
