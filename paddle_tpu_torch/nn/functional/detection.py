"""Detection ops — port of ``paddle_tpu.nn.functional.detection``: IoU,
box coding, SSD matching and loss, the NMS family, anchors and priors,
RPN proposals and FPN routing, the RoI ops and the YOLOv3 head.

Everything is dense and batch-first, as in the JAX package: ground truth
comes padded ``[N, G, 4]`` (zero boxes are inert), outputs have fixed
capacities padded with -1 labels / scores or zero boxes, and ``rois_num``
stands in for the RoI LoD.  Where JAX vmaps over images or classes, the
batch dimension is written out.

Three things differ in mechanism, not in result:

* JAX's ``lax.top_k`` puts equal values (the -inf padding too) in
  ascending index order, and ``jnp.argsort`` / ``jnp.argmax`` are stable /
  first-maximum; here every top-k is a stable descending ``torch.sort``
  (:func:`_top_k`), sorts are ``stable=True`` and ``torch.argmax`` takes
  the first maximum.
* NMS's keep loop (a ``lax.fori_loop``) is ``ops.nms_sweep``: the CUDA
  sweep kernel on the card, the loop itself on the CPU.  One launch
  decides every instance of a call (all images, or all (image, class)
  pairs).
* The RoI ops do not gather ``[C, PH, PW, g, g]`` for all RoIs at once:
  each output bin is a weighted sum of at most a few rows of the NHWC map
  (``[N·H·W, C]``), gathered for a chunk of RoIs at a time
  (:func:`_chunks`), so a 1024-RoI head at C = 1024 stays within a few
  hundred MB; the gradient of the gather is the scatter-add autograd gives
  it.  Reductions that JAX differentiates use ``amax`` / ``amin``, which
  split a tie's gradient evenly as JAX does.
"""
from __future__ import annotations

import math as _math
import warnings

import torch

from ...framework.errors import InvalidArgumentError
from ...ops.nms_sweep import nms_sweep
from ...tensor._common import device_of, t as _t

__all__ = [
    "iou_similarity", "box_coder", "bipartite_match", "target_assign",
    "mine_hard_examples", "ssd_loss", "prior_box", "nms",
    "multiclass_nms", "detection_output", "box_clip", "roi_align",
    "roi_pool", "sigmoid_focal_loss", "yolo_box", "yolov3_loss",
    "matrix_nms", "density_prior_box", "anchor_generator",
    "generate_proposals", "box_decoder_and_assign",
    "distribute_fpn_proposals", "collect_fpn_proposals", "psroi_pool",
    "locality_aware_nms",
]

#: exp() clamp in proposal decoding (bbox_util.h kBBoxClipDefault)
_BBOX_CLIP = _math.log(1000.0 / 16.0)
_EPS = 1e-6
_INF = float("inf")
#: elements a RoI op gathers at once (chunks of RoIs): 2**27 — 256 MB bf16
_GATHER_ELEMENTS = 1 << 27


def _dev(x):
    return x.device if isinstance(x, torch.Tensor) else device_of()


def _div(x, n):
    """``x / n`` as a true division: torch's CUDA division by a Python
    number multiplies by its reciprocal, which can land an exact integer
    quotient an ulp off (and flip a floor or a ceil); a 0-d tensor
    divisor divides as the CPU and XLA do."""
    return x / torch.tensor(n, dtype=x.dtype, device=x.device)


def _top_k(x, k):
    """``lax.top_k`` over the last axis: the k largest, equal values in
    ascending index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take_rows(x, idx):
    """``x [B, M, D]`` gathered at ``idx [B, k]`` → ``[B, k, D]``."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _chunks(R, per_roi):
    """RoI ranges ``[r0, r1)`` gathering at most ``_GATHER_ELEMENTS``."""
    step = max(1, _GATHER_ELEMENTS // max(int(per_roi), 1))
    return [(r0, min(r0 + step, R)) for r0 in range(0, R, step)]


def iou_similarity(x, y, box_normalized=True, name=None):
    """Pairwise IoU between box sets (+1 edge length in pixel coordinates,
    ``box_normalized=False``).  x ``[..., M, 4]``, y ``[..., P, 4]`` →
    ``[..., M, P]``."""
    x = _t(x)
    y = _t(y, x).to(x.dtype)
    off = 0.0 if box_normalized else 1.0
    ax = x[..., :, None, :]
    ay = y[..., None, :, :]
    iw = torch.clamp_min(torch.minimum(ax[..., 2], ay[..., 2])
                         - torch.maximum(ax[..., 0], ay[..., 0]) + off, 0.0)
    ih = torch.clamp_min(torch.minimum(ax[..., 3], ay[..., 3])
                         - torch.maximum(ax[..., 1], ay[..., 1]) + off, 0.0)
    inter = iw * ih

    def area(b):
        return (b[..., 2] - b[..., 0] + off) * (b[..., 3] - b[..., 1] + off)

    union = area(ax) + area(ay) - inter
    return torch.where(union > 0, inter / torch.clamp_min(union, _EPS),
                       torch.zeros((), dtype=inter.dtype, device=x.device))


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              name=None, axis=0):
    """Encode / decode boxes against priors.  encode: target ``[M, 4]`` x
    prior ``[P, 4]`` → ``[M, P, 4]`` center-size offsets divided by
    ``prior_box_var``; decode: target ``[M, P, 4]`` → corner boxes (the
    prior index is the column when ``axis=0``, the row when ``axis=1``)."""
    tb = _t(target_box)
    pb = _t(prior_box, tb)
    tb = tb.to(pb.dtype) if tb.is_floating_point() else tb
    off = 0.0 if box_normalized else 1.0
    pbw = pb[..., 2] - pb[..., 0] + off
    pbh = pb[..., 3] - pb[..., 1] + off
    pbx = pb[..., 0] + pbw * 0.5
    pby = pb[..., 1] + pbh * 0.5
    if prior_box_var is None:
        var = torch.ones((4,), dtype=pb.dtype, device=pb.device)
    else:
        var = _t(prior_box_var, pb).to(pb.dtype)
    if var.dim() not in (1, 2) or var.shape[-1] != 4:
        raise InvalidArgumentError(
            f"prior_box_var must be a 4-vector or [P, 4], got "
            f"{tuple(var.shape)}")
    if axis not in (0, 1):
        raise InvalidArgumentError(f"axis must be 0 or 1, got {axis}")

    if code_type == "encode_center_size":
        tbw = tb[..., 2] - tb[..., 0] + off
        tbh = tb[..., 3] - tb[..., 1] + off
        tbx = tb[..., 0] + tbw * 0.5
        tby = tb[..., 1] + tbh * 0.5
        ex = (tbx[..., :, None] - pbx) / pbw
        ey = (tby[..., :, None] - pby) / pbh
        ew = torch.log(torch.clamp_min(tbw[..., :, None] / pbw, _EPS))
        eh = torch.log(torch.clamp_min(tbh[..., :, None] / pbh, _EPS))
        out = torch.stack([ex, ey, ew, eh], dim=-1)
        if var.dim() == 2:
            return out / var
        return out / var.reshape((1,) * (out.dim() - 1) + (4,))
    if code_type == "decode_center_size":
        rows = axis == 1 and tb.dim() >= 3

        def expand(a):
            return a[..., :, None] if rows else a

        v = var[:, None, :] if (var.dim() == 2 and rows) else var
        tt = tb * v
        cx = tt[..., 0] * expand(pbw) + expand(pbx)
        cy = tt[..., 1] * expand(pbh) + expand(pby)
        w = torch.exp(tt[..., 2]) * expand(pbw)
        h = torch.exp(tt[..., 3]) * expand(pbh)
        return torch.stack([cx - w * 0.5, cy - h * 0.5,
                            cx + w * 0.5 - off, cy + h * 0.5 - off], dim=-1)
    raise InvalidArgumentError(
        f"code_type must be encode/decode_center_size, got {code_type!r}")


def bipartite_match(dist_matrix, match_type="bipartite",
                    dist_threshold=None, name=None):
    """Greedy bipartite (+ optional per-prediction argmax) matching.
    dist ``[G, P]`` or ``[N, G, P]`` → (match_indices ``[N, P]`` int32 gt
    row or -1, match_dist ``[N, P]``).  G rounds of a masked global
    argmax (the first maximum in row-major order); pairs below eps never
    match."""
    dist = _t(dist_matrix)
    if dist.dim() == 2:
        dist = dist[None]
    N, G, P = dist.shape
    dev = dist.device
    col_match = torch.full((N, P), -1, dtype=torch.int64, device=dev)
    col_dist = torch.zeros((N, P), dtype=dist.dtype, device=dev)
    row_used = torch.zeros((N, G), dtype=torch.bool, device=dev)
    ar = torch.arange(N, device=dev)
    neg_inf = torch.full((), -_INF, dtype=dist.dtype, device=dev)
    for _ in range(G):
        masked = torch.where(row_used[:, :, None]
                             | (col_match != -1)[:, None, :], neg_inf, dist)
        flat = masked.reshape(N, -1)
        at = torch.argmax(flat, dim=1)
        best = flat.gather(1, at[:, None])[:, 0]
        i, j = at // P, at % P
        ok = best >= _EPS
        col_match = col_match.index_put(
            (ar, j), torch.where(ok, i, col_match[ar, j]))
        col_dist = col_dist.index_put(
            (ar, j), torch.where(ok, best, col_dist[ar, j]))
        row_used = row_used.index_put((ar, i), row_used[ar, i] | ok)
    if match_type == "per_prediction":
        thr = 0.5 if dist_threshold is None else max(float(dist_threshold),
                                                     _EPS)
        best_row = torch.argmax(dist, dim=1)
        best_dist = torch.amax(dist, dim=1)
        backfill = (col_match == -1) & (best_dist >= thr)
        col_match = torch.where(backfill, best_row, col_match)
        col_dist = torch.where(backfill, best_dist, col_dist)
    return col_match.to(torch.int32), col_dist


def target_assign(x, match_indices, negative_mask=None, mismatch_value=0,
                  name=None):
    """Gather per-prior targets by match index.  x ``[N, G, K]`` (per-gt
    targets) or ``[N, G, P, K]`` (per-(gt, prior) targets), match_indices
    ``[N, P]`` → (out ``[N, P, K]``, weight ``[N, P, 1]``); the dense
    ``negative_mask [N, P]`` raises the weight of mined negatives to 1."""
    x = _t(x)
    mi = _t(match_indices, x).long()
    matched = mi != -1
    safe = torch.clamp_min(mi, 0)
    N, P = mi.shape
    if x.dim() == 3:
        out = _take_rows(x, safe)
    elif x.dim() == 4:
        out = x[torch.arange(N, device=x.device)[:, None], safe,
                torch.arange(P, device=x.device)[None, :], :]
    else:
        raise InvalidArgumentError(
            f"target_assign expects rank-3/4 x, got shape {tuple(x.shape)}")
    out = torch.where(matched[:, :, None], out,
                      torch.full((), mismatch_value, dtype=out.dtype,
                                 device=x.device))
    weight = matched.to(x.dtype if x.is_floating_point() else torch.float32)
    if negative_mask is not None:
        weight = torch.maximum(weight,
                               _t(negative_mask, x).to(weight.dtype))
    return out, weight[:, :, None]


def mine_hard_examples(cls_loss, match_indices, match_dist,
                       neg_pos_ratio=3.0, neg_dist_threshold=0.5,
                       mining_type="max_negative", sample_size=None,
                       loc_loss=None):
    """Hard-negative mining (max_negative): among unmatched priors whose
    overlap is below ``neg_dist_threshold``, the ``min(num_pos · ratio,
    #candidates)`` with the highest classification loss become negatives
    (ties in index order).  → (neg_mask ``[N, P]`` bool, match_indices)."""
    if mining_type != "max_negative":
        raise InvalidArgumentError(
            "Only mining_type='max_negative' is supported (the reference "
            "op registers hard_example but ssd_loss rejects it too, "
            "detection.py:1644)")
    loss = _t(cls_loss)
    mi = _t(match_indices, loss)
    dist = _t(match_dist, loss)
    eligible = (mi == -1) & (dist < neg_dist_threshold)
    num_pos = (mi != -1).sum(1)
    quota = torch.minimum((num_pos.double() * neg_pos_ratio).long(),
                          eligible.sum(1))
    masked = torch.where(eligible, loss, torch.full_like(loss, -_INF))
    order = torch.argsort(-masked, dim=1, stable=True)
    P = loss.shape[1]
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(P, device=loss.device).expand_as(order))
    neg_mask = eligible & (ranks < quota[:, None])
    return neg_mask, mi


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True, sample_size=None):
    """SSD multibox loss: match, mining-pass confidence loss, hard-negative
    mining, target assignment, weighted SmoothL1 + softmax-CE.  location
    ``[N, P, 4]``, confidence ``[N, P, C]``, gt_box ``[N, G, 4]``, gt_label
    ``[N, G]`` or ``[N, G, 1]``, prior_box ``[P, 4]`` → ``[N, 1]``.  The
    targets carry no gradient (JAX's stop_gradient)."""
    from .loss import softmax_with_cross_entropy

    location = _t(location)
    confidence = _t(confidence, location)
    gt_box = _t(gt_box, location)
    gt_label = _t(gt_label, location)
    if gt_label.dim() == 3:
        gt_label = gt_label[..., 0]
    N, P, C = confidence.shape
    labels = gt_label[:, :, None].long()

    with torch.no_grad():
        iou = iou_similarity(gt_box, _t(prior_box, location))  # [N, G, P]
        matched_indices, matched_dist = bipartite_match(
            iou, match_type, overlap_threshold)
        target_label, _ = target_assign(labels, matched_indices,
                                        mismatch_value=background_label)
        conf_loss = softmax_with_cross_entropy(
            confidence.reshape(N * P, C),
            target_label.reshape(N * P, 1)).reshape(N, P)
        neg_mask, updated = mine_hard_examples(
            conf_loss, matched_indices, matched_dist,
            neg_pos_ratio=neg_pos_ratio, neg_dist_threshold=neg_overlap,
            mining_type=mining_type, sample_size=sample_size)
        encoded = box_coder(prior_box, prior_box_var, gt_box,
                            code_type="encode_center_size")  # [N, G, P, 4]
        target_bbox, target_loc_weight = target_assign(
            encoded, updated, mismatch_value=background_label)
        target_label, target_conf_weight = target_assign(
            labels, updated, negative_mask=neg_mask,
            mismatch_value=background_label)

    conf = softmax_with_cross_entropy(
        confidence.reshape(N * P, C), target_label.reshape(N * P, 1))
    conf = conf.reshape(N, P) * target_conf_weight[..., 0]
    ad = torch.abs(location - target_bbox)
    loc = torch.where(ad < 1.0, 0.5 * ad * ad, ad - 0.5).sum(-1)
    loc = loc * target_loc_weight[..., 0]
    loss = (conf_loss_weight * conf + loc_loss_weight * loc).sum(
        1, keepdim=True)
    if normalize:
        loss = loss / torch.clamp_min(target_loc_weight.sum(), _EPS)
    return loss


def _nms_keep(boxes, scores, score_threshold, nms_top_k, nms_threshold,
              nms_eta, normalized):
    """Greedy NMS of a batch of instances: boxes ``[B, M, 4]``, scores
    ``[B, M]`` → keep ``[B, M]`` bool.  Candidates above the threshold are
    sorted (the top ``nms_top_k``), their IoU matrix built, and the keep
    decisions made by ``ops.nms_sweep`` (one launch for the batch)."""
    B, M = scores.shape
    k = M if nms_top_k is None or nms_top_k < 0 else min(int(nms_top_k), M)
    with torch.no_grad():
        s = torch.where(scores > score_threshold, scores,
                        torch.full((), -_INF, dtype=scores.dtype,
                                   device=scores.device))
        top_s, order = _top_k(s, k)
        sb = _take_rows(boxes, order)
        iou = iou_similarity(sb, sb, normalized)
        keep_sorted = nms_sweep(iou.float(), top_s.float(), nms_threshold,
                                nms_eta)
        del iou
        return torch.zeros((B, M), dtype=torch.bool,
                           device=scores.device).scatter(1, order,
                                                         keep_sorted)


def nms(boxes, scores, score_threshold=-_INF, nms_top_k=-1,
        nms_threshold=0.3, nms_eta=1.0, normalized=True):
    """Single-class greedy NMS → keep mask ``[M]`` bool, with the
    adaptive-eta threshold decay after each kept box."""
    boxes = _t(boxes)
    scores = _t(scores, boxes)
    return _nms_keep(boxes[None], scores[None], score_threshold, nms_top_k,
                     nms_threshold, nms_eta, normalized)[0]


def _fg_classes(scores, background_label):
    """Drop the background class: (scores ``[N, Cf, M]``, labels ``[Cf]``)."""
    C = scores.shape[1]
    if 0 <= background_label < C:
        fg = [c for c in range(C) if c != background_label]
        labels = torch.tensor(fg, dtype=torch.int64, device=scores.device)
        return scores[:, labels, :], labels
    return scores, torch.arange(C, device=scores.device)


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                   nms_threshold=0.3, normalized=True, nms_eta=1.0,
                   background_label=0, name=None, return_num=False):
    """Multi-class NMS.  bboxes ``[N, M, 4]``, scores ``[N, C, M]`` →
    ``[N, K, 6]`` rows of (label, score, xmin, ymin, xmax, ymax) sorted by
    score, padded with -1, ``K = keep_top_k`` (or C·M when -1); with
    ``return_num`` also the kept counts ``[N]``.  Every (image, class)
    pair is one instance of one sweep launch."""
    bboxes = _t(bboxes)
    scores = _t(scores, bboxes)
    N, M = bboxes.shape[0], bboxes.shape[1]
    scores, fg_labels = _fg_classes(scores, background_label)
    Cf = scores.shape[1]
    K = Cf * M if keep_top_k is None or keep_top_k < 0 else min(
        int(keep_top_k), Cf * M)
    keep = _nms_keep(
        bboxes[:, None].expand(N, Cf, M, 4).reshape(N * Cf, M, 4),
        scores.reshape(N * Cf, M), score_threshold, nms_top_k,
        nms_threshold, nms_eta, normalized).reshape(N, Cf * M)
    flat = torch.where(keep, scores.reshape(N, Cf * M),
                       torch.full((), -_INF, dtype=scores.dtype,
                                  device=scores.device))
    top_s, top_i = _top_k(flat, K)
    label = fg_labels[top_i // M].to(bboxes.dtype)
    box = _take_rows(bboxes, top_i % M)
    valid = torch.isfinite(top_s)
    row = torch.cat([label[..., None], top_s[..., None].to(bboxes.dtype),
                     box], dim=-1)
    row = torch.where(valid[..., None], row,
                      torch.full((), -1.0, dtype=row.dtype,
                                 device=row.device))
    nums = valid.sum(1).to(torch.int32)
    return (row, nums) if return_num else row


def anchor_generator(input, anchor_sizes, aspect_ratios,
                     variances=(0.1, 0.1, 0.2, 0.2), stride=(16.0, 16.0),
                     offset=0.5, name=None):
    """Faster-RCNN anchor grid: per cell, one pixel-coordinate anchor per
    (aspect_ratio, anchor_size), with the base extents rounded half away
    from zero (C++ ``round``).  → (anchors ``[H, W, K, 4]``, variances)."""
    H, W = input.shape[2], input.shape[3]
    dev = _dev(input)
    sw, sh = float(stride[0]), float(stride[1])

    def round_half_up(v):
        return _math.floor(v + 0.5)

    whs = []
    for ar in aspect_ratios:
        base_w = round_half_up(_math.sqrt(sw * sh / ar))
        base_h = round_half_up(base_w * ar)
        for size in anchor_sizes:
            whs.append((size / sw * base_w, size / sh * base_h))
    wh = torch.tensor(whs, dtype=torch.float32, device=dev)
    K = wh.shape[0]
    cx = torch.arange(W, dtype=torch.float32, device=dev) * sw \
        + offset * (sw - 1)
    cy = torch.arange(H, dtype=torch.float32, device=dev) * sh \
        + offset * (sh - 1)
    cxg = cx[None, :, None].expand(H, W, K)
    cyg = cy[:, None, None].expand(H, W, K)
    anchors = torch.stack([
        cxg - 0.5 * (wh[:, 0] - 1), cyg - 0.5 * (wh[:, 1] - 1),
        cxg + 0.5 * (wh[:, 0] - 1), cyg + 0.5 * (wh[:, 1] - 1)], dim=-1)
    var = torch.tensor(variances, dtype=torch.float32,
                       device=dev).expand(anchors.shape)
    return anchors, var


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0, name=None,
                       return_rois_num=False):
    """RPN proposals: per image, the pre_nms_top_n best anchors, decoded
    (+1-pixel center-size, exp clamped at log(1000/16), variance-scaled),
    clipped to the image, filtered by min_size at the original scale,
    greedy-NMSed, the post_nms_top_n best kept.  scores ``[N, A, H, W]``,
    bbox_deltas ``[N, 4A, H, W]``, im_info ``[N, 3]``, anchors / variances
    ``[H, W, A, 4]`` → (rois ``[N, K, 4]``, roi_probs ``[N, K, 1]``)
    padded with zero boxes / -1; ``return_rois_num`` adds the counts."""
    scores = _t(scores)
    deltas = _t(bbox_deltas, scores).to(scores.dtype)
    im_info = _t(im_info, scores).to(scores.dtype)
    anchors = _t(anchors, scores).to(scores.dtype).reshape(-1, 4)
    variances = _t(variances, scores).to(scores.dtype).reshape(-1, 4)
    N, A, H, W = scores.shape
    M = A * H * W
    s_flat = scores.permute(0, 2, 3, 1).reshape(N, M)
    d_flat = deltas.permute(0, 2, 3, 1).reshape(N, M, 4)
    k = M if pre_nms_top_n <= 0 else min(int(pre_nms_top_n), M)
    K = min(int(post_nms_top_n), k) if post_nms_top_n > 0 else k

    top_s, idx = _top_k(s_flat, k)
    anc = anchors[idx]
    var = variances[idx]
    dd = _take_rows(d_flat, idx)
    aw = anc[..., 2] - anc[..., 0] + 1.0
    ah = anc[..., 3] - anc[..., 1] + 1.0
    acx = anc[..., 0] + 0.5 * aw
    acy = anc[..., 1] + 0.5 * ah
    cx = var[..., 0] * dd[..., 0] * aw + acx
    cy = var[..., 1] * dd[..., 1] * ah + acy
    bw = torch.exp(torch.clamp_max(var[..., 2] * dd[..., 2], _BBOX_CLIP)) * aw
    bh = torch.exp(torch.clamp_max(var[..., 3] * dd[..., 3], _BBOX_CLIP)) * ah
    imh, imw, imscale = im_info[:, 0:1], im_info[:, 1:2], im_info[:, 2:3]

    def clip(v, hi):
        return torch.minimum(torch.clamp_min(v, 0), hi)

    x0 = clip(cx - 0.5 * bw, imw - 1)
    y0 = clip(cy - 0.5 * bh, imh - 1)
    x1 = clip(cx + 0.5 * bw - 1, imw - 1)
    y1 = clip(cy + 0.5 * bh - 1, imh - 1)
    props = torch.stack([x0, y0, x1, y1], dim=-1)
    ms = max(min_size, 1.0)
    ws = (x1 - x0) / imscale + 1.0
    hs = (y1 - y0) / imscale + 1.0
    ctr_x = x0 + (x1 - x0 + 1) / 2
    ctr_y = y0 + (y1 - y0 + 1) / 2
    ok = (ws >= ms) & (hs >= ms) & (ctr_x <= imw) & (ctr_y <= imh)
    neg_inf = torch.full((), -_INF, dtype=top_s.dtype, device=top_s.device)
    s_kept = torch.where(ok, top_s, neg_inf)
    keep = _nms_keep(props, s_kept, -_INF, -1, nms_thresh, eta, False)
    final_s = torch.where(keep & torch.isfinite(s_kept), s_kept, neg_inf)
    out_s, out_i = _top_k(final_s, K)
    valid = torch.isfinite(out_s)
    rois = torch.where(valid[..., None], _take_rows(props, out_i),
                       torch.zeros((), dtype=props.dtype,
                                   device=props.device))
    probs = torch.where(valid, out_s,
                        torch.full((), -1.0, dtype=out_s.dtype,
                                   device=out_s.device))[..., None]
    nums = valid.sum(1).to(torch.int32)
    if return_rois_num:
        return rois, probs, nums
    return rois, probs


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, rois_num=None, name=None):
    """Route RoIs to FPN levels by scale: level = clip(⌊log2(√area /
    refer_scale + 1e-6)⌋ + refer_level, min, max), +1-pixel areas.
    fpn_rois ``[R, 4]`` packed (``rois_num`` a scalar or per-image counts
    summing to the valid prefix) or ``[N, K, 4]`` per-image blocks with
    ``rois_num [N]``.  → (per-level ``[R, 4]`` zero-padded tensors,
    restore_ind ``[R, 1]``, per-level valid counts)."""
    rois = _t(fpn_rois)
    dev = rois.device
    L = max_level - min_level + 1
    valid_mask = None
    if rois.dim() == 3:
        NB, K = rois.shape[0], rois.shape[1]
        if rois_num is None:
            block_valid = torch.ones((NB, K), dtype=torch.bool, device=dev)
        else:
            counts_in = _t(rois_num, rois).long().reshape(NB)
            block_valid = torch.arange(K, device=dev)[None, :] \
                < counts_in[:, None]
        valid_mask = block_valid.reshape(-1)
        rois = rois.reshape(-1, 4)
    R = rois.shape[0]
    w = rois[:, 2] - rois[:, 0]
    h = rois[:, 3] - rois[:, 1]
    area = torch.where((w < 0) | (h < 0), torch.zeros_like(w),
                       (w + 1) * (h + 1))
    lvl = torch.floor(torch.log2(_div(torch.sqrt(area), refer_scale) + 1e-6)
                      + refer_level)
    lvl = torch.clamp(lvl, min_level, max_level).long() - min_level
    if valid_mask is not None:
        lvl = torch.where(valid_mask, lvl, torch.full_like(lvl, L))
    elif rois_num is not None:
        n_valid = _t(rois_num, rois).long().sum()
        lvl = torch.where(torch.arange(R, device=dev) < n_valid, lvl,
                          torch.full_like(lvl, L))
    multi, counts = [], []
    rank_in_level = torch.zeros((R,), dtype=torch.int64, device=dev)
    for i in range(L):
        m = lvl == i
        rank = torch.cumsum(m.long(), 0) - 1
        dest = torch.where(m, rank, torch.full_like(rank, R))
        out = torch.zeros((R + 1, 4), dtype=rois.dtype, device=dev)
        out = out.index_put((dest,), rois)[:R]
        multi.append(out)
        counts.append(m.sum().to(torch.int32))
        rank_in_level = torch.where(m, rank, rank_in_level)
    offsets = torch.cumsum(torch.stack(
        [torch.zeros((), dtype=torch.int32, device=dev)] + counts[:-1]), 0)
    restore = (offsets[torch.clamp_max(lvl, L - 1)]
               + rank_in_level).to(torch.int32)[:, None]
    return multi, restore, counts


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, rois_num_per_level=None,
                          name=None):
    """The top ``post_nms_top_n`` RoIs across FPN levels by score:
    per-level ``[Ri, 4]`` rois and ``[Ri]`` scores (valid counts mask each
    level's padding) → (rois ``[K, 4]`` zero-padded, kept count)."""
    rois = torch.cat([_t(r) for r in multi_rois], dim=0)
    parts = [_t(s, rois).reshape(-1) for s in multi_scores]
    if rois_num_per_level is not None:
        parts = [torch.where(torch.arange(s.shape[0], device=s.device)
                             < _t(n, s), s, torch.full_like(s, -_INF))
                 for s, n in zip(parts, rois_num_per_level)]
    scores = torch.cat(parts)
    K = min(int(post_nms_top_n), scores.shape[0])
    top_s, idx = _top_k(scores, K)
    valid = torch.isfinite(top_s)
    out = torch.where(valid[:, None], rois[idx],
                      torch.zeros((), dtype=rois.dtype, device=rois.device))
    return out, valid.sum().to(torch.int32)


def box_decoder_and_assign(prior_box, prior_box_var, target_box, box_score,
                           box_clip=None, name=None):
    """Cascade-RCNN decode + per-RoI class assignment: decode each class's
    deltas against the RoI (+1-pixel center-size, exp clamp), then take
    the box of the best non-background class (background-best RoIs keep
    the prior).  prior_box ``[R, 4]``, prior_box_var ``[4]``, target_box
    ``[R, C·4]``, box_score ``[R, C]`` → (``[R, C·4]``, ``[R, 4]``)."""
    pb = _t(prior_box)
    var = _t(prior_box_var, pb).to(pb.dtype).reshape(4)
    tb = _t(target_box, pb).to(pb.dtype)
    scores = _t(box_score, pb).to(pb.dtype)
    R, C = pb.shape[0], scores.shape[1]
    clip = _BBOX_CLIP if box_clip is None else float(box_clip)
    d = tb.reshape(R, C, 4)
    pw = pb[:, 2] - pb[:, 0] + 1.0
    ph = pb[:, 3] - pb[:, 1] + 1.0
    pcx = pb[:, 0] + pw / 2
    pcy = pb[:, 1] + ph / 2
    cx = var[0] * d[..., 0] * pw[:, None] + pcx[:, None]
    cy = var[1] * d[..., 1] * ph[:, None] + pcy[:, None]
    bw = torch.exp(torch.clamp_max(var[2] * d[..., 2], clip)) * pw[:, None]
    bh = torch.exp(torch.clamp_max(var[3] * d[..., 3], clip)) * ph[:, None]
    decoded = torch.stack([cx - bw / 2, cy - bh / 2,
                           cx + bw / 2 - 1, cy + bh / 2 - 1], dim=-1)
    if C > 1:
        fg = scores.clone()
        fg[:, 0] = -_INF
    else:
        fg = scores
    best = torch.argmax(fg, dim=1)
    assigned = decoded[torch.arange(R, device=pb.device), best]
    assigned = torch.where((best > 0)[:, None], assigned, pb)
    return decoded.reshape(R, C * 4), assigned


def _sce(x, t):
    """Stable sigmoid cross-entropy (yolov3_loss_op.h SigmoidCrossEntropy)."""
    return torch.clamp_min(x, 0.0) - x * t + torch.log1p(torch.exp(-x.abs()))


def _center_iou(x1, y1, w1, h1, x2, y2, w2, h2):
    """IoU of center-format boxes (yolov3_loss_op.h CalcBoxIoU)."""
    ow = torch.minimum(x1 + w1 / 2, x2 + w2 / 2) - torch.maximum(
        x1 - w1 / 2, x2 - w2 / 2)
    oh = torch.minimum(y1 + h1 / 2, y2 + h2 / 2) - torch.maximum(
        y1 - h1 / 2, y2 - h2 / 2)
    inter = torch.where((ow < 0) | (oh < 0), torch.zeros_like(ow), ow * oh)
    union = w1 * h1 + w2 * h2 - inter
    return inter / torch.clamp_min(union, _EPS)


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3 training loss for one detection scale.  x ``[N, A·(5+cls),
    H, W]`` (A = len(anchor_mask)), gt_box ``[N, B, 4]`` center-format
    normalized (w / h ≤ 0: padding), gt_label ``[N, B]``, gt_score
    ``[N, B]`` (None → 1) → per-image loss ``[N]``.  Predictions whose
    best IoU with a GT exceeds ``ignore_thresh`` leave the objectness
    loss; each GT trains the best whole-image anchor when it is in this
    scale's mask; GTs write the objectness target in order, the last
    write winning."""
    x = _t(x)
    dev, dt = x.device, x.dtype
    gt_box = _t(gt_box, x).to(dt)
    gt_label = _t(gt_label, x).long()
    N, _, H, W = x.shape
    A = len(anchor_mask)
    B = gt_box.shape[1]
    an_num = len(anchors) // 2
    anc = torch.tensor(anchors, dtype=dt, device=dev).reshape(an_num, 2)
    mask = torch.tensor(anchor_mask, dtype=torch.int64, device=dev)
    in_size = downsample_ratio * H
    scale = float(scale_x_y)
    bias = -0.5 * (scale - 1.0)
    score = (_t(gt_score, x).to(dt) if gt_score is not None
             else torch.ones((N, B), dtype=dt, device=dev))
    if use_label_smooth:
        delta = min(1.0 / class_num, 1.0 / 40)
        pos, neg = 1.0 - delta, delta
    else:
        pos, neg = 1.0, 0.0

    t = x.reshape(N, A, 5 + class_num, H, W)
    valid = (gt_box[..., 2] > 0) & (gt_box[..., 3] > 0)  # [N, B]

    # the ignore mask: best pred-vs-gt IoU per cell
    grid_x = torch.arange(W, dtype=dt, device=dev)
    grid_y = torch.arange(H, dtype=dt, device=dev).reshape(-1, 1)
    px = (grid_x + torch.sigmoid(t[:, :, 0]) * scale + bias) / W
    py = (grid_y + torch.sigmoid(t[:, :, 1]) * scale + bias) / H
    pw = torch.exp(t[:, :, 2]) * anc[mask, 0].reshape(1, A, 1, 1) / in_size
    ph = torch.exp(t[:, :, 3]) * anc[mask, 1].reshape(1, A, 1, 1) / in_size
    g = [gt_box[..., i].reshape(N, 1, 1, 1, B) for i in range(4)]
    ious = _center_iou(px[..., None], py[..., None], pw[..., None],
                       ph[..., None], *g)  # [N, A, H, W, B]
    ious = torch.where(valid.reshape(N, 1, 1, 1, B), ious,
                       torch.zeros((), dtype=dt, device=dev))
    ignored = torch.amax(ious, dim=-1) > ignore_thresh  # [N, A, H, W]

    # per-GT best anchor over the whole anchor set
    zero = torch.zeros((), dtype=dt, device=dev)
    wh_iou = _center_iou(
        zero, zero, (anc[:, 0] / in_size).reshape(1, 1, an_num),
        (anc[:, 1] / in_size).reshape(1, 1, an_num), zero, zero,
        gt_box[..., 2:3], gt_box[..., 3:4])  # [N, B, an_num]
    best_n = torch.argmax(wh_iou, dim=-1)
    mask_pos = torch.full((an_num,), -1, dtype=torch.int64, device=dev)
    mask_pos[mask] = torch.arange(A, device=dev)
    mask_idx = mask_pos[best_n]
    matched = valid & (mask_idx >= 0) & (gt_label >= 0)

    gi = (gt_box[..., 0] * W).to(torch.int64).clamp(0, W - 1)
    gj = (gt_box[..., 1] * H).to(torch.int64).clamp(0, H - 1)
    n_ix = torch.arange(N, device=dev)[:, None].expand(N, B)
    a_ix = torch.clamp_min(mask_idx, 0)
    pred_at = t[n_ix, a_ix, :, gj, gi]  # [N, B, 5+cls]

    tx = gt_box[..., 0] * W - gi
    ty = gt_box[..., 1] * H - gj
    tw = torch.log(torch.clamp_min(gt_box[..., 2] * in_size
                                   / anc[best_n, 0], _EPS))
    th = torch.log(torch.clamp_min(gt_box[..., 3] * in_size
                                   / anc[best_n, 1], _EPS))
    loc_scale = (2.0 - gt_box[..., 2] * gt_box[..., 3]) * score
    loc = (_sce(pred_at[..., 0], tx) + _sce(pred_at[..., 1], ty)
           + (pred_at[..., 2] - tw).abs()
           + (pred_at[..., 3] - th).abs()) * loc_scale
    cls_t = torch.where(
        torch.arange(class_num, device=dev)[None, None, :]
        == gt_label[..., None],
        torch.full((), pos, dtype=dt, device=dev),
        torch.full((), neg, dtype=dt, device=dev))
    cls = _sce(pred_at[..., 5:], cls_t).sum(-1) * score
    per_gt = torch.where(matched, loc + cls, zero)
    loss = per_gt.sum(1)

    # objectness target: 0 negative, -1 ignored, the score at matched cells
    obj = torch.where(ignored, torch.full((), -1.0, dtype=dt, device=dev),
                      zero)
    flat = torch.cat([obj.reshape(N, A * H * W),
                      torch.zeros((N, 1), dtype=dt, device=dev)], dim=1)
    cell = a_ix * (H * W) + gj * W + gi
    cell = torch.where(matched, cell, torch.full_like(cell, A * H * W))
    ar = torch.arange(N, device=dev)
    for i in range(B):  # in GT order: the last write wins
        flat = flat.index_put((ar, cell[:, i]), score[:, i])
    obj = flat[:, :A * H * W].reshape(N, A, H, W)
    pobj = t[:, :, 4]
    obj_loss = torch.where(
        obj > 1e-5, _sce(pobj, 1.0) * obj,
        torch.where(obj > -0.5, _sce(pobj, 0.0), zero))
    return loss + obj_loss.sum((1, 2, 3))


def matrix_nms(bboxes, scores, score_threshold, post_threshold, nms_top_k,
               keep_top_k, use_gaussian=False, gaussian_sigma=2.0,
               background_label=0, normalized=True, return_index=False,
               name=None, return_rois_num=False):
    """Matrix NMS: every candidate's score decays by ``min_j f(iou_ij,
    iou_max_j)`` over the higher-scored candidates j (gaussian
    ``exp((max² - iou²)·σ)`` or linear ``(1 - iou) / (1 - max)``) — dense
    matrix algebra, no sequential loop.  bboxes ``[N, M, 4]``, scores
    ``[N, C, M]`` → ``[N, K, 6]`` rows (label, decayed score, box), -1
    padding; ``return_index`` adds the kept box indices ``[N, K]``,
    ``return_rois_num`` the counts ``[N]``."""
    bboxes = _t(bboxes)
    scores = _t(scores, bboxes)
    dev = bboxes.device
    N, M = bboxes.shape[0], bboxes.shape[1]
    scores, fg_labels = _fg_classes(scores, background_label)
    Cf = scores.shape[1]
    k = M if nms_top_k is None or nms_top_k < 0 else min(int(nms_top_k), M)
    K = Cf * k if keep_top_k is None or keep_top_k < 0 else min(
        int(keep_top_k), Cf * k)
    idx = torch.arange(k, device=dev)
    strict_lower = idx[:, None] > idx[None, :]  # j < i

    neg_inf = torch.full((), -_INF, dtype=scores.dtype, device=dev)
    s = torch.where(scores > score_threshold, scores, neg_inf)
    top_s, order = _top_k(s, k)  # [N, Cf, k]
    sb = _take_rows(bboxes, order.reshape(N, Cf * k)).reshape(N, Cf, k, 4)
    iou = iou_similarity(sb, sb, normalized)  # [N, Cf, k, k]
    iou_l = torch.where(strict_lower, iou, torch.zeros((), dtype=iou.dtype,
                                                       device=dev))
    iou_max = torch.amax(iou_l, dim=-1)  # max over j < i
    if use_gaussian:
        decay_m = torch.exp((iou_max[..., None, :] ** 2 - iou_l ** 2)
                            * gaussian_sigma)
    else:
        decay_m = (1.0 - iou_l) / torch.clamp_min(
            1.0 - iou_max[..., None, :], _EPS)
    decay = torch.amin(torch.where(strict_lower, decay_m,
                                   torch.ones((), dtype=decay_m.dtype,
                                              device=dev)), dim=-1)
    ds = decay * top_s
    ds = torch.where(torch.isfinite(top_s) & (ds > post_threshold), ds,
                     neg_inf)
    flat = ds.reshape(N, Cf * k)
    top2, top_i = _top_k(flat, K)
    cls = top_i // k
    box_idx = order.reshape(N, Cf * k).gather(1, top_i)
    box = _take_rows(bboxes, box_idx)
    valid = torch.isfinite(top2)
    row = torch.cat([fg_labels[cls].to(bboxes.dtype)[..., None],
                     top2[..., None].to(bboxes.dtype), box], dim=-1)
    out = torch.where(valid[..., None], row,
                      torch.full((), -1.0, dtype=row.dtype, device=dev))
    rets = (out,)
    if return_index:
        rets += (torch.where(valid, box_idx, torch.full_like(box_idx, -1))
                 .to(torch.int32),)
    if return_rois_num:
        rets += (valid.sum(1).to(torch.int32),)
    return rets[0] if len(rets) == 1 else rets


def locality_aware_nms(bboxes, scores, score_threshold, nms_top_k,
                       keep_top_k, nms_threshold=0.3, normalized=True,
                       nms_eta=1.0, background_label=-1, name=None):
    """Locality-aware NMS (EAST): one ordered pass score-weight-merges each
    box into the current merge head while they overlap above
    ``nms_threshold`` (the head's score accumulates), then greedy NMS
    prunes the merged candidates.  One class: bboxes ``[N, M, 4]``, scores
    ``[N, 1, M]`` → ``[N, K, 6]`` rows, label 0, -1 padding.  The merge
    pass is a loop over the M boxes, every image at once."""
    bboxes = _t(bboxes)
    scores = _t(scores, bboxes)
    if scores.shape[1] != 1:
        raise InvalidArgumentError(
            "locality_aware_nms supports one class (the reference op's "
            "documented limit) — use multiclass_nms/matrix_nms otherwise")
    dev = bboxes.device
    N, M = bboxes.shape[0], bboxes.shape[1]
    K = M if keep_top_k is None or keep_top_k < 0 else min(
        int(keep_top_k), M)
    ar = torch.arange(N, device=dev)
    pos = torch.arange(M, device=dev)
    bx, sc = bboxes, scores[:, 0]
    head = torch.zeros((N,), dtype=torch.int64, device=dev)
    skip = torch.ones((N, M), dtype=torch.bool, device=dev)
    for i in range(M):
        bi, bh = bx[:, i], bx[ar, head]
        si, sh = sc[:, i], sc[ar, head]
        iou = iou_similarity(bi[:, None], bh[:, None], normalized)[:, 0, 0]
        merge = (head != i) & (iou > nms_threshold)
        merged = (bi * si[:, None] + bh * sh[:, None]) / torch.clamp_min(
            si + sh, _EPS)[:, None]
        at_head = pos[None, :] == head[:, None]
        hit = at_head & merge[:, None]
        bx = torch.where(hit[..., None], merged[:, None, :], bx)
        sc = torch.where(hit, (sh + si)[:, None], sc)
        skip = skip & ~(at_head & ~merge[:, None])
        head = torch.where(merge, head, torch.full_like(head, i))
    skip = skip & (pos[None, :] != head[:, None])
    neg_inf = torch.full((), -_INF, dtype=sc.dtype, device=dev)
    s2 = torch.where(skip | (sc <= score_threshold), neg_inf, sc)
    keep = _nms_keep(bx, s2, -_INF, nms_top_k, nms_threshold, nms_eta,
                     normalized)
    final = torch.where(keep & torch.isfinite(s2), s2, neg_inf)
    top_s, top_i = _top_k(final, K)
    valid = torch.isfinite(top_s)
    row = torch.cat([torch.zeros((N, K, 1), dtype=bboxes.dtype, device=dev),
                     top_s[..., None].to(bboxes.dtype),
                     _take_rows(bx, top_i)], dim=-1)
    return torch.where(valid[..., None], row,
                       torch.full((), -1.0, dtype=row.dtype, device=dev))


def density_prior_box(input, image, densities=None, fixed_sizes=None,
                      fixed_ratios=None, variance=(0.1, 0.1, 0.2, 0.2),
                      clip=False, steps=(0.0, 0.0), offset=0.5,
                      flatten_to_2d=False, name=None):
    """Density prior boxes: per cell, each (fixed_size, density) pair lays
    a density x density sub-grid of centers shifted by
    ``step_average / density``, one box per fixed_ratio, clipped to
    [0, 1]."""
    H, W = input.shape[2], input.shape[3]
    IH, IW = image.shape[2], image.shape[3]
    dev = _dev(input)
    densities = [int(d) for d in (densities or [])]
    fixed_sizes = [float(s) for s in (fixed_sizes or [])]
    fixed_ratios = [float(r) for r in (fixed_ratios or [])]
    if not densities or not fixed_sizes or not fixed_ratios:
        raise InvalidArgumentError(
            "density_prior_box needs non-empty densities, fixed_sizes "
            "and fixed_ratios (the reference op requires all three)")
    if len(densities) != len(fixed_sizes):
        raise InvalidArgumentError(
            "densities and fixed_sizes must pair up")
    step_w = float(steps[0]) or IW / W
    step_h = float(steps[1]) or IH / H
    step_avg = int((step_w + step_h) * 0.5)
    cx = (torch.arange(W, dtype=torch.float32, device=dev) + offset) * step_w
    cy = (torch.arange(H, dtype=torch.float32, device=dev) + offset) * step_h
    rows = []
    for size, density in zip(fixed_sizes, densities):
        shift = step_avg // density
        for ratio in fixed_ratios:
            bw = size * ratio ** 0.5
            bh = size / ratio ** 0.5
            for di in range(density):
                for dj in range(density):
                    dx = -step_avg / 2.0 + shift / 2.0 + dj * shift
                    dy = -step_avg / 2.0 + shift / 2.0 + di * shift
                    rows.append((dx, dy, bw, bh))
    K = len(rows)
    d = torch.tensor(rows, dtype=torch.float32, device=dev)
    ctr_x = (cx[None, :, None] + d[:, 0]).expand(H, W, K)
    ctr_y = (cy[:, None, None] + d[:, 1]).expand(H, W, K)
    boxes = torch.stack([
        torch.clamp_min((ctr_x - d[:, 2] / 2) / IW, 0.0),
        torch.clamp_min((ctr_y - d[:, 3] / 2) / IH, 0.0),
        torch.clamp_max((ctr_x + d[:, 2] / 2) / IW, 1.0),
        torch.clamp_max((ctr_y + d[:, 3] / 2) / IH, 1.0)], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = torch.tensor(variance, dtype=torch.float32,
                       device=dev).expand(boxes.shape)
    if flatten_to_2d:
        return boxes.reshape(-1, 4), var.reshape(-1, 4)
    return boxes, var


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0,
                     return_index=False):
    """SSD inference head: decode the location offsets against the priors,
    softmax the class logits, multi-class NMS.  loc ``[N, M, 4]``, scores
    ``[N, M, C]`` → ``[N, keep_top_k, 6]`` (and the kept counts with
    ``return_index``)."""
    loc = _t(loc)
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    probs = torch.softmax(_t(scores, loc), dim=-1)
    out, nums = multiclass_nms(
        decoded, probs.transpose(1, 2), score_threshold, nms_top_k,
        keep_top_k, nms_threshold, True, nms_eta, background_label,
        return_num=True)
    return (out, nums) if return_index else out


def box_clip(input, im_info, name=None):
    """Clip boxes to the image: per image, x into [0, w/scale - 1], y into
    [0, h/scale - 1].  input ``[N, M, 4]``, im_info ``[N, 3]``."""
    boxes = _t(input)
    info = _t(im_info, boxes).to(boxes.dtype)
    im_h = torch.round(info[:, 0] / info[:, 2]) - 1.0
    im_w = torch.round(info[:, 1] / info[:, 2]) - 1.0
    shape = (-1,) + (1,) * (boxes.dim() - 1)
    x = torch.minimum(torch.clamp_min(boxes[..., 0::2], 0.0),
                      im_w.reshape(shape))
    y = torch.minimum(torch.clamp_min(boxes[..., 1::2], 0.0),
                      im_h.reshape(shape))
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None,
              min_max_aspect_ratios_order=False):
    """SSD prior boxes.  input ``[N, C, H, W]`` feature map, image
    ``[N, C, IH, IW]`` → (boxes ``[H, W, K, 4]``, variances)."""
    H, W = input.shape[2], input.shape[3]
    IH, IW = image.shape[2], image.shape[3]
    dev = _dev(input)
    min_sizes = [float(s) for s in (
        min_sizes if isinstance(min_sizes, (list, tuple)) else [min_sizes])]
    max_sizes = [float(s) for s in (max_sizes or [])] if not isinstance(
        max_sizes, (int, float)) else [float(max_sizes)]
    ars = [1.0]
    for ar in (aspect_ratios if isinstance(aspect_ratios, (list, tuple))
               else [aspect_ratios]):
        ar = float(ar)
        if not any(abs(ar - e) < 1e-6 for e in ars):
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)
    step_w = float(steps[0]) or IW / W
    step_h = float(steps[1]) or IH / H
    cx = (torch.arange(W, dtype=torch.float32, device=dev) + offset) * step_w
    cy = (torch.arange(H, dtype=torch.float32, device=dev) + offset) * step_h
    cxg, cyg = torch.meshgrid(cx, cy, indexing="xy")  # [H, W]
    whs = []
    for k, ms in enumerate(min_sizes):
        if min_max_aspect_ratios_order:
            whs.append((ms, ms))
            if k < len(max_sizes):
                s = (ms * max_sizes[k]) ** 0.5
                whs.append((s, s))
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                whs.append((ms * ar ** 0.5, ms / ar ** 0.5))
        else:
            for ar in ars:
                whs.append((ms * ar ** 0.5, ms / ar ** 0.5))
            if k < len(max_sizes):
                s = (ms * max_sizes[k]) ** 0.5
                whs.append((s, s))
    wh = torch.tensor(whs, dtype=torch.float32, device=dev)
    boxes = torch.stack([
        (cxg[..., None] - wh[:, 0] / 2) / IW,
        (cyg[..., None] - wh[:, 1] / 2) / IH,
        (cxg[..., None] + wh[:, 0] / 2) / IW,
        (cyg[..., None] + wh[:, 1] / 2) / IH], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = torch.tensor(variance, dtype=torch.float32,
                       device=dev).expand(boxes.shape)
    return boxes, var


def _roi_batch_ids(rois_num, R, device):
    """rois_num ``[N]`` → the image of each RoI ``[R]`` (all image 0 when
    None): the dense stand-in for the RoI LoD."""
    if rois_num is None:
        return torch.zeros((R,), dtype=torch.int64, device=device)
    counts = torch.as_tensor(rois_num).to(device=device, dtype=torch.int64)
    bounds = torch.cumsum(counts, 0)
    return (torch.arange(R, device=device)[:, None]
            >= bounds[None, :]).sum(1)


def _nhwc_rows(x):
    """``[N, C, H, W]`` → ``[N·H·W, C]`` rows (free for a channels-last
    view)."""
    N, C, H, W = x.shape
    return x.permute(0, 2, 3, 1).reshape(N * H * W, C)


def _gather_sum(rows, idx, wgt, out_rows):
    """``Σ_s wgt[i, s] · rows[idx[i, s]]`` for ``idx`` / ``wgt`` of shape
    ``[R, B, S]`` (R RoIs, B bins, S samples), chunked over RoIs →
    ``[R, B, C]``."""
    R, B, S = idx.shape
    C = rows.shape[1]
    outs = []
    for r0, r1 in _chunks(R, B * S * C):
        n = (r1 - r0) * B
        g = rows.index_select(0, idx[r0:r1].reshape(-1)).reshape(n, S, C)
        w = wgt[r0:r1].reshape(n, 1, S).to(rows.dtype)
        outs.append(torch.bmm(w, g).reshape(r1 - r0, B, C))
    if not outs:
        return rows.new_zeros((0, out_rows, C))
    return torch.cat(outs, 0)


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, rois_num=None,
              name=None):
    """RoI Align: the average of bilinear samples on a regular g x g grid
    in each output bin.  input ``[N, C, H, W]``, rois ``[R, 4]``, rois_num
    ``[N]`` (omitted: every RoI on image 0) → ``[R, C, PH, PW]``.
    ``sampling_ratio <= 0`` takes a fixed 2 x 2 grid and warns (the
    reference's adaptive grid is data-dependent).  Samples outside
    ``[-1, H] x [-1, W]`` are 0 and low corners clamp into the map
    (PreCalcForBilinearInterpolate).  Differentiable in the input and the
    boxes."""
    x = _t(input)
    rois = _t(rois, x).to(x.dtype)
    N, C, H, W = x.shape
    R = rois.shape[0]
    if sampling_ratio <= 0:
        warnings.warn(
            "roi_align(sampling_ratio=-1): the reference uses an adaptive "
            "per-ROI ceil(roi/bin) sample grid, which is data-dependent and "
            "cannot compile to a static shape; using a fixed 2x2 grid. Set "
            "sampling_ratio explicitly for exact parity with ported configs.",
            RuntimeWarning, stacklevel=2)
    g = int(sampling_ratio) if sampling_ratio > 0 else 2
    PH, PW = int(pooled_height), int(pooled_width)
    dev, dt = x.device, x.dtype
    bid = _roi_batch_ids(rois_num, R, dev)
    g_ix = _div(torch.arange(g, dtype=dt, device=dev) + 0.5, g)
    r = rois * spatial_scale
    xmin, ymin, xmax, ymax = r.unbind(1)
    bin_w = _div(torch.clamp_min(xmax - xmin, 1.0), PW)
    bin_h = _div(torch.clamp_min(ymax - ymin, 1.0), PH)
    ys = ymin[:, None, None] + (torch.arange(PH, dtype=dt, device=dev)[
        :, None] + g_ix[None, :])[None] * bin_h[:, None, None]  # [R, PH, g]
    xs = xmin[:, None, None] + (torch.arange(PW, dtype=dt, device=dev)[
        :, None] + g_ix[None, :])[None] * bin_w[:, None, None]  # [R, PW, g]

    def axis(v, n):
        """Low / high index and the two weights along one axis; a zero
        weight pair outside [-1, n]."""
        outside = (v < -1.0) | (v > n)
        v = torch.clamp_min(v, 0.0)
        low = torch.floor(v).long().clamp(0, n - 1)
        v = torch.where(low >= n - 1, torch.full((), n - 1.0, dtype=dt,
                                                 device=dev), v)
        high = (low + 1).clamp(max=n - 1)
        lv = v - low
        return low, high, (1.0 - lv), lv, outside

    yl, yh, wy0, wy1, oy = axis(ys, H)   # [R, PH, g]
    xl, xh, wx0, wx1, ox = axis(xs, W)   # [R, PW, g]
    # samples [R, PH, PW, gy, gx] x corners (yl xl, yl xh, yh xl, yh xh)
    Y = [t[:, :, None, :, None] for t in (yl, yh)]
    X = [t[:, None, :, None, :] for t in (xl, xh)]
    WY = [t[:, :, None, :, None] for t in (wy0, wy1)]
    WX = [t[:, None, :, None, :] for t in (wx0, wx1)]
    inside = ~(oy[:, :, None, :, None] | ox[:, None, :, None, :])
    base = (bid * (H * W))[:, None, None, None, None]
    idx, wgt = [], []
    for a in (0, 1):
        for b in (0, 1):
            idx.append(base + Y[a] * W + X[b])
            wgt.append(torch.where(inside, WY[a] * WX[b],
                                   torch.zeros((), dtype=dt, device=dev)))
    shape = (R, PH, PW, g, g)
    idx = torch.stack([i.expand(shape) for i in idx], -1).reshape(
        R, PH * PW, g * g * 4)
    wgt = _div(torch.stack([w.expand(shape) for w in wgt], -1),
               g * g).reshape(R, PH * PW, g * g * 4)
    out = _gather_sum(_nhwc_rows(x), idx, wgt, PH * PW)
    return out.reshape(R, PH, PW, C).permute(0, 3, 1, 2)


def _window_bounds(lo, hi):
    """The largest window ``hi - lo`` (at least 1) — a host read; 1 for the
    static graph's shape inference on meta tensors."""
    if lo.device.type == "meta" or lo.numel() == 0:
        return 1
    return max(1, int((hi - lo).max()))


def _window_rows(bid, hs, he, ws, we, H, W):
    """Row indices of the NHWC map ``[R, PH, PW, hmax·wmax]`` covering each
    bin's integer window, and their validity."""
    hmax, wmax = _window_bounds(hs, he), _window_bounds(ws, we)
    dev = hs.device
    hh = hs[..., None] + torch.arange(hmax, device=dev)       # [R, PH, hm]
    ww = ws[..., None] + torch.arange(wmax, device=dev)       # [R, PW, wm]
    ok = ((hh < he[..., None])[:, :, None, :, None]
          & (ww < we[..., None])[:, None, :, None, :])
    rows = (bid[:, None, None, None, None] * (H * W)
            + hh.clamp(0, H - 1)[:, :, None, :, None] * W
            + ww.clamp(0, W - 1)[:, None, :, None, :])
    R, PH, PW = hs.shape[0], hs.shape[1], ws.shape[1]
    shape = (R, PH, PW, hmax, wmax)
    return (rows.expand(shape).reshape(R, PH, PW, hmax * wmax),
            ok.expand(shape).reshape(R, PH, PW, hmax * wmax))


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0, rois_num=None, name=None):
    """RoI max pooling: the rounded RoI split into integer bins, the max of
    each bin, empty bins 0.  → ``[R, C, PH, PW]``."""
    x = _t(input)
    rois = _t(rois, x).to(x.dtype)
    N, C, H, W = x.shape
    R = rois.shape[0]
    PH, PW = int(pooled_height), int(pooled_width)
    dev, dt = x.device, x.dtype
    bid = _roi_batch_ids(rois_num, R, dev)
    ph = torch.arange(PH, dtype=dt, device=dev)
    pw = torch.arange(PW, dtype=dt, device=dev)
    x0, y0, x1, y1 = torch.round(rois * spatial_scale).unbind(1)
    bin_h = _div(torch.clamp_min(y1 - y0 + 1, 1.0)[:, None], PH)
    bin_w = _div(torch.clamp_min(x1 - x0 + 1, 1.0)[:, None], PW)
    hs = torch.clamp(torch.floor(ph * bin_h) + y0[:, None], 0, H).long()
    he = torch.clamp(torch.ceil((ph + 1) * bin_h) + y0[:, None], 0, H).long()
    ws = torch.clamp(torch.floor(pw * bin_w) + x0[:, None], 0, W).long()
    we = torch.clamp(torch.ceil((pw + 1) * bin_w) + x0[:, None], 0, W).long()
    rows, ok = _window_rows(bid, hs, he, ws, we, H, W)
    src = _nhwc_rows(x)
    S = rows.shape[-1]
    outs = []
    for r0, r1 in _chunks(R, PH * PW * S * C):
        v = src.index_select(0, rows[r0:r1].reshape(-1)).reshape(
            r1 - r0, PH, PW, S, C)
        v = torch.where(ok[r0:r1, ..., None], v,
                        torch.full((), -_INF, dtype=dt, device=dev))
        m = torch.amax(v, dim=3)
        outs.append(torch.where(torch.isfinite(m), m,
                                torch.zeros((), dtype=dt, device=dev)))
    out = torch.cat(outs, 0) if outs else x.new_zeros((0, PH, PW, C))
    return out.permute(0, 3, 1, 2)


def psroi_pool(input, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, rois_num=None, name=None):
    """Position-sensitive RoI average pooling (R-FCN): bin (c, ph, pw)
    averages input channel ``(c·PH + ph)·PW + pw`` over its integer window
    (RoI corners rounded, then scaled; empty bins 0).  input
    ``[N, C·PH·PW, H, W]``, rois ``[R, 4]`` → ``[R, C, PH, PW]``."""
    x = _t(input)
    rois = _t(rois, x).to(x.dtype)
    N, Cin, H, W = x.shape
    PH, PW = int(pooled_height), int(pooled_width)
    C = int(output_channels)
    if Cin != C * PH * PW:
        raise InvalidArgumentError(
            f"input channels {Cin} != output_channels·PH·PW = "
            f"{C * PH * PW}")
    R = rois.shape[0]
    dev, dt = x.device, x.dtype
    bid = _roi_batch_ids(rois_num, R, dev)
    ph = torch.arange(PH, dtype=dt, device=dev)
    pw = torch.arange(PW, dtype=dt, device=dev)
    rr = torch.round(rois)
    x0 = rr[:, 0:1] * spatial_scale
    y0 = rr[:, 1:2] * spatial_scale
    x1 = (rr[:, 2:3] + 1.0) * spatial_scale
    y1 = (rr[:, 3:4] + 1.0) * spatial_scale
    bh = _div(torch.clamp_min(y1 - y0, 0.1), PH)
    bw = _div(torch.clamp_min(x1 - x0, 0.1), PW)
    hs = torch.clamp(torch.floor(ph * bh + y0), 0, H).long()
    he = torch.clamp(torch.ceil((ph + 1) * bh + y0), 0, H).long()
    ws = torch.clamp(torch.floor(pw * bw + x0), 0, W).long()
    we = torch.clamp(torch.ceil((pw + 1) * bw + x0), 0, W).long()
    # rows of the map split by bin: [N, PH, PW, H, W] rows of C channels
    src = x.reshape(N, C, PH, PW, H, W).permute(0, 2, 3, 4, 5, 1).reshape(
        -1, C)
    rows, ok = _window_rows(bid, hs, he, ws, we, H, W)
    img = rows // (H * W)
    cell = rows % (H * W)
    binid = (torch.arange(PH, device=dev)[:, None] * PW
             + torch.arange(PW, device=dev)[None, :])[None, :, :, None]
    rows = (img * (PH * PW) + binid) * (H * W) + cell
    S = rows.shape[-1]
    cnt = ok.sum(-1).to(dt)
    wgt = ok.to(dt) / torch.clamp_min(cnt, 1.0)[..., None]
    out = _gather_sum(src, rows.reshape(R, PH * PW, S),
                      wgt.reshape(R, PH * PW, S), PH * PW)
    return out.reshape(R, PH, PW, C).permute(0, 3, 1, 2)


def sigmoid_focal_loss(x, label, fg_num, gamma=2.0, alpha=0.25):
    """Dense-detection focal loss ``[N, C]``: x ``[N, C]`` logits, label
    ``[N, 1]`` with classes 1..C (0: background, a negative for every
    class; -1: ignored), scaled by ``1 / max(fg_num, 1)``."""
    x = _t(x)
    label = _t(label, x).reshape(-1, 1)
    fg = torch.clamp_min(_t(fg_num, x).to(x.dtype).reshape(()), 1.0)
    d = torch.arange(x.shape[1], device=x.device)[None, :]
    c_pos = (label == d + 1).to(x.dtype)
    c_neg = ((label != -1) & (label != d + 1)).to(x.dtype)
    p = torch.sigmoid(x)
    term_pos = torch.pow(1.0 - p, gamma) * torch.log(torch.clamp_min(p,
                                                                     1e-37))
    pos = (x >= 0).to(x.dtype)
    log1mp = -x * pos - torch.log1p(torch.exp(x - 2.0 * x * pos))
    term_neg = torch.pow(p, gamma) * log1mp
    return -(c_pos * term_pos * (alpha / fg)
             + c_neg * term_neg * ((1.0 - alpha) / fg))


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, name=None, scale_x_y=1.0):
    """Decode a YOLOv3 head.  x ``[N, A·(5+cls), H, W]``, img_size
    ``[N, 2]`` (height, width) → (boxes ``[N, A·H·W, 4]`` corners, scores
    ``[N, A·H·W, cls]``); predictions below ``conf_thresh`` are zero."""
    x = _t(x)
    dev, dt = x.device, x.dtype
    img_size = _t(img_size, x)
    N, _, H, W = x.shape
    A = len(anchors) // 2
    anc = torch.tensor(anchors, dtype=dt, device=dev).reshape(A, 2)
    scale = float(scale_x_y)
    bias = -0.5 * (scale - 1.0)
    in_h = downsample_ratio * H
    in_w = downsample_ratio * W
    t = x.reshape(N, A, 5 + class_num, H, W)
    img_h = img_size[:, 0].to(dt).reshape(N, 1, 1, 1)
    img_w = img_size[:, 1].to(dt).reshape(N, 1, 1, 1)
    grid_x = torch.arange(W, dtype=dt, device=dev)
    grid_y = torch.arange(H, dtype=dt, device=dev).reshape(-1, 1)
    cx = (grid_x + torch.sigmoid(t[:, :, 0]) * scale + bias) * img_w / W
    cy = (grid_y + torch.sigmoid(t[:, :, 1]) * scale + bias) * img_h / H
    bw = torch.exp(t[:, :, 2]) * anc[:, 0].reshape(1, A, 1, 1) * img_w / in_w
    bh = torch.exp(t[:, :, 3]) * anc[:, 1].reshape(1, A, 1, 1) * img_h / in_h
    conf = torch.sigmoid(t[:, :, 4])
    keep = conf >= conf_thresh
    x0, y0 = cx - bw / 2, cy - bh / 2
    x1, y1 = cx + bw / 2, cy + bh / 2
    if clip_bbox:
        x0 = torch.clamp_min(x0, 0.0)
        y0 = torch.clamp_min(y0, 0.0)
        x1 = torch.minimum(x1, img_w - 1)
        y1 = torch.minimum(y1, img_h - 1)
    zero = torch.zeros((), dtype=dt, device=dev)
    boxes = torch.where(keep[..., None],
                        torch.stack([x0, y0, x1, y1], dim=-1), zero)
    scores = conf[..., None] * torch.sigmoid(t[:, :, 5:].movedim(2, -1))
    scores = torch.where(keep[..., None], scores, zero)
    return (boxes.reshape(N, A * H * W, 4),
            scores.reshape(N, A * H * W, class_num))
