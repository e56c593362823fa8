"""Two-stage detector training targets (Faster / Mask R-CNN, RetinaNet) —
port of ``paddle_tpu.nn.functional.detection_targets``.

Every op is dense with fixed capacities, as in the JAX package: ragged
ground truth comes zero-padded ``[N, G, ...]`` with ``gt_num [N]``,
outputs are capacity-sized with -1 labels and zero weights on padding
rows, and the images are one batch dimension (JAX vmaps them).

Subsampling fills a quota with the top-k of per-candidate priority
scores.  With ``use_random=False`` the first k candidates in index order
win, exactly as in the JAX package.  With ``use_random=True`` the scores
are uniform draws from ``key``, a ``torch.Generator`` on the tensors'
device (``None``: ``framework.random.generator_for(device)``): a uniform
k-subset, as JAX's, but not JAX's bits (ROADMAP §C).
"""
from __future__ import annotations

import torch

from ...framework.errors import InvalidArgumentError
from ...framework.random import generator_for
from ...tensor._common import t as _t
from .detection import _take_rows, _top_k, iou_similarity

__all__ = [
    "rpn_target_assign", "retinanet_target_assign",
    "generate_proposal_labels", "generate_mask_labels",
    "rasterize_polygon",
]

_EPS_TIE = 1e-5  # ScoreAssign epsilon (rpn_target_assign_op.cc:180)
_INF = float("inf")


def _generator(key, device):
    return key if key is not None else generator_for(device)


def _rank_desc(score):
    """Rank of each element in a stable descending sort (0 = largest),
    along the last axis."""
    order = torch.argsort(-score, dim=-1, stable=True)
    n = score.shape[-1]
    return torch.empty_like(order).scatter_(
        -1, order, torch.arange(n, device=score.device).expand_as(order))


def _candidate_scores(mask, gen, use_random):
    """Priority scores over candidate masks ``[N, M]`` (-inf off the
    candidates): uniform draws, or ``-index`` so the first candidates
    win."""
    M = mask.shape[-1]
    if use_random:
        score = torch.rand(mask.shape, generator=gen, device=mask.device)
    else:
        score = -torch.arange(M, dtype=torch.float32,
                              device=mask.device).expand(mask.shape)
    return torch.where(mask, score, torch.full((), -_INF,
                                               device=mask.device))


def _sample_k(mask, k, gen, use_random):
    """At most k of each row's candidates ``[N, M]``."""
    k = min(int(k), mask.shape[-1])
    if k <= 0:
        return torch.zeros_like(mask)
    _, idx = _top_k(_candidate_scores(mask, gen, use_random), k)
    sel = torch.zeros_like(mask).scatter(-1, idx, True)
    return sel & mask


def _sample_dynamic(mask, k_dynamic, gen, use_random):
    """Like :func:`_sample_k` with a per-row data-dependent quota
    ``k_dynamic [N]``."""
    score = _candidate_scores(mask, gen, use_random)
    return mask & (_rank_desc(score) < k_dynamic[:, None])


def _compact_indices(mask, capacity, priority=None):
    """Pack each row's True positions of ``mask [N, M]`` into ``capacity``
    slots, ordered by (priority, index): (src ``[N, capacity]``, -1
    padding; valid ``[N, capacity]``)."""
    N, M = mask.shape
    order = torch.arange(M, device=mask.device).expand(N, M)
    if priority is not None:
        order = priority.long() * M + order
    key = torch.where(mask, order, torch.full_like(order, 2 ** 62))
    rank = torch.argsort(key, dim=1, stable=True)
    cap = min(capacity, M)
    src = rank[:, :cap]
    if cap < capacity:
        src = torch.cat([src, src.new_zeros((N, capacity - cap))], 1)
    valid = torch.arange(capacity, device=mask.device)[None, :] \
        < mask.sum(1, keepdim=True)
    return torch.where(valid, src, torch.full_like(src, -1)), valid


def _box_to_delta(ex, gt, weights=None):
    """BoxToDelta (bbox_util.h:56): +1-pixel center-size encoding of gt
    against ex, optionally divided by per-coordinate weights."""
    ew = ex[..., 2] - ex[..., 0] + 1.0
    eh = ex[..., 3] - ex[..., 1] + 1.0
    ex_x = ex[..., 0] + 0.5 * ew
    ex_y = ex[..., 1] + 0.5 * eh
    gw = gt[..., 2] - gt[..., 0] + 1.0
    gh = gt[..., 3] - gt[..., 1] + 1.0
    gx = gt[..., 0] + 0.5 * gw
    gy = gt[..., 1] + 0.5 * gh
    d = torch.stack([(gx - ex_x) / ew, (gy - ex_y) / eh,
                     torch.log(gw / ew), torch.log(gh / eh)], dim=-1)
    if weights is not None:
        d = d / torch.tensor(weights, dtype=d.dtype, device=d.device)
    return d


def _rpn_assign(anchors, gt, is_crowd, gt_count, im_info, cfg, gen):
    """ScoreAssign + sampling (rpn_target_assign_op.cc:172-275) for every
    image: anchors ``[M, 4]``, gt ``[N, G, 4]``."""
    (batch_size, straddle, pos_ov, neg_ov, fg_frac, use_random) = cfg
    N, G = gt.shape[0], gt.shape[1]
    M = anchors.shape[0]
    dev = anchors.device
    im_h, im_w, im_scale = im_info[:, 0:1], im_info[:, 1:2], im_info[:, 2:3]
    if straddle >= 0:
        inside = ((anchors[None, :, 0] >= -straddle)
                  & (anchors[None, :, 1] >= -straddle)
                  & (anchors[None, :, 2] < im_w + straddle)
                  & (anchors[None, :, 3] < im_h + straddle))      # [N, M]
    else:
        inside = torch.ones((N, M), dtype=torch.bool, device=dev)
    valid_gt = (torch.arange(G, device=dev)[None, :] < gt_count[:, None]) \
        & (is_crowd == 0)
    gt_scaled = gt * im_scale[:, :, None]
    iou = iou_similarity(anchors, gt_scaled, box_normalized=False)  # [N,M,G]
    pair_ok = inside[:, :, None] & valid_gt[:, None, :]
    iou = torch.where(pair_ok, iou, torch.full((), -1.0, dtype=iou.dtype,
                                               device=dev))
    a2g_max = torch.amax(iou, dim=2)
    a2g_arg = torch.argmax(iou, dim=2)
    g2a_max = torch.amax(iou, dim=1)
    tie = pair_ok & ((iou - g2a_max[:, None, :]).abs() < _EPS_TIE)
    fg_cand = inside & (tie.any(2) | (a2g_max >= pos_ov))
    bg_cand = inside & (a2g_max < neg_ov)

    if batch_size < 0:
        # RetinaNet (batch = fraction = -1): every candidate trains
        fg_sel, bg_sel = fg_cand, bg_cand
        F_cap = S_cap = M
    else:
        fg_quota = int(fg_frac * batch_size)
        fg_sel = _sample_k(fg_cand, fg_quota, gen, use_random)
        bg_sel = _sample_dynamic(bg_cand, batch_size - fg_sel.sum(1), gen,
                                 use_random)
        F_cap = max(fg_quota, 1)
        S_cap = batch_size
    fg_fake_num = fg_sel.sum(1)

    # a sampled bg also sampled fg flips to label 0; its loc slot becomes a
    # zero-weight "fake" pointing at the first fg anchor
    fake = fg_sel & bg_sel
    real_fg = fg_sel & ~bg_sel
    loc_src, loc_valid = _compact_indices(
        fake | real_fg, F_cap, priority=torch.where(fake, 0, 1))
    fg_first = torch.argmax(fg_sel.to(torch.uint8), dim=1)
    safe_loc = loc_src.clamp(0, M - 1)
    is_fake_slot = loc_valid & fake.gather(1, safe_loc)
    loc_anchor = torch.where(is_fake_slot, fg_first[:, None], safe_loc)
    gt_idx = a2g_arg.gather(1, loc_anchor)
    tgt_bbox = _box_to_delta(anchors[loc_anchor], _take_rows(gt_scaled,
                                                             gt_idx))
    inside_w = (loc_valid & ~is_fake_slot).to(anchors.dtype)[..., None] \
        .expand(N, F_cap, 4)
    tgt_bbox = torch.where(loc_valid[..., None], tgt_bbox,
                           torch.zeros((), dtype=tgt_bbox.dtype,
                                       device=dev))
    loc_index = torch.where(loc_valid, loc_anchor,
                            torch.zeros_like(loc_anchor))

    score_src, score_valid = _compact_indices(
        real_fg | bg_sel, S_cap, priority=torch.where(real_fg, 0, 1))
    safe_score = score_src.clamp(0, M - 1)
    label = torch.where(real_fg.gather(1, safe_score), 1, 0)
    label = torch.where(score_valid, label, -1).to(torch.int32)
    score_index = torch.where(score_valid, safe_score,
                              torch.zeros_like(safe_score))
    return (loc_index, loc_valid, tgt_bbox, inside_w, score_index,
            score_valid, label, a2g_arg, real_fg, fg_fake_num)


def _gather_preds(pred, index, valid):
    """Rows of ``pred [N, M, D]`` at ``index [N, S]``, zero where not
    valid → ``[N·S, D]``."""
    out = _take_rows(pred, index)
    out = torch.where(valid[..., None], out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    return out.reshape(-1, pred.shape[-1])


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd, im_info, gt_num=None,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True, key=None):
    """RPN training targets.  bbox_pred ``[N, M, 4]``, cls_logits
    ``[N, M, 1]``, anchor_box ``[M, 4]``, gt_boxes ``[N, G, 4]`` with
    ``gt_num [N]`` (None: all G), is_crowd ``[N, G]``, im_info ``[N, 3]``
    → (predicted_scores ``[S, 1]``, predicted_location ``[F, 4]``,
    target_label ``[S, 1]`` with -1 padding, target_bbox ``[F, 4]``,
    bbox_inside_weight ``[F, 4]``), ``F = N·max(int(fg_fraction·batch),
    1)``, ``S = N·batch``."""
    bbox_pred = _t(bbox_pred)
    cls_logits = _t(cls_logits, bbox_pred)
    anchors = _t(anchor_box, bbox_pred)
    gt_boxes = _t(gt_boxes, bbox_pred)
    if bbox_pred.dim() != 3 or gt_boxes.dim() != 3:
        raise InvalidArgumentError(
            "rpn_target_assign dense contract wants batched bbox_pred "
            f"[N,M,4] and gt_boxes [N,G,4]; got {tuple(bbox_pred.shape)}, "
            f"{tuple(gt_boxes.shape)}")
    N, G = bbox_pred.shape[0], gt_boxes.shape[1]
    dev = bbox_pred.device
    is_crowd = _t(is_crowd, bbox_pred).reshape(N, G)
    im_info = _t(im_info, bbox_pred).to(anchors.dtype)
    gt_count = (torch.full((N,), G, dtype=torch.int64, device=dev)
                if gt_num is None else _t(gt_num, bbox_pred).long())
    cfg = (int(rpn_batch_size_per_im), float(rpn_straddle_thresh),
           float(rpn_positive_overlap), float(rpn_negative_overlap),
           float(rpn_fg_fraction), bool(use_random))
    with torch.no_grad():
        (loc_index, loc_valid, tgt_bbox, inside_w, score_index,
         score_valid, label, _, _, _) = _rpn_assign(
            anchors, gt_boxes.to(anchors.dtype), is_crowd, gt_count,
            im_info, cfg, _generator(key, dev))
    pred_loc = _gather_preds(bbox_pred, loc_index, loc_valid)
    pred_scores = _gather_preds(cls_logits, score_index, score_valid)[:, :1]
    return (pred_scores, pred_loc, label.reshape(-1, 1),
            tgt_bbox.reshape(-1, 4), inside_w.reshape(-1, 4))


def retinanet_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                            gt_boxes, gt_labels, is_crowd, im_info,
                            num_classes=1, gt_num=None,
                            positive_overlap=0.5, negative_overlap=0.4,
                            key=None):
    """RetinaNet targets: the RPN assignment without subsampling (every
    fg / bg anchor trains) and class labels from ``gt_labels``.  Returns
    (predicted_scores ``[N·M, num_classes]``, predicted_location, labels
    ``[N·M, 1]`` with -1 padding, target_bbox, bbox_inside_weight,
    fg_num ``[N, 1]`` — the foreground count + 1)."""
    bbox_pred = _t(bbox_pred)
    cls_logits = _t(cls_logits, bbox_pred)
    anchors = _t(anchor_box, bbox_pred)
    gt_boxes = _t(gt_boxes, bbox_pred)
    N, M, G = bbox_pred.shape[0], anchors.shape[0], gt_boxes.shape[1]
    dev = bbox_pred.device
    gt_labels = _t(gt_labels, bbox_pred).reshape(N, G)
    is_crowd = _t(is_crowd, bbox_pred).reshape(N, G)
    im_info = _t(im_info, bbox_pred).to(anchors.dtype)
    gt_count = (torch.full((N,), G, dtype=torch.int64, device=dev)
                if gt_num is None else _t(gt_num, bbox_pred).long())
    cfg = (-1, -1.0, float(positive_overlap), float(negative_overlap),
           -1.0, False)
    with torch.no_grad():
        (loc_index, loc_valid, tgt_bbox, inside_w, score_index, score_valid,
         label, a2g_arg, real_fg, fg_fake_num) = _rpn_assign(
            anchors, gt_boxes.to(anchors.dtype), is_crowd, gt_count,
            im_info, cfg, _generator(key, dev))
        safe = score_index.clamp(0, M - 1)
        cls = torch.where(real_fg.gather(1, safe),
                          gt_labels.long().gather(1, a2g_arg.gather(1, safe)),
                          0)
        label = torch.where(label == 1, cls, label.long()).to(torch.int32)
    pred_loc = _gather_preds(bbox_pred, loc_index, loc_valid)
    pred_scores = _gather_preds(cls_logits, score_index, score_valid)
    fg_num = (fg_fake_num + 1).to(torch.int32).reshape(N, 1)
    return (pred_scores, pred_loc, label.reshape(-1, 1),
            tgt_bbox.reshape(-1, 4), inside_w.reshape(-1, 4), fg_num)


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info, rois_num=None, gt_num=None,
                             batch_size_per_im=256, fg_fraction=0.25,
                             fg_thresh=0.25, bg_thresh_hi=0.5,
                             bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=None, use_random=True,
                             is_cls_agnostic=False, is_cascade_rcnn=False,
                             max_overlap=None, return_max_overlap=False,
                             key=None):
    """Sample RoIs and build the RCNN head's targets (SampleRoisForOneImage,
    every image at once).  rpn_rois ``[N, R, 4]`` with ``rois_num [N]``,
    gt_classes / is_crowd ``[N, G]``, gt_boxes ``[N, G, 4]`` with
    ``gt_num``, im_info ``[N, 3]``; the ground truth joins the proposal
    pool.  Capacity a image: ``batch_size_per_im`` (``G + R`` in cascade
    mode, no sampling) → (rois ``[N·B, 4]``, labels_int32 ``[N·B, 1]``
    with -1 padding, bbox_targets ``[N·B, 4·class_nums]``,
    bbox_inside_weights, bbox_outside_weights[, max_overlap ``[N·B]``])."""
    if class_nums is None:
        raise InvalidArgumentError("class_nums is required")
    rois = _t(rpn_rois)
    gt = _t(gt_boxes, rois).to(rois.dtype)
    if rois.dim() != 3 or gt.dim() != 3:
        raise InvalidArgumentError(
            "generate_proposal_labels dense contract wants rpn_rois "
            f"[N,R,4] and gt_boxes [N,G,4]; got {tuple(rois.shape)}, "
            f"{tuple(gt.shape)}")
    N, R, G = rois.shape[0], rois.shape[1], gt.shape[1]
    dev = rois.device
    gt_cls = _t(gt_classes, rois).reshape(N, G).long()
    crowd = _t(is_crowd, rois).reshape(N, G)
    im_info = _t(im_info, rois).to(rois.dtype)
    roi_count = (torch.full((N,), R, dtype=torch.int64, device=dev)
                 if rois_num is None else _t(rois_num, rois).long())
    gt_count = (torch.full((N,), G, dtype=torch.int64, device=dev)
                if gt_num is None else _t(gt_num, rois).long())
    if is_cascade_rcnn and max_overlap is None:
        raise InvalidArgumentError(
            "max_overlap is required when is_cascade_rcnn=True "
            "(generate_proposal_labels_op.cc InferShape)")
    max_ov_in = (torch.zeros((N, R), dtype=rois.dtype, device=dev)
                 if max_overlap is None
                 else _t(max_overlap, rois).reshape(N, R))
    B = int(batch_size_per_im)
    C = int(class_nums)
    gen = _generator(key, dev)
    with torch.no_grad():
        P = G + R
        im_scale = im_info[:, 2:3]
        rois_s = rois / im_scale[:, :, None]
        ar_g = torch.arange(G, device=dev)[None, :]
        valid_gt = ar_g < gt_count[:, None]
        valid_roi = torch.arange(R, device=dev)[None, :] < roi_count[:, None]
        if is_cascade_rcnn:
            valid_roi = valid_roi \
                & ((rois_s[..., 2] - rois_s[..., 0] + 1) > 0) \
                & ((rois_s[..., 3] - rois_s[..., 1] + 1) > 0) \
                & (max_ov_in < 1.0)
        boxes = torch.cat([gt, rois_s], dim=1)                    # [N, P, 4]
        valid_row = torch.cat([valid_gt, valid_roi], dim=1)
        iou = iou_similarity(boxes, gt, box_normalized=False)    # [N, P, G]
        iou = torch.where(valid_row[:, :, None] & valid_gt[:, None, :], iou,
                          torch.full((), -1.0, dtype=iou.dtype, device=dev))
        max_ov = torch.amax(iou, dim=2)
        row_crowd = torch.cat([(crowd != 0) & valid_gt,
                               torch.zeros((N, R), dtype=torch.bool,
                                           device=dev)], dim=1)
        max_ov = torch.where(row_crowd, torch.full_like(max_ov, -1.0),
                             max_ov)
        fg_cand = max_ov >= fg_thresh
        bg_cand = ~fg_cand & (max_ov >= bg_thresh_lo) \
            & (max_ov < bg_thresh_hi)
        tie = ((max_ov[:, :, None] - iou).abs() < _EPS_TIE) \
            & valid_gt[:, None, :]
        mapped_gt = torch.argmax(tie.to(torch.uint8), dim=2)
        if is_cascade_rcnn:
            fg_sel, bg_sel = fg_cand, bg_cand
            cap = P
        else:
            fg_sel = _sample_k(fg_cand, int(B * fg_fraction), gen,
                               use_random)
            bg_sel = _sample_dynamic(bg_cand, B - fg_sel.sum(1), gen,
                                     use_random)
            cap = B
        src, valid = _compact_indices(fg_sel | bg_sel, cap,
                                      priority=torch.where(fg_sel, 0, 1))
        safe = src.clamp(0, P - 1)
        is_fg = valid & fg_sel.gather(1, safe)
        sampled = _take_rows(boxes, safe)
        g_idx = mapped_gt.gather(1, safe)
        labels = torch.where(is_fg, gt_cls.gather(1, g_idx), 0)
        labels = torch.where(valid, labels, -1).to(torch.int32)
        sampled_ov = torch.where(valid, max_ov.gather(1, safe),
                                 torch.zeros((), dtype=max_ov.dtype,
                                             device=dev))
        deltas = _box_to_delta(sampled, _take_rows(gt, g_idx),
                               tuple(float(w) for w in bbox_reg_weights))
        slot = torch.where(is_fg, 1 if is_cls_agnostic else labels.long(), 0)
        onehot = torch.nn.functional.one_hot(slot, C).to(deltas.dtype) \
            * is_fg[..., None].to(deltas.dtype)                  # [N, cap, C]
        targets = (onehot[..., None] * deltas[:, :, None, :]).reshape(
            N, cap, 4 * C)
        w = onehot.repeat_interleave(4, dim=2)
        rois_out = torch.where(valid[..., None], sampled * im_scale[:, :, None],
                               torch.zeros((), dtype=sampled.dtype,
                                           device=dev))
    res = (rois_out.reshape(N * cap, 4), labels.reshape(N * cap, 1),
           targets.reshape(N * cap, -1), w.reshape(N * cap, -1),
           w.reshape(N * cap, -1))
    if return_max_overlap:
        return res + (sampled_ov.reshape(N * cap),)
    return res


def rasterize_polygon(verts, nv, resolution, box):
    """Fill one polygon onto a ``resolution²`` grid relative to ``box``
    (even-odd crossing rule at pixel centers).  verts ``[V, 2]`` (x, y)
    with ``nv`` valid vertices → ``[M, M]`` int32.  Leading batch
    dimensions of verts / nv / box are kept."""
    M = int(resolution)
    verts = _t(verts)
    box = _t(box, verts).to(verts.dtype)
    nv = _t(nv, verts)
    V = verts.shape[-2]
    dev = verts.device
    x0, y0 = box[..., 0:1], box[..., 1:2]
    w = torch.clamp_min(box[..., 2:3] - box[..., 0:1], 1.0)
    h = torch.clamp_min(box[..., 3:4] - box[..., 1:2], 1.0)
    px = (verts[..., 0] - x0) * M / w                       # [..., V]
    py = (verts[..., 1] - y0) * M / h
    # the pixel centers in float64, as the JAX package's (x64) grid
    c = torch.arange(M, dtype=torch.float64, device=dev) + 0.5
    gx, gy = torch.meshgrid(c, c, indexing="xy")            # [M, M]
    idx = torch.arange(V, device=dev)
    nxt = torch.where(idx + 1 >= nv[..., None], torch.zeros_like(idx),
                      idx + 1)                               # [..., V]
    valid_edge = idx < nv[..., None]
    x1, y1 = px, py
    x2, y2 = px.gather(-1, nxt), py.gather(-1, nxt)
    e = (Ellipsis, slice(None), None, None)
    y1b, y2b, x1b, x2b = y1[e], y2[e], x1[e], x2[e]
    cond = ((y1b > gy) != (y2b > gy)) & valid_edge[e]
    tt = (gy - y1b) / torch.where(y2b == y1b, torch.ones_like(y2b),
                                  y2b - y1b)
    xi = x1b + tt * (x2b - x1b)
    cross = cond & (gx < xi)
    return (cross.sum(-3) % 2).to(torch.int32)


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         labels_int32, num_classes, resolution,
                         gt_num=None, rois_num=None, poly_vertex_num=None,
                         poly_num=None):
    """Mask R-CNN mask-head targets.  gt_segms ``[N, G, Pp, V, 2]``
    polygon vertices, poly_vertex_num ``[N, G, Pp]``, poly_num ``[N, G]``,
    rois ``[N, R, 4]`` + labels_int32 ``[N, R]`` from
    :func:`generate_proposal_labels` → (mask_rois ``[N·R, 4]``,
    roi_has_mask_int32 ``[N·R, 1]``, mask_int32 ``[N·R,
    num_classes·resolution²]`` with -1 = ignore, mask_num ``[N]``)."""
    rois = _t(rois)
    segms = _t(gt_segms, rois).to(rois.dtype)
    if rois.dim() != 3 or segms.dim() != 5:
        raise InvalidArgumentError(
            "generate_mask_labels dense contract wants rois [N,R,4] and "
            f"gt_segms [N,G,Pp,V,2]; got {tuple(rois.shape)}, "
            f"{tuple(segms.shape)}")
    N, R = rois.shape[0], rois.shape[1]
    G, Pp, V = segms.shape[1], segms.shape[2], segms.shape[3]
    C, M = int(num_classes), int(resolution)
    dev = rois.device
    labels = _t(labels_int32, rois).reshape(N, R).long()
    gt_cls = _t(gt_classes, rois).reshape(N, G)
    crowd = _t(is_crowd, rois).reshape(N, G)
    im_info = _t(im_info, rois).to(rois.dtype)
    nv = (torch.full((N, G, Pp), V, dtype=torch.int64, device=dev)
          if poly_vertex_num is None else _t(poly_vertex_num, rois).long())
    pc = (torch.full((N, G), Pp, dtype=torch.int64, device=dev)
          if poly_num is None else _t(poly_num, rois).long())
    gt_count = (torch.full((N,), G, dtype=torch.int64, device=dev)
                if gt_num is None else _t(gt_num, rois).long())
    roi_count = (torch.full((N,), R, dtype=torch.int64, device=dev)
                 if rois_num is None else _t(rois_num, rois).long())
    im_scale = im_info[:, 2]

    valid_gt = (torch.arange(G, device=dev)[None] < gt_count[:, None]) \
        & (gt_cls > 0) & (crowd == 0)
    vmask = (torch.arange(V, device=dev)[None, None, None, :]
             < nv[..., None]) \
        & (torch.arange(Pp, device=dev)[None, None, :, None]
           < pc[:, :, None, None])                           # [N, G, Pp, V]
    big = torch.full((), _INF, dtype=segms.dtype, device=dev)
    vx, vy = segms[..., 0], segms[..., 1]
    poly_boxes = torch.stack([
        torch.where(vmask, vx, big).amin((2, 3)),
        torch.where(vmask, vy, big).amin((2, 3)),
        torch.where(vmask, vx, -big).amax((2, 3)),
        torch.where(vmask, vy, -big).amax((2, 3))], dim=-1)  # [N, G, 4]
    poly_boxes = torch.where(valid_gt[..., None], poly_boxes,
                             torch.zeros((), dtype=segms.dtype, device=dev))

    valid_roi = torch.arange(R, device=dev)[None] < roi_count[:, None]
    fg = valid_roi & (labels > 0)
    fg_num = fg.sum(1)
    src, valid = _compact_indices(fg, R)
    safe = src.clamp(0, R - 1)
    rois_fg = _take_rows(rois, safe) / im_scale[:, None, None]
    ov = iou_similarity(rois_fg, poly_boxes, box_normalized=False)
    ov = torch.where(valid_gt[:, None, :], ov, -big)
    g_for_roi = torch.argmax(ov, dim=2)                       # [N, R]

    # every (roi, polygon of its gt) rasterized at once
    ar = torch.arange(N, device=dev)[:, None]
    pverts = segms[ar, g_for_roi]                             # [N,R,Pp,V,2]
    pnv = nv[ar, g_for_roi]                                   # [N,R,Pp]
    masks = rasterize_polygon(
        pverts, pnv, M, rois_fg[:, :, None, :].expand(N, R, Pp, 4))
    present = (torch.arange(Pp, device=dev)[None, None, :]
               < pc[ar, g_for_roi][..., None])               # [N, R, Pp]
    masks = (torch.where(present[..., None, None], masks,
                         torch.zeros_like(masks)).sum(2) > 0)  # [N, R, M, M]
    cls = torch.where(valid, labels.gather(1, safe), 0)

    no_fg = fg_num == 0
    count = torch.clamp_min(fg_num, 1)
    roi0 = rois[:, 0] / im_scale[:, None]
    rois_fg = torch.where(no_fg[:, None, None], roi0[:, None, :], rois_fg)
    first_bg = torch.argmax((valid_roi & (labels == 0)).to(torch.uint8),
                            dim=1)
    has_mask = torch.where(valid, safe, torch.zeros_like(safe))
    has_mask = torch.where(no_fg[:, None], first_bg[:, None],
                           has_mask).to(torch.int32)

    flat = masks.reshape(N, R, M * M).to(torch.int32)
    flat = torch.where(no_fg[:, None, None], torch.full_like(flat, -1), flat)
    onehot = torch.nn.functional.one_hot(cls.clamp_min(0), C) \
        .to(torch.int32)                                      # [N, R, C]
    expand = torch.where((onehot[..., None] > 0) & (cls[..., None, None] > 0),
                         flat[:, :, None, :], -1).reshape(N, R, C * M * M)
    row_valid = torch.arange(R, device=dev)[None] < count[:, None]
    expand = torch.where(row_valid[..., None], expand,
                         torch.full_like(expand, -1))
    rois_out = torch.where(row_valid[..., None],
                           rois_fg * im_scale[:, None, None],
                           torch.zeros((), dtype=rois.dtype, device=dev))
    return (rois_out.reshape(N * R, 4), has_mask.reshape(N * R, 1),
            expand.reshape(N * R, -1), count.to(torch.int32))
