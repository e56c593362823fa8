"""The port's two-stage detector targets
(``paddle_tpu_torch.nn.functional.detection_targets``) against the JAX
package's, and a port of the JAX package's two-stage training test.

With ``use_random=False`` both packages keep the first k candidates, so
every output — sampled indices, labels, targets, weights, counts — must
agree: index outputs exactly, floats at rtol / atol 1e-5 (float32), the
gradients of the gathered predictions within 1e-4 of JAX's rms.  With
``use_random=True`` the port draws from a ``torch.Generator`` (JAX's bits
cannot be reproduced): those cases are held to the sampling's invariants
(the fg quota, the per-image batch, the candidate sets) and to
reproducibility from one seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import functional as JF
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch.nn import functional as TF
from test_torch_detection import check_out, fwd_bwd


def _rpn_data(seed, N=2, M=40, G=4):
    rng = np.random.RandomState(seed)
    anchors = np.zeros((M, 4), np.float32)
    anchors[:, :2] = rng.uniform(-10, 70, (M, 2))
    anchors[:, 2:] = anchors[:, :2] + rng.uniform(5, 40, (M, 2))
    anchors[5] = anchors[4]                       # tied anchors
    gt = np.zeros((N, G, 4), np.float32)
    gt[..., :2] = rng.uniform(0, 50, (N, G, 2))
    gt[..., 2:] = gt[..., :2] + rng.uniform(10, 40, (N, G, 2))
    crowd = (rng.uniform(size=(N, G)) < 0.2).astype(np.int32)
    im_info = np.array([[90, 90, 1.0], [90, 90, 0.5]], np.float32)[:N]
    bbox_pred = rng.randn(N, M, 4).astype(np.float32)
    cls_logits = rng.randn(N, M, 1).astype(np.float32)
    gt_num = np.array([G, G - 1], np.int32)[:N]
    return bbox_pred, cls_logits, anchors, gt, crowd, im_info, gt_num


RPN = {
    "default": dict(rpn_batch_size_per_im=16, rpn_straddle_thresh=0.0),
    "no_straddle_small_quota": dict(rpn_batch_size_per_im=8,
                                    rpn_straddle_thresh=-1.0,
                                    rpn_fg_fraction=0.25,
                                    rpn_positive_overlap=0.5),
    "large_batch": dict(rpn_batch_size_per_im=32, rpn_negative_overlap=0.4),
}


@pytest.mark.parametrize("case", list(RPN))
def test_rpn_target_assign(case):
    bp, cl, anc, gt, crowd, info, gn = _rpn_data(1)
    kw = RPN[case]

    def call(F):
        return lambda b, c, a, g, cr, ii, n: F.rpn_target_assign(
            b, c, a, None, g, cr, ii, gt_num=n, use_random=False, **kw)

    fwd_bwd(call(JF), call(TF), [bp, cl, anc, gt, crowd, info, gn],
            grad=(0, 1), pick=lambda o: o[0].sum() + o[1].sum() * 0.5)


def test_retinanet_target_assign():
    bp, _, anc, gt, crowd, info, gn = _rpn_data(2)
    rng = np.random.RandomState(2)
    C = 3
    cl = rng.randn(bp.shape[0], bp.shape[1], C).astype(np.float32)
    labels = rng.randint(1, C + 1, crowd.shape).astype(np.int32)

    def call(F):
        return lambda b, c, a, g, lb, cr, ii, n: F.retinanet_target_assign(
            b, c, a, None, g, lb, cr, ii, num_classes=C, gt_num=n)

    fwd_bwd(call(JF), call(TF), [bp, cl, anc, gt, labels, crowd, info, gn],
            grad=(0, 1), pick=lambda o: o[0].sum() + o[1].sum())


def _rcnn_data(seed, N=2, R=16, G=3, C=4):
    rng = np.random.RandomState(seed)
    gt = np.zeros((N, G, 4), np.float32)
    gt[..., :2] = rng.uniform(5, 30, (N, G, 2))
    gt[..., 2:] = gt[..., :2] + rng.uniform(15, 30, (N, G, 2))
    gt_cls = rng.randint(1, C, (N, G)).astype(np.int32)
    crowd = np.zeros((N, G), np.int32)
    crowd[1, 0] = 1
    info = np.array([[80, 80, 1.0], [100, 100, 1.25]], np.float32)[:N]
    rois = np.zeros((N, R, 4), np.float32)
    rois[..., :2] = rng.uniform(0, 50, (N, R, 2))
    rois[..., 2:] = rois[..., :2] + rng.uniform(8, 30, (N, R, 2))
    rois[:, :G] = gt * info[:, 2:3, None] + rng.uniform(-3, 3, (N, G, 4))
    rois_num = np.array([R, R - 4], np.int32)[:N]
    gt_num = np.array([G, G - 1], np.int32)[:N]
    return rois, gt_cls, crowd, gt, info, rois_num, gt_num


PROPOSAL_LABELS = {
    "default": dict(batch_size_per_im=12, fg_fraction=0.5, fg_thresh=0.5),
    "agnostic_max_overlap": dict(batch_size_per_im=10, fg_thresh=0.4,
                                 bg_thresh_hi=0.6, is_cls_agnostic=True,
                                 return_max_overlap=True),
    "cascade": dict(is_cascade_rcnn=True, fg_thresh=0.5,
                    return_max_overlap=True),
}


@pytest.mark.parametrize("case", list(PROPOSAL_LABELS))
def test_generate_proposal_labels(case):
    rois, gt_cls, crowd, gt, info, rn, gn = _rcnn_data(3)
    kw = dict(PROPOSAL_LABELS[case])
    arrays = [rois, gt_cls, crowd, gt, info, rn, gn]
    if kw.get("is_cascade_rcnn"):
        arrays.append(np.random.RandomState(4).uniform(
            0, 1.2, rois.shape[:2]).astype(np.float32))

    def call(F):
        def f(r, gc, cr, g, ii, rnum, gnum, *mo):
            return F.generate_proposal_labels(
                r, gc, cr, g, ii, rois_num=rnum, gt_num=gnum, class_nums=4,
                use_random=False, max_overlap=mo[0] if mo else None, **kw)
        return f

    fwd_bwd(call(JF), call(TF), arrays, grad=())


@pytest.mark.parametrize("nv", [3, 5])
def test_rasterize_polygon(nv):
    verts = np.array([[2.0, 3.0], [18.0, 5.5], [14.0, 17.0], [4.5, 14.0],
                      [1.0, 9.0], [0.0, 0.0]], np.float32)
    box = np.array([0.0, 1.0, 20.0, 19.0], np.float32)
    j = JF.rasterize_polygon(jnp.asarray(verts), nv, 14, jnp.asarray(box))
    t = TF.rasterize_polygon(torch.from_numpy(verts), nv, 14,
                             torch.from_numpy(box))
    check_out(t, j)
    assert int(t.sum()) > 0


def test_generate_mask_labels():
    rois, gt_cls, crowd, gt, info, rn, gn = _rcnn_data(5)
    srois, labels = jax.jit(lambda *a: JF.generate_proposal_labels(
        *a[:5], rois_num=a[5], gt_num=a[6], batch_size_per_im=12,
        fg_thresh=0.5, class_nums=4, use_random=False)[:2])(
        rois, gt_cls, crowd, gt, info, rn, gn)
    N, G = gt.shape[:2]
    srois = np.asarray(srois).reshape(N, -1, 4)
    labels = np.asarray(labels).reshape(N, -1)
    rng = np.random.RandomState(5)
    Pp, V = 2, 5
    segms = np.zeros((N, G, Pp, V, 2), np.float32)
    for n in range(N):
        for g in range(G):
            x0, y0, x1, y1 = gt[n, g]
            for p in range(Pp):
                segms[n, g, p, :, 0] = rng.uniform(x0, x1, V)
                segms[n, g, p, :, 1] = rng.uniform(y0, y1, V)
    nv = rng.randint(3, V + 1, (N, G, Pp)).astype(np.int32)
    pn = np.array([[2, 1, 2], [1, 2, 1]], np.int32)[:N, :G]
    cnt = (labels >= 0).sum(1).astype(np.int32)

    def call(F):
        return lambda *a: F.generate_mask_labels(
            a[0], a[1], a[2], a[3], a[4], a[5], 4, 8, gt_num=a[6],
            rois_num=a[7], poly_vertex_num=a[8], poly_num=a[9])

    out = fwd_bwd(call(JF), call(TF),
                  [info, gt_cls, crowd, segms, srois, labels, gn, cnt, nv,
                   pn], grad=())
    assert int((out[2] >= 0).sum()) > 0          # some mask pixels trained


def test_fallback_without_foreground():
    """No fg RoI: one all-ignore mask on RoI 0, class 0 (both packages)."""
    rois, gt_cls, crowd, gt, info, rn, gn = _rcnn_data(6)
    N, R = rois.shape[:2]
    labels = np.zeros((N, R), np.int32)
    segms = np.zeros((N, gt.shape[1], 1, 4, 2), np.float32)
    segms[..., 0] = gt[:, :, None, [0, 2, 2, 0]]
    segms[..., 1] = gt[:, :, None, [1, 1, 3, 3]]
    fwd_bwd(lambda *a: JF.generate_mask_labels(*a, 4, 6),
            lambda *a: TF.generate_mask_labels(*a, 4, 6),
            [info, gt_cls, crowd, segms, rois, labels], grad=())


# -- use_random=True: the invariants -------------------------------------------
def _rpn_random(seed):
    bp, cl, anc, gt, crowd, info, gn = [torch.from_numpy(a) for a in
                                        _rpn_data(7, M=60)]
    gen = torch.Generator().manual_seed(seed)
    return TF.rpn_target_assign(bp, cl, anc, None, gt, crowd, info,
                                gt_num=gn, rpn_batch_size_per_im=16,
                                use_random=True, key=gen)


def _rpn_candidates(anc, gt, crowd, info, gn, pos=0.7, neg=0.3):
    """fg / bg candidate masks ``[N, M]`` (straddle 0): ScoreAssign's
    sets, written out here."""
    N, G = gt.shape[:2]
    inside = ((anc[None, :, 0] >= 0) & (anc[None, :, 1] >= 0)
              & (anc[None, :, 2] < info[:, 1:2])
              & (anc[None, :, 3] < info[:, 0:1]))
    ok = (torch.arange(G)[None] < gn[:, None]) & (crowd == 0)
    iou = TF.iou_similarity(anc, gt * info[:, 2, None, None], False)
    pair = inside[:, :, None] & ok[:, None, :]
    iou = torch.where(pair, iou, torch.full_like(iou, -1.0))
    a2g = iou.amax(2)
    tie = pair & ((iou - iou.amax(1, keepdim=True)).abs() < 1e-5)
    return inside & (tie.any(2) | (a2g >= pos)), inside & (a2g < neg)


def test_rpn_random_sampling_invariants():
    a, b, c = _rpn_random(0), _rpn_random(0), _rpn_random(1)
    for x, y in zip(a, b):
        assert torch.equal(x, y)                   # one seed, one draw
    assert any(not torch.equal(x, y) for x, y in zip(a, c))
    bp, cl, anc, gt, crowd, info, gn = [torch.from_numpy(v) for v in
                                        _rpn_data(7, M=60)]
    fg_cand, bg_cand = _rpn_candidates(anc, gt, crowd, info, gn)
    scores, lbl = a[0].reshape(2, 16), a[2].reshape(2, 16)
    inw = a[4].reshape(2, 8, 4)
    for n in range(2):
        fg = int((lbl[n] == 1).sum())
        assert fg <= 8 and int((lbl[n] >= 0).sum()) <= 16   # the quotas
        assert int(inw[n, :, 0].sum()) == fg      # real fg rows weighted
        # each sampled row's anchor (its logit is unique) is a candidate
        for s, l in zip(scores[n], lbl[n]):
            if l < 0:
                continue
            m = int(torch.nonzero(cl[n, :, 0] == s)[0, 0])
            assert bool((fg_cand if l == 1 else bg_cand)[n, m]), (n, m)


def test_proposal_labels_random_invariants():
    rois, gt_cls, crowd, gt, info, rn, gn = [torch.from_numpy(a) for a in
                                             _rcnn_data(8, R=40)]
    kw = dict(rois_num=rn, gt_num=gn, batch_size_per_im=16,
              fg_fraction=0.25, fg_thresh=0.5, class_nums=4,
              return_max_overlap=True)
    outs = [TF.generate_proposal_labels(
        rois, gt_cls, crowd, gt, info, use_random=True,
        key=torch.Generator().manual_seed(s), **kw) for s in (3, 3, 4)]
    for x, y in zip(outs[0], outs[1]):
        assert torch.equal(x, y)
    srois, labels, tgt, inw, _, ov = outs[0]
    labels = labels.reshape(2, 16)
    ov = ov.reshape(2, 16)
    for n in range(2):
        fg = labels[n] > 0
        assert int(fg.sum()) <= 4                          # the fg quota
        assert bool((ov[n][fg] >= 0.5).all())              # fg candidates
        bg = labels[n] == 0
        assert bool((ov[n][bg] < 0.5).all())               # bg candidates
    # the weights sit at the fg rows' class slots, 4 columns each
    assert int(inw.sum()) == 4 * int((labels > 0).sum())
    assert any(not torch.equal(x, y) for x, y in zip(outs[0], outs[2]))


# -- the two-stage chain, trained (TestTwoStageEndToEnd's port) ---------------
def test_joint_rpn_rcnn_training_converges():
    """Backbone features → RPN losses (rpn_target_assign) → proposals →
    RCNN sampling (generate_proposal_labels) → head losses, trained with
    Adam at the JAX test's size; the loss falls below half its first value
    as the JAX test asserts."""
    rng = np.random.RandomState(0)
    N, C, Hf, Wf, IM, A, G = 2, 8, 8, 8, 64, 3, 2
    gt = np.zeros((N, G, 4), np.float32)
    gt[..., :2] = rng.uniform(4, 28, (N, G, 2))
    gt[..., 2:] = gt[..., :2] + rng.uniform(16, 30, (N, G, 2))
    gt = torch.from_numpy(np.clip(gt, 0, IM - 1))
    gt_cls = torch.from_numpy(rng.randint(1, 3, (N, G)).astype(np.int32))
    crowd = torch.zeros((N, G), dtype=torch.int32)
    im_info = torch.tensor([[IM, IM, 1.0]] * N)
    feats = torch.from_numpy(rng.randn(N, C, Hf, Wf).astype(np.float32)
                             * 0.1)
    anchors, variances = TF.anchor_generator(
        feats, anchor_sizes=[16.0, 24.0, 32.0], aspect_ratios=[1.0],
        stride=[8.0, 8.0])
    anchors_flat = anchors.reshape(-1, 4)
    M = anchors_flat.shape[0]
    params = {k: torch.tensor(v, requires_grad=True) for k, v in {
        "rpn_w": rng.randn(C, A * 5) * 0.01,
        "head_w1": rng.randn(6, 32) * 0.1,
        "head_cls": rng.randn(32, 3) * 0.1,
        "head_box": rng.randn(32, 12) * 0.01}.items()}
    for p in params.values():
        p.data = p.data.float()
    opt = topt.Adam(learning_rate=0.02, parameters=list(params.values()))

    def loss_fn(p):
        o = torch.einsum("nchw,ck->nkhw", feats, p["rpn_w"])
        o = o.permute(0, 2, 3, 1).reshape(N, M, 5)
        bbox_pred, cls_logits = o[..., :4], o[..., 4:5]
        scores, loc, lbl, tgt, inw = TF.rpn_target_assign(
            bbox_pred, cls_logits, anchors_flat, None, gt, crowd, im_info,
            rpn_batch_size_per_im=32, rpn_positive_overlap=0.5,
            rpn_negative_overlap=0.3, use_random=True,
            key=torch.Generator().manual_seed(1))
        valid = (lbl >= 0).float()
        rpn_cls = (valid * (torch.nn.functional.softplus(scores)
                            - scores * lbl.float())).sum() \
            / valid.sum().clamp_min(1.0)
        rpn_reg = (inw * (loc - tgt) ** 2).sum() / inw.sum().clamp_min(1.0)
        rois, _, counts = TF.generate_proposals(
            torch.sigmoid(cls_logits).reshape(N, Hf, Wf, A).permute(
                0, 3, 1, 2).detach(),
            bbox_pred.reshape(N, Hf, Wf, A * 4).permute(0, 3, 1, 2).detach(),
            im_info, anchors, variances, pre_nms_top_n=64,
            post_nms_top_n=16, return_rois_num=True)
        s_rois, labels, btgt, binw, _ = TF.generate_proposal_labels(
            rois, gt_cls, crowd, gt, im_info, rois_num=counts,
            batch_size_per_im=16, fg_fraction=0.5, fg_thresh=0.5,
            class_nums=3, use_random=True,
            key=torch.Generator().manual_seed(2))
        rf = torch.cat([s_rois / IM, (s_rois[:, 2:] - s_rois[:, :2]) / IM], 1)
        h = torch.relu(rf @ p["head_w1"])
        logits = h @ p["head_cls"]
        deltas = h @ p["head_box"]
        head_cls = TF.cross_entropy(logits, labels.reshape(-1).long(),
                                    ignore_index=-1, reduction="mean")
        head_reg = (binw * (deltas - btgt) ** 2).sum() \
            / binw.sum().clamp_min(1.0)
        return rpn_cls + rpn_reg + head_cls + head_reg

    losses = []
    for _ in range(250):
        loss = loss_fn(params)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
