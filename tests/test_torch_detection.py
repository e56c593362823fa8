"""The port's detection ops (``paddle_tpu_torch.nn.functional.detection``)
against the JAX package's, forward and backward, and the greedy sweep's
plain loop (``ops.nms_sweep_ref``) against JAX's ``fori_loop``.

Every input is a numpy array from a seed, fed to the JAX function and to
its port.  Float outputs are compared at rtol / atol 1e-5 (float32);
index outputs (keep masks, matches, labels, counts) must be equal in
value (the port may give int64 where JAX gives int32).  Gradients are
``jax.grad`` / autograd of ``Σ out · c`` for a seeded cotangent ``c``,
held within 1e-4 of the JAX gradient's rms.  Ties are built on purpose
where JAX fixes their order (``lax.top_k``'s ascending index order, the
-inf padding included, ``argsort``'s stability, ``argmax``'s first
maximum).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.functional import detection as jdet
import paddle_tpu_torch.vision.ops as tops
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional import detection as tdet
from paddle_tpu_torch.ops import nms_sweep_ref

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RMS = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [v for part in tree for v in _leaves(part)]
    return [tree]


def check_out(tout, jout, tol=TOL):
    """Every leaf equal: floats within ``tol``, the rest exactly."""
    tl, jl = _leaves(tout), _leaves(jout)
    assert len(tl) == len(jl)
    for i, (t, j) in enumerate(zip(tl, jl)):
        t, j = _np(t), np.asarray(j)
        assert t.shape == j.shape, (i, t.shape, j.shape)
        if np.issubdtype(j.dtype, np.floating):
            np.testing.assert_allclose(t, j.astype(np.float32),
                                       err_msg=f"leaf {i}", **tol)
        else:
            np.testing.assert_array_equal(t.astype(np.int64),
                                          j.astype(np.int64),
                                          err_msg=f"leaf {i}")


def fwd_bwd(jfn, tfn, arrays, grad=(0,), pick=lambda o: o, tol=TOL,
            seed=1):
    """Forward of both on ``arrays`` (compared leaf by leaf), then the
    gradient of ``Σ pick(out) · c`` for the arrays in ``grad``."""
    jfn = jax.jit(jfn)  # one compile instead of one per eager op
    jin = [jnp.asarray(a) for a in arrays]
    tin = [torch.tensor(a, requires_grad=i in grad
                        and np.issubdtype(a.dtype, np.floating))
           for i, a in enumerate(arrays)]
    jout, tout = jfn(*jin), tfn(*tin)
    check_out(tout, jout, tol)
    if not grad:
        return tout
    shape = np.asarray(pick(jout)).shape
    cot = np.asarray(np.random.RandomState(seed).randn(*shape), np.float32)
    jg = jax.grad(lambda *xs: jnp.sum(pick(jfn(*xs)) * cot),
                  argnums=tuple(grad))(*jin)
    tg = torch.autograd.grad((pick(tout) * torch.from_numpy(cot)).sum(),
                             [tin[i] for i in grad], allow_unused=True)
    for i, g, want in zip(grad, tg, jg):
        want = np.asarray(want)
        got = np.zeros_like(want) if g is None else g.numpy()
        rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2))) or 1.0
        np.testing.assert_allclose(got, want, rtol=GRAD_RMS,
                                   atol=GRAD_RMS * rms,
                                   err_msg=f"d/d input {i}")
    return tout


def _boxes(rng, n, lo=0.0, hi=1.0, min_wh=0.05, max_wh=0.4):
    xy = rng.uniform(lo, hi - max_wh * (hi - lo), (n, 2))
    wh = rng.uniform(min_wh, max_wh, (n, 2)) * (hi - lo)
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _pixel_boxes(rng, n, size):
    return _boxes(rng, n, 0.0, float(size), 0.1, 0.5)


# -- box utilities -----------------------------------------------------------
@pytest.mark.parametrize("normalized", [True, False])
def test_iou_similarity(normalized):
    rng = np.random.RandomState(0)
    x = _boxes(rng, 5) * (1 if normalized else 50)
    y = _boxes(rng, 7) * (1 if normalized else 50)
    y[3] = x[2]  # an identical pair
    fwd_bwd(lambda a, b: JF.iou_similarity(a, b, normalized),
            lambda a, b: TF.iou_similarity(a, b, normalized), [x, y],
            grad=(0, 1))
    # batched
    xb = np.stack([x, x[::-1]])
    yb = np.stack([y, y[::-1]])
    fwd_bwd(lambda a, b: JF.iou_similarity(a, b, normalized),
            lambda a, b: TF.iou_similarity(a, b, normalized), [xb, yb],
            grad=())


BOX_CODER = {
    "encode_vec": ("encode_center_size", "vec", 0, True),
    "encode_rows": ("encode_center_size", "rows", 0, True),
    "encode_none_pixel": ("encode_center_size", None, 0, False),
    "decode_axis0": ("decode_center_size", "vec", 0, True),
    "decode_axis0_rows": ("decode_center_size", "rows", 0, True),
    "decode_axis1_rows": ("decode_center_size", "rows", 1, True),
    "decode_pixel": ("decode_center_size", "vec", 1, False),
}


@pytest.mark.parametrize("case", list(BOX_CODER))
def test_box_coder(case):
    code, var, axis, normalized = BOX_CODER[case]
    rng = np.random.RandomState(1)
    P, M = 6, 4
    prior = _boxes(rng, P) * (1 if normalized else 40)
    if var == "vec":
        v = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
    elif var == "rows":
        v = rng.uniform(0.1, 0.3, ((M if axis == 1 else P), 4)).astype(
            np.float32)
    else:
        v = None
    if code == "encode_center_size":
        target = _boxes(rng, M) * (1 if normalized else 40)
    elif axis == 0:
        target = (rng.randn(M, P, 4) * 0.3).astype(np.float32)
    else:
        prior = _boxes(rng, M) * (1 if normalized else 40)
        target = (rng.randn(M, P, 4) * 0.3).astype(np.float32)
    arrays = [prior, target] + ([v] if v is not None else [])

    def call(F):
        return lambda p, t, *vv: F.box_coder(
            p, vv[0] if vv else None, t, code_type=code,
            box_normalized=normalized, axis=axis)

    fwd_bwd(call(JF), call(TF), arrays, grad=(0, 1))


def test_box_clip():
    rng = np.random.RandomState(2)
    boxes = (rng.uniform(-20, 120, (2, 6, 4))).astype(np.float32)
    info = np.array([[100, 80, 1.0], [150, 90, 1.5]], np.float32)
    fwd_bwd(JF.box_clip, TF.box_clip, [boxes, info], grad=(0,))


ANCHORS = {
    "rpn": dict(anchor_sizes=[32.0, 64.0, 128.0], aspect_ratios=[0.5, 1.0,
                                                                 2.0]),
    # base extents that round: sqrt(81 / 0.32) = 15.9 → 16, 16·0.32 → 5
    "rounded": dict(anchor_sizes=[24.0], aspect_ratios=[0.32, 2.0, 0.125],
                    stride=[9.0, 9.0], offset=0.3),
}


@pytest.mark.parametrize("case", list(ANCHORS))
def test_anchor_generator(case):
    x = np.zeros((1, 3, 5, 7), np.float32)
    fwd_bwd(lambda a: JF.anchor_generator(a, **ANCHORS[case]),
            lambda a: TF.anchor_generator(a, **ANCHORS[case]), [x], grad=())


def test_anchor_generator_rounds_half_away_from_zero():
    # base_w = sqrt(sw·sh / ar) exactly 12.5 → 13 (Python's round gives 12)
    sw = 12.5
    anc, _ = TF.anchor_generator(torch.zeros(1, 1, 1, 1), [sw],
                                 [1.0], stride=[sw, sw], offset=0.0)
    janc, _ = JF.anchor_generator(np.zeros((1, 1, 1, 1)), [sw], [1.0],
                                  stride=[sw, sw], offset=0.0)
    np.testing.assert_allclose(anc.numpy(), np.asarray(janc), **TOL)
    assert float(anc[0, 0, 0, 2] - anc[0, 0, 0, 0]) == 12.0  # 13 - 1


PRIOR_BOX = {
    "ssd_first": dict(min_sizes=[30.0], max_sizes=[60.0],
                      aspect_ratios=[2.0], flip=True, clip=True),
    "mmaro": dict(min_sizes=[20.0, 40.0], max_sizes=[50.0, 80.0],
                  aspect_ratios=[2.0, 3.0], flip=True,
                  min_max_aspect_ratios_order=True),
    "steps_offset": dict(min_sizes=[16.0], aspect_ratios=[1.0, 0.5],
                         steps=[8.0, 10.0], offset=0.25),
}


@pytest.mark.parametrize("case", list(PRIOR_BOX))
def test_prior_box(case):
    feat = np.zeros((1, 8, 5, 6), np.float32)
    img = np.zeros((1, 3, 60, 72), np.float32)
    fwd_bwd(lambda f, i: JF.prior_box(f, i, **PRIOR_BOX[case]),
            lambda f, i: TF.prior_box(f, i, **PRIOR_BOX[case]), [feat, img],
            grad=())


@pytest.mark.parametrize("flatten", [False, True])
def test_density_prior_box(flatten):
    feat = np.zeros((1, 8, 4, 5), np.float32)
    img = np.zeros((1, 3, 64, 80), np.float32)
    kw = dict(densities=[4, 2], fixed_sizes=[32.0, 64.0],
              fixed_ratios=[1.0, 2.0], clip=True, flatten_to_2d=flatten)
    fwd_bwd(lambda f, i: JF.density_prior_box(f, i, **kw),
            lambda f, i: TF.density_prior_box(f, i, **kw), [feat, img],
            grad=())


# -- SSD matching --------------------------------------------------------------
@pytest.mark.parametrize("match_type", ["bipartite", "per_prediction"])
def test_bipartite_match_with_ties(match_type):
    rng = np.random.RandomState(3)
    dist = rng.uniform(0, 1, (2, 4, 9)).astype(np.float32)
    dist[0, 1, 3] = dist[0, 2, 3] = dist[0, 0, 5] = 0.99  # a 3-way tie
    dist[1, :, 2] = 0.97                               # a tied column
    dist[1, 3, :] = 0.0                                # a padding gt row
    dist[0, 0, 0] = 1e-7                               # below eps
    fwd_bwd(lambda d: JF.bipartite_match(d, match_type, 0.4),
            lambda d: TF.bipartite_match(d, match_type, 0.4), [dist],
            grad=())
    fwd_bwd(lambda d: JF.bipartite_match(d, match_type),
            lambda d: TF.bipartite_match(d, match_type), [dist[0]], grad=())


@pytest.mark.parametrize("rank", [3, 4])
def test_target_assign(rank):
    rng = np.random.RandomState(4)
    N, G, P, K = 2, 3, 7, 4
    x = (rng.randn(N, G, K) if rank == 3 else rng.randn(N, G, P, K))
    x = x.astype(np.float32)
    mi = rng.randint(-1, G, (N, P)).astype(np.int32)
    neg = rng.uniform(size=(N, P)) < 0.3
    fwd_bwd(lambda a, m, n: JF.target_assign(a, m, n, mismatch_value=-2),
            lambda a, m, n: TF.target_assign(a, m, n, mismatch_value=-2),
            [x, mi, neg], grad=(0,), pick=lambda o: o[0])


def test_mine_hard_examples_ties_in_index_order():
    rng = np.random.RandomState(5)
    N, P = 2, 12
    loss = rng.uniform(0, 1, (N, P)).astype(np.float32)
    loss[0, [2, 5, 7, 9]] = 0.8      # equal losses: lower index first
    mi = np.full((N, P), -1, np.int32)
    mi[0, [0, 1]] = 0
    mi[1, 4] = 1
    dist = rng.uniform(0, 0.7, (N, P)).astype(np.float32)
    fwd_bwd(lambda a, b, c: jdet.mine_hard_examples(a, b, c, 1.5),
            lambda a, b, c: tdet.mine_hard_examples(a, b, c, 1.5),
            [loss, mi, dist], grad=())


def _ssd_inputs(seed, N=2, G=3, C=5):
    rng = np.random.RandomState(seed)
    feat = np.zeros((1, 4, 4, 4), np.float32)
    img = np.zeros((1, 3, 32, 32), np.float32)
    prior, var = jdet.prior_box(feat, img, [8.0], [16.0], [2.0], flip=True,
                                clip=True)
    prior = np.asarray(prior).reshape(-1, 4)
    P = prior.shape[0]
    loc = (rng.randn(N, P, 4) * 0.2).astype(np.float32)
    conf = rng.randn(N, P, C).astype(np.float32)
    gt = np.zeros((N, G, 4), np.float32)
    gt[0] = _boxes(rng, G)
    gt[1, :2] = _boxes(rng, 2)             # one padding row
    lab = rng.randint(1, C, (N, G, 1)).astype(np.int64)
    return loc, conf, gt, lab, prior, np.asarray(var).reshape(-1, 4)


@pytest.mark.parametrize("normalize", [True, False])
def test_ssd_loss(normalize):
    loc, conf, gt, lab, prior, var = _ssd_inputs(6)

    def call(F):
        return lambda l, c, g, b, p, v: F.ssd_loss(
            l, c, g, b, p, v, normalize=normalize)

    fwd_bwd(call(JF), call(TF), [loc, conf, gt, lab, prior, var],
            grad=(0, 1))


# -- the NMS family -----------------------------------------------------------
def _nms_inputs(seed, M=40, ties=True):
    rng = np.random.RandomState(seed)
    boxes = _boxes(rng, M, max_wh=0.3)
    boxes[M // 2:] = boxes[:M - M // 2] + rng.uniform(
        -0.02, 0.02, (M - M // 2, 4)).astype(np.float32)   # overlaps
    scores = rng.uniform(0, 1, M).astype(np.float32)
    if ties:
        scores[[3, 8, 11, M - 10]] = 0.75
        scores[[5, M // 2 + 3]] = scores[6]
    return boxes, scores


NMS = {
    "default": dict(),
    "threshold_topk": dict(score_threshold=0.3, nms_top_k=25,
                           nms_threshold=0.5),
    "eta_decay": dict(nms_threshold=0.9, nms_eta=0.7),
    "pixel": dict(nms_threshold=0.45, normalized=False),
}


@pytest.mark.parametrize("case", list(NMS))
def test_nms(case):
    boxes, scores = _nms_inputs(7)
    if not NMS[case].get("normalized", True):
        boxes = boxes * 100
    kw = NMS[case]
    fwd_bwd(lambda b, s: jdet.nms(b, s, **kw),
            lambda b, s: tdet.nms(b, s, **kw), [boxes, scores], grad=())


def test_nms_sweep_ref_against_the_loop():
    """The plain sweep on the IoU matrix JAX builds, eta decaying below
    the 0.5 floor's check, -inf padding at the tail."""
    boxes, scores = _nms_inputs(8, M=30)
    order = np.argsort(-scores, kind="stable")
    s = scores[order].copy()
    s[-5:] = -np.inf
    iou = np.array(JF.iou_similarity(boxes[order], boxes[order]))
    for thr, eta in ((0.3, 1.0), (0.95, 0.8), (0.6, 0.99)):
        keep = nms_sweep_ref(torch.from_numpy(iou)[None],
                             torch.from_numpy(s)[None], thr, eta)[0]
        # JAX's fori_loop body over the same matrix
        want, t = [], np.float32(thr)
        for i in range(len(s)):
            sup = any(want[j] and iou[i, j] > t for j in range(i))
            ok = (not sup) and np.isfinite(s[i])
            want.append(ok)
            if ok and eta < 1.0 and t > 0.5:
                t = np.float32(t * np.float32(eta))
        np.testing.assert_array_equal(keep.numpy(), np.array(want))


MULTICLASS = {
    "bg0_keep10": dict(score_threshold=0.2, nms_top_k=15, keep_top_k=10,
                       background_label=0),
    "no_bg_all": dict(score_threshold=0.0, nms_top_k=-1, keep_top_k=-1,
                      background_label=-1, nms_threshold=0.5),
    "eta": dict(score_threshold=0.1, nms_top_k=20, keep_top_k=30,
                nms_threshold=0.8, nms_eta=0.8),
}


@pytest.mark.parametrize("case", list(MULTICLASS))
def test_multiclass_nms(case):
    rng = np.random.RandomState(9)
    N, C, M = 2, 4, 20
    boxes = np.stack([_nms_inputs(10 + n, M)[0] for n in range(N)])
    scores = rng.uniform(0, 1, (N, C, M)).astype(np.float32)
    scores[0, 1, [2, 7]] = scores[0, 2, 4] = 0.9     # ties across classes
    kw = MULTICLASS[case]
    fwd_bwd(lambda b, s: JF.multiclass_nms(b, s, return_num=True, **kw),
            lambda b, s: TF.multiclass_nms(b, s, return_num=True, **kw),
            [boxes, scores], grad=(1,), pick=lambda o: o[0])


@pytest.mark.parametrize("gaussian", [False, True])
def test_matrix_nms(gaussian):
    rng = np.random.RandomState(11)
    N, C, M = 2, 3, 16
    boxes = np.stack([_nms_inputs(20 + n, M, ties=False)[0]
                      for n in range(N)])
    scores = rng.uniform(0, 1, (N, C, M)).astype(np.float32)
    kw = dict(score_threshold=0.1, post_threshold=0.05, nms_top_k=12,
              keep_top_k=20, use_gaussian=gaussian, return_index=True,
              return_rois_num=True)
    fwd_bwd(lambda b, s: JF.matrix_nms(b, s, **kw),
            lambda b, s: TF.matrix_nms(b, s, **kw), [boxes, scores],
            grad=(0, 1), pick=lambda o: o[0])


def test_locality_aware_nms():
    rng = np.random.RandomState(12)
    N, M = 2, 14
    base = _boxes(rng, 5, max_wh=0.25)
    boxes = np.stack([np.concatenate([
        np.repeat(base, 3, 0)[:M - 1] + rng.uniform(-0.01, 0.01, (M - 1, 4)),
        _boxes(rng, 1)]).astype(np.float32) for _ in range(N)])
    scores = rng.uniform(0.1, 1, (N, 1, M)).astype(np.float32)
    kw = dict(score_threshold=0.2, nms_top_k=-1, keep_top_k=8,
              nms_threshold=0.4)
    fwd_bwd(lambda b, s: JF.locality_aware_nms(b, s, **kw),
            lambda b, s: TF.locality_aware_nms(b, s, **kw),
            [boxes, scores], grad=())


def test_detection_output():
    loc, conf, _, _, prior, var = _ssd_inputs(13)
    kw = dict(nms_threshold=0.45, nms_top_k=30, keep_top_k=12,
              score_threshold=0.15, return_index=True)
    fwd_bwd(lambda l, c, p, v: JF.detection_output(l, c, p, v, **kw),
            lambda l, c, p, v: TF.detection_output(l, c, p, v, **kw),
            [loc, conf, prior, var], grad=(0, 1), pick=lambda o: o[0])


# -- proposals -----------------------------------------------------------------
def _rpn_outputs(seed, N=2, A=3, H=6, W=7, IM=96):
    rng = np.random.RandomState(seed)
    anchors, var = jdet.anchor_generator(
        np.zeros((N, 4, H, W), np.float32), [16.0, 32.0, 48.0][:A], [1.0],
        stride=[16.0, 16.0])
    scores = rng.uniform(0, 1, (N, A, H, W)).astype(np.float32)
    scores[0, 0, 0, :4] = 0.5                    # ties in the pre-NMS top-k
    deltas = (rng.randn(N, 4 * A, H, W) * 0.3).astype(np.float32)
    info = np.array([[IM, IM + 16, 1.0], [IM - 8, IM, 0.8]],
                    np.float32)[:N]
    return scores, deltas, info, np.asarray(anchors), np.asarray(var)


PROPOSALS = {
    "default": dict(pre_nms_top_n=60, post_nms_top_n=20, nms_thresh=0.5),
    "eta_minsize": dict(pre_nms_top_n=80, post_nms_top_n=30,
                        nms_thresh=0.9, eta=0.8, min_size=12.0),
    "all": dict(pre_nms_top_n=-1, post_nms_top_n=-1, nms_thresh=0.7,
                min_size=0.0),
}


@pytest.mark.parametrize("case", list(PROPOSALS))
def test_generate_proposals(case):
    arrays = list(_rpn_outputs(14))
    kw = PROPOSALS[case]
    fwd_bwd(lambda *a: JF.generate_proposals(*a, return_rois_num=True, **kw),
            lambda *a: TF.generate_proposals(*a, return_rois_num=True, **kw),
            arrays, grad=())


def test_distribute_and_collect_fpn_proposals():
    scores, deltas, info, anchors, var = _rpn_outputs(15)
    rois, probs, nums = jax.jit(lambda *a: JF.generate_proposals(
        *a, pre_nms_top_n=60, post_nms_top_n=20, return_rois_num=True))(
        scores, deltas, info, anchors, var)
    rois, probs, nums = (np.asarray(rois), np.asarray(probs),
                         np.asarray(nums))
    for args in ((rois, nums),                                # blocks
                 (rois.reshape(-1, 4)[:25], np.array([25])),  # packed
                 (rois.reshape(-1, 4), None)):
        fwd_bwd(lambda r, *n: JF.distribute_fpn_proposals(
                    r, 2, 5, 4, 24, rois_num=n[0] if n else None),
                lambda r, *n: TF.distribute_fpn_proposals(
                    r, 2, 5, 4, 24, rois_num=n[0] if n else None),
                [a for a in args if a is not None], grad=())
    multi, _, counts = jax.jit(lambda r, n: JF.distribute_fpn_proposals(
        r, 2, 5, 4, 24, rois_num=n))(rois, nums)
    sc = [np.random.RandomState(i).uniform(size=m.shape[0]).astype(
        np.float32) for i, m in enumerate(multi)]
    sc[1][:3] = 0.5                                         # ties
    arrays = [np.asarray(m) for m in multi] + sc
    L = len(multi)
    cnt = [np.asarray(c) for c in counts]
    fwd_bwd(lambda *a: JF.collect_fpn_proposals(a[:L], a[L:], 2, 5, 17,
                                                cnt),
            lambda *a: TF.collect_fpn_proposals(a[:L], a[L:], 2, 5, 17,
                                                cnt), arrays, grad=())


def test_box_decoder_and_assign():
    rng = np.random.RandomState(16)
    R, C = 8, 4
    prior = _pixel_boxes(rng, R, 80)
    var = np.array([0.1, 0.1, 0.2, 0.2], np.float32)
    target = (rng.randn(R, C * 4) * 0.5).astype(np.float32)
    target[0, 2] = 9.0                                       # exp clamp
    score = rng.uniform(size=(R, C)).astype(np.float32)
    score[1, 0] = 2.0                                        # bg best
    score[2, 1] = score[2, 3] = 1.5                          # tie
    fwd_bwd(JF.box_decoder_and_assign, TF.box_decoder_and_assign,
            [prior, var, target, score], grad=(0, 2), pick=lambda o: o[1])


# -- the RoI ops ---------------------------------------------------------------
def _roi_inputs(seed, N=2, C=3, H=9, W=11, R=6):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, C, H, W).astype(np.float32)
    rois = _pixel_boxes(rng, R, 2 * W)
    rois[0] = [-6.0, -5.0, 3.0, 4.0]                 # partly outside
    rois[1] = [2 * W - 2, 2 * H - 3, 2 * W + 9, 2 * H + 8]  # mostly outside
    rois[2] = [4.0, 4.0, 4.3, 4.2]                   # under one pixel
    num = np.array([R - 2, 2], np.int32)[:N]
    return x, rois, num


@pytest.mark.parametrize("sampling_ratio", [2, 3])
def test_roi_align(sampling_ratio):
    x, rois, num = _roi_inputs(17)
    kw = dict(pooled_height=3, pooled_width=4, spatial_scale=0.5,
              sampling_ratio=sampling_ratio)
    fwd_bwd(lambda a, r, n: JF.roi_align(a, r, rois_num=n, **kw),
            lambda a, r, n: TF.roi_align(a, r, rois_num=n, **kw),
            [x, rois, num], grad=(0, 1))


def test_roi_align_fixed_grid_warns():
    x, rois, _ = _roi_inputs(18, N=1)
    with pytest.warns(RuntimeWarning, match="fixed 2x2 grid"):
        out = TF.roi_align(torch.from_numpy(x), torch.from_numpy(rois), 2, 2,
                           0.5, sampling_ratio=-1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax.jit(lambda a, r: JF.roi_align(
            a, r, 2, 2, 0.5, sampling_ratio=-1))(x, rois)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    assert tops.roi_align is TF.roi_align


def test_roi_pool():
    x, rois, num = _roi_inputs(19)
    # unique values: a bin's maximum (and its gradient) is one element
    x = (np.random.RandomState(0).permutation(x.size).reshape(x.shape)
         / x.size).astype(np.float32)
    fwd_bwd(lambda a, r, n: JF.roi_pool(a, r, 3, 2, 0.5, rois_num=n),
            lambda a, r, n: TF.roi_pool(a, r, 3, 2, 0.5, rois_num=n),
            [x, rois, num], grad=(0,))


def test_psroi_pool():
    x, rois, num = _roi_inputs(20, C=2 * 3 * 2)
    fwd_bwd(lambda a, r, n: JF.psroi_pool(a, r, 2, 0.5, 3, 2, rois_num=n),
            lambda a, r, n: TF.psroi_pool(a, r, 2, 0.5, 3, 2, rois_num=n),
            [x, rois, num], grad=(0,))


# -- YOLO ----------------------------------------------------------------------
ANCHORS9 = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90, 156,
            198, 373, 326]


def test_yolo_box():
    rng = np.random.RandomState(21)
    cls = 3
    x = rng.randn(2, 3 * (5 + cls), 5, 4).astype(np.float32)
    size = np.array([[160, 128], [150, 140]], np.int32)
    for kw in (dict(clip_bbox=True), dict(clip_bbox=False, scale_x_y=1.2)):
        fwd_bwd(lambda a, s: JF.yolo_box(a, s, ANCHORS9[:6], cls, 0.4, 32,
                                         **kw),
                lambda a, s: TF.yolo_box(a, s, ANCHORS9[:6], cls, 0.4, 32,
                                         **kw), [x, size], grad=(0,),
                pick=lambda o: o[0] + 0.1 * o[1].sum(-1, keepdims=True))


@pytest.mark.parametrize("smooth,mixup", [(True, False), (False, True)])
def test_yolov3_loss(smooth, mixup):
    rng = np.random.RandomState(22)
    N, B, cls, H = 2, 6, 4, 8
    mask = [3, 4, 5]
    x = (rng.randn(N, 3 * (5 + cls), H, H) * 0.5).astype(np.float32)
    gt = np.zeros((N, B, 4), np.float32)
    gt[:, :5, :2] = rng.uniform(0.1, 0.9, (N, 5, 2))
    gt[:, :5, 2:] = rng.uniform(0.05, 0.5, (N, 5, 2))
    gt[0, 4] = gt[0, 3]                               # two GTs, one cell
    lab = rng.randint(0, cls, (N, B)).astype(np.int32)
    score = rng.uniform(0.5, 1, (N, B)).astype(np.float32)
    arrays = [x, gt, lab] + ([score] if mixup else [])

    def call(F):
        return lambda a, g, l, *s: F.yolov3_loss(
            a, g, l, ANCHORS9, mask, cls, 0.5, 32,
            gt_score=s[0] if s else None, use_label_smooth=smooth)

    fwd_bwd(call(JF), call(TF), arrays, grad=(0,))


def test_vision_ops_names():
    import paddle_tpu.vision.ops as jops

    for name in jops.__all__:
        if name == "MultiBoxHead":
            continue
        assert getattr(tops, name) is getattr(TF, name), name
    assert TF.sigmoid_focal_loss is tdet.sigmoid_focal_loss
