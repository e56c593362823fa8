"""The detection slice on the card (``gpu`` marker; skipped without one):
``chip_smoke.py``'s B1 checks at small sizes, held to the port's own CPU
results (this file imports no JAX).

* The greedy-sweep kernel (``ops.nms_sweep``) against its plain loop on
  the same IoU matrix and sorted scores: keep masks equal, with and
  without the ``eta`` decay, -inf padding at the tail, one launch a call.
* ``nms`` / ``multiclass_nms`` / ``generate_proposals`` on the card
  against the CPU on one seeded input: indices and counts equal, boxes
  and scores within 1e-5 (relative to their scale).
* The RoI ops and ``deform_conv2d`` on the card against the CPU, float32
  with TF32 off: outputs and the gradients of ``Σ out · c`` within 1e-4
  of the CPU result's rms (the gathers' backward adds with atomics, in
  another order).

Run on the card: ``python -m pytest -m gpu tests/test_torch_detection_card.py``.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import nms_sweep, nms_sweep_ref

TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the detection ops against the CPU")
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


def _err(got, ref):
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    rms = float(ref.pow(2).mean().sqrt()) or 1.0
    return float((got - ref).abs().max()) / rms


def _boxes(rng, n, size):
    xy = rng.uniform(0, size * 0.8, (n, 2))
    wh = rng.uniform(size * 0.02, size * 0.3, (n, 2))
    return torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(
        np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("eta", [1.0, 0.9])
def test_sweep_kernel_against_the_loop(card, eta):
    rng = np.random.RandomState(0)
    B, k = 3, 700
    boxes = torch.stack([_boxes(rng, k, 100.0) for _ in range(B)])
    scores = torch.from_numpy(rng.uniform(size=(B, k)).astype(np.float32))
    scores[1, -100:] = -float("inf")
    scores[2, 50:60] = 0.5                                 # ties
    s, order = torch.sort(scores, dim=1, descending=True, stable=True)
    sb = torch.gather(boxes, 1, order[..., None].expand(B, k, 4))
    iou = F.iou_similarity(sb, sb, False)
    want = nms_sweep_ref(iou, s, 0.6 if eta == 1.0 else 0.9, eta)
    before = nms_sweep.launches
    got = nms_sweep(iou.to(card), s.to(card), 0.6 if eta == 1.0 else 0.9,
                    eta)
    torch.cuda.synchronize()
    assert nms_sweep.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_nms_family_card_vs_cpu(card):
    rng = np.random.RandomState(1)
    N, C, M = 2, 5, 300
    boxes = torch.stack([_boxes(rng, M, 1.0) for _ in range(N)])
    scores = torch.from_numpy(rng.uniform(size=(N, C, M)).astype(np.float32))
    for args, kw in (((boxes[0], scores[0, 0]), dict(nms_threshold=0.5,
                                                    nms_eta=0.8)),):
        want = F.nms(*args, **kw)
        got = F.nms(*[a.to(card) for a in args], **kw)
        assert torch.equal(got.cpu(), want)
    kw = dict(score_threshold=0.05, nms_top_k=200, keep_top_k=50,
              nms_threshold=0.5, return_num=True)
    want = F.multiclass_nms(boxes, scores, **kw)
    got = F.multiclass_nms(boxes.to(card), scores.to(card), **kw)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.allclose(got[0].cpu(), want[0], rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_generate_proposals_card_vs_cpu(card):
    rng = np.random.RandomState(2)
    N, A, H, W = 2, 15, 12, 16
    anchors, var = F.anchor_generator(
        torch.zeros(1, 1, H, W), [32.0, 64.0, 128.0, 256.0, 512.0],
        [0.5, 1.0, 2.0], stride=[16.0, 16.0])
    scores = torch.from_numpy(rng.uniform(size=(N, A, H, W)).astype(
        np.float32))
    deltas = torch.from_numpy((rng.randn(N, 4 * A, H, W) * 0.2).astype(
        np.float32))
    info = torch.tensor([[192.0, 256.0, 1.0], [180.0, 250.0, 1.0]])
    kw = dict(pre_nms_top_n=1200, post_nms_top_n=300, nms_thresh=0.7,
              min_size=0.0, return_rois_num=True)
    want = F.generate_proposals(scores, deltas, info, anchors, var, **kw)
    got = F.generate_proposals(*[t.to(card) for t in (scores, deltas, info,
                                                      anchors, var)], **kw)
    assert torch.equal(got[2].cpu(), want[2])
    assert torch.allclose(got[0].cpu(), want[0], rtol=1e-5, atol=1e-3)
    assert torch.equal(got[1].cpu(), want[1])


def _pair(card, fn, arrays, grad):
    """fn on the CPU and on the card: output and gradients within TOL."""
    cpu = [a.clone().requires_grad_(i in grad) for i, a in enumerate(arrays)]
    dev = [a.to(card).requires_grad_(i in grad)
           for i, a in enumerate(arrays)]
    out_c, out_d = fn(*cpu), fn(*dev)
    assert _err(out_d, out_c) < TOL
    cot = torch.from_numpy(np.random.RandomState(9).randn(
        *out_c.shape).astype(np.float32))
    gc = torch.autograd.grad((out_c * cot).sum(), [cpu[i] for i in grad])
    gd = torch.autograd.grad((out_d * cot.to(card)).sum(),
                             [dev[i] for i in grad])
    for a, b in zip(gd, gc):
        assert _err(a, b) < TOL


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["roi_align", "roi_pool", "psroi_pool"])
def test_roi_ops_card_vs_cpu(card, op):
    rng = np.random.RandomState(3)
    C = 32 if op != "psroi_pool" else 8 * 4 * 4
    x = torch.from_numpy(rng.permutation(2 * C * 20 * 24).reshape(
        2, C, 20, 24).astype(np.float32) / 1000.0)
    rois = _boxes(rng, 64, 320.0)
    num = torch.tensor([40, 24])
    fns = {
        "roi_align": lambda a, r: F.roi_align(a, r, 7, 7, 1 / 16, 2,
                                              rois_num=num),
        "roi_pool": lambda a, r: F.roi_pool(a, r, 7, 7, 1 / 16,
                                            rois_num=num),
        "psroi_pool": lambda a, r: F.psroi_pool(a, r, 8, 1 / 16, 4, 4,
                                                rois_num=num)}
    _pair(card, fns[op], [x, rois], grad=(0, 1) if op == "roi_align"
          else (0,))


@pytest.mark.gpu
@pytest.mark.parametrize("modulated", [False, True])
def test_deform_conv2d_card_vs_cpu(card, modulated):
    rng = np.random.RandomState(4)
    N, Cin, H, W, Cout = 2, 16, 12, 14, 8
    arrays = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.randn(N, Cin, H, W), rng.randn(N, 18, H, W) * 2.0,
        rng.randn(Cout, Cin, 3, 3) * 0.1, rng.uniform(size=(N, 9, H, W)))]
    if not modulated:
        arrays = arrays[:3]
    _pair(card, lambda x, o, w, *m: F.deform_conv2d(
        x, o, w, padding=1, mask=m[0] if m else None), arrays,
        grad=tuple(range(len(arrays))))
