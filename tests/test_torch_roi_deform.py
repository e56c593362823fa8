"""The port's RoI long-tail ops (``nn.functional.roi_extra``) and
deformable convolution (``nn.functional.deform_conv``) against the JAX
package's, forward and backward (``jax.grad`` vs autograd of ``Σ out ·
c``): float32 outputs at rtol / atol 1e-5, gradients within 1e-4 of
JAX's rms.
"""
import numpy as np
import pytest

from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.nn import functional as TF
from test_torch_detection import fwd_bwd

def _feat(seed, N=2, C=4, H=10, W=12):
    return np.random.RandomState(seed).randn(N, C, H, W).astype(np.float32)


def _rois(seed, R=5, size=20.0):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-2, size * 0.6, (R, 2))
    wh = rng.uniform(2, size * 0.5, (R, 2))
    r = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    r[0] = [3.0, 3.0, 3.0, 7.0]          # zero width
    return r


@pytest.mark.parametrize("scale", [0.5, 1.0])
def test_prroi_pool(scale):
    x, rois = _feat(0), _rois(1)
    num = np.array([3, 2], np.int32)
    fwd_bwd(lambda a, r, n: JF.prroi_pool(a, r, scale, 3, 2,
                                          batch_roi_nums=n),
            lambda a, r, n: TF.prroi_pool(a, r, scale, 3, 2,
                                          batch_roi_nums=n),
            [x, rois, num], grad=(0, 1))


DEFORMABLE = {
    "trans": dict(no_trans=False, part_size=(3, 3), sample_per_part=2,
                  trans_std=0.2),
    "no_trans": dict(no_trans=True, sample_per_part=3),
    "position_sensitive": dict(no_trans=False, position_sensitive=True,
                               group_size=(3, 3), sample_per_part=2),
}


@pytest.mark.parametrize("case", list(DEFORMABLE))
def test_deformable_roi_pooling(case):
    kw = DEFORMABLE[case]
    C = 18 if kw.get("position_sensitive") else 4
    x, rois = _feat(2, C=C), _rois(3)
    num = np.array([2, 3], np.int32)
    ncls = 2
    trans = (np.random.RandomState(4).randn(len(rois), 2 * ncls, 3, 3)
             * 0.5).astype(np.float32)
    fwd_bwd(lambda a, r, t, n: JF.deformable_roi_pooling(
                a, r, t, spatial_scale=0.5, pooled_height=3,
                pooled_width=3, rois_num=n, **kw),
            lambda a, r, t, n: TF.deformable_roi_pooling(
                a, r, t, spatial_scale=0.5, pooled_height=3,
                pooled_width=3, rois_num=n, **kw),
            [x, rois, trans, num], grad=(0, 2))


def test_roi_perspective_transform():
    x = _feat(5)
    rois = np.array([[1, 1, 9, 2, 10, 8, 2, 7],        # a quadrilateral
                     [3, 3, 7, 3, 7, 7, 3, 7],          # a square
                     [0, 0, 20, 0, 20, 4, 0, 4],        # past the map
                     [2, 5, 6, 1, 10, 5, 6, 9]],        # a diamond
                    np.float32)
    num = np.array([2, 2], np.int32)
    fwd_bwd(lambda a, r, n: JF.roi_perspective_transform(a, r, 5, 6, 1.0,
                                                         rois_num=n),
            lambda a, r, n: TF.roi_perspective_transform(a, r, 5, 6, 1.0,
                                                         rois_num=n),
            [x, rois, num], grad=(0,), pick=lambda o: o[0])


def test_polygon_box_transform():
    x = _feat(6, C=8)
    fwd_bwd(JF.polygon_box_transform, TF.polygon_box_transform, [x])


DCN = {
    "v1": dict(mask=False, stride=1, padding=1, dilation=1, dg=1, groups=1),
    "v2_stride_dilation": dict(mask=True, stride=2, padding=2, dilation=2,
                               dg=1, groups=1),
    "v2_groups_dg": dict(mask=True, stride=1, padding=1, dilation=1, dg=2,
                         groups=2),
}


@pytest.mark.parametrize("case", list(DCN))
def test_deform_conv2d(case):
    c = DCN[case]
    rng = np.random.RandomState(7)
    N, Cin, H, W, Cout, k = 2, 8, 9, 11, 6, 3
    s, p, d, dg, g = c["stride"], c["padding"], c["dilation"], c["dg"], \
        c["groups"]
    Ho = (H + 2 * p - d * (k - 1) - 1) // s + 1
    Wo = (W + 2 * p - d * (k - 1) - 1) // s + 1
    x = rng.randn(N, Cin, H, W).astype(np.float32)
    off = (rng.randn(N, 2 * dg * k * k, Ho, Wo) * 1.5).astype(np.float32)
    off[0, 0, 0, 0] = -5.0                  # a sample far outside the map
    w = (rng.randn(Cout, Cin // g, k, k) * 0.2).astype(np.float32)
    b = rng.randn(Cout).astype(np.float32)
    arrays = [x, off, w, b]
    if c["mask"]:
        arrays.append(rng.uniform(0, 1, (N, dg * k * k, Ho, Wo)).astype(
            np.float32))

    def call(F):
        return lambda xx, oo, ww, bb, *m: F.deform_conv2d(
            xx, oo, ww, bb, stride=s, padding=p, dilation=d,
            deformable_groups=dg, groups=g, mask=m[0] if m else None)

    fwd_bwd(call(JF), call(TF), arrays, grad=tuple(range(len(arrays))))
