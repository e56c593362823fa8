"""RoI long-tail ops — port of ``paddle_tpu.nn.functional.roi_extra``:
precise and deformable RoI pooling, the perspective transform and EAST's
geometry decode.

PrRoI's exact bilinear integral is two separable weight matrices and one
einsum per RoI, every RoI at once; the sampling ops use the clamped
bilinear gather of deformable PS-RoI pooling.  ``rois_num`` per-image
counts follow :mod:`.detection`'s dense-LoD convention.
"""
from __future__ import annotations

import torch

from ...framework.errors import InvalidArgumentError
from ...tensor._common import t as _t
from .detection import _div, _roi_batch_ids

__all__ = ["prroi_pool", "deformable_roi_pooling",
           "roi_perspective_transform", "polygon_box_transform"]


def _hat_integral(p, a, b):
    """∫_a^b max(0, 1 - |x - p|) dx for pixel centers p over windows
    [a, b] (broadcast) — the exact bilinear integral of PrRoI pooling."""
    def anti(u):
        u = torch.clamp(u, -1.0, 1.0)
        neg = 0.5 * (u + 1.0) ** 2
        pos = 0.5 + u - 0.5 * u * u
        return torch.where(u <= 0, neg, pos)

    return anti(b - p) - anti(a - p)


def prroi_pool(input, rois, spatial_scale=1.0, pooled_height=1,
               pooled_width=1, batch_roi_nums=None, name=None):
    """Precise RoI pooling: each bin is the exact integral of the
    bilinearly interpolated feature over the bin divided by its area,
    differentiable in the RoI coordinates too.  input ``[N, C, H, W]``,
    rois ``[R, 4]`` → ``[R, C, PH, PW]``."""
    x = _t(input)
    rois = _t(rois, x).to(torch.float32)
    N, C, H, W = x.shape
    R = rois.shape[0]
    PH, PW = int(pooled_height), int(pooled_width)
    dev = x.device
    bid = _roi_batch_ids(batch_roi_nums, R, dev)
    py = torch.arange(H, dtype=torch.float32, device=dev)
    px = torch.arange(W, dtype=torch.float32, device=dev)
    x0, y0, x1, y1 = (rois * spatial_scale).unbind(1)
    bw = _div(torch.clamp_min(x1 - x0, 0.0), PW)
    bh = _div(torch.clamp_min(y1 - y0, 0.0), PH)
    win = bw * bh
    ys = y0[:, None] + torch.arange(PH, dtype=torch.float32,
                                    device=dev) * bh[:, None]   # [R, PH]
    xs = x0[:, None] + torch.arange(PW, dtype=torch.float32,
                                    device=dev) * bw[:, None]   # [R, PW]
    Wy = _hat_integral(py, ys[..., None], (ys + bh[:, None])[..., None])
    Wx = _hat_integral(px, xs[..., None], (xs + bw[:, None])[..., None])
    feat = x[bid].to(torch.float32)                              # [R, C, H, W]
    out = torch.einsum("rph,rqw,rchw->rcpq", Wy, Wx, feat)
    out = torch.where(win[:, None, None, None] > 0,
                      out / torch.clamp_min(win, 1e-12)[:, None, None, None],
                      torch.zeros((), device=dev))
    return out.to(x.dtype)


def _bilinear_clamped(flat, base, H, W, h, w):
    """Bilinear samples at coordinates already clamped into an ``H x W``
    map (deformable_psroi_pooling_op.h bilinear_interp): ``flat`` is the
    input's elements, ``base`` (broadcast against h / w) the offset of
    each sample's ``[H, W]`` plane in it."""
    h0 = torch.floor(h).long().clamp(0, H - 1)
    w0 = torch.floor(w).long().clamp(0, W - 1)
    h1 = (h0 + 1).clamp(0, H - 1)
    w1 = (w0 + 1).clamp(0, W - 1)
    lh = h - h0
    lw = w - w0

    def at(a, b):
        return flat[base + a * W + b]

    v00, v01, v10, v11 = at(h0, w0), at(h0, w1), at(h1, w0), at(h1, w1)
    top = v00 + (v01 - v00) * lw
    bot = v10 + (v11 - v10) * lw
    return top + (bot - top) * lh


def deformable_roi_pooling(input, rois, trans, no_trans=False,
                           spatial_scale=1.0, group_size=(1, 1),
                           pooled_height=1, pooled_width=1, part_size=None,
                           sample_per_part=1, trans_std=0.1,
                           position_sensitive=False, rois_num=None,
                           name=None):
    """Deformable (PS-)RoI pooling: the average of bilinear samples on a
    grid displaced by learned per-part offsets ``trans``.  input
    ``[N, C, H, W]``, rois ``[R, 4]``, trans ``[R, 2·classes, part_h,
    part_w]`` (ignored when ``no_trans``); ``position_sensitive`` divides
    the channels by PH·PW → ``[R, C', PH, PW]``."""
    x = _t(input)
    rois = _t(rois, x).to(torch.float32)
    N, C, H, W = x.shape
    R = rois.shape[0]
    dev = x.device
    PH, PW = int(pooled_height), int(pooled_width)
    gh, gw = int(group_size[0]), int(group_size[1])
    if part_size is None:
        part_h, part_w = PH, PW
    else:
        part_h, part_w = int(part_size[0]), int(part_size[1])
    sp = int(sample_per_part)
    if position_sensitive:
        if C % (PH * PW):
            raise InvalidArgumentError(
                f"position_sensitive: channels {C} not divisible by "
                f"{PH}*{PW}")
        out_dim = C // (PH * PW)
    else:
        if gh != 1 or gw != 1:
            raise InvalidArgumentError(
                "group_size != [1, 1] requires position_sensitive=True "
                "(the channel group indexing is PS-RoI's)")
        out_dim = C
    bid = _roi_batch_ids(rois_num, R, dev)
    if not no_trans:
        trans = _t(trans, x).to(torch.float32)
        num_classes = trans.shape[1] // 2
        channels_each_class = max(out_dim // num_classes, 1)
    else:
        channels_each_class = out_dim

    rr = torch.round(rois)
    x0 = rr[:, 0] * spatial_scale - 0.5
    y0 = rr[:, 1] * spatial_scale - 0.5
    x1 = (rr[:, 2] + 1.0) * spatial_scale - 0.5
    y1 = (rr[:, 3] + 1.0) * spatial_scale - 0.5
    rw = torch.clamp_min(x1 - x0, 0.1)
    rh = torch.clamp_min(y1 - y0, 0.1)
    bw = _div(rw, PW)
    bh = _div(rh, PH)
    sub_w = _div(bw, sp)
    sub_h = _div(bh, sp)

    ct = torch.arange(out_dim, device=dev)                      # ctop
    ph = torch.arange(PH, device=dev)
    pw = torch.arange(PW, device=dev)
    ctg = ct[:, None, None]
    phg = ph[None, :, None]
    pwg = pw[None, None, :]                                     # [D, PH, PW]
    # float64 as the JAX package's int / int (x64)
    part_hi = torch.floor(_div(phg.double(), PH) * part_h).long()
    part_wi = torch.floor(_div(pwg.double(), PW) * part_w).long()
    class_id = ctg // channels_each_class
    shape = (R, out_dim, PH, PW)
    if no_trans:
        tx = torch.zeros(shape, device=dev)
        ty = torch.zeros(shape, device=dev)
    else:
        ar = torch.arange(R, device=dev)[:, None, None, None]
        tx = trans[ar, (2 * class_id)[None], part_hi[None],
                   part_wi[None]] * trans_std
        ty = trans[ar, (2 * class_id + 1)[None], part_hi[None],
                   part_wi[None]] * trans_std
    r4 = (slice(None), None, None, None)
    wstart = pwg * bw[r4] + x0[r4] + tx * rw[r4]                # [R, D, PH, PW]
    hstart = phg * bh[r4] + y0[r4] + ty * rh[r4]
    if position_sensitive:
        g_w = torch.floor(_div((pwg * gw).double(), PW)).long().clamp(
            0, gw - 1)
        g_h = torch.floor(_div((phg * gh).double(), PH)).long().clamp(
            0, gh - 1)
        c = (ctg * gh + g_h) * gw + g_w
    else:
        c = ctg
    c = c.expand(out_dim, PH, PW)
    iw = torch.arange(sp, dtype=torch.float32, device=dev)
    ww = (wstart[..., None] + iw * sub_w[r4 + (None,)])[..., None, :]
    hh = (hstart[..., None] + iw * sub_h[r4 + (None,)])[..., :, None]
    ww, hh = torch.broadcast_tensors(ww, hh)              # [R, D, PH, PW, sp, sp]
    ok = (ww >= -0.5) & (ww <= W - 0.5) & (hh >= -0.5) & (hh <= H - 0.5)
    wc = torch.clamp(ww, 0.0, W - 1.0)
    hc = torch.clamp(hh, 0.0, H - 1.0)
    base = ((bid[r4] * C + c[None]) * (H * W))[..., None, None]
    vals = _bilinear_clamped(x.to(torch.float32).reshape(-1), base, H, W,
                             hc, wc)
    cnt = ok.sum((-2, -1))
    tot = torch.where(ok, vals, torch.zeros((), device=dev)).sum((-2, -1))
    out = torch.where(cnt > 0, tot / torch.clamp_min(cnt, 1),
                      torch.zeros((), device=dev))
    return out.to(x.dtype)


def _transform_matrix(rx, ry, TH, TW):
    """get_transform_matrix (roi_perspective_transform_op.cc:110) for RoI
    corners ``rx / ry [R, 4]`` → ``[R, 9]``."""
    x0, x1, x2, x3 = rx.unbind(1)
    y0, y1, y2, y3 = ry.unbind(1)
    len1 = torch.sqrt((x0 - x1) ** 2 + (y0 - y1) ** 2)
    len2 = torch.sqrt((x1 - x2) ** 2 + (y1 - y2) ** 2)
    len3 = torch.sqrt((x2 - x3) ** 2 + (y2 - y3) ** 2)
    len4 = torch.sqrt((x3 - x0) ** 2 + (y3 - y0) ** 2)
    est_h = (len2 + len4) / 2.0
    est_w = (len1 + len3) / 2.0
    norm_h = float(max(2, TH))
    norm_w = torch.round(est_w * (norm_h - 1)
                         / torch.clamp_min(est_h, 1e-5)) + 1
    norm_w = torch.clamp(norm_w, 2, TW)
    dx1, dx2, dx3 = x1 - x2, x3 - x2, x0 - x1 + x2 - x3
    dy1, dy2, dy3 = y1 - y2, y3 - y2, y0 - y1 + y2 - y3
    den = dx1 * dy2 - dx2 * dy1 + 1e-5
    m6 = (dx3 * dy2 - dx2 * dy3) / den / (norm_w - 1)
    m7 = (dx1 * dy3 - dx3 * dy1) / den / (norm_h - 1)
    m8 = torch.ones_like(m6)
    m3 = (y1 - y0 + m6 * (norm_w - 1) * y1) / (norm_w - 1)
    m4 = (y3 - y0 + m7 * (norm_h - 1) * y3) / (norm_h - 1)
    m0 = (x1 - x0 + m6 * (norm_w - 1) * x1) / (norm_w - 1)
    m1 = (x3 - x0 + m7 * (norm_h - 1) * x3) / (norm_h - 1)
    return torch.stack([m0, m1, x0, m3, m4, y0, m6, m7, m8], dim=1)


def _in_quad(px, py, rx, ry):
    """Point-in-quadrilateral with the kernel's 1e-4 edge tolerance (on-edge
    points count as inside); px / py ``[R, TH, TW]``, rx / ry ``[R, 4]``."""
    on_edge = torch.zeros_like(px, dtype=torch.bool)
    n_cross = torch.zeros_like(px, dtype=torch.int64)
    for i in range(4):
        xs, ys = rx[:, i, None, None], ry[:, i, None, None]
        xe, ye = rx[:, (i + 1) % 4, None, None], ry[:, (i + 1) % 4, None,
                                                    None]
        horiz = (ys - ye).abs() < 1e-4
        on_h = (horiz & ((py - ys).abs() < 1e-4)
                & (px >= torch.minimum(xs, xe) - 1e-4)
                & (px <= torch.maximum(xs, xe) + 1e-4))
        ix = (py - ys) * (xe - xs) / torch.where(
            horiz, torch.ones_like(ye), ye - ys) + xs
        on_e = (~horiz & ((ix - px).abs() < 1e-4)
                & (py >= torch.minimum(ys, ye) - 1e-4)
                & (py <= torch.maximum(ys, ye) + 1e-4))
        on_edge = on_edge | on_h | on_e
        crossing = (~horiz & (py > torch.minimum(ys, ye) + 1e-4)
                    & (py <= torch.maximum(ys, ye) + 1e-4) & (ix > px))
        n_cross = n_cross + crossing.long()
    return on_edge | (n_cross % 2 == 1)


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0,
                              rois_num=None, name=None):
    """Warp quadrilateral RoIs to a fixed rectangle by perspective
    transform.  input ``[N, C, H, W]``, rois ``[R, 8]`` (x1 y1 ... x4 y4,
    clockwise from top-left) → (out ``[R, C, TH, TW]``, mask
    ``[R, 1, TH, TW]`` int32, transform_matrix ``[R, 9]``)."""
    x = _t(input)
    rois = _t(rois, x).to(torch.float32)
    N, C, H, W = x.shape
    R = rois.shape[0]
    dev = x.device
    TH, TW = int(transformed_height), int(transformed_width)
    bid = _roi_batch_ids(rois_num, R, dev)
    rx = rois[:, 0::2] * spatial_scale
    ry = rois[:, 1::2] * spatial_scale
    m = _transform_matrix(rx, ry, TH, TW)
    owg, ohg = torch.meshgrid(torch.arange(TW, dtype=torch.float32,
                                           device=dev),
                              torch.arange(TH, dtype=torch.float32,
                                           device=dev), indexing="xy")
    mm = [m[:, i, None, None] for i in range(9)]
    u = mm[0] * owg + mm[1] * ohg + mm[2]
    v = mm[3] * owg + mm[4] * ohg + mm[5]
    w = mm[6] * owg + mm[7] * ohg + mm[8]
    in_w = u / w
    in_h = v / w
    valid = (_in_quad(in_w, in_h, rx, ry)
             & (in_w > -0.5) & (in_w < W - 0.5)
             & (in_h > -0.5) & (in_h < H - 0.5))            # [R, TH, TW]
    wc = torch.clamp(in_w, 0.0, W - 1.0)
    hc = torch.clamp(in_h, 0.0, H - 1.0)
    base = ((bid[:, None] * C + torch.arange(C, device=dev)[None])
            * (H * W))[..., None, None]
    vals = _bilinear_clamped(x.to(torch.float32).reshape(-1), base, H, W,
                             hc[:, None], wc[:, None])      # [R, C, TH, TW]
    out = torch.where(valid[:, None], vals, torch.zeros((), device=dev))
    return out.to(x.dtype), valid.to(torch.int32)[:, None], m


def polygon_box_transform(input, name=None):
    """EAST geometry decode: per-pixel offsets to absolute quad
    coordinates on the 4x downsampled grid — even channels ``4·w - v``,
    odd channels ``4·h - v``.  input ``[N, G, H, W]`` (G even)."""
    x = _t(input)
    if x.dim() != 4 or x.shape[1] % 2:
        raise InvalidArgumentError(
            f"polygon_box_transform wants [N, 2k, H, W], got "
            f"{tuple(x.shape)}")
    N, G, H, W = x.shape
    wpos = 4.0 * torch.arange(W, dtype=x.dtype, device=x.device)
    hpos = 4.0 * torch.arange(H, dtype=x.dtype, device=x.device)
    even = wpos[None, None, None, :] - x
    odd = hpos[None, None, :, None] - x
    is_even = (torch.arange(G, device=x.device) % 2 == 0)[None, :, None,
                                                          None]
    return torch.where(is_even, even, odd)
