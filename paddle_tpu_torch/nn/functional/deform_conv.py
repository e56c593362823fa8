"""Deformable convolution v1 / v2 (DCN) — port of
``paddle_tpu.nn.functional.deform_conv``.

The sampling points are the regular taps displaced by learned per-position
offsets, read by bilinear interpolation with zero padding outside the map
(a corner outside contributes nothing, dmcn_im2col_bilinear), optionally
scaled by a learned modulation mask (v2).  The im2col + GEMM structure is
kept: each corner gathers whole channel rows of the NHWC map at once (one
row a sample and deformable group), the four corners' weighted rows make
the columns ``[N·Ho·Wo, K, Cin]``, and one product with the filter
contracts taps and channels.

Offset layout as the reference kernel: ``[N, 2·dg·K, Ho, Wo]`` with (h, w)
interleaved per tap; mask ``[N, dg·K, Ho, Wo]``.
"""
from __future__ import annotations

import torch

from ...framework.errors import InvalidArgumentError
from ...tensor._common import t as _t

__all__ = ["deform_conv2d"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """x ``[N, Cin, H, W]``, offset ``[N, 2·dg·K, Ho, Wo]``, weight
    ``[Cout, Cin/groups, kh, kw]``, mask ``[N, dg·K, Ho, Wo]`` (None:
    DCN v1) → ``[N, Cout, Ho, Wo]``.  Differentiable in x, offset, mask,
    weight and bias."""
    x = _t(x)
    offset = _t(offset, x).to(x.dtype)
    weight = _t(weight, x).to(x.dtype)
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    N, Cin, H, W = x.shape
    Cout, Cin_g, kh, kw = weight.shape
    K = kh * kw
    dg = int(deformable_groups)
    if Cin % dg or Cin_g * groups != Cin:
        raise InvalidArgumentError(
            f"channel split mismatch: Cin={Cin}, groups={groups}, "
            f"weight Cin/groups={Cin_g}, deformable_groups={dg}")
    Ho, Wo = offset.shape[2], offset.shape[3]
    if offset.shape[1] != 2 * dg * K:
        raise InvalidArgumentError(
            f"offset channels {offset.shape[1]} != 2·dg·K = {2 * dg * K}")
    want_ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    want_wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    if (Ho, Wo) != (want_ho, want_wo):
        raise InvalidArgumentError(
            f"offset spatial dims {(Ho, Wo)} don't match the conv output "
            f"{(want_ho, want_wo)} for input {(H, W)}, kernel "
            f"{(kh, kw)}, stride {(sh, sw)}, padding {(ph, pw)}, "
            f"dilation {(dh, dw)} — the offset head must run at the "
            f"output resolution")
    dev, dt = x.device, x.dtype
    ki = torch.arange(kh, device=dev).repeat_interleave(kw)    # [K]
    kj = torch.arange(kw, device=dev).repeat(kh)
    # sample positions [N, Ho, Wo, dg, K]
    off = offset.reshape(N, dg, K, 2, Ho, Wo).permute(0, 4, 5, 1, 2, 3)
    base_h = (torch.arange(Ho, device=dev) * sh - ph)[:, None, None, None] \
        + (ki * dh)[None, None, None, :]                        # [Ho,1,1,K]
    base_w = (torch.arange(Wo, device=dev) * sw - pw)[None, :, None, None] \
        + (kj * dw)[None, None, None, :]                        # [1,Wo,1,K]
    y = base_h.to(dt) + off[..., 0]
    xw = base_w.to(dt) + off[..., 1]
    y0 = torch.floor(y)
    x0 = torch.floor(xw)
    ly = y - y0
    lx = xw - x0
    rep = Cin // dg
    # rows of the NHWC map split by deformable group: [N·H·W·dg, Cin/dg]
    rows = x.permute(0, 2, 3, 1).reshape(N * H * W * dg, rep)
    img = torch.arange(N, device=dev)[:, None, None, None, None] * (H * W)
    grp = torch.arange(dg, device=dev)[None, None, None, :, None]
    cols = None
    for ddy, ddx, wgt in ((0, 0, (1 - ly) * (1 - lx)), (0, 1, (1 - ly) * lx),
                          (1, 0, ly * (1 - lx)), (1, 1, ly * lx)):
        yc = y0 + ddy
        xc = x0 + ddx
        ok = (yc >= 0) & (yc < H) & (xc >= 0) & (xc < W)
        pos = (yc.clamp(0, H - 1) * W + xc.clamp(0, W - 1)).long()
        r = ((img + pos) * dg + grp).reshape(-1)
        v = rows.index_select(0, r).reshape(N, Ho, Wo, dg, K, rep)
        term = v * torch.where(ok, wgt, torch.zeros((), dtype=dt,
                                                    device=dev))[..., None]
        cols = term if cols is None else cols + term
    if mask is not None:
        m = _t(mask, x).to(dt).reshape(N, dg, K, Ho, Wo).permute(
            0, 3, 4, 1, 2)
        cols = cols * m[..., None]
    # [N·Ho·Wo, K, Cin] (channel c = group · rep + c') x weight
    cols = cols.permute(0, 1, 2, 4, 3, 5).reshape(N * Ho * Wo, K, groups,
                                                  Cin_g)
    wf = weight.reshape(groups, Cout // groups, Cin_g, K)
    out = torch.einsum("lkgc,gock->lgo", cols, wf).reshape(N, Ho, Wo, Cout)
    out = out.permute(0, 3, 1, 2)
    if bias is not None:
        out = out + _t(bias, x).to(dt).reshape(1, -1, 1, 1)
    return out
