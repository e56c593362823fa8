"""Common functional ops — port of ``paddle_tpu.nn.functional.common``:
``linear``, the dropouts, ``embedding``, ``one_hot``, ``interpolate``, the
pixel and channel shuffles, ``unfold`` / ``fold``, ``sequence_mask``,
``bilinear``, ``affine_grid`` / ``grid_sample`` and ``temporal_shift``,
each with the JAX package's arithmetic and layouts.

``embedding``: the lookup is ``jnp.take``'s: ids in ``[-n, 0)`` wrap to
``id + n``, any other id outside ``[0, n)`` gives a NaN row — on the card
through a clamped gather and a mask, never an out-of-range index (a
device assert).  ``padding_idx`` positions give zeros, and no gradient
reaches the table through them.

The dropouts draw their keep-masks from the generator of the input's
device (``framework.random.generator_for``), never from torch's global
RNG.  ``one_hot`` and ``sequence_mask`` take
int64 ids (the port's integer kind, ROADMAP §C).  ``interpolate``'s
``bicubic`` mode is ``jax.image.resize``'s: the Keys cubic kernel
(a = -0.5) on half-pixel centres, antialiased when it shrinks.
"""
from __future__ import annotations

import numpy as np
import torch

from ...framework.dtype import convert_dtype
from ...framework.errors import InvalidArgumentError
from ...framework.random import generator_for
from ...framework.selected_rows import _ids, take_rows
from ...tensor._common import t as _t
from ...tensor.manipulation import pad  # noqa: F401  (paddle exposes it here)

__all__ = [
    "linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
    "embedding", "one_hot", "interpolate", "upsample", "pixel_shuffle",
    "pixel_unshuffle", "channel_shuffle", "unfold", "fold", "pad",
    "sequence_mask", "bilinear", "affine_grid", "grid_sample",
    "temporal_shift", "npu_identity",
]


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with paddle's ``[in, out]`` weight; the
    output in x's dtype."""
    x = _t(x)
    out = torch.matmul(x, _t(weight, x).to(x.dtype))
    if bias is not None:
        out = out + _t(bias, x).to(out.dtype)
    return out


def _keep_mask(x, p, shape=None):
    """A keep-mask (x's dtype, 1 with probability ``1 - p``) of x's shape,
    or of ``shape`` (broadcast over the other axes)."""
    keep = (torch.empty_like(x) if shape is None
            else torch.empty(shape, dtype=x.dtype, device=x.device))
    return keep.bernoulli_(1.0 - p, generator=generator_for(x.device))


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Parity: ``paddle.nn.functional.dropout``.  ``upscale_in_train``:
    kept elements scaled by ``1 / (1 - p)`` in training, identity in eval;
    ``downscale_in_infer``: kept elements as they are in training, all
    scaled by ``1 - p`` in eval.  ``axis``: the mask varies along those
    axes only."""
    x = _t(x)
    if p == 0.0 or not training:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    shape = None
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [a % x.dim() for a in axes]
        shape = tuple(x.shape[i] if i in axes else 1 for i in range(x.dim()))
    keep = _keep_mask(x, p, shape)
    if mode == "upscale_in_train":
        return x * keep / (1.0 - p)
    return x * keep


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU-preserving dropout: dropped elements take SELU's negative
    saturation, then an affine map restores mean and variance."""
    x = _t(x)
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = _keep_mask(x, p)
    a = 1.0 / ((1 - p) * (1 + p * alpha_p ** 2)) ** 0.5
    b = -a * alpha_p * p
    return (a * torch.where(keep.bool(), x, torch.full_like(x, alpha_p))
            + b).to(x.dtype)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Parity: paddle.nn.functional.embedding.  ``sparse`` is accepted and
    ignored here, as in the JAX package: SelectedRows gradients come from
    ``nn.Embedding(sparse=True)`` inside a sparse-aware train step."""
    ids = _ids(x, weight.device)
    out = take_rows(weight, ids, float("nan"))
    if padding_idx is not None:
        out = out.masked_fill((ids == padding_idx).unsqueeze(-1), 0.0)
    return out


def one_hot(x, num_classes, name=None):
    """float32 one-hot rows; an id outside ``[0, num_classes)`` gives a row
    of zeros (``jax.nn.one_hot``)."""
    x = _t(x)
    classes = torch.arange(num_classes, device=x.device)
    return (x.unsqueeze(-1) == classes).to(torch.float32)


def _resize_nearest(x, out_sizes, start):
    out = x
    for i, n_out in enumerate(out_sizes):
        n_in = x.shape[start + i]
        idx = torch.floor(torch.arange(n_out, dtype=torch.float64)
                          * (n_in / n_out)).long().clamp(0, n_in - 1)
        out = out.index_select(start + i, idx.to(x.device))
    return out


def _resize_linear_1d(x, n_out, axis, align_corners, align_mode):
    n_in = x.shape[axis]
    f64 = torch.float64  # the JAX package computes positions in float64
    if align_corners:
        pos = torch.linspace(0.0, n_in - 1.0, n_out, dtype=f64)
    elif align_mode == 1:
        pos = torch.arange(n_out, dtype=f64) * (n_in / n_out)
    else:
        pos = (torch.arange(n_out, dtype=f64) + 0.5) * (n_in / n_out) - 0.5
    pos = pos.clamp(0.0, n_in - 1.0)
    lo = torch.floor(pos).long()
    hi = (lo + 1).clamp(max=n_in - 1)
    shape = [1] * x.dim()
    shape[axis] = n_out
    w_hi = (pos - lo).to(device=x.device, dtype=x.dtype).reshape(shape)
    x_lo = x.index_select(axis, lo.to(x.device))
    x_hi = x.index_select(axis, hi.to(x.device))
    return x_lo * (1 - w_hi) + x_hi * w_hi


def _cubic_weights(n_in, n_out):
    """``jax.image.resize``'s ``[n_in, n_out]`` bicubic weights (Keys
    kernel, half-pixel centres, antialiased when shrinking), float64."""
    inv = 1.0 / (n_out / n_in)
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / max(inv, 1.0)
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = np.where(x >= 2.0, 0.0, w)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.from_numpy(np.where(inside[None, :], w, 0.0))


def _adaptive_avg(x, out_sizes, start):
    """Adaptive average pooling one axis after another: an even split
    reshapes, an uneven one averages windows ``[floor(i n / o), ceil((i +
    1) n / o))``."""
    out = x
    for i, o in enumerate(out_sizes):
        dim = start + i
        n = out.shape[dim]
        if n % o == 0:
            out = out.reshape(out.shape[:dim] + (o, n // o)
                              + out.shape[dim + 1:]).mean(dim + 1)
            continue
        lo = np.floor(np.arange(o) * n / o).astype(np.int64)
        hi = np.ceil((np.arange(o) + 1) * n / o).astype(np.int64)
        out = torch.cat([out.narrow(dim, int(a), int(b - a)).mean(
            dim, keepdim=True) for a, b in zip(lo, hi)], dim)
    return out


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format=None,
                name=None):
    """Parity: ``paddle.nn.functional.interpolate``: ``nearest``,
    ``linear`` / ``bilinear`` / ``trilinear`` (one axis after another),
    ``bicubic`` and ``area`` (adaptive average pooling)."""
    x = _t(x)
    n_sp = x.dim() - 2
    if data_format is None:
        data_format = {1: "NCW", 2: "NCHW", 3: "NCDHW"}[n_sp]
    channel_last = data_format in ("NWC", "NHWC", "NDHWC")
    start = 1 if channel_last else 2
    in_sizes = [x.shape[start + i] for i in range(n_sp)]
    if size is not None:
        out_sizes = ([int(s) for s in size] if isinstance(size, (list, tuple))
                     else [int(size)] * n_sp)
    elif scale_factor is not None:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else [scale_factor] * n_sp)
        out_sizes = [int(np.floor(i * s)) for i, s in zip(in_sizes, sf)]
    else:
        raise InvalidArgumentError("one of size / scale_factor required")
    if mode == "nearest":
        return _resize_nearest(x, out_sizes, start)
    if mode in ("linear", "bilinear", "trilinear"):
        out = x
        for i in range(n_sp):
            out = _resize_linear_1d(out, out_sizes[i], start + i,
                                    align_corners, align_mode)
        return out
    if mode == "bicubic":
        out = x
        for i, (n_in, n_out) in enumerate(zip(in_sizes, out_sizes)):
            if n_in == n_out:
                continue
            w = _cubic_weights(n_in, n_out).to(x.device, x.dtype)
            out = torch.tensordot(out, w, dims=([start + i], [0])).movedim(
                -1, start + i)
        return out
    if mode == "area":
        return _adaptive_avg(x, out_sizes, start)
    raise InvalidArgumentError(f"unknown interpolate mode {mode!r}")


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format=None, name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    x, r = _t(x), upscale_factor
    if data_format == "NCHW":
        N, C, H, W = x.shape
        oc = C // (r * r)
        out = x.reshape(N, oc, r, r, H, W).permute(0, 1, 4, 2, 5, 3)
        return out.reshape(N, oc, H * r, W * r)
    N, H, W, C = x.shape
    oc = C // (r * r)
    out = x.reshape(N, H, W, r, r, oc).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(N, H * r, W * r, oc)


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    x, r = _t(x), downscale_factor
    if data_format == "NCHW":
        N, C, H, W = x.shape
        out = x.reshape(N, C, H // r, r, W // r, r).permute(0, 1, 3, 5, 2, 4)
        return out.reshape(N, C * r * r, H // r, W // r)
    N, H, W, C = x.shape
    out = x.reshape(N, H // r, r, W // r, r, C).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(N, H // r, W // r, C * r * r)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    x = _t(x)
    if data_format == "NCHW":
        N, C, H, W = x.shape
        out = x.reshape(N, groups, C // groups, H, W).transpose(1, 2)
        return out.reshape(N, C, H, W)
    N, H, W, C = x.shape
    out = x.reshape(N, H, W, groups, C // groups).transpose(3, 4)
    return out.reshape(N, H, W, C)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _pads(p):
    """paddle's paddings: one int, ``[h, w]`` or ``[top, left, bottom,
    right]``."""
    if isinstance(p, int):
        return (p,) * 4
    if len(p) == 2:
        return (p[0], p[1], p[0], p[1])
    return tuple(p)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[N, C * k0 * k1, L]``, channels outer, kernel positions
    inner (paddle's layout)."""
    x = _t(x)
    N, C, _, _ = x.shape
    k, s, d, p = (_pair(kernel_sizes), _pair(strides), _pair(dilations),
                  _pads(paddings))
    xp = torch.nn.functional.pad(x, (p[1], p[3], p[0], p[2]))
    oh = (xp.shape[2] - (d[0] * (k[0] - 1) + 1)) // s[0] + 1
    ow = (xp.shape[3] - (d[1] * (k[1] - 1) + 1)) // s[1] + 1
    patches = [xp[:, :, i * d[0]: i * d[0] + oh * s[0]: s[0],
                  j * d[1]: j * d[1] + ow * s[1]: s[1]]
               for i in range(k[0]) for j in range(k[1])]
    return torch.stack(patches, 2).reshape(N, C * k[0] * k[1], oh * ow)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the inverse layout of :func:`unfold`; overlapping patches
    add."""
    x = _t(x)
    N = x.shape[0]
    oh_, ow_ = _pair(output_sizes)
    k, s, d, p = (_pair(kernel_sizes), _pair(strides), _pair(dilations),
                  _pads(paddings))
    C = x.shape[1] // (k[0] * k[1])
    ph, pw = oh_ + p[0] + p[2], ow_ + p[1] + p[3]
    oh = (ph - (d[0] * (k[0] - 1) + 1)) // s[0] + 1
    ow = (pw - (d[1] * (k[1] - 1) + 1)) // s[1] + 1
    cols = x.reshape(N, C, k[0], k[1], oh, ow)
    canvas = x.new_zeros((N, C, ph, pw))
    for i in range(k[0]):
        for j in range(k[1]):
            canvas[:, :, i * d[0]: i * d[0] + oh * s[0]: s[0],
                   j * d[1]: j * d[1] + ow * s[1]: s[1]] += cols[:, :, i, j]
    return canvas[:, :, p[0]: p[0] + oh_, p[1]: p[1] + ow_]


def sequence_mask(lengths, maxlen=None, dtype="int64", name=None):
    """``mask[..., j] = j < lengths[...]`` in ``dtype``; ``maxlen``
    defaults to the largest length (read on the host)."""
    lengths = _t(lengths)
    if maxlen is None:
        maxlen = int(lengths.max())
    row = torch.arange(int(maxlen), device=lengths.device)
    return (row < lengths.unsqueeze(-1)).to(convert_dtype(dtype))


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] · weight[o] · x2[b]`` (+ bias); weight ``[out,
    in1, in2]``."""
    x1 = _t(x1)
    out = torch.einsum("bi,oij,bj->bo", x1, _t(weight, x1), _t(x2, x1))
    if bias is not None:
        out = out + _t(bias, x1).to(out.dtype)
    return out


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """The ``[N, H, W, 2]`` sampling grid of the affine maps ``theta``
    ``[N, 2, 3]`` over an ``out_shape`` ``[N, C, H, W]`` output."""
    theta = _t(theta)
    _, _, H, W = [int(v) for v in out_shape]

    def coords(n):
        if align_corners:
            return torch.linspace(-1.0, 1.0, n, device=theta.device)
        return ((torch.arange(n, device=theta.device) * 2 + 1) / n
                - 1.0).float()

    gy, gx = torch.meshgrid(coords(H), coords(W), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1).to(theta.dtype)
    return torch.einsum("hwi,nji->nhwj", base, theta)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample ``x`` ``[N, C, H, W]`` at ``grid`` ``[N, Ho, Wo, 2]`` (x, y
    in [-1, 1]): ``bilinear`` (outside samples zero under ``zeros``, the
    border value otherwise) or ``nearest``."""
    x, grid = _t(x), _t(grid)
    N, C, H, W = x.shape

    def unnorm(g, size):
        if align_corners:
            return (g + 1) * (size - 1) / 2
        return ((g + 1) * size - 1) / 2

    gx = unnorm(grid[..., 0], W)
    gy = unnorm(grid[..., 1], H)
    batch = torch.arange(N, device=x.device)[:, None, None]
    if mode == "nearest":
        ix = torch.round(gx).long().clamp(0, W - 1)
        iy = torch.round(gy).long().clamp(0, H - 1)
        return x.permute(0, 2, 3, 1)[batch, iy, ix].permute(0, 3, 1, 2)
    x0, y0 = torch.floor(gx), torch.floor(gy)
    x1, y1 = x0 + 1, y0 + 1
    wx1 = (gx - x0).to(x.dtype)
    wy1 = (gy - y0).to(x.dtype)
    xl = x.permute(0, 2, 3, 1)

    def sample(ix, iy):
        v = xl[batch, iy.clamp(0, H - 1).long(), ix.clamp(0, W - 1).long()]
        if padding_mode == "zeros":
            inb = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
            v = torch.where(inb[..., None], v, torch.zeros_like(v))
        return v

    out = (sample(x0, y0) * ((1 - wx1) * (1 - wy1))[..., None]
           + sample(x1, y0) * (wx1 * (1 - wy1))[..., None]
           + sample(x0, y1) * ((1 - wx1) * wy1)[..., None]
           + sample(x1, y1) * (wx1 * wy1)[..., None])
    return out.permute(0, 3, 1, 2)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM: of ``[N * T, C, H, W]``, the first ``C * shift_ratio``
    channels shift one step back in time, the next as many one step
    forward (zeros at the ends), the rest stay."""
    x = _t(x)
    NT, C, H, W = x.shape
    x = x.reshape(NT // seg_num, seg_num, C, H, W)
    fc = int(C * shift_ratio)
    left = torch.cat([x[:, 1:, :fc], torch.zeros_like(x[:, :1, :fc])], 1)
    right = torch.cat([torch.zeros_like(x[:, :1, fc:2 * fc]),
                       x[:, :-1, fc:2 * fc]], 1)
    out = torch.cat([left, right, x[:, :, 2 * fc:]], 2)
    return out.reshape(NT, C, H, W)


def npu_identity(x, format=-1):
    return _t(x)
