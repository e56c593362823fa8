"""The 1.x long tail of small dense ops — port of
``paddle_tpu.nn.functional.extras``: 1.x adaptive pooling, position
encoding, affine channel, the ranking losses, channel shuffle,
space-to-depth, the FSP matrix, CVM, ``sampling_id``, the
``*_batch_size_like`` constructors, ``lrn`` and ``im2sequence``.

The random ops cannot reproduce ``jax.random``'s bits: a nonzero ``seed``
seeds a ``torch.Generator`` (on the output's device), ``seed=0`` draws
from ``framework.random.generator_for`` that device (or the active
``nn.rng_scope``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as _tF

from ...framework.dtype import convert_dtype
from ...framework.errors import InvalidArgumentError
from ...framework.random import generator_for
from ...tensor._common import t as _t

__all__ = [
    "adaptive_pool2d", "adaptive_pool3d", "add_position_encoding",
    "affine_channel", "bpr_loss", "rank_loss", "margin_rank_loss",
    "shuffle_channel", "space_to_depth", "fsp_matrix",
    "continuous_value_model", "sampling_id",
    "fill_constant_batch_size_like", "gaussian_random_batch_size_like",
    "uniform_random_batch_size_like", "lrn", "im2sequence",
]


def _generator(seed, device):
    """A generator on ``device``: seeded with ``seed`` when nonzero, else
    the device's own stream (None on the meta device, where nothing is
    drawn); ``fluid.layers``' random ops draw from it too."""
    device = torch.device(device)
    if device.type == "meta":
        return None
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    return generator_for(device)


def _adaptive(nd, input, pool_size, pool_type, require_index):
    from . import pooling as P

    if pool_type == "max":
        fn = getattr(P, f"adaptive_max_pool{nd}d")
        if require_index:
            return fn(input, pool_size, return_mask=True)
        return fn(input, pool_size)
    if pool_type == "avg":
        if require_index:
            raise InvalidArgumentError("require_index only with max pooling")
        return getattr(P, f"adaptive_avg_pool{nd}d")(input, pool_size)
    raise InvalidArgumentError(f"pool_type must be max/avg, got {pool_type!r}")


def adaptive_pool2d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    """1.x adaptive pooling over the 2.0 functional ops."""
    return _adaptive(2, input, pool_size, pool_type, require_index)


def adaptive_pool3d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    return _adaptive(3, input, pool_size, pool_type, require_index)


def add_position_encoding(input, alpha, beta, name=None):
    """``alpha·x + beta·sinusoid``: channel k < E/2 gets
    sin(pos / 10000^(k/(E/2−1))), channel E/2+k the matching cos.
    input ``[N, S, E]``."""
    x = _t(input)
    if x.dim() != 3:
        raise InvalidArgumentError(
            f"add_position_encoding wants [N, S, E], got {tuple(x.shape)}")
    N, S, E = x.shape
    if E % 2:
        raise InvalidArgumentError(
            f"add_position_encoding needs an even feature size, got {E} "
            "(the encoding pairs sin/cos channels)")
    half = E // 2
    dev = x.device
    pos = torch.arange(S, dtype=torch.float32, device=dev)[:, None]
    k = torch.arange(half, dtype=torch.float32, device=dev)[None, :]
    denom = (torch.pow(10000.0, k / max(half - 1, 1)) if half > 1
             else torch.full_like(k, 10000.0))
    val = pos / denom
    enc = torch.cat([torch.sin(val), torch.cos(val)], dim=1)  # [S, E]
    return (x * alpha + enc[None].to(x.dtype) * beta).to(x.dtype)


def affine_channel(x, scale=None, bias=None, data_layout="NCHW", act=None,
                   name=None):
    """Per-channel ``scale·x + bias``."""
    x = _t(x)
    ch = 1 if data_layout == "NCHW" else x.dim() - 1
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    out = x
    if scale is not None:
        out = out * _t(scale, x).to(x.dtype).reshape(shape)
    if bias is not None:
        out = out + _t(bias, x).to(x.dtype).reshape(shape)
    if act == "relu":
        out = torch.relu(out)
    elif act is not None:
        raise InvalidArgumentError(f"unsupported act {act!r}")
    return out


def bpr_loss(input, label, name=None):
    """Bayesian personalized ranking loss:
    ``−(1/(D−1)) Σ_{j≠y} log σ(x_y − x_j)``.  input ``[N, D]``, label
    ``[N, 1]`` → ``[N, 1]``."""
    x = _t(input).to(torch.float32)
    y = _t(label, x).reshape(-1).to(device=x.device, dtype=torch.int64)
    N, D = x.shape
    pos = torch.gather(x, 1, y[:, None])
    sp = _tF.softplus(x - pos)  # −log σ(pos − neg), overflow-stable
    mask = _tF.one_hot(y, D).to(torch.bool)
    total = torch.where(mask, torch.zeros_like(sp), sp).sum(dim=1)
    return (total / (D - 1))[:, None].to(_t(input).dtype)


def rank_loss(label, left, right, name=None):
    """RankNet loss ``log(1 + exp(l − r)) − label·(l − r)``."""
    l = _t(left).to(torch.float32)
    r = _t(right, l).to(torch.float32)
    lbl = _t(label, l).to(torch.float32)
    return _tF.softplus(l - r) - lbl * (l - r)


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    """``relu(−label·(l − r) + margin)``."""
    l = _t(left).to(torch.float32)
    r = _t(right, l).to(torch.float32)
    lbl = _t(label, l).to(torch.float32)
    return torch.relu(-lbl * (l - r) + margin)


def shuffle_channel(x, group, name=None):
    """Channel shuffle of ``[N, C, H, W]``, C = g·n: (g, n) → (n, g)."""
    x = _t(x)
    N, C, H, W = x.shape
    if C % group:
        raise InvalidArgumentError(f"channels {C} not divisible by {group}")
    return (x.reshape(N, group, C // group, H, W).transpose(1, 2)
            .reshape(N, C, H, W))


def space_to_depth(x, blocksize, name=None):
    """Spatial blocks into channels, offset-major:
    ``out[b, off·C + c, j, i] = in[b, c, j·bs + off//bs, i·bs + off%bs]``;
    ``[N, C, H, W]`` → ``[N, C·bs², H/bs, W/bs]``."""
    x = _t(x)
    bs = int(blocksize)
    N, C, H, W = x.shape
    if H % bs or W % bs:
        raise InvalidArgumentError(
            f"spatial dims {(H, W)} not divisible by blocksize {bs}")
    r = x.reshape(N, C, H // bs, bs, W // bs, bs).permute(0, 3, 5, 1, 2, 4)
    return r.reshape(N, C * bs * bs, H // bs, W // bs)


def fsp_matrix(x, y, name=None):
    """The H·W-normalized gram of two feature maps:
    ``out[n, i, j] = Σ_hw x[n,i,h,w]·y[n,j,h,w] / (H·W)``."""
    x = _t(x)
    xf = x.to(torch.float32)
    yf = _t(y, x).to(torch.float32)
    H, W = xf.shape[2], xf.shape[3]
    return (torch.einsum("nihw,njhw->nij", xf, yf) / (H * W)).to(x.dtype)


def continuous_value_model(input, cvm, use_cvm=True, name=None):
    """CTR show / click transform: with ``use_cvm`` the first two columns
    become log(show+1) and log(click+1) − log(show+1); without, they are
    dropped."""
    x = _t(input).to(torch.float32)
    if use_cvm:
        c0 = torch.log1p(x[:, 0:1])
        c1 = torch.log1p(x[:, 1:2]) - c0
        return torch.cat([c0, c1, x[:, 2:]], dim=1)
    return x[:, 2:]


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="int64", name=None):
    """One index a row of probability rows ``x``: r ~ U[min, max), the
    first index whose cumulative sum reaches r."""
    xf = _t(x).to(torch.float32)
    r = torch.empty((xf.shape[0],), dtype=torch.float32, device=xf.device)
    r.uniform_(float(min), float(max), generator=_generator(seed, xf.device))
    cum = torch.cumsum(xf, dim=1)
    idx = (cum < r[:, None]).to(torch.int64).sum(dim=1)
    return torch.clamp(idx, 0, xf.shape[1] - 1).to(convert_dtype(dtype))


def _like_shape(input, shape, input_dim_idx, output_dim_idx):
    shape = [int(s) for s in shape]
    shape[output_dim_idx] = int(_t(input).shape[input_dim_idx])
    return tuple(shape)


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0,
                                  force_cpu=False):
    """``shape`` with dim ``output_dim_idx`` taken from input's
    ``input_dim_idx``, filled with ``value``."""
    x = _t(input)
    return torch.full(_like_shape(x, shape, input_dim_idx, output_dim_idx),
                      value, dtype=convert_dtype(dtype), device=x.device)


def uniform_random_batch_size_like(input, shape, dtype="float32", min=-1.0,
                                   max=1.0, seed=0, input_dim_idx=0,
                                   output_dim_idx=0):
    x = _t(input)
    out = torch.empty(_like_shape(x, shape, input_dim_idx, output_dim_idx),
                      dtype=torch.float32, device=x.device)
    out.uniform_(float(min), float(max),
                 generator=_generator(seed, x.device))
    return out.to(convert_dtype(dtype))


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    x = _t(input)
    out = torch.empty(_like_shape(x, shape, input_dim_idx, output_dim_idx),
                      dtype=torch.float32, device=x.device)
    out.normal_(0.0, 1.0, generator=_generator(seed, x.device))
    return (out * std + mean).to(convert_dtype(dtype))


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None,
        data_format="NCHW"):
    """1.x local response norm over the 2.0 functional (size=n)."""
    from .norm import local_response_norm

    return local_response_norm(input, size=n, alpha=alpha, beta=beta, k=k,
                               data_format=data_format)


def im2sequence(input, filter_size=1, stride=1, padding=0,
                input_image_size=None, out_stride=1, name=None):
    """Sliding-window patches: ``[N, C, H, W]`` → ``[N, OH·OW, C·fh·fw]``
    rows in output-position order, columns channel-major (c, fh, fw);
    the per-image-size (LoD) branch is not supported: pad upstream."""
    if input_image_size is not None:
        raise InvalidArgumentError(
            "im2sequence: per-image sizes are LoD machinery; pad upstream")
    x = _t(input)
    fh, fw = ((filter_size, filter_size) if isinstance(filter_size, int)
              else tuple(filter_size))
    sh, sw = (stride, stride) if isinstance(stride, int) else tuple(stride)
    if isinstance(padding, int):
        pu = pd = pl = pr = padding
    elif len(padding) == 2:
        pu, pl = padding
        pd, pr = padding
    else:
        pu, pl, pd, pr = padding
    xp = _tF.pad(x, (pl, pr, pu, pd))
    cols = _tF.unfold(xp, (fh, fw), stride=(sh, sw))  # [N, C·fh·fw, L]
    return cols.transpose(1, 2)
