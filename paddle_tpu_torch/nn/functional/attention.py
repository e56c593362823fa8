"""Attention ops — port of ``paddle_tpu/nn/functional/attention.py``.

``scaled_dot_product_attention`` takes paddle's ``[B, S, H, hd]`` layout.
Long sequences on the card go to the hand-written flash-attention kernels
(:func:`paddle_tpu_torch.ops.flash_attention`: the forward kernel, and the
dq and dk / dv kernels as its backward); everything else takes the dense
path with the JAX arithmetic.  The two routes align a causal mask
differently when the lengths differ, as in the JAX package: the dense
route bottom-right (``tril(k = s_k - s_q)``), the flash route top-left
(``row >= key``).
"""
from __future__ import annotations

import math

import torch

from ...framework.random import generator_for
from ...ops.flash_attention import HEAD_DIMS, flash_attention

__all__ = ["scaled_dot_product_attention", "flash_eligible"]

_NEG = -1e30  # the JAX dense path's mask fill


def flash_eligible(query, key, attn_mask=None, dropout_p=0.0) -> bool:
    """Should :func:`scaled_dot_product_attention` take the flash kernel?
    The JAX gate with "the tensor is on CUDA" for "the backend is TPU":
    no mask, no dropout, S_q >= 4096, both lengths multiples of 128,
    head_dim in {64, 128, 256}.  The flash route is differentiable."""
    return (query.device.type == "cuda" and attn_mask is None
            and dropout_p == 0.0 and query.shape[1] >= 4096
            and query.shape[1] % 128 == 0 and key.shape[1] % 128 == 0
            and query.shape[-1] in HEAD_DIMS)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, use_pallas=None):
    """query/key/value: ``[batch, seq, heads, head_dim]``; returns the
    same layout in query's dtype.

    ``use_pallas``: ``None`` decides by :func:`flash_eligible`, ``True``
    takes the hand-written flash kernel (the plain flash version for CPU
    tensors), ``False`` the dense path: float32 logits, a bottom-right
    aligned causal mask and boolean masks filled with ``-1e30``, float
    masks added, probabilities cast to query's dtype, dropout (when
    ``dropout_p > 0`` and ``training``) drawn from the generator of the
    tensors' device, the product with value in float32."""
    q, k, v = query, key, value
    if use_pallas is None:
        use_pallas = flash_eligible(q, k, attn_mask, dropout_p)
    if use_pallas:
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=is_causal)
        return out.transpose(1, 2)

    scale = 1.0 / math.sqrt(q.shape[-1])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, S, hd]
    logits = torch.matmul(qt.float(), kt.float().transpose(-1, -2)) * scale
    if is_causal:
        s_q, s_k = logits.shape[-2], logits.shape[-1]
        causal = torch.ones(s_q, s_k, dtype=torch.bool,
                            device=logits.device).tril(s_k - s_q)
        logits = logits.masked_fill(~causal, _NEG)
    if attn_mask is not None:
        m = torch.as_tensor(attn_mask, device=logits.device)
        if m.dtype == torch.bool:
            logits = logits.masked_fill(~m, _NEG)
        else:
            logits = logits + m.to(logits.dtype)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_p > 0.0 and training:
        if dropout_p >= 1.0:
            probs = torch.zeros_like(probs)
        else:
            keep = torch.empty_like(probs).bernoulli_(
                1.0 - dropout_p, generator=generator_for(probs.device))
            probs = torch.where(keep.bool(), probs / (1.0 - dropout_p),
                                torch.zeros_like(probs))
    out = torch.matmul(probs.float(), vt.float()).to(q.dtype)
    return out.transpose(1, 2)
