"""Sequence / context parallelism: ring attention and Ulysses (port of
``paddle_tpu.distributed.sequence_parallel``).

* :func:`ring_attention` — q / k / v are this rank's chunks ``[B, H,
  S/p, hd]`` of a sequence split over the ``sep`` axis.  JAX's schedule:
  at step 0 each rank attends its own chunk (causal), then KV rotates one
  rank along the ring (``ppermute``) each step; a chunk entirely above
  the causal diagonal (source rank > this rank) is skipped — no kernel
  runs — and one entirely below is attended without a mask.  The
  partials merge by their log-sum-exp.  Every chunk's forward is
  ``flash_attention_fwd_lse`` (kernel 4 on the card); the backward runs
  ``flash_attention_bwd_chunk`` (the dq and dk / dv kernels 5-6) on each
  non-skipped chunk with the GLOBAL merged ``(out, lse)``, the dk / dv
  accumulators travelling the ring with their chunk and a last rotation
  delivering them to the chunk's owner.
* :func:`ulysses_attention` — two ``all_to_all_single`` reshards around
  one whole-sequence ``flash_attention`` per head group: ``[B, H, S/p,
  hd]`` → ``[B, H/p, S, hd]`` → attention → back.

The ``*_sharded`` wrappers take the whole ``[B, H, S, hd]`` tensors on
every rank, run this rank's chunk and join the chunks again (their
backward takes this rank's share of the gradient and joins the chunk
gradients), as the JAX wrappers' ``shard_map`` does.  On CPU tensors the
flash entries take their plain versions.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..framework.errors import InvalidArgumentError
from ..ops.flash_attention import (_delta, flash_attention,
                                   flash_attention_bwd_chunk,
                                   flash_attention_fwd_lse)
from .collective import _group, all_to_all_single, ppermute
from .meta_parallel import gather_from, split_to

__all__ = [
    "ring_attention",
    "ulysses_attention",
    "ring_attention_sharded",
    "ulysses_attention_sharded",
    "ring_schedule",
]


def _merge(o_a, lse_a, o_b, lse_b):
    """Numerically-stable combine of two normalized partial attentions
    (float32), as JAX's ``_merge``."""
    m = torch.maximum(lse_a, lse_b)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    wa = torch.where(torch.isneginf(lse_a), torch.zeros_like(lse_a),
                     torch.exp(lse_a - m_safe))
    wb = torch.where(torch.isneginf(lse_b), torch.zeros_like(lse_b),
                     torch.exp(lse_b - m_safe))
    denom = wa + wb
    denom_safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    o = (o_a * wa[..., None] + o_b * wb[..., None]) / denom_safe[..., None]
    lse = m + torch.log(denom_safe)
    lse = torch.where(denom == 0.0, torch.full_like(lse, -math.inf), lse)
    return o, lse


def ring_schedule(p: int, idx: int, causal: bool):
    """The chunks rank ``idx`` of a ``p``-rank ring attends, step by
    step: ``(step, source rank, causal mask)``; skipped chunks are left
    out.  Its length is the rank's kernel-4 launches a forward (and
    kernel-5 / kernel-6 launches a backward)."""
    out = [(0, idx, causal)]
    for step in range(1, p):
        src = (idx - step) % p
        if not causal or src < idx:
            out.append((step, src, False))
    return out


def _rotate(x, g):
    p = g.size
    return ppermute(x, g, [(j, (j + 1) % p) for j in range(p)])


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, g, causal, scale):
        p, idx = g.size, g.index
        plan = {step: mask for step, _, mask in ring_schedule(p, idx, causal)}
        out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full(q.shape[:3], -math.inf, dtype=torch.float32,
                         device=q.device)
        kc, vc = k, v
        for step in range(p):
            if step in plan:
                o_i, l_i = flash_attention_fwd_lse(
                    q, kc, vc, causal=plan[step], sm_scale=scale)
                out, lse = _merge(out, lse, o_i.float(), l_i)
            if step + 1 < p:
                kc, vc = _rotate(kc, g), _rotate(vc, g)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (g, causal, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        g, causal, scale = ctx.args
        p, idx = g.size, g.index
        plan = {step: mask for step, _, mask in ring_schedule(p, idx, causal)}
        do = do.to(q.dtype).contiguous()
        # loop-invariant: computed once, read by every step's kernels
        delta = _delta(out, do)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvc = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        kc, vc = k, v
        for step in range(p):
            if step in plan:
                dq_i, dk_i, dv_i = flash_attention_bwd_chunk(
                    q, kc, vc, out, lse, do, causal=plan[step],
                    sm_scale=scale, delta=delta)
                dq += dq_i.float()
                dkc += dk_i.float()
                dvc += dv_i.float()
            if step + 1 < p:
                kc, vc = _rotate(kc, g), _rotate(vc, g)
                dkc, dvc = _rotate(dkc, g), _rotate(dvc, g)
        # after p-1 rotations rank i holds chunk (i+1) % p: one more step
        # delivers each dk / dv to its chunk's owner
        dkc, dvc = _rotate(dkc, g), _rotate(dvc, g)
        return (dq.to(q.dtype), dkc.to(k.dtype), dvc.to(v.dtype), None, None,
                None)


def _scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None \
        else float(sm_scale)


def ring_attention(q, k, v, axis_name: str = "sep", causal: bool = False,
                   sm_scale: Optional[float] = None):
    """Exact attention over a sequence split on ``axis_name``: q / k / v
    are this rank's chunks ``[B, H, S_local, hd]``; returns this rank's
    chunk of the output.  Differentiable in q, k and v."""
    g = _group(axis_name)
    if g.size == 1:
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    return _RingFlash.apply(q, k, v, g, bool(causal), _scale(q, sm_scale))


def ulysses_attention(q, k, v, axis_name: str = "sep", causal: bool = False,
                      sm_scale: Optional[float] = None):
    """Attention through two all-to-all head reshards (DeepSpeed-Ulysses):
    q / k / v are this rank's chunks ``[B, H, S_local, hd]`` with ``H``
    divisible by the axis size; returns this rank's output chunk."""
    g = _group(axis_name)
    p = g.size
    if q.shape[1] % p:
        raise InvalidArgumentError(
            f"num_heads {q.shape[1]} not divisible by axis {axis_name!r} "
            f"size {p}")
    scale = _scale(q, sm_scale)

    def reshard_in(x):  # [B, H, S/p, D] → [B, H/p, S, D]
        return all_to_all_single(x, g, split_axis=1, concat_axis=2)

    o2 = flash_attention(reshard_in(q), reshard_in(k), reshard_in(v),
                         causal=causal, sm_scale=scale)
    return all_to_all_single(o2, g, split_axis=2, concat_axis=1)


def _sharded(fn, q, k, v, axis, causal, sm_scale):
    g = _group(axis)
    if q.shape[2] % g.size:
        raise InvalidArgumentError(
            f"sequence length {q.shape[2]} is not divisible by the "
            f"{g.size} ranks of axis {axis!r}")
    ql, kl, vl = (split_to(t, g, 2) for t in (q, k, v))
    out = fn(ql, kl, vl, axis_name=g, causal=causal, sm_scale=sm_scale)
    return gather_from(out, g, 2)


def ring_attention_sharded(q, k, v, axis: str = "sep", causal: bool = False,
                           sm_scale: Optional[float] = None):
    """Whole-tensor wrapper: q / k / v ``[B, H, S, hd]`` on every rank;
    this rank computes its sequence chunk and the chunks are joined."""
    return _sharded(ring_attention, q, k, v, axis, causal, sm_scale)


def ulysses_attention_sharded(q, k, v, axis: str = "sep",
                              causal: bool = False,
                              sm_scale: Optional[float] = None):
    return _sharded(ulysses_attention, q, k, v, axis, causal, sm_scale)
