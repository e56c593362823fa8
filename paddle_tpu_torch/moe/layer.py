"""Mixture-of-experts FFN — GShard-style top-k routing (port of
``paddle_tpu.moe.layer``).

``MoELayer`` is a drop-in for the dense ``ParallelMLP``: the same ``(x) ->
y`` signature and GELU FFN, with the FFN weights stacked ``[E, ...]`` per
expert and each token processed by the ``top_k`` experts its router
picks.  Every shape follows from the input's shape alone, as in the JAX
package, and nothing in :meth:`MoELayer.forward` synchronises with the
card (counts stay device tensors):

* **Router** — a ``[D, E]`` gate in x's dtype; softmax over experts in
  float32, then the top k by a STABLE descending sort: ``jax.lax.top_k``
  breaks ties toward the lower expert index, which ``torch.topk`` does not
  promise (on the card its order on ties varies).  Training multiplies
  the gate INPUT by uniform jitter in ``[1 - eps, 1 + eps]`` (GShard
  §3.1) drawn from the device generator
  (``framework.random.generator_for``, reseeded by
  ``paddle_tpu_torch.seed``); eval routes greedily.
* **Capacity** — expert slots ``C = ceil(k * N * cf / E)``.  Slot
  positions come from a cumsum over the one-hot assignment flattened
  SLOT-MAJOR: every token's 1st choice beats any token's 2nd choice, and
  within a choice rank the earlier token wins.  Overflowing selections are
  dropped (their one-hot rows are all zero, where ``jax.nn.one_hot(-1)``
  gives zeros and ``torch.nn.functional.one_hot`` would raise).
* **Dispatch / combine** — the JAX package's one-hot products into and
  out of the ``[E, C, D]`` capacity buffer: plain matmuls, as XLA ran
  them.  ``disp`` enters the dispatch in x's dtype and ``comb`` the
  combine in the experts' output dtype, as in JAX.
* **Expert FFN** — stacked weights ``expert_fc1`` ``[E, D, F]``,
  ``expert_b1`` ``[E, F]``, ``expert_fc2`` ``[E, F, D]``, ``expert_b2``
  ``[E, D]`` under the JAX names, so ``bridge.load_jax_params`` maps them
  1:1.  On the card, at any width, both matmuls are the hand-written
  ``grouped_matmul`` CUDA kernel (padding rows skipped and exactly 0),
  the bias added after the product in x's dtype; on the CPU the masked
  einsum of the JAX package.
* **Aux loss** — the Switch Transformer load-balance loss ``E * Σ_e f_e ·
  P_e`` (≈ 1 when balanced).  It and the per-expert routed / dropped
  counts ride :mod:`paddle_tpu_torch.moe.stats`.

Dense equivalence: with identical experts, ``top_k=1`` and capacity at
least the token count, the combine weight is the constant 1 and dispatch
and combine move each row unchanged, so the routed model computes the
dense model's function (``tests/test_torch_moe.py`` holds it at a stated
tolerance: the products run in another order).
"""
from __future__ import annotations

import math

import torch

from .. import nn
from ..framework.dtype import promote
from ..framework.random import generator_for
from ..nn.initializer import XavierNormal
from ..ops.grouped_matmul import grouped_matmul
from . import stats as moe_stats

__all__ = ["MoELayer"]


class MoELayer(nn.Layer):
    """Top-k routed expert FFN; config knobs: ``moe_experts`` (E),
    ``moe_top_k``, ``moe_capacity_factor``, ``moe_jitter`` plus the dense
    MLP's ``hidden_size`` / ``intermediate_size`` / ``dropout``."""

    def __init__(self, cfg):
        super().__init__()
        D = cfg.hidden_size
        F = cfg.intermediate_size
        E = int(cfg.moe_experts)
        if E < 1:
            raise ValueError(f"MoELayer needs moe_experts >= 1, got {E}")
        self.num_experts = E
        self.top_k = max(1, min(int(getattr(cfg, "moe_top_k", 2)), E))
        self.capacity_factor = float(getattr(cfg, "moe_capacity_factor",
                                             1.25))
        self.jitter = float(getattr(cfg, "moe_jitter", 0.0))
        self.gate = nn.Parameter(torch.empty(D, E))
        self.expert_fc1 = nn.Parameter(torch.empty(E, D, F))
        self.expert_b1 = nn.Parameter(torch.empty(E, F))
        self.expert_fc2 = nn.Parameter(torch.empty(E, F, D))
        self.expert_b2 = nn.Parameter(torch.empty(E, D))
        self.act = nn.GELU()
        self.drop = nn.Dropout(cfg.dropout)

    def reset_parameters(self, generator=None):
        """XavierNormal gate; expert weights XavierNormal with the fans of
        one ``[D, F]`` / ``[F, D]`` layer (the JAX package passes them
        explicitly); zero biases."""
        D, F = self.expert_fc1.shape[1:]
        XavierNormal().init_(self.gate, generator)
        XavierNormal(fan_in=D, fan_out=F).init_(self.expert_fc1, generator)
        XavierNormal(fan_in=F, fan_out=D).init_(self.expert_fc2, generator)
        with torch.no_grad():
            self.expert_b1.zero_()
            self.expert_b2.zero_()

    def capacity(self, num_tokens: int) -> int:
        """Per-expert slot count for ``num_tokens`` routed rows."""
        return max(1, math.ceil(self.top_k * num_tokens *
                                self.capacity_factor / self.num_experts))

    def _expert_ffn(self, xe, group_sizes):
        """``[E, C, D] -> [E, C, D]``; rows past ``group_sizes[e]`` may hold
        the bias path — combine's one-hot weights never read them."""
        w1, w2 = self.expert_fc1, self.expert_fc2
        b1, b2 = self.expert_b1, self.expert_b2
        # a bf16 activation beside float32 experts (amp O1) is promoted, as
        # jnp.einsum promotes it
        if self._use_kernel(xe):
            # the bias after the product, in x's dtype: the kernel rounds
            # the product to x's dtype first, as the TPU kernel does
            h = grouped_matmul(*promote(xe, w1), group_sizes) + b1[:, None, :]
            h = self.act(h)
            return (grouped_matmul(*promote(h, w2), group_sizes)
                    + b2[:, None, :])
        h = torch.matmul(*promote(xe, w1)) + b1[:, None, :]
        h = self.act(h)
        return torch.matmul(*promote(h, w2)) + b2[:, None, :]

    def _use_kernel(self, xe) -> bool:
        """The JAX gate with "the activation is on CUDA" for "TPU".  The
        JAX gate also asks for lane-aligned D and F, a limit of the TPU's
        tiles; the CUDA kernel checks its edges and takes any C, D and F,
        so every CUDA activation runs it.  On the CPU the masked einsum
        runs, as the JAX package's does off the TPU."""
        return xe.device.type == "cuda"

    def _route(self, xf, C):
        """The router: ``(probs [N, E] float32, combine_w [N, k] float32,
        top_e [N, k], slot [N, k], kept [N, k])`` for the ``[N, D]`` rows
        ``xf`` and ``C`` slots an expert."""
        N, E, k = xf.shape[0], self.num_experts, self.top_k
        gate_in = xf
        if self.training and self.jitter > 0.0:
            eps = self.jitter
            noise = torch.empty_like(xf).uniform_(
                1.0 - eps, 1.0 + eps, generator=generator_for(xf.device))
            gate_in = xf * noise
        logits = torch.matmul(*promote(gate_in, self.gate))
        probs = torch.softmax(logits.float(), dim=-1)
        # jax.lax.top_k: ties go to the lower expert index
        sorted_p, order = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
        top_p, top_e = sorted_p[:, :k], order[:, :k]          # [N, k]
        # normalized combine weights; for top-1 the constant 1 (p/p, with
        # no gradient), as the JAX package spells it
        if k == 1:
            combine_w = torch.ones_like(top_p)
        else:
            combine_w = top_p / top_p.sum(-1, keepdim=True)
        onehot = torch.nn.functional.one_hot(top_e, E).to(torch.int32)
        # position-in-expert: cumsum in slot-major-then-token order, so
        # 1st choices beat 2nd choices and earlier tokens beat later ones.
        # Laid out [E, k * N] so the scan runs along the contiguous dim: on
        # the card a scan over the outer dim of a [k * N, E] tensor is slow
        flat = onehot.permute(2, 1, 0).reshape(E, k * N)
        pos_flat = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat
        pos = pos_flat.reshape(E, k, N).permute(2, 1, 0)     # [N, k, E]
        slot = (pos * onehot).sum(-1)                        # [N, k]
        kept = (slot < C) & (onehot.sum(-1) > 0)
        return probs, combine_w, top_e, slot, kept

    def _dispatch(self, xf, top_e, slot, kept, combine_w, C):
        """The one-hot dispatch: ``(xe [E, C, D], comb [N, E, C] float32,
        selected [E])`` — each kept (token, choice) row copied into its
        expert's slot, and the combine weights that bring them back."""
        N, D = xf.shape
        E = self.num_experts
        onehot = torch.nn.functional.one_hot(top_e, E)       # [N, k, E]
        # a dropped slot's row is all zero (jax.nn.one_hot(-1) is zeros)
        cap_oh = ((torch.arange(C, device=xf.device) == slot[..., None])
                  & kept[..., None])                          # [N, k, C]
        # disp holds only 0 and 1, exact in any float dtype: built in x's
        # dtype, it equals JAX's float32 disp cast to x's dtype
        disp = torch.einsum("nke,nkc->nec", onehot.to(xf.dtype),
                            cap_oh.to(xf.dtype))              # [N, E, C]
        comb = torch.einsum("nke,nkc->nec",
                            onehot.float() * combine_w[..., None],
                            cap_oh.float())                   # float32
        # xe = einsum("nec,nd->ecd", disp, xf): one product over n
        xe = torch.matmul(disp.reshape(N, E * C).t(), xf).reshape(E, C, D)
        return xe, comb, onehot.sum((0, 1))

    def _combine(self, comb, ye):
        """``y = einsum("nec,ecd->nd", comb, ye)``, comb in ye's dtype."""
        N = comb.shape[0]
        E, C, D = ye.shape
        return torch.matmul(comb.to(ye.dtype).reshape(N, E * C),
                            ye.reshape(E * C, D))

    def forward(self, x):
        lead = x.shape[:-1]
        D = x.shape[-1]
        E, k = self.num_experts, self.top_k
        xf = x.reshape(-1, D)
        N = xf.shape[0]
        C = self.capacity(N)
        probs, combine_w, top_e, slot, kept = self._route(xf, C)
        xe, comb, selected = self._dispatch(xf, top_e, slot, kept,
                                            combine_w, C)
        routed = torch.clamp(selected, max=C).to(torch.int32)
        y = self._combine(comb, self._expert_ffn(xe, routed))

        # Switch load-balance loss: E * sum_e f_e * P_e  (≈ 1 balanced)
        f = selected.float() / float(N * k)
        aux = float(E) * torch.sum(f * probs.mean(0))
        moe_stats.record(aux, routed, (selected - routed).to(torch.int32))
        return self.drop(y.reshape(*lead, D))
