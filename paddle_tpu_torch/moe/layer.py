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

Under a fleet mesh the layer routes the GLOBAL batch, as the JAX
package's GSPMD step does: the data ranks' tokens are all-gathered over
the data axes (backward: the gradient summed over them, this rank's rows
taken), so capacity, slot order and drops are one rank's over the whole
batch, and each rank keeps its own rows of the output.  With an
``expert`` axis of size ``ep`` (``strategy.expert_parallel``), the expert
weights carry ``("expert", ...)`` specs and a rank holds ``E / ep``
experts; every rank of an expert group routes the same tokens the same
way (the routing counters are one rank's, on every rank), and:

* the router's differentiable part runs a rank's ``1/ep`` share of the
  tokens, its probabilities all-gathered; the gate is the Megatron ``f``
  of the group (gradient summed over it), as is the layer's input;
* a rank dispatches its share of the tokens into the ``[E, C, D]``
  buffer, and the autograd all-to-all (``collective.all_to_all_single``)
  brings each rank its experts' slots from every rank (summed: the slots
  are disjoint);
* kernel 10 computes the local experts' two products;
* an all-gather over the group brings every rank every expert's output
  (its backward sums the gradient over the group); a rank combines its
  share of the tokens and the shares are all-gathered.

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
from ..distributed.mesh import PartitionSpec
from ..framework.errors import InvalidArgumentError
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
        for w in (self.expert_fc1, self.expert_fc2):
            w.partition_spec = PartitionSpec("expert", None, None)
        for b in (self.expert_b1, self.expert_b2):
            b.partition_spec = PartitionSpec("expert", None)
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

    def _gate_input(self, xf):
        """The router's input: ``xf``, times uniform jitter in training."""
        if self.training and self.jitter > 0.0:
            eps = self.jitter
            noise = torch.empty_like(xf).uniform_(
                1.0 - eps, 1.0 + eps, generator=generator_for(xf.device))
            return xf * noise
        return xf

    def _route(self, probs, C):
        """The router's decisions from its ``[N, E]`` float32
        probabilities: ``(probs, combine_w [N, k] float32, top_e [N, k],
        slot [N, k], kept [N, k])`` with ``C`` slots an expert."""
        N, E, k = probs.shape[0], self.num_experts, self.top_k
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
        """The one-hot dispatch: ``(xe [E, C, D], comb [N, E, C] float32)``
        — each kept (token, choice) row copied into its expert's slot, and
        the combine weights that bring them back."""
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
        return xe, comb

    def _combine(self, comb, ye):
        """``y = einsum("nec,ecd->nd", comb, ye)``, comb in ye's dtype."""
        N = comb.shape[0]
        E, C, D = ye.shape
        return torch.matmul(comb.to(ye.dtype).reshape(N, E * C),
                            ye.reshape(E * C, D))

    def forward(self, x):
        """The layer on this rank's rows; under a fleet mesh (the module
        docstring) with the data-axes group and the expert group, each
        ``None`` where of size 1, so one device runs the same steps with
        no collective: its share is every token and it holds every
        expert."""
        from ..distributed.collective import all_to_all_single
        from ..distributed.meta_parallel import copy_to, gather_from

        lead, D = x.shape[:-1], x.shape[-1]
        E, k = self.num_experts, self.top_k
        dg, eg = _groups()
        xf = x.reshape(-1, D)
        n_local = xf.shape[0]
        gin = self._gate_input(xf)
        jittered = gin is not xf
        if dg is not None:  # the global batch, in data-rank order
            xf = _GatherRows.apply(xf, dg)
            gin = _GatherRows.apply(gin, dg) if jittered else xf
        N = xf.shape[0]
        C = self.capacity(N)
        ep, r = (eg.size, eg.index) if eg is not None else (1, 0)
        if E % ep:
            raise InvalidArgumentError(
                f"MoELayer: {E} experts do not split over an expert axis "
                f"of {ep} ranks")
        gate = self.gate
        if eg is not None:  # the Megatron f: gradients summed over eg
            xf = copy_to(xf, eg)
            gin = copy_to(gin, eg) if jittered else xf
            gate = copy_to(gate, eg)
        # the router's differentiable part on this rank's token share
        share = slice(N * r // ep, N * (r + 1) // ep)
        probs = torch.softmax(
            torch.matmul(*promote(gin[share], gate)).float(), dim=-1)
        if eg is not None:
            probs = gather_from(probs, eg, 0)
        probs, combine_w, top_e, slot, kept = self._route(probs, C)
        xe, comb = self._dispatch(xf[share], top_e[share], slot[share],
                                  kept[share], combine_w[share], C)
        selected = torch.nn.functional.one_hot(top_e, E).sum((0, 1))
        routed = torch.clamp(selected, max=C).to(torch.int32)
        El = E // ep
        if eg is not None:
            # each rank's slots of this rank's experts, summed (disjoint)
            xe = all_to_all_single(xe, eg, 0, 0).reshape(
                ep, El, C, D).sum(0)
        ye = self._expert_ffn(xe, routed[r * El:(r + 1) * El])
        if eg is not None:  # every expert's output on every rank
            ye = _GatherRows.apply(ye, eg)
        y = self._combine(comb, ye)
        if eg is not None:
            y = gather_from(y, eg, 0)
        if dg is not None:
            y = y[dg.index * n_local:(dg.index + 1) * n_local]

        # Switch load-balance loss: E * sum_e f_e * P_e  (≈ 1 balanced)
        f = selected.float() / float(N * k)
        aux = float(E) * torch.sum(f * probs.mean(0))
        moe_stats.record(aux, routed, (selected - routed).to(torch.int32))
        return self.drop(y.reshape(*lead, D))


def _groups():
    """``(data-axes group, expert group)`` of the active fleet mesh, each
    ``None`` where of size 1 (or outside ``fleet.init``: a one-process run
    or a ``DataParallel`` wrapper routes its own rows)."""
    from ..distributed import fleet
    from ..distributed.mesh import data_axes, get_mesh

    if not fleet.is_initialized():
        return None, None
    mesh = get_mesh()
    axes = tuple(data_axes(mesh))
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    dg = mesh.group(axes) if n > 1 else None
    eg = mesh.group("expert") if mesh.shape.get("expert", 1) > 1 else None
    return dg, eg


class _GatherRows(torch.autograd.Function):
    """Every rank's rows of group ``g`` joined in rank order; the backward
    sums the gradient over the ranks and takes this rank's rows (each
    rank's loss reaches every row: the data ranks' through the routing,
    the expert ranks' through their shares' combine)."""

    @staticmethod
    def forward(ctx, x, g):
        from ..distributed.collective import _gather_cat

        ctx.g, ctx.n = g, x.shape[0]
        return _gather_cat(x.contiguous(), g, 0)

    @staticmethod
    def backward(ctx, dy):
        from ..distributed.collective import all_reduce

        dy = all_reduce(dy.contiguous().clone(), group=ctx.g)
        i = ctx.g.index
        return dy[i * ctx.n:(i + 1) * ctx.n], None
