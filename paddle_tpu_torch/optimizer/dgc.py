"""Deep Gradient Compression — ``DGCMomentum`` (port of
``paddle_tpu.optimizer.dgc``).

Parity: DGCMomentumOptimizer (python/paddle/fluid/optimizer.py:1129) over
the dgc ops (paddle/fluid/operators/dgc_op.cc, dgc_clip_by_norm_op):
momentum correction, local gradient accumulation (error feedback) and
top-k sparsification, after a dense warmup of plain momentum, with a
sparsity ramp-up schedule.  It runs inside the fleet ``DGCPlan``'s step
(``strategy.dgc``), where each data rank's gradients are still its own;
its exchange is an all-gather of each rank's ``(indices, values)`` top-k
pairs — ``2·k·ndp`` words instead of an ``n``-word all-reduce — then a
local scatter-add, in a fixed order (``SelectedRows.to_dense``), so every
rank applies the same update.

Per parameter (Lin et al., "Deep Gradient Compression"; the reference's
dgc_op):

    u = m·u + g                (momentum folded locally)
    v = v + u                  (velocity accumulation, error feedback)
    send top-k of |v|; v[sent] = 0; u[sent] = 0   (momentum factor masking)
    p = p - lr · mean_over_replicas(scatter(sent))

The top-k takes ``jax.lax.top_k``'s order: the larger magnitude first,
and among equal magnitudes the lower index first.  The state is JAX's
``{"count", "velocity", "u", "v"}``; ``u`` / ``v`` are this rank's (JAX
stacks every replica's).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..framework.errors import InvalidArgumentError
from ..framework.selected_rows import SelectedRows, all_gather_rows, safe_rows
from .optimizer import Optimizer

__all__ = ["DGCMomentum"]


def topk_indices(flat: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` indices of the largest ``|flat|``, ``lax.top_k``'s order
    (ties: the lower index first)."""
    order = torch.sort(flat.abs(), descending=True, stable=True).indices
    return order[:k]


class DGCMomentum(Optimizer):
    """Momentum with top-k gradient compression.  Runs only on the fleet
    ``Model`` path (``strategy.dgc``): its exchange needs the data axis."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 rampup_begin_step: int = 0, rampup_step: int = 1,
                 sparsity: Sequence[float] = (0.999,),
                 use_nesterov: bool = False, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision=False)
        if not 0.0 <= momentum < 1.0:
            raise InvalidArgumentError("momentum in [0, 1)")
        sparsity = [float(s) for s in sparsity]
        if not sparsity or not all(0.0 <= s < 1.0 for s in sparsity):
            raise InvalidArgumentError("sparsity values must be in [0, 1)")
        self._momentum = float(momentum)
        self._nesterov = bool(use_nesterov)
        self.rampup_begin_step = int(rampup_begin_step)
        self.rampup_step = max(int(rampup_step), 1)
        self.sparsity = sparsity
        #: the phase of the next functional ``update``: None → dense
        #: warmup momentum, a float → that sparsity (DGCPlan sets it)
        self._sparsity_now: Optional[float] = None
        self._axis = "data"

    # -- schedule ------------------------------------------------------------
    def sparsity_at(self, t: int) -> Optional[float]:
        """Sparsity for 1-based step ``t``; None during dense warmup."""
        if t <= self.rampup_begin_step:
            return None
        period = max(self.rampup_step // len(self.sparsity), 1)
        i = (t - self.rampup_begin_step - 1) // period
        return self.sparsity[min(i, len(self.sparsity) - 1)]

    # -- state ---------------------------------------------------------------
    def init(self, params):
        zeros = lambda: {n: torch.zeros_like(  # noqa: E731
            p.detach(), dtype=torch.float32) for n, p in params.items()}
        return {"count": 0, "velocity": zeros(), "u": zeros(),
                "v": zeros()}

    # -- the update ----------------------------------------------------------
    def update(self, grads, state, params, lr=None, group=None):
        """Pure update over the data group (``group``: an axis name or
        ``AxisGroup``; ``"data"`` by default): returns ``(new_params,
        new_state)`` — the JAX signature; the phase is
        ``_sparsity_now``."""
        new_params = {k: p.detach().clone() for k, p in params.items()}
        new_state = {"count": state["count"],
                     **{s: {k: v.clone() for k, v in state[s].items()}
                        for s in ("velocity", "u", "v")}}
        self._dgc(grads, new_state, new_params, lr,
                  self._sparsity_now, group or self._axis)
        return new_params, new_state

    def _dgc(self, grads, state, params, lr, sparsity, group):
        """One step IN PLACE on ``params`` and ``state``."""
        from ..distributed.collective import (_all_reduce_coalesced,
                                              _gather_list, _group)

        if lr is None:
            lr = self.get_lr()
        g_axis = _group(group)
        ndp = g_axis.size
        grads = {n: g for n, g in grads.items() if g is not None}
        if self._grad_clip is not None and sparsity is not None:
            # sparse phase: each rank clips before compressing, like the
            # reference's dgc_clip_by_norm
            grads = self._grad_clip(grads)
        if sparsity is None:
            # dense warmup: average FIRST (parity with plain DP Momentum),
            # then clip the averaged gradient; SelectedRows leaves are
            # gathered before the clip so every rank sees the same norm
            dense = {n: g.float().clone() for n, g in grads.items()
                     if not isinstance(g, SelectedRows)}
            vals = list(dense.values())
            _all_reduce_coalesced(vals, g_axis)
            torch._foreach_div_(vals, float(ndp)) if vals else None
            grads = {n: (all_gather_rows(g, g_axis, scale=1.0 / ndp).merged()
                         if isinstance(g, SelectedRows) else dense[n])
                     for n, g in grads.items()}
            if self._grad_clip is not None:
                grads = self._grad_clip(grads)
        state["count"] += 1
        m = self._momentum
        with torch.no_grad():
            for name, p in params.items():
                g = grads.get(name)
                if g is None:
                    continue
                if isinstance(g, SelectedRows):
                    # sparse-embedding rows are never compressed: they ride
                    # the sparse all-reduce and take plain momentum on the
                    # touched rows (details/sparse_all_reduce_op_handle.cc)
                    if sparsity is not None:
                        g = all_gather_rows(g, g_axis, scale=1.0 / ndp)
                    self._momentum_rows(p, g.merged(), state["velocity"][name],
                                        lr)
                    continue
                g = g.float()
                w = p.float()
                if self._regularizer is not None:
                    g = g + self._regularizer(w)
                elif self._weight_decay:
                    g = g + self._weight_decay * w
                if sparsity is None:
                    vel = state["velocity"][name]
                    vel.mul_(m).add_(g)
                    step_dir = g + m * vel if self._nesterov else vel
                    p.copy_((w - lr * step_dir).to(p.dtype))
                    continue
                u, v = state["u"][name], state["v"][name]
                if self._nesterov:
                    # reference dgc_op.h:151 — u = m·(u+g); v = v + u + g
                    u.add_(g).mul_(m)
                    v.add_(u).add_(g)
                else:
                    u.mul_(m).add_(g)
                    v.add_(u)
                flat_v, flat_u = v.view(-1), u.view(-1)
                n = flat_v.numel()
                k = max(int(round(n * (1.0 - sparsity))), 1)
                idx = topk_indices(flat_v, k)
                vals = flat_v[idx]
                # error feedback: what is sent leaves the accumulators
                flat_v[idx] = 0.0
                flat_u[idx] = 0.0
                all_idx = torch.cat(_gather_list(g_axis, idx, "all_gather"))
                all_vals = torch.cat(_gather_list(g_axis, vals, "all_gather"))
                summed = SelectedRows(all_idx, all_vals[:, None], n).to_dense()
                dense = summed.view(p.shape) / ndp
                p.copy_((w - lr * dense).to(p.dtype))

    def _momentum_rows(self, p, sr, vel, lr):
        """Momentum on the touched rows of a merged SelectedRows."""
        if sr.ids.shape[0] == 0:
            return
        ids, values, keep = safe_rows(sr)
        w_rows = p.index_select(0, ids).float()
        g_rows = values.float()
        if self._regularizer is not None:
            g_rows = g_rows + self._regularizer(w_rows)
        elif self._weight_decay:
            g_rows = g_rows + self._weight_decay * w_rows
        v_rows = vel.index_select(0, ids)
        v_new = self._momentum * v_rows + g_rows
        step_dir = (g_rows + self._momentum * v_new if self._nesterov
                    else v_new)
        new_w = torch.where(keep, w_rows - lr * step_dir, w_rows)
        vel.index_copy_(0, ids, torch.where(keep, v_new, v_rows))
        p.index_copy_(0, ids, new_w.to(p.dtype))

    def step(self, grads=None, _plan=None):
        raise InvalidArgumentError(
            "DGCMomentum only runs through Model.prepare/fit with "
            "strategy.dgc — the compression exchange needs the mesh data "
            "axis; the eager step() path has no per-replica accumulators")
