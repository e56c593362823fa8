"""LocalSGD data parallelism — k local steps per replica, then model
averaging (port of ``paddle_tpu.distributed.fleet.localsgd``).

Parity: the reference's LocalSGD transpiler (transpiler/collective.py:270
— snapshot vars and a c_allreduce of the parameters every ``k_steps``)
and the fleet meta-optimizer (fleet/meta_optimizers/localsgd_optimizer.py).

Each data rank advances its own replica — parameters, optimizer slots and
buffers — with no collective between syncs; every ``k_steps`` (and every
step before ``begin_step``) the replicas' parameters and buffers are
averaged over ``data`` in one coalesced all-reduce and every replica
restarts from the average.  The JAX package stacks the replicas
``[ndp, ...]`` in its optimizer state; a port rank holds its own
(``Model._opt_state["local"]``: ``params``, ``inner`` — the optimizer's
state — and ``buffers``).  The ``Model``-visible parameters and buffers
are the last synced values: the network computes with the local replica
only inside a train step.

The loss a local step returns is this rank's (the step makes no
collective); a sync step returns the replicas' mean, which the JAX step
returns every step.  The adaptive plan averages the loss every step: its
period rule reads it.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .. import collective as C
from .plan import ShardingPlan

__all__ = ["LocalSGDPlan", "AdaptiveLocalSGDPlan"]


class LocalSGDPlan(ShardingPlan):
    """ShardingPlan variant where the ``data`` ranks hold independent
    replicas between sync points."""

    _FEATURE = "localsgd"  # the flag named in mesh-compat errors
    #: average the loss at local steps too (the adaptive period rule)
    _MEAN_LOSS_EVERY_STEP = False

    def __init__(self, network, optimizer, strategy, mesh=None):
        super().__init__(network, optimizer, strategy, mesh)
        self._require_pure_dp(self._FEATURE)
        cfg = getattr(strategy, "localsgd_configs", None) or {}
        self.k_steps = max(int(cfg.get("k_steps", 1)), 1)
        self.begin_step = max(int(cfg.get("begin_step", 1)), 1)
        self.axis = "data"
        self.ndp = self.mesh.shape["data"]
        self._t = 0
        self._last_sync = 0
        self.synced: Dict[str, torch.Tensor] = {}
        self.local: Dict[str, torch.Tensor] = {}
        self.synced_buffers: Dict[str, torch.Tensor] = {}
        self.local_buffers: Dict[str, torch.Tensor] = {}
        self._buffer_slots: List[Tuple[torch.nn.Module, str, str]] = []

    # -- state ---------------------------------------------------------------
    def place_network(self):
        if self._placed:
            return
        super().place_network()
        for n, p in self.network.named_parameters():
            self.synced[n] = p.data
            self.local[n] = p.data.clone()
        for mod_name, mod in self.network.named_modules():
            for leaf, b in mod._buffers.items():
                if b is None:
                    continue
                full = f"{mod_name}.{leaf}" if mod_name else leaf
                self._buffer_slots.append((mod, leaf, full))
                self.synced_buffers[full] = b
                self.local_buffers[full] = b.clone()

    def opt_state(self):
        """``{"count", "local": {"params", "inner", "buffers"}}`` — this
        rank's replica (JAX: every replica, stacked)."""
        return {"count": self._t,
                "local": {"params": self.local,
                          "inner": self.optimizer._state,
                          "buffers": self.local_buffers}}

    def _show(self, local: bool):
        """Point the network at the local replica or at the synced one."""
        params = self.local if local else self.synced
        bufs = self.local_buffers if local else self.synced_buffers
        for n, p in self.network.named_parameters():
            p.data = params[n]
        for mod, leaf, full in self._buffer_slots:
            mod._buffers[leaf] = bufs[full]

    # -- step ----------------------------------------------------------------
    def train_step(self, model, batch, step_plan=None):
        t = self._t + 1
        sync = t < self.begin_step or (t - self._last_sync) >= self.k_steps
        opt = self.optimizer
        self._show(local=True)
        try:
            if model._sparse:
                loss, out, labels, grads = model._sparse_grads(batch)
                args = ({n: grads.get(n) for n in opt._bound()},)
            else:
                loss, out, labels = model._forward_loss(batch)
                loss.backward()
                args = ()
            opt.step(*args) if step_plan is None else opt.step(
                *args, _plan=step_plan)
            for p in self.network.parameters():
                p.grad = None
            for mod, leaf, full in self._buffer_slots:  # a forward may
                self.local_buffers[full] = mod._buffers[leaf]  # rebind one
            loss = loss.detach()
            if sync:
                loss = self._sync(loss)
            elif self._MEAN_LOSS_EVERY_STEP:
                loss = self.mean_loss(loss)
        finally:
            self._show(local=False)
        self._t = t
        if sync:
            self._last_sync = t
        self._after_step(t, sync, loss, opt.get_lr())
        return loss, out, labels

    def _float_buffers(self):
        return [k for k, b in self.local_buffers.items()
                if b.is_floating_point()]

    def _sync(self, loss):
        """Average the replicas (parameters, float buffers and the loss)
        over ``data``; every replica and the visible copy take the mean."""
        names = list(self.local)
        bufs = self._float_buffers()
        lbox = loss.float().reshape(1).clone()
        ts = [self.local[n] for n in names] + \
            [self.local_buffers[k] for k in bufs] + [lbox]
        C._all_reduce_coalesced(ts, self.data_group())
        with torch.no_grad():
            torch._foreach_div_(ts, float(self.ndp))
            for n in names:
                self.synced[n].copy_(self.local[n])
            for k in bufs:
                self.synced_buffers[k].copy_(self.local_buffers[k])
        return lbox.reshape(())

    def _after_step(self, t, synced, loss, lr):
        """Hook for host-side schedule adaptation (AdaptiveLocalSGDPlan)."""


class AdaptiveLocalSGDPlan(LocalSGDPlan):
    """Step-adaptive LocalSGD (ref: fleet/meta_optimizers/
    localsgd_optimizer.py:194 AdaptiveLocalSGDOptimizer): the sync period
    adapts to training progress,

        k = clip(ceil(sqrt(lr0 * loss / (lr * loss0) * init_k)), 1, 16)

    recomputed at every sync point from the replica-averaged loss (lr0 /
    loss0 recorded at step 1, :352-433 in the reference)."""

    MAX_K, MIN_K = 16, 1  # the reference's clamp constants (:425-431)
    _MEAN_LOSS_EVERY_STEP = True

    def __init__(self, network, optimizer, strategy, mesh=None):
        cfg = getattr(strategy, "adaptive_localsgd_configs", None) or {}
        super().__init__(network, optimizer, strategy, mesh)
        self.init_k_steps = max(int(cfg.get("init_k_steps", 1)), 1)
        self.begin_step = max(int(cfg.get("begin_step", 1)), 1)
        self.k_steps = self.init_k_steps
        self._loss0 = None
        self._lr0 = None

    def _after_step(self, t, synced, loss, lr):
        if self._loss0 is None:
            # the reference records (loss0, lr0) at step 1; a non-finite
            # first loss waits for a finite one
            l0, r0 = float(loss), float(lr)
            if math.isfinite(l0) and math.isfinite(r0):
                self._loss0 = max(l0, 1e-12)
                self._lr0 = max(r0, 1e-12)
            return
        if not synced:
            return
        ratio = (self._lr0 * max(float(loss), 0.0)) / \
            (max(float(lr), 1e-12) * self._loss0)
        if not math.isfinite(ratio):  # divergence spike: sync at max period
            self.k_steps = self.MAX_K
            return
        next_k = math.ceil(math.sqrt(ratio * self.init_k_steps))
        self.k_steps = int(min(self.MAX_K, max(self.MIN_K, next_k)))
