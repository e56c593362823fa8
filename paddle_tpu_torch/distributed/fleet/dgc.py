"""DGC execution plan (port of ``paddle_tpu.distributed.fleet.dgc``): the
train step keeps each data rank's gradients its own and hands them to
``DGCMomentum``, which exchanges them compressed.

Parity: the reference's DGC meta-optimizer path (fluid/optimizer.py:1129
DGCMomentumOptimizer + operators/dgc_op.cc).  The parameters and the
dense-warmup velocity stay equal on every rank (each applies the same
update); ``u`` / ``v``, each rank's unsent gradient mass, are this rank's
(JAX stacks them ``[ndp, ...]`` sharded over ``data``).  The sparsity
ramp-up resolves on the host: each step's phase is
``DGCMomentum.sparsity_at(t)``.  Buffers are averaged over ``data`` after
every step (the global-batch statistics), and the loss is the replicas'
mean.
"""
from __future__ import annotations

import torch

from ...framework.errors import InvalidArgumentError
from .. import collective as C
from .plan import ShardingPlan

__all__ = ["DGCPlan"]


class DGCPlan(ShardingPlan):
    def __init__(self, network, optimizer, strategy, mesh=None):
        super().__init__(network, optimizer, strategy, mesh)
        self._require_pure_dp("dgc")
        from ...optimizer.dgc import DGCMomentum

        if not isinstance(optimizer, DGCMomentum):
            raise InvalidArgumentError(
                "strategy.dgc requires a Momentum optimizer (reference "
                "_can_apply); fleet.distributed_optimizer converts one")
        self.axis = "data"
        self.ndp = self.mesh.shape["data"]
        self._t = 0

    def opt_state(self):
        """``{"count", "velocity", "u", "v"}`` — ``u`` / ``v`` this
        rank's."""
        return self.optimizer._state

    def train_step(self, model, batch, step_plan=None):
        opt = self.optimizer
        if model._sparse:
            loss, out, labels, grads = model._sparse_grads(batch)
        else:
            loss, out, labels = model._forward_loss(batch)
            loss.backward()
            grads = {n: p.grad for n, p in self.network.named_parameters()}
        bound = opt._bound()
        t = self._t + 1
        phase = opt.sparsity_at(t)
        opt._sparsity_now = phase
        opt._dgc({n: grads.get(n) for n in bound}, opt._ensure_state(),
                 bound, opt.get_lr(), phase, self.data_group())
        self._t = t
        for p in self.network.parameters():
            p.grad = None
        bufs = [b for b in self.network.buffers() if b.is_floating_point()]
        if bufs and self.ndp > 1:
            C._all_reduce_coalesced(bufs, self.data_group())
            with torch.no_grad():
                torch._foreach_div_(bufs, float(self.ndp))
        return self.mean_loss(loss.detach()), out, labels
