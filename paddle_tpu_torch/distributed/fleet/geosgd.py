"""Geo-SGD — local steps with periodic parameter-DELTA synchronization
(port of ``paddle_tpu.distributed.fleet.geosgd``).

Parity: the reference's Geo-SGD mode (transpiler/geo_sgd_transpiler.py:1
+ operators/distributed/communicator.h:413 GeoCommunicator): workers
train locally; every ``k_steps`` each sends the delta of its parameters
since its last send and merges the mean delta into its local parameters
WITHOUT resetting them, so the replicas keep their drift — what sets Geo
apart from LocalSGD's reset to the average.  At a sync step:

    delta       = local − snapshot          (this rank)
    mean_delta  = mean over data of delta   (the server's aggregate)
    global     += mean_delta                (the Model-visible copy)
    local      += mean_delta                (the merge — no reset)
    snapshot    = local

Buffers have no delta semantics: they are averaged and every replica
takes the average, as in LocalSGD.  With every replica starting from one
global copy, the first window's global update equals LocalSGD's average.
LocalSGD's state layout and step; only the sync differs.
"""
from __future__ import annotations

import torch

from ...framework.errors import InvalidArgumentError
from .. import collective as C
from .localsgd import LocalSGDPlan

__all__ = ["GeoSgdPlan"]


class GeoSgdPlan(LocalSGDPlan):
    _FEATURE = "a_sync (Geo-SGD)"

    def __init__(self, network, optimizer, strategy, mesh=None):
        super().__init__(network, optimizer, strategy, mesh)
        cfg = getattr(strategy, "a_sync_configs", None) or {}
        self.k_steps = int(cfg.get("k_steps", 0))
        if self.k_steps <= 0:
            raise InvalidArgumentError(
                "GeoSgdPlan needs a_sync_configs={'k_steps': N>0} "
                "(N local steps per delta push)")
        self.begin_step = 1  # geo has no dense warmup in the reference
        if getattr(strategy, "localsgd", False) or \
                getattr(strategy, "adaptive_localsgd", False):
            raise InvalidArgumentError(
                "a_sync(geo) and localsgd are mutually exclusive sync "
                "strategies — pick one")
        self.snapshot = {}

    def place_network(self):
        if self._placed:
            return
        super().place_network()
        self.snapshot = {n: t.clone() for n, t in self.local.items()}

    def opt_state(self):
        state = super().opt_state()
        state["local"]["snapshot"] = self.snapshot
        return state

    def _sync(self, loss):
        names = list(self.local)
        bufs = self._float_buffers()
        deltas = [self.local[n].float() - self.snapshot[n].float()
                  for n in names]
        lbox = loss.float().reshape(1).clone()
        ts = deltas + [self.local_buffers[k] for k in bufs] + [lbox]
        C._all_reduce_coalesced(ts, self.data_group())
        with torch.no_grad():
            torch._foreach_div_(ts, float(self.ndp))
            for n, d in zip(names, deltas):
                g, loc = self.synced[n], self.local[n]
                g.copy_((g.float() + d).to(g.dtype))
                loc.copy_((loc.float() + d).to(loc.dtype))
                self.snapshot[n].copy_(loc)
            for k in bufs:
                self.synced_buffers[k].copy_(self.local_buffers[k])
        return lbox.reshape(())
