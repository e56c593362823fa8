"""Comm-precision data parallelism: the gradient mean in 16 bits (port of
``paddle_tpu.distributed.fleet.fp16_allreduce``).

Reference capability: FP16AllReduceOptimizer
(fleet/meta_optimizers/fp16_allreduce_optimizer.py:18) casts each
gradient to fp16 before its all-reduce and back after.  Here each rank's
gradients are pre-scaled by ``1/n`` (a sum of fp16 values could overflow
where the mean does not), cast to the wire dtype, summed over the data
axis in one flat buffer a dtype (the wire is half the float32 plan's
bytes: ``collective_stats()`` counts them) and cast back; the optimizer
update runs in the parameters' dtype.  SelectedRows leaves ride the
sparse all-reduce (``all_gather_rows`` with the values on the wire in the
comm dtype), as the reference composes the two.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as tdist

from ...framework.errors import InvalidArgumentError
from .. import collective as C
from .plan import ShardingPlan

__all__ = ["Fp16AllReducePlan"]

_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16}


class Fp16AllReducePlan(ShardingPlan):
    def __init__(self, network, optimizer, strategy, mesh=None):
        super().__init__(network, optimizer, strategy, mesh)
        self._require_pure_dp("fp16_allreduce")
        cfg = strategy.fp16_allreduce_configs or {}
        name = cfg.get("dtype")
        if name is None:
            # pre-scaling by 1/n trades overflow for underflow: past 8
            # replicas bfloat16 (same wire bytes, float32's exponent range)
            name = "float16" if self.mesh.shape.get("data", 1) <= 8 \
                else "bfloat16"
        name = str(name)
        if name not in _DTYPES:
            raise InvalidArgumentError(
                f"fp16_allreduce dtype must be float16/bfloat16, got {name!r}")
        self.comm_dtype = _DTYPES[name]
        self.axis = "data"

    def _wire_mean(self, grads):
        """Every dense gradient of ``grads`` replaced IN PLACE by its mean
        over the data axis, summed on the wire in ``comm_dtype``."""
        n = self.n_data_shards
        g = self.data_group()
        if n == 1 or not grads or g.pg is None:
            return
        by_dev: Dict[torch.device, list] = {}
        for t in grads:
            by_dev.setdefault(t.device, []).append(t)
        for ts in by_dev.values():
            flat = torch.cat([(t.float() / n).reshape(-1) for t in ts]).to(
                self.comm_dtype)
            h = C._Host(g, flat.device)
            buf = h.put(flat)
            tdist.all_reduce(buf, group=g.pg)
            out = h.back(buf, flat.device)
            C._count("all_reduce", h.staged)
            off = 0
            with torch.no_grad():
                for t in ts:
                    k = t.numel()
                    t.copy_(out[off:off + k].reshape(t.shape).to(t.dtype))
                    off += k

    def sync_gradients(self):
        self._wire_mean([p.grad for p in self.network.parameters()
                         if p.grad is not None])

    def reduce_gradients(self, grads):
        from ...framework.selected_rows import SelectedRows, all_gather_rows

        n = self.n_data_shards
        if n == 1:
            return grads
        self._wire_mean([v for v in grads.values()
                         if v is not None and not isinstance(v, SelectedRows)])
        return {k: (all_gather_rows(v, self.data_group(), scale=1.0 / n,
                                    wire_dtype=self.comm_dtype)
                    if isinstance(v, SelectedRows) else v)
                for k, v in grads.items()}
