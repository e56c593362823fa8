"""ShardingPlan — a DistributedStrategy made explicit (port of
``paddle_tpu.distributed.fleet.plan``).

The JAX plan assigns a ``NamedSharding`` to every value of one jitted
step and GSPMD inserts the collectives.  The port runs one process per
rank, so the plan does each step itself:

* **placement** (:meth:`place_network`): every parameter and buffer is
  broadcast from rank 0 (replicas start equal), then each parameter whose
  ``partition_spec`` names a mesh axis of size > 1 is sliced to this
  rank's shard (``meta_parallel.shard``), so a whole JAX tree loaded with
  ``bridge.load_jax_params`` lands on any rank;
* **batch** (:meth:`shard_batch`): every rank takes the same global
  batch and keeps its rows over :func:`~..mesh.data_axes`, with JAX's
  error for an indivisible batch;
* **gradients** (:meth:`sync_gradients`): averaged over the data axes,
  one all-reduce per dtype;
* **ZeRO-1** (``sharding`` > 1): each sharding rank keeps the optimizer
  slots — and the float32 masters under ``multi_precision`` — of one
  slice of every parameter, on the dimension JAX's ``_dim_to_shard``
  picks (past the tensor-parallel dims), updates its slice of the
  parameters and all-gathers them; parameters stay whole for the forward,
  as in JAX;
* **clipping** (:meth:`_clip`): the norms of tensor-parallel gradient
  shards are summed over their axes before the scale is taken, so
  ``ClipGradByNorm`` / ``ClipGradByGlobalNorm`` see the whole
  parameters.

``gather_parameters`` returns the whole parameters on every rank (what
the JAX package's arrays hold).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ...framework.errors import InvalidArgumentError, UnimplementedError
from ..mesh import PartitionSpec, data_axes, get_mesh
from .. import collective as C
from ..meta_parallel import shard, unshard

__all__ = ["ShardingPlan"]


def _dim_to_shard(shape, axis_size: int, taken_axes) -> Optional[int]:
    """First dim divisible by axis_size that isn't already sharded."""
    for d, s in enumerate(shape):
        if d in taken_axes:
            continue
        if s % axis_size == 0 and s >= axis_size:
            return d
    return None


class ShardingPlan:
    def __init__(self, network, optimizer, strategy, mesh=None):
        self.network = network
        self.optimizer = optimizer
        self.strategy = strategy
        self.mesh = mesh or get_mesh()
        self._batch_axes = tuple(data_axes(self.mesh))
        self._zero = self.mesh.shape.get("sharding", 1) > 1
        # parameter specs from layer annotations (TP); default replicated
        self.param_specs: Dict[str, PartitionSpec] = {}
        self._full_shapes: Dict[str, Tuple[int, ...]] = {}
        for name, p in network.named_parameters():
            spec = getattr(p, "partition_spec", None)
            self.param_specs[name] = PartitionSpec(*spec) if spec \
                else PartitionSpec()
            # a parameter an earlier plan sliced remembers its whole shape
            self._full_shapes[name] = getattr(p, "full_shape",
                                              tuple(p.shape))
        #: ZeRO: name -> (dim, this rank's slice of the parameter)
        self._zero_shards: Dict[str, Tuple[int, torch.Tensor]] = {}
        self._placed = False

    @property
    def n_data_shards(self) -> int:
        n = 1
        for a in self._batch_axes:
            n *= self.mesh.shape[a]
        return n

    @property
    def sharded(self) -> bool:
        """Whether a rank holds part of some parameter or optimizer slot
        (tensor parallelism or ZeRO)."""
        return self._zero or any(self._sharded_axes(s)
                                 for s in self.param_specs.values())

    def _sharded_axes(self, spec) -> List[Tuple[int, str]]:
        return [(d, a) for d, a in enumerate(spec)
                if a is not None and self.mesh.shape.get(a, 1) > 1]

    # -- placement -----------------------------------------------------------
    def place_network(self):
        """Make the replicas equal (broadcast from rank 0 of the world),
        then slice every parameter to this rank's ``partition_spec``
        shard.  Runs once."""
        if self._placed:
            return
        net = self.network
        if self.mesh.shape.get("model", 1) > 1:
            for mod in net.modules():
                if hasattr(mod, "shardable"):
                    mod.shardable()
        # shards an earlier plan placed differ between ranks: left alone
        whole = [(n, p) for n, p in net.named_parameters()
                 if tuple(p.shape) == self._full_shapes[n]]
        world = self.mesh.group(tuple(self.mesh.axis_names))
        C._broadcast_coalesced([p.data for _, p in whole]
                               + list(net.buffers()), world, src=0)
        with torch.no_grad():
            for name, p in whole:
                spec = self.param_specs[name]
                data = p.data
                p.full_shape = self._full_shapes[name]
                for d, a in self._sharded_axes(spec):
                    g = self.mesh.group(a)
                    data = shard(data, d, g.index, g.size,
                                 getattr(p, "partition_groups", 1))
                if data is not p.data:
                    p.data = data.contiguous().clone()
        self._placed = True

    def gather_parameters(self) -> Dict[str, torch.Tensor]:
        """The whole parameters (tensor-parallel shards joined), on every
        rank, detached."""
        out = {}
        for name, p in self.network.named_parameters():
            t = p.detach()
            for d, a in reversed(self._sharded_axes(self.param_specs[name])):
                g = self.mesh.group(a)
                t = unshard(C._gather_list(g, t.contiguous(), "all_gather"),
                            d, getattr(p, "partition_groups", 1))
            out[name] = t
        return out

    # -- batch ---------------------------------------------------------------
    def data_group(self):
        return self.mesh.group(self._batch_axes)

    def shard_batch(self, batch):
        """This rank's rows of every array of a global batch."""
        n_shards = self.n_data_shards
        g = self.data_group()
        out = []
        for b in batch:
            shape = tuple(getattr(b, "shape", ()))
            if not shape or shape[0] % n_shards != 0:
                raise InvalidArgumentError(
                    f"batch dim {shape[:1]} not divisible by the "
                    f"{n_shards} data-parallel shards; use a batch size "
                    f"divisible by {n_shards} and drop_last=True (Model.fit "
                    f"does this automatically for partial final batches)"
                )
            rows = shape[0] // n_shards
            out.append(b[g.index * rows:(g.index + 1) * rows])
        return tuple(out)

    def gather_batch(self, t):
        """Every data shard's rows joined (outputs of this rank's rows →
        the global batch's); nested tuples / lists are walked."""
        if isinstance(t, (tuple, list)):
            return type(t)(self.gather_batch(x) for x in t)
        if not isinstance(t, torch.Tensor) or self.n_data_shards == 1:
            return t
        return C._gather_cat(t.detach().contiguous(), self.data_group(), 0)

    def mean_loss(self, loss):
        """The global mean of a per-shard mean loss (equal shards)."""
        if self.n_data_shards == 1:
            return loss
        return C.all_reduce(loss.detach().clone(),
                            group=self.data_group()) / self.n_data_shards

    # -- the optimizer side --------------------------------------------------
    def bind_optimizer(self):
        """Bind the optimizer to what this rank updates: the parameters,
        or under ZeRO this rank's slice of each (slots and masters then
        hold the slice only)."""
        opt = self.optimizer
        from ...optimizer.optimizer import Lamb, Lars

        if self.sharded and isinstance(opt, (Lamb, Lars)):
            raise UnimplementedError(
                f"{type(opt).__name__} takes whole-parameter norms; on "
                f"sharded parameters it is not ported yet (ROADMAP queue A, "
                f"distributed execution)")
        params = dict(self.network.named_parameters())
        if not self._zero:
            opt._bind(params)
            return
        s = self.mesh.shape["sharding"]
        g = self.mesh.group("sharding")
        bound = {}
        for name, p in params.items():
            taken = {d for d, a in enumerate(self.param_specs[name])
                     if a is not None}
            d = _dim_to_shard(self._full_shapes[name], s, taken)
            if d is None or not p.requires_grad:
                bound[name] = p
                continue
            piece = shard(p.detach(), d, g.index, s).clone()
            piece.requires_grad_(True)
            self._zero_shards[name] = (d, piece)
            bound[name] = piece
        opt._bind(bound)

    def sync_gradients(self):
        """Average the gradients over the data axes (in place)."""
        if self.n_data_shards == 1:
            return
        grads = [p.grad for p in self.network.parameters()
                 if p.grad is not None]
        C._all_reduce_coalesced(grads, self.data_group())
        inv = 1.0 / self.n_data_shards
        torch._foreach_mul_(grads, inv)

    def _clip(self, grads):
        """The optimizer's clip over whole parameters: the squared norms
        of tensor-parallel shards summed over their axes first."""
        from ...optimizer.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                                       _scaled, _sq_norm)

        clip = self.optimizer._grad_clip
        if not isinstance(clip, (ClipGradByNorm, ClipGradByGlobalNorm)):
            return clip(grads)
        sq = {n: _sq_norm(g) for n, g in grads.items()}
        by_axes: Dict[tuple, List[str]] = {}
        for n in grads:
            axes = tuple(a for _, a in self._sharded_axes(
                self.param_specs.get(n, ())))
            if axes:
                by_axes.setdefault(axes, []).append(n)
        for axes, names in by_axes.items():
            v = C.all_reduce(torch.stack([sq[n] for n in names]),
                             group=axes)
            for i, n in enumerate(names):
                sq[n] = v[i]
        if isinstance(clip, ClipGradByNorm):
            return {n: _scaled(g, (clip.clip_norm / sq[n].sqrt().clamp_min(
                1e-12)).clamp_max(1.0)) for n, g in grads.items()}
        if not grads:
            return grads
        gnorm = torch.stack(list(sq.values())).sum().sqrt()
        scale = clip.clip_norm / gnorm.clamp_min(clip.clip_norm)
        return {n: _scaled(g, scale) for n, g in grads.items()}

    def step(self, plan=None):
        """The optimizer step on this rank's share, then the ZeRO
        all-gather of the updated slices.  ``plan``: the step's host half
        (``Optimizer._plan``), where one was taken."""
        opt = self.optimizer
        params = dict(self.network.named_parameters())
        if not self.sharded:
            opt.step() if plan is None else opt.step(_plan=plan)
            return
        grads = {n: p.grad for n, p in params.items()
                 if p.requires_grad and p.grad is not None}
        if opt._grad_clip is not None:
            grads = self._clip(grads)
        for n, (d, piece) in self._zero_shards.items():
            if n in grads:
                grads[n] = shard(grads[n], d, self.mesh.group(
                    "sharding").index, self.mesh.shape["sharding"])
        clip, opt._grad_clip = opt._grad_clip, None
        try:
            bound = opt._bound()
            full = {n: grads.get(n) for n in bound}
            if plan is None:
                opt.step(full)
            else:
                opt.step(full, _plan=plan)
        finally:
            opt._grad_clip = clip
        if self._zero_shards:
            g = self.mesh.group("sharding")
            with torch.no_grad():
                for n, (d, piece) in self._zero_shards.items():
                    params[n].data.copy_(
                        C._gather_cat(piece.detach().contiguous(), g, d))
