"""paddle_tpu_torch.distributed.fleet — the distributed-training control
plane (port of ``paddle_tpu.distributed.fleet``).  Usage is the JAX
package's four lines, run on every rank:

    strategy = fleet.DistributedStrategy(sharding=True)
    fleet.init(is_collective=True, strategy=strategy)
    opt = fleet.distributed_optimizer(paddle_tpu_torch.optimizer.Adam(...))
    model = paddle_tpu_torch.Model(net); model.prepare(opt, loss); model.fit(...)

``init`` joins the process group (``init_parallel_env``) and builds the
hybrid rank mesh (``pipe``, ``data``, ``sharding``, ``sep``, ``expert``,
``model``); ``distributed_optimizer`` composes the strategy's
optimizer-level features (``lamb``, ``lars``, ``gradient_merge``, the DGC
swap of a ``Momentum`` for ``DGCMomentum``) and tags the optimizer;
``Model.prepare`` turns the tag into the strategy's plan: Geo-SGD
(``a_sync`` with ``k_steps``), adaptive LocalSGD, LocalSGD, DGC,
fp16_allreduce, else the :class:`ShardingPlan` (with a pipeline over
``pipe``).  Parameter-server mode, and ``a_sync`` with ``k_steps=0``, are
rejected as in JAX.  ``fleet.metrics``, ``fleet.utils`` and
``fleet.data_generator`` are the JAX package's host modules.
"""
from __future__ import annotations

from typing import Optional

from ...framework.errors import InvalidArgumentError, UnimplementedError
from .. import env as _env
from . import data_generator, metrics, utils  # noqa: F401
from .utils import HDFSClient, LocalFS  # noqa: F401  (ref fleet/utils)
from ..mesh import build_mesh, get_mesh, set_mesh
from .plan import ShardingPlan
from .strategy import DistributedStrategy

__all__ = [
    "DistributedStrategy",
    "ShardingPlan",
    "metrics",
    "init",
    "distributed_optimizer",
    "distributed_model",
    "worker_num",
    "worker_index",
    "is_first_worker",
    "barrier_worker",
    "stop_worker",
    "get_strategy",
    "is_initialized",
]

_strategy: Optional[DistributedStrategy] = None
_initialized = False


def init(role_maker=None, is_collective: bool = True,
         strategy: Optional[DistributedStrategy] = None, devices=None):
    """Join the process group, build the hybrid mesh from the strategy
    degrees over the ranks and mark fleet active.  ``role_maker`` is
    accepted for parity and ignored (rank wiring comes from the launch
    environment).  ``devices``: the ranks of the mesh (all by default)."""
    global _strategy, _initialized
    if not is_collective:
        raise InvalidArgumentError(
            "parameter-server mode is not supported on TPU; capabilities are "
            "covered by sharded arrays (see SURVEY §7 translation table)"
        )
    strategy = strategy or DistributedStrategy()
    _env.init_parallel_env()
    devices = (list(devices) if devices is not None
               else list(range(_env.get_world_size())))
    n = len(devices)
    fixed = (strategy.mp_degree * strategy.pp_degree * strategy.sep_degree
             * strategy.ep_degree)
    sharding_degree = strategy.sharding_degree
    dp = strategy.dp_degree
    if strategy.sharding and sharding_degree in (0, 1):
        # span the ranks an explicit dp_degree doesn't claim
        sharding_degree = n // (fixed * (dp or 1))
        if sharding_degree < 1:
            raise InvalidArgumentError(
                f"mp*pp*sep*dp degrees ({fixed * (dp or 1)}) exceed the "
                f"device count {n}; no devices left for the sharding axis"
            )
    if strategy.sharding and dp in (0, None):
        dp = n // (fixed * sharding_degree)
    mesh = build_mesh(
        dp=dp or 0,
        mp=strategy.mp_degree,
        pp=strategy.pp_degree,
        sep=strategy.sep_degree,
        sharding=max(sharding_degree, 1),
        ep=strategy.ep_degree,
        devices=devices,
    )
    set_mesh(mesh)
    strategy.sharding_degree = max(sharding_degree, 1)
    _strategy = strategy
    _initialized = True
    return mesh


def is_initialized() -> bool:
    return _initialized


def get_strategy() -> Optional[DistributedStrategy]:
    return _strategy


def distributed_optimizer(optimizer,
                          strategy: Optional[DistributedStrategy] = None):
    """Compose the strategy's optimizer-level features (``lamb``,
    ``lars``, ``gradient_merge``, the DGC swap) and tag the result for
    distributed execution; ``Model.prepare`` builds the plan from the
    tag."""
    global _strategy
    if not _initialized:
        raise InvalidArgumentError(
            "call fleet.init() before distributed_optimizer")
    st = strategy or _strategy or DistributedStrategy()

    if (st.localsgd or st.adaptive_localsgd) and st.gradient_merge:
        raise InvalidArgumentError(
            "strategy.localsgd/adaptive_localsgd does not compose with "
            "gradient_merge (the reference meta-optimizers are mutually "
            "exclusive too)")
    if st.localsgd and st.adaptive_localsgd:
        raise InvalidArgumentError(
            "pick ONE of strategy.localsgd / strategy.adaptive_localsgd "
            "(the reference meta-optimizers black-list each other)")
    if st.dgc:
        # reference: the DGC meta-optimizer applies only to Momentum
        # (fleet/meta_optimizers/dgc_optimizer.py _can_apply); swap it for
        # DGCMomentum, which compresses inside the DGCPlan's step
        from ...optimizer.dgc import DGCMomentum
        from ...optimizer.optimizer import Momentum as _Momentum

        for other in ("localsgd", "adaptive_localsgd", "lamb", "lars",
                      "gradient_merge"):
            if getattr(st, other):
                raise InvalidArgumentError(
                    f"strategy.dgc does not compose with {other} (the "
                    "reference meta-optimizers are mutually exclusive too)")
        if not isinstance(optimizer, (DGCMomentum, _Momentum)):
            raise InvalidArgumentError(
                "strategy.dgc applies to a Momentum optimizer (reference "
                "dgc_optimizer.py _can_apply)")
        if not isinstance(optimizer, DGCMomentum):
            if optimizer._multi_precision:
                raise InvalidArgumentError(
                    "strategy.dgc has no multi_precision support (the u/v "
                    "accumulators are f32 already); construct the Momentum "
                    "with multi_precision=False")
            cfg = st.dgc_configs or {}
            optimizer = DGCMomentum(
                learning_rate=optimizer._learning_rate,
                momentum=optimizer._momentum,
                parameters=optimizer._params,
                rampup_begin_step=int(cfg.get("rampup_begin_step", 0)),
                rampup_step=int(cfg.get("rampup_step", 1)),
                sparsity=cfg.get("sparsity", [0.999]),
                use_nesterov=optimizer._nesterov,
                # a regularizer object lives in _regularizer with
                # _weight_decay zeroed — forward whichever is active
                weight_decay=(optimizer._regularizer
                              or optimizer._weight_decay),
                grad_clip=optimizer._grad_clip,
            )
    if st.a_sync and int((st.a_sync_configs or {}).get("k_steps", 0)) <= 0:
        raise UnimplementedError(
            "strategy.a_sync with k_steps=0 is PURE parameter-server async "
            "mode (reference: operators/distributed/communicator.h:268); "
            "its stale-tolerance has no counterpart on a synchronous TPU "
            "mesh.  Migrations that carry the capability: "
            "a_sync_configs={'k_steps': N} for Geo-SGD (local steps + "
            "periodic parameter-delta push, geo_sgd_transpiler.py parity), "
            "strategy.localsgd for periodic model averaging, and "
            "paddle.incubate.HostEmbeddingTable for beyond-HBM tables "
            "(the PS role's big-table job)")

    from ...optimizer.optimizer import Lamb, Lars, Momentum

    if st.lamb and not isinstance(optimizer, Lamb):
        # LAMB meta-optimizer replaces an Adam-family inner optimizer
        # (reference: fleet/meta_optimizers/lamb_optimizer.py)
        cfg = st.lamb_configs or {}
        optimizer = Lamb(
            learning_rate=optimizer._learning_rate,
            lamb_weight_decay=cfg.get("lamb_weight_decay", 0.01),
            parameters=optimizer._params,
            grad_clip=optimizer._grad_clip,
            multi_precision=optimizer._multi_precision,
            exclude_from_weight_decay_fn=cfg.get(
                "exclude_from_weight_decay_fn"),
        )
    if st.lars and not isinstance(optimizer, Lars):
        # reference: fleet/meta_optimizers/lars_optimizer.py (momentum only)
        cfg = st.lars_configs or {}
        if not isinstance(optimizer, Momentum):
            raise InvalidArgumentError(
                "strategy.lars applies to a Momentum optimizer (reference "
                "lars_optimizer.py _can_apply)")
        optimizer = Lars(
            learning_rate=optimizer._learning_rate,
            momentum=optimizer._momentum,
            lars_coeff=cfg.get("lars_coeff", 0.001),
            lars_weight_decay=cfg.get("lars_weight_decay", 0.0005),
            parameters=optimizer._params,
            grad_clip=optimizer._grad_clip,
            multi_precision=optimizer._multi_precision,
            exclude_from_weight_decay=cfg.get("exclude_from_weight_decay"),
            epsilon=cfg.get("epsilon", 0),
        )
    if st.gradient_merge:
        from ...optimizer.gradient_merge import GradientMergeOptimizer

        cfg = st.gradient_merge_configs or {}
        optimizer = GradientMergeOptimizer(
            optimizer, k_steps=int(cfg.get("k_steps", 1)),
            avg=bool(cfg.get("avg", True)))
    _strategy = st
    optimizer._fleet_strategy = st
    return optimizer


def distributed_model(model):
    """Place a Layer's parameters per the active strategy (replicas made
    equal, tensor-parallel parameters sliced to this rank's shard).
    Returns the same object (no wrapper)."""
    import torch

    from ...hapi.model import Model as _HapiModel

    net = model.network if isinstance(model, _HapiModel) else model
    if not isinstance(net, torch.nn.Module):
        raise InvalidArgumentError(
            "distributed_model expects a Layer or Model")
    if _strategy is not None and (_strategy.localsgd
                                  or _strategy.adaptive_localsgd):
        raise InvalidArgumentError(
            "strategy.localsgd only runs through Model.prepare/fit (the "
            "per-replica state and sync schedule live in the Model's plan); "
            "manual training loops would silently skip the averaging")
    plan = ShardingPlan(net, optimizer=None, strategy=_strategy,
                        mesh=get_mesh())
    plan.place_network()
    return model


def worker_num() -> int:
    return _env.process_count()


def worker_index() -> int:
    return _env.process_index()


def is_first_worker() -> bool:
    return _env.process_index() == 0


def barrier_worker():
    from .. import collective

    mesh = get_mesh()
    collective.barrier(group=mesh.group(tuple(mesh.axis_names)))


def stop_worker():
    """No persistent worker daemons exist (the reference tears down
    brpc/gloo servers here)."""
