"""paddle_tpu_torch.distributed.fleet — the distributed-training control
plane (port of ``paddle_tpu.distributed.fleet``).  Usage is the JAX
package's four lines, run on every rank:

    strategy = fleet.DistributedStrategy(sharding=True)
    fleet.init(is_collective=True, strategy=strategy)
    opt = fleet.distributed_optimizer(paddle_tpu_torch.optimizer.Adam(...))
    model = paddle_tpu_torch.Model(net); model.prepare(opt, loss); model.fit(...)

``init`` joins the process group (``init_parallel_env``) and builds the
hybrid rank mesh; ``distributed_optimizer`` composes the strategy's
optimizer-level features and tags the optimizer; ``Model.prepare`` turns
the tag into a :class:`ShardingPlan`.  Parameter-server mode is rejected
as in JAX.  Toggles whose plans are not ported yet — ``pipeline`` /
``pp_degree > 1``, ``expert_parallel`` / ``ep_degree > 1``,
``localsgd``, ``adaptive_localsgd``, Geo-SGD (``a_sync`` with
``k_steps``), ``dgc`` and ``fp16_allreduce`` — raise
``UnimplementedError`` citing distributed execution (ROADMAP queue A).
"""
from __future__ import annotations

from typing import Optional

from ...framework.errors import InvalidArgumentError, UnimplementedError
from .. import env as _env
from ..mesh import build_mesh, get_mesh, set_mesh
from .plan import ShardingPlan
from .strategy import DistributedStrategy

__all__ = [
    "DistributedStrategy",
    "ShardingPlan",
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


def _unported(what: str):
    raise UnimplementedError(
        f"{what} is not ported yet (ROADMAP queue A, distributed execution)")


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
    if strategy.pipeline or strategy.pp_degree > 1:
        _unported("strategy.pipeline (pipeline parallelism)")
    if strategy.expert_parallel or strategy.ep_degree > 1:
        _unported("strategy.expert_parallel (the expert mesh axis)")
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
    ``lars``, ``gradient_merge``) and tag the result for distributed
    execution; ``Model.prepare`` builds the :class:`ShardingPlan` from the
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
    for flag, what in (("localsgd", "strategy.localsgd"),
                       ("adaptive_localsgd", "strategy.adaptive_localsgd"),
                       ("a_sync", "strategy.a_sync Geo-SGD"),
                       ("dgc", "strategy.dgc (DGCMomentum)"),
                       ("fp16_allreduce", "strategy.fp16_allreduce")):
        if getattr(st, flag):
            _unported(what)

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
