"""DistributedStrategy — declarative parallelism config.

Port of ``paddle_tpu.distributed.fleet.strategy`` (copied: it
imports no JAX).  Parity: python/paddle/distributed/fleet/base/distributed_strategy.py over
framework/distributed_strategy.proto:110 (fields amp:113, recompute:114,
gradient_merge:117, pipeline:120, sharding, …).  The reference's strategy
toggles *meta-optimizer program rewrites*; here each knob selects mesh axis
degrees and sharding rules consumed by the ShardingPlan (no program
rewriting exists — XLA partitions one jitted step).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

__all__ = ["DistributedStrategy"]


@dataclass
class DistributedStrategy:
    # hybrid mesh degrees (paddle 2.x fleet "hybrid_configs" analogue)
    dp_degree: int = 0          # 0 = all remaining devices
    mp_degree: int = 1          # tensor (model) parallel
    pp_degree: int = 1          # pipeline stages
    sep_degree: int = 1         # sequence/context parallel
    sharding_degree: int = 1    # ZeRO optimizer-state sharding
    ep_degree: int = 1          # expert parallel (MoE; paddle_tpu/moe)

    # feature toggles (proto parity)
    amp: bool = False
    amp_configs: Dict = field(default_factory=dict)
    recompute: bool = False
    recompute_configs: Dict = field(default_factory=dict)
    gradient_merge: bool = False
    gradient_merge_configs: Dict = field(default_factory=lambda: {"k_steps": 1})
    sharding: bool = False      # convenience: sets sharding_degree if unset
    sharding_configs: Dict = field(default_factory=dict)
    tensor_parallel: bool = False
    tensor_parallel_configs: Dict = field(default_factory=dict)
    pipeline: bool = False
    pipeline_configs: Dict = field(default_factory=lambda: {"accumulate_steps": 1})
    sequence_parallel: bool = False
    sequence_parallel_configs: Dict = field(
        default_factory=lambda: {"method": "ring"})
    expert_parallel: bool = False
    expert_parallel_configs: Dict = field(default_factory=dict)
    localsgd: bool = False
    localsgd_configs: Dict = field(default_factory=dict)
    adaptive_localsgd: bool = False  # step-adaptive sync period (ref:
    # localsgd_optimizer.py:194 AdaptiveLocalSGDOptimizer)
    adaptive_localsgd_configs: Dict = field(
        default_factory=lambda: {"init_k_steps": 1, "begin_step": 1})
    fp16_allreduce: bool = False  # comm-precision: cast grads for the
    # cross-replica reduction (ref: fp16_allreduce_optimizer.py:18)
    fp16_allreduce_configs: Dict = field(
        default_factory=lambda: {"dtype": "float16"})
    # collective schedule dials the measured-search plan tuner owns
    # (paddle.fleet analogue: fuse_grad_size_in_MB / comm overlap in
    # graph_execution_optimizer).  0 = one reduction per gradient leaf
    # (the historical behavior); >0 asks plans to fuse reductions into
    # ~N MB buckets.  overlap_grad_sync keeps XLA free to run the grad
    # collectives concurrently with independent compute (latency hiding).
    allreduce_bucket_mb: int = 0
    overlap_grad_sync: bool = True
    dgc: bool = False
    dgc_configs: Dict = field(default_factory=dict)
    lamb: bool = False
    lamb_configs: Dict = field(default_factory=dict)
    lars: bool = False
    lars_configs: Dict = field(default_factory=dict)
    a_sync: bool = False        # PS async mode; with a_sync_configs
    # {"k_steps": N>0} this is Geo-SGD (ref: geo_sgd_transpiler.py:1,
    # communicator.h:413 GeoCommunicator) — local steps + periodic
    # parameter-DELTA push, served here by GeoSgdPlan.  Pure async
    # (k_steps=0) has no TPU counterpart and raises with the migration
    # paths (GeoSGD / LocalSGD / incubate.HostEmbeddingTable).
    a_sync_configs: Dict = field(default_factory=dict)
    hybrid_configs: Optional[Dict] = None

    def __post_init__(self):
        if self.hybrid_configs:
            self.dp_degree = self.hybrid_configs.get("dp_degree", self.dp_degree)
            self.mp_degree = self.hybrid_configs.get("mp_degree", self.mp_degree)
            self.pp_degree = self.hybrid_configs.get("pp_degree", self.pp_degree)
            self.sep_degree = self.hybrid_configs.get("sep_degree", self.sep_degree)
            self.sharding_degree = self.hybrid_configs.get(
                "sharding_degree", self.sharding_degree)
            self.ep_degree = self.hybrid_configs.get(
                "ep_degree", self.ep_degree)
        if self.expert_parallel and self.ep_degree == 1:
            self.ep_degree = int(self.expert_parallel_configs.get(
                "expert_parallel_degree", 1))
        if self.tensor_parallel and self.mp_degree == 1:
            self.mp_degree = int(self.tensor_parallel_configs.get(
                "tensor_parallel_degree", 1))
        if self.sharding and self.sharding_degree == 1:
            self.sharding_degree = int(self.sharding_configs.get(
                "sharding_degree", 0)) or 0  # 0 → span the data dimension
        if self.pipeline and self.pp_degree == 1:
            self.pp_degree = int(self.pipeline_configs.get("pp_degree", 1))
        sched = str((self.pipeline_configs or {}).get(
            "schedule", "gpipe")).lower()
        # F-then-B is the reference's name for the fwd-all-then-bwd-all
        # schedule — the GPipe execution this package already provides
        if sched not in ("gpipe", "f-then-b", "1f1b"):
            raise ValueError(
                "pipeline_configs['schedule'] must be 'gpipe'/'F-then-B'/"
                f"'1F1B' (case-insensitive), got {sched!r}")

    def apply_tuned(self, config: Dict) -> "DistributedStrategy":
        """Apply a measured-search plan winner's collective dials (the
        ``tuning.plan_space`` config keys this class owns) in place and
        return self.  Unknown keys — the per-group axis assignment, which
        ``tuning.apply_plan`` lowers onto parameter annotations — are
        ignored here."""
        if "fp16_allreduce" in config:
            self.fp16_allreduce = bool(config["fp16_allreduce"])
        if "allreduce_bucket_mb" in config:
            self.allreduce_bucket_mb = int(config["allreduce_bucket_mb"])
        if "overlap_grad_sync" in config:
            self.overlap_grad_sync = bool(config["overlap_grad_sync"])
        return self
