"""Serving layer of the port: greedy generation over a dense ring KV
cache (continuous or legacy batching) or a paged KV pool, with the
prefill/decode KV hand-off, hot weight swaps, batched multi-LoRA adapters
and multi-tenant admission (``TenantScheduler``); and the bucketed
dynamic-batching ``InferenceEngine`` over an exported artifact."""
from .batcher import MicroBatcher, Request
from .bucketing import Bucket, BucketSet, as_bucket
from .engine import InferenceEngine
from .generation import GenerationEngine, KVHandoff
from .metrics import ServingMetrics
from .paging import PagePool
from .tenancy import TenantScheduler, TenantSpec

__all__ = ["Bucket", "BucketSet", "as_bucket", "InferenceEngine",
           "GenerationEngine", "KVHandoff", "MicroBatcher", "Request",
           "PagePool", "ServingMetrics", "TenantScheduler", "TenantSpec"]
