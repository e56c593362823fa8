"""Serving layer of the port: greedy generation over a dense ring KV
cache (continuous or legacy batching) or a paged KV pool, with the
prefill/decode KV hand-off, hot weight swaps, batched multi-LoRA adapters
and multi-tenant admission (``TenantScheduler``)."""
from .batcher import MicroBatcher, Request
from .generation import GenerationEngine, KVHandoff
from .metrics import ServingMetrics
from .paging import PagePool
from .tenancy import TenantScheduler, TenantSpec

__all__ = ["GenerationEngine", "KVHandoff", "MicroBatcher", "Request",
           "PagePool", "ServingMetrics", "TenantScheduler", "TenantSpec"]
