"""Serving layer of the port: greedy generation over a dense ring KV
cache (continuous or legacy batching) or a paged KV pool, with the
prefill/decode KV hand-off and hot weight swaps."""
from .batcher import MicroBatcher, Request
from .generation import GenerationEngine, KVHandoff
from .metrics import ServingMetrics
from .paging import PagePool

__all__ = ["GenerationEngine", "KVHandoff", "MicroBatcher", "Request",
           "PagePool", "ServingMetrics"]
