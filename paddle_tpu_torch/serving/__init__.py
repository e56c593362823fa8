"""Serving layer of the port: paged-KV continuous-batching generation."""
from .batcher import MicroBatcher, Request
from .generation import GenerationEngine
from .metrics import ServingMetrics
from .paging import PagePool

__all__ = ["GenerationEngine", "MicroBatcher", "Request", "PagePool",
           "ServingMetrics"]
