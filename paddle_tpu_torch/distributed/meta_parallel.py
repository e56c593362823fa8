"""Tensor-parallel layers on one device (port of
``paddle_tpu.distributed.meta_parallel``).

On a single card these are the plain layers under the megatron names the
models use, with the same parameter names and shapes as the JAX package:
``ColumnParallelLinear`` / ``RowParallelLinear`` keep the ``[in, out]``
weight, ``VocabParallelEmbedding`` the ``[vocab, hidden]`` table.
Sharding over a ``model`` axis (and the quantized and LoRA legs of the
JAX layers) come with the distributed, quantized-serving and LoRA slices.
"""
from __future__ import annotations

from ..nn.common import Embedding, Linear

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding"]


class ColumnParallelLinear(Linear):
    """Linear whose output features shard over ``model`` (one device:
    unsharded)."""


class RowParallelLinear(Linear):
    """Linear whose input features shard over ``model`` (one device:
    unsharded)."""


class VocabParallelEmbedding(Embedding):
    """Embedding whose vocabulary shards over ``model`` (one device:
    unsharded); N(0, 0.02²) init as in the JAX package."""
