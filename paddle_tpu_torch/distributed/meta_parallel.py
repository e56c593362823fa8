"""Tensor-parallel layers on one device (port of
``paddle_tpu.distributed.meta_parallel``).

On a single card these are the plain layers under the megatron names the
models use, with the same parameter names and shapes as the JAX package:
``ColumnParallelLinear`` / ``RowParallelLinear`` keep the ``[in, out]``
weight, ``VocabParallelEmbedding`` the ``[vocab, hidden]`` table.
A weight quantized for serving (``slim.quantize_weights``) is int8 or
float8_e4m3fn and cannot be a float ``nn.Parameter`` with a gradient: it
is held as a buffer under the same dotted name ``weight``, with its
per-output-channel float32 ``weight_scale`` buffer beside it, so names map
1:1 onto the JAX package's quantized trees.  The forward dispatches on
the weight dtype, as the JAX layers do.  A layer that carries an adapter
table (``lora.enable_lora``: ``lora_A`` / ``lora_B`` / ``lora_scale``
buffers) adds the batched multi-LoRA delta after the float product plus
bias, or after the quantized leg, when an ``adapter_scope`` is active
(``_lora_leg``); a LoRA-free layer pays one membership check.  Sharding
over a ``model`` axis comes with the distributed slice.
"""
from __future__ import annotations

import torch

from ..framework.errors import InvalidArgumentError
from ..nn.common import Embedding, Linear
from ..ops.quantized_matmul import quantized_linear

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding"]

#: weight dtypes the quantized serving path stores (slim.quantize_weights)
_QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)


def _lora_leg(layer, x, y):
    """Batched multi-LoRA delta shared by Column/RowParallelLinear: when
    the layer carries an adapter table AND a per-slot id scope is active
    (the serving step installs one), add the ragged grouped delta; rows
    with id -1 keep the base output bitwise."""
    if "lora_A" not in layer._buffers:
        return y
    from ..lora.batched import apply_lora

    return apply_lora(layer, x, y)


class _ParallelLinear(Linear):
    """What Column/RowParallelLinear share on one device: the float
    ``Linear`` forward, or the quantized leg when the weight arrived
    int8/fp8, then the LoRA leg."""

    def set_quantized(self, weight_q, weight_scale):
        """Replace the float ``weight`` parameter by the quantized
        ``weight_q`` ``[in, out]`` (int8 or float8_e4m3fn) and store its
        ``weight_scale`` ``[out]`` float32, both as buffers."""
        if (weight_q.dtype not in _QUANT_DTYPES
                or tuple(weight_q.shape) != tuple(self.weight.shape)
                or tuple(weight_scale.shape) != (self.out_features,)):
            raise InvalidArgumentError(
                f"{type(self).__name__}.set_quantized: weight "
                f"{weight_q.dtype} {tuple(weight_q.shape)} / scale "
                f"{tuple(weight_scale.shape)} do not fit "
                f"{tuple(self.weight.shape)}")
        dev = self.weight.device
        del self.weight  # a parameter or a buffer; re-registered below
        self.register_buffer("weight", weight_q.detach().to(dev))
        self.register_buffer("weight_scale",
                             weight_scale.detach().float().to(dev))

    def forward(self, x):
        scale = self._buffers.get("weight_scale")
        if self.weight.dtype not in _QUANT_DTYPES:
            if "weight" in self._buffers:
                # a dtype cast (Module.to) turned fp8 codes into floats:
                # computing with them would ignore their scales (a float
                # weight PARAMETER may sit beside the unit weight_scale
                # slim.quantize_model_trees registers: it is not read)
                raise InvalidArgumentError(
                    f"{type(self).__name__}: a weight_scale buffer sits "
                    f"beside a {self.weight.dtype} weight — the quantized "
                    f"codes were cast to a float dtype (Module.to(dtype) "
                    f"after slim.quantize_weights); quantize a float model "
                    f"after the cast instead")
            return _lora_leg(self, x, super().forward(x))
        if scale is None:
            raise InvalidArgumentError(
                f"{type(self).__name__}: weight is {self.weight.dtype} but "
                f"no weight_scale buffer is registered — quantize via "
                f"slim.quantize_weights / slim.quantize_model, not a bare "
                f"dtype cast")
        return _lora_leg(self, x,
                         quantized_linear(x, self.weight, scale, self.bias))


class ColumnParallelLinear(_ParallelLinear):
    """Linear whose output features shard over ``model`` (one device:
    unsharded)."""


class RowParallelLinear(_ParallelLinear):
    """Linear whose input features shard over ``model`` (one device:
    unsharded)."""


class VocabParallelEmbedding(Embedding):
    """Embedding whose vocabulary shards over ``model`` (one device:
    unsharded); N(0, 0.02²) init as in the JAX package.  ``sparse=True``
    gives the table SelectedRows gradients inside a sparse-aware train
    step, as ``nn.Embedding(sparse=True)`` does."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr=None, sparse: bool = False, name=None):
        super().__init__(num_embeddings, embedding_dim, sparse=sparse,
                         weight_attr=weight_attr, std=0.02)
