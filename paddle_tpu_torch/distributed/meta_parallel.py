"""Tensor-parallel layers (port of ``paddle_tpu.distributed.meta_parallel``).

The layers keep the JAX package's names, parameter names, shapes and
``partition_spec`` annotations: ``ColumnParallelLinear`` weight ``[in,
out]`` sharded ``(None, "model")``, bias ``("model",)``;
``RowParallelLinear`` weight ``("model", None)``, bias replicated;
``VocabParallelEmbedding`` table ``("model", None)``.  Built, they hold
the whole tensors and compute as single-device layers;
``fleet.ShardingPlan.place_network`` slices each parameter to this
rank's shard, and a layer whose weight holds a shard computes with it.
Where the JAX layers annotate (``constrain``) and GSPMD inserts the
collective, these issue it at the same point, as the Megatron f / g
operators (``torch.autograd.Function``\\ s over the ``model`` group):

* column: f (identity forward, all-reduce backward) on the input, the
  local ``[in, out/mp]`` product, and with ``gather_output`` an
  all-gather of the output (its backward takes this rank's slice);
* row: the local ``[in/mp, out]`` product (its input sliced first unless
  ``input_is_parallel``), g (all-reduce forward, identity backward), the
  bias added once — with the ``defer_row_reduce`` dial the bias joins
  model rank 0's partial sum and the reduce comes last, as the JAX dial
  moves its reduce past the bias add;
* vocab embedding: the masked lookup of the ids this rank's rows hold,
  then g.

``partition_groups`` (a port argument of ``ColumnParallelLinear``) says
the output dim is that many equal fused blocks — GPT's ``qkv`` is 3 —
each sliced separately, so a rank's shard holds its heads of q, k and v
(the JAX layer slices the fused dim contiguously and GSPMD reshards at
the head reshape; the values are the same).

A weight quantized for serving (``slim.quantize_weights``) is int8 or
float8_e4m3fn and cannot be a float ``nn.Parameter`` with a gradient: it
is held as a buffer under the same dotted name ``weight``, with its
per-output-channel float32 ``weight_scale`` buffer beside it, so names map
1:1 onto the JAX package's quantized trees.  The forward dispatches on
the weight dtype, as the JAX layers do.  A layer that carries an adapter
table (``lora.enable_lora``: ``lora_A`` / ``lora_B`` / ``lora_scale``
buffers) adds the batched multi-LoRA delta after the float product plus
bias, or after the quantized leg, when an ``adapter_scope`` is active
(``_lora_leg``); a LoRA-free layer pays one membership check.  Both legs
are single-device: ``place_network`` refuses to shard such a layer over a
``model`` axis of size > 1.
"""
from __future__ import annotations

import torch

from ..framework.errors import InvalidArgumentError, UnimplementedError
from ..framework.selected_rows import current_tape, take_rows
from ..nn.common import Embedding, Linear
from ..nn.functional import embedding
from ..ops.quantized_matmul import quantized_linear
from .mesh import PartitionSpec, get_mesh

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "constrain"]

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


def constrain(x, *spec):
    """The JAX sharding annotation: identity here — the port's layers
    issue the collective at each annotation point themselves."""
    return x


# -- shard layout ------------------------------------------------------------
def shard(t: torch.Tensor, dim: int, index: int, parts: int,
          groups: int = 1) -> torch.Tensor:
    """Shard ``index`` of ``parts`` of ``t`` along ``dim``, which is
    ``groups`` equal blocks sliced one by one (a view)."""
    dim %= t.dim()
    v = t.unflatten(dim, (groups, t.shape[dim] // groups))
    if v.shape[dim + 1] % parts:
        raise InvalidArgumentError(
            f"dim {dim} of {tuple(t.shape)} ({groups} block(s)) does not "
            f"split into {parts} shards")
    c = v.shape[dim + 1] // parts
    return v.narrow(dim + 1, index * c, c).flatten(dim, dim + 1)


def unshard(shards, dim: int, groups: int = 1) -> torch.Tensor:
    """The inverse of :func:`shard`: the whole tensor from every shard in
    rank order."""
    dim %= shards[0].dim()
    vs = [s.unflatten(dim, (groups, s.shape[dim] // groups))
          for s in shards]
    return torch.cat(vs, dim + 1).flatten(dim, dim + 1)


# -- the f / g operators -------------------------------------------------------
class _CopyTo(torch.autograd.Function):
    """f: identity forward, gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x

    @staticmethod
    def backward(ctx, dy):
        from .collective import all_reduce

        return all_reduce(dy.contiguous().clone(), group=ctx.g), None


class _ReduceFrom(torch.autograd.Function):
    """g: sum over the group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, g):
        from .collective import all_reduce

        return all_reduce(x.contiguous().clone(), group=g)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherFrom(torch.autograd.Function):
    """Every rank's ``x`` joined along ``dim`` (in fused blocks); the
    backward takes this rank's shard of the gradient."""

    @staticmethod
    def forward(ctx, x, g, dim, groups):
        from .collective import _gather_list

        ctx.args = (g, dim, groups)
        return unshard(_gather_list(g, x.contiguous(), "all_gather"), dim,
                       groups)

    @staticmethod
    def backward(ctx, dy):
        g, dim, groups = ctx.args
        return (shard(dy, dim, g.index, g.size, groups).contiguous(), None,
                None, None)


class _SplitTo(torch.autograd.Function):
    """This rank's shard of ``x`` along ``dim``; the backward joins every
    rank's gradient shard."""

    @staticmethod
    def forward(ctx, x, g, dim, groups):
        ctx.args = (g, dim, groups)
        return shard(x, dim, g.index, g.size, groups).contiguous()

    @staticmethod
    def backward(ctx, dy):
        from .collective import _gather_list

        g, dim, groups = ctx.args
        return (unshard(_gather_list(g, dy.contiguous(), "all_gather"), dim,
                        groups), None, None, None)


class _AddOnFirst(torch.autograd.Function):
    """``y + b`` on rank 0 of the group, ``y`` elsewhere; ``b``'s gradient
    is the whole sum on every rank (it is a replicated parameter)."""

    @staticmethod
    def forward(ctx, y, b, g):
        ctx.shape = b.shape
        return y + b if g.index == 0 else y.clone()

    @staticmethod
    def backward(ctx, dy):
        db = dy.reshape(-1, *ctx.shape).sum(0) if dy.dim() > 1 else dy
        return dy, db, None


def copy_to(x, group):
    return x if group.size == 1 else _CopyTo.apply(x, group)


def reduce_from(x, group):
    return x if group.size == 1 else _ReduceFrom.apply(x, group)


def gather_from(x, group, dim: int, groups: int = 1):
    if group.size == 1:
        return x
    return _GatherFrom.apply(x, group, dim % x.dim(), groups)


def split_to(x, group, dim: int, groups: int = 1):
    if group.size == 1:
        return x
    return _SplitTo.apply(x, group, dim % x.dim(), groups)


def _model_group(parts: int, layer):
    g = get_mesh().group("model")
    if g.size != parts:
        raise InvalidArgumentError(
            f"{type(layer).__name__} holds 1/{parts} of its weight but the "
            f"mesh's model axis has {g.size} ranks")
    return g


class _ParallelLinear(Linear):
    """What Column/RowParallelLinear share: the JAX constructor
    (``has_bias``), the quantized leg when the weight arrived int8/fp8,
    then the LoRA leg."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, has_bias: bool = True, name=None,
                 bias_attr=None):
        super().__init__(in_features, out_features, weight_attr=weight_attr,
                         bias_attr=False if not has_bias else bias_attr,
                         name=name)

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

    def _single_device(self, x):
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

    def shardable(self):
        """Raise where this layer cannot shard over ``model``."""
        if self.weight.dtype in _QUANT_DTYPES or "lora_A" in self._buffers:
            raise UnimplementedError(
                f"{type(self).__name__}: quantized and LoRA layers run on "
                f"one model rank; a model axis of size > 1 does not shard "
                f"them (ROADMAP queue A, distributed execution)")


class ColumnParallelLinear(_ParallelLinear):
    """Linear with the OUTPUT features sharded over ``model``: weight
    ``[in, out/mp]``, bias ``[out/mp]``; ``gather_output=True`` joins the
    output shards (ends the tensor-parallel region).
    ``partition_groups``: the output dim is that many fused blocks, each
    sharded (GPT's qkv: 3)."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, gather_output: bool = True,
                 name=None, *, bias_attr=None, partition_groups: int = 1):
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         name, bias_attr)
        self.gather_output = gather_output
        self.partition_groups = int(partition_groups)
        self.weight.partition_spec = PartitionSpec(None, "model")
        self.weight.partition_groups = self.partition_groups
        if self.bias is not None:
            self.bias.partition_spec = PartitionSpec("model")
            self.bias.partition_groups = self.partition_groups

    def forward(self, x):
        parts = self.out_features // self.weight.shape[1]
        if parts == 1:
            return self._single_device(x)
        g = _model_group(parts, self)
        y = torch.matmul(copy_to(x, g), self.weight)
        if self.bias is not None:
            y = y + self.bias
        if self.gather_output:
            y = gather_from(y, g, -1, self.partition_groups)
        return y


class RowParallelLinear(_ParallelLinear):
    """Linear with the INPUT features sharded over ``model``: weight
    ``[in/mp, out]``, bias ``[out]`` (replicated, added once).  Fed a
    ``ColumnParallelLinear(gather_output=False)`` output
    (``input_is_parallel=True``) it keeps the hidden activations sharded:
    the one all-reduce of the Megatron MLP."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, input_is_parallel: bool = False,
                 name=None, *, bias_attr=None):
        super().__init__(in_features, out_features, weight_attr, has_bias,
                         name, bias_attr)
        self.input_is_parallel = input_is_parallel
        self.weight.partition_spec = PartitionSpec("model", None)

    def forward(self, x):
        parts = self.in_features // self.weight.shape[0]
        if parts == 1:
            return self._single_device(x)
        from .collective import get_overlap_schedule

        g = _model_group(parts, self)
        if not self.input_is_parallel:
            x = split_to(x, g, -1)
        y = torch.matmul(x, self.weight)
        if get_overlap_schedule().get("defer_row_reduce"):
            if self.bias is not None:
                y = _AddOnFirst.apply(y, self.bias, g)
            return reduce_from(y, g)
        y = reduce_from(y, g)
        return y if self.bias is None else y + self.bias


class VocabParallelEmbedding(Embedding):
    """Embedding with the vocabulary sharded over ``model``: this rank
    holds rows ``[r·V/mp, (r+1)·V/mp)``, looks up the ids that fall there
    (zeros elsewhere) and the lookups are summed over the group.
    N(0, 0.02²) init as in the JAX package.  ``sparse=True`` gives the
    table SelectedRows gradients inside a sparse-aware train step, as
    ``nn.Embedding(sparse=True)`` does; on a sharded table they hold this
    rank's rows (local ids; an id another rank holds is the sentinel and
    updates nothing), so a lazy rule touches this rank's looked-up rows
    only."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr=None, sparse: bool = False, name=None):
        super().__init__(num_embeddings, embedding_dim, sparse=sparse,
                         weight_attr=weight_attr, std=0.02)
        self.weight.partition_spec = PartitionSpec("model", None)

    def forward(self, ids):
        rows = self.weight.shape[0]
        parts = self.num_embeddings // rows
        if parts == 1:
            return super().forward(ids)
        g = _model_group(parts, self)
        start = g.index * rows
        ids = torch.as_tensor(ids, device=self.weight.device)
        off = ids - start
        miss = (off < 0) | (off >= rows)
        tape = current_tape() if self.sparse else None
        if tape is not None:
            # this rank's rows through the tape; another rank's id is the
            # sentinel `rows` (gathers zeros, its delta masked off)
            local = off.masked_fill(miss, rows)
            out = tape.tap(self.weight, self.weight, local,
                           take_rows(self.weight.detach(), local, 0.0),
                           ~miss)
            return reduce_from(out, g)
        out = embedding(off.masked_fill(miss, 0), self.weight)
        out = out.masked_fill(miss[..., None], 0.0)
        return reduce_from(out, g)
