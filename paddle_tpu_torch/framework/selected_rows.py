"""SelectedRows: sparse embedding gradients with O(touched-rows) updates
(port of ``paddle_tpu.framework.selected_rows``).

A table flagged ``sparse`` (``nn.Embedding(sparse=True)``,
``VocabParallelEmbedding(sparse=True)``) gets its gradient as a
:class:`SelectedRows` ``(ids, values, height)`` inside a sparse-aware train
step (``hapi.Model.train_batch`` builds one), never as a ``[height, D]``
buffer; the row-mode optimizers (SGD, Momentum, Adagrad, Ftrl, Adam /
AdamW with ``lazy_mode=True``) then gather, update and scatter only the
touched rows.

The differentiation is the JAX package's: the tables enter the step with
``requires_grad`` off, and each lookup (:func:`tap_lookup`) adds a zeros
``delta`` of the gathered rows' shape that requires grad, so
``delta.grad`` is the per-row gradient — no O(vocab) buffer is built and no
COO tensor needs ``coalesce()``.  CONTRACT (as in JAX): a sparse table gets
gradients ONLY through its lookups; any other read of it inside the step
trains that use as a constant.  Outside a sparse-aware step the flag is
inert and gradients are dense.

Ids follow ``jnp.take``: ``-height <= id < 0`` wraps; any other id outside
``[0, height)`` gathers zeros in the tap and updates nothing.  The padding
sentinel is ``height`` itself.  A :class:`SelectedRows` stores a wrapped id
as ``id + height`` (JAX keeps it negative), so it merges with its twin
instead of writing the same row twice.  :meth:`SelectedRows.merged` keeps
the JAX layout — k slots, the unique ids ascending, the tail padded with
the sentinel — and sums duplicates in a fixed order (a stable sort, then
``torch.segment_reduce`` in float64, each segment from its head, rounded
once), so two runs on the card are bit-equal where an ``index_add_`` would
add in atomic order.
CUDA has no drop-out-of-range scatter mode (an out-of-range index is a
device assert), so :func:`safe_rows` maps every sentinel or out-of-range
slot onto a copy of a valid slot — same id, same value, so the duplicate
write carries the same bits — and says whether any valid slot exists.

:func:`all_gather_rows` is the cross-replica sparse reduction the data
axes of a fleet plan run (``distributed.fleet``): each rank's rows,
gathered.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .errors import InvalidArgumentError

__all__ = ["SelectedRows", "sparse_tape", "current_tape", "tap_lookup",
           "sparse_param_names", "build_sparse_step", "all_gather_rows",
           "safe_rows", "take_rows"]


def _ids(ids, device=None) -> torch.Tensor:
    """``ids`` as an int64 tensor (numpy or a tensor of any integer
    dtype), on ``device`` when given."""
    t = torch.as_tensor(ids, device=device)
    if t.is_floating_point() or t.is_complex() or t.dtype == torch.bool:
        raise InvalidArgumentError(f"ids must be integers, got {t.dtype}")
    return t.long()


def take_rows(table: torch.Tensor, ids: torch.Tensor, fill: float):
    """``jnp.take(table, ids, axis=0)`` with out-of-range rows set to
    ``fill``: ids in ``[-n, 0)`` wrap, the rest outside ``[0, n)`` fill.
    A clamped gather then a mask — never an out-of-range index on the
    card.  Differentiable in ``table``."""
    n = table.shape[0]
    inside = (ids >= -n) & (ids < n)
    rows = F.embedding(torch.remainder(ids, n), table)
    return rows.masked_fill(~inside.unsqueeze(-1), fill)


class SelectedRows:
    """A sparse slice of a ``[height, D]`` table: ``values[i]`` is the row
    at ``ids[i]``.  Duplicate ids mean "sum"; ids outside the table (the
    sentinel ``height`` above all) are dropped by the updates."""

    __slots__ = ("ids", "values", "height", "_is_merged", "_merged_cache")

    def __init__(self, ids, values, height: int, _merged: bool = False):
        values = torch.as_tensor(values)
        ids = _ids(ids, values.device).reshape(-1)
        self.height = int(height)
        self.ids = torch.where(ids < 0, ids + self.height, ids)
        k = self.ids.shape[0]
        if k:
            self.values = values.reshape(k, -1)
        else:  # reshape(0, -1) cannot infer the row dim
            d = values.shape[-1] if values.dim() >= 2 else 0
            self.values = values.reshape(0, d)
        self._is_merged = _merged
        self._merged_cache = None

    @property
    def dim(self) -> int:
        return self.values.shape[1]

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    # -- algebra used by the optimizer plumbing ------------------------------
    def __mul__(self, other):  # grad clip / loss scale: scales values
        return SelectedRows(self.ids, self.values * other, self.height,
                            self._is_merged)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return SelectedRows(self.ids, self.values / other, self.height,
                            self._is_merged)

    def astype(self, dtype):
        return SelectedRows(self.ids, self.values.to(dtype), self.height,
                            self._is_merged)

    def concat(self, other: "SelectedRows") -> "SelectedRows":
        if other.height != self.height:
            raise InvalidArgumentError(
                f"SelectedRows height mismatch {self.height} vs "
                f"{other.height}")
        return SelectedRows(torch.cat([self.ids, other.ids]),
                            torch.cat([self.values, other.values]),
                            self.height)

    def merged(self) -> "SelectedRows":
        """Sum duplicate ids: k slots, the unique ids ascending, the tail
        padded with the sentinel ``height`` and zero values (the JAX
        layout; ids outside the table sort and sum like any other).  The sums run in a fixed order, so the result is the same
        on every call; it is cached on this object."""
        if self._is_merged or self.ids.shape[0] == 0:
            return self
        if self._merged_cache is None:
            self._merged_cache = self._merge()
        return self._merged_cache

    def _merge(self) -> "SelectedRows":
        ids, values = self.ids, self.values
        k = ids.shape[0]
        sid, order = torch.sort(ids, stable=True)
        first = torch.ones(k, dtype=torch.bool, device=ids.device)
        first[1:] = sid[1:] != sid[:-1]
        seg = torch.cumsum(first, 0) - 1  # segment of each sorted element
        slots = torch.arange(k, device=ids.device)
        lo = torch.searchsorted(seg, slots)               # segment starts
        hi = torch.searchsorted(seg, slots, right=True)   # ... and ends
        # each segment summed on its own, in order from its head, in
        # float64 and rounded once: a one-row segment is its own value, bit
        # for bit, whatever precedes it; an empty slot (lo = hi = k) sums
        # to 0.  unsafe: the safe mode reads the lengths' sum back (a sync)
        summed = torch.segment_reduce(
            values[order].double(), "sum", lengths=hi - lo, axis=0,
            unsafe=True).to(values.dtype)
        uniq = torch.where(lo < k, sid[lo.clamp(max=k - 1)],
                           torch.full_like(sid, self.height))
        return SelectedRows(uniq, summed, self.height, _merged=True)

    def to_dense(self) -> torch.Tensor:
        """The dense ``[height, D]`` gradient (O(height): for the
        optimizers that densify, as the JAX package does)."""
        m = self.merged()
        dense = torch.zeros((self.height, m.dim), dtype=m.dtype,
                            device=m.device)
        if m.ids.shape[0]:
            ids, values, _ = safe_rows(m)
            # the copies of a valid slot write its own value; with no
            # valid slot at all, every slot writes zeros onto one row
            dense.index_copy_(0, ids, values)
        return dense

    def l2_norm_sq(self) -> torch.Tensor:
        """Sum of squares in float32 — exact for merged rows; for unmerged
        duplicates it is the norm of the unmerged stack (call
        ``.merged()`` first for the gradient's norm)."""
        return self.values.float().square().sum()

    def __repr__(self):
        return (f"SelectedRows(k={self.ids.shape[0]}, dim={self.dim}, "
                f"height={self.height})")


def safe_rows(sr: SelectedRows):
    """``(ids, values, any_valid)`` for scattering a MERGED ``sr`` into its
    table on any device: every slot whose id is outside ``[0, height)``
    (the sentinel) takes the id and value of the first valid slot, so a
    duplicate write stores the same bits; ``any_valid`` (a 0-d bool
    tensor) is false when no slot is valid — all ids then point at one
    in-range row with zero values, and the caller must write back what it
    read."""
    h = sr.height
    ids = sr.ids
    valid = (ids >= 0) & (ids < h)
    # the first valid slot, or slot 0; indexed by index_select, since a
    # 0-d index tensor would be read back to the host (a sync)
    donor = valid.to(torch.int8).argmax().reshape(1)
    any_valid = valid.index_select(0, donor).reshape(())
    ids = torch.where(valid, ids, ids.index_select(0, donor)).clamp(0, h - 1)
    donated = sr.values.index_select(0, donor)
    fill = torch.where(any_valid, donated, torch.zeros_like(donated))
    values = torch.where(valid.unsqueeze(-1), sr.values, fill)
    return ids, values, any_valid


# ---------------------------------------------------------------------------
# The gradient tape
# ---------------------------------------------------------------------------
_state = threading.local()


def current_tape() -> Optional["_Tape"]:
    return getattr(_state, "tape", None)


class _Tape:
    """Collects the sparse-embedding lookups of one forward: each tap adds
    a zeros ``delta`` that requires grad to its gathered rows and records
    ``(box, ids, delta)``; after the backward, ``delta``'s gradient is the
    rows' gradient.  (The JAX tape first records the deltas' shapes under
    ``eval_shape``; an eager forward makes them as it goes.)"""

    def __init__(self):
        self.taps: List[Tuple[Any, torch.Tensor, torch.Tensor]] = []

    def tap(self, box, table: torch.Tensor, ids: torch.Tensor,
            rows: torch.Tensor, valid: Optional[torch.Tensor] = None):
        """Called by a sparse layer's forward with its gathered ``rows``;
        returns the rows to use downstream.  ``valid`` (bool, ids-shaped)
        zeroes the delta at padding positions, so their cotangent is
        exactly zero — as the dense path blocks it, and as a clip by norm
        must see it."""
        d = torch.zeros(rows.shape, dtype=rows.dtype, device=rows.device,
                        requires_grad=True)
        self.taps.append((box, ids, d))
        if valid is not None:
            d = torch.where(valid.unsqueeze(-1), d, torch.zeros_like(d))
        return rows + d


class sparse_tape:
    """Context manager installing a tape for the duration of a forward."""

    def __init__(self):
        self._tape = _Tape()

    def __enter__(self) -> _Tape:
        if current_tape() is not None:
            raise InvalidArgumentError("sparse_tape does not nest")
        _state.tape = self._tape
        return self._tape

    def __exit__(self, *exc):
        _state.tape = None
        return False


def tap_lookup(box, table, ids, num_embeddings: int,
               padding_idx: Optional[int] = None):
    """The sparse layer forward: gather rows from the table without
    gradient (out-of-range ids gather zeros) and route them through the
    active tape.  Padding ids become the sentinel ``num_embeddings``.
    Returns the rows, or ``None`` when no tape is active (the caller then
    takes the dense path)."""
    tape = current_tape()
    if tape is None:
        return None
    ids = _ids(ids, table.device)
    valid = None
    if padding_idx is not None:
        ids = torch.where(ids == padding_idx,
                          torch.full_like(ids, num_embeddings), ids)
        valid = ids != num_embeddings
    rows = take_rows(table.detach(), ids, 0.0)
    return tape.tap(box, table, ids, rows, valid)


def all_gather_rows(sr: SelectedRows, axis_name, scale=1.0,
                    wire_dtype=None) -> SelectedRows:
    """The cross-replica SelectedRows reduction (the reference's sparse
    all-reduce, details/sparse_all_reduce_op_handle.cc): every rank's
    ``(ids, values)`` over the group ``axis_name`` (a mesh axis name, a
    tuple of them, or an ``AxisGroup``), joined in rank order — the rows
    are gathered, never densified.  Duplicate ids across ranks merge by
    sum downstream, so ``scale=1/n`` gives the dense mean.  ``wire_dtype``
    sends the values in a reduced precision (the fp16_allreduce
    composition; ids stay integers); they come back in ``sr``'s dtype.
    Ranks whose row counts differ pad theirs with the sentinel id and
    zero values (dropped by every update)."""
    from ..distributed.collective import _gather_list, _group

    g = _group(axis_name)
    vals = sr.values * scale if scale != 1.0 else sr.values
    wire = vals.to(wire_dtype) if wire_dtype is not None else vals
    ids = sr.ids
    if g.size > 1:
        k = torch.tensor([ids.shape[0]], dtype=torch.int64, device=ids.device)
        ks = [int(v) for v in torch.cat(_gather_list(g, k, "all_gather"))]
        pad = max(ks) - ids.shape[0]
        if pad:
            ids = torch.cat([ids, ids.new_full((pad,), sr.height)])
            wire = torch.cat([wire, wire.new_zeros((pad, wire.shape[1]))])
    got_ids = torch.cat(_gather_list(g, ids.contiguous(), "all_gather"))
    got = torch.cat(_gather_list(g, wire.contiguous(), "all_gather"))
    return SelectedRows(got_ids, got.to(sr.values.dtype), sr.height)


def sparse_param_names(layer) -> Dict[int, str]:
    """``{id(parameter): dotted name}`` for every parameter of ``layer``
    flagged ``sparse`` (set by ``Embedding(sparse=True)``).  The flag is
    read from the parameter or, since ``copy.deepcopy`` drops a
    parameter's attributes, from the layer that owns it as ``weight``."""
    owned = {id(m.weight) for m in layer.modules()
             if getattr(m, "sparse", False) is True
             and isinstance(getattr(m, "weight", None), torch.nn.Parameter)}
    return {id(p): name for name, p in layer.named_parameters()
            if getattr(p, "sparse", False) or id(p) in owned}


def build_sparse_step(forward_loss: Callable, sparse_names: Dict[int, str],
                      table_shapes: Dict[str, Tuple[int, int]]):
    """The differentiation of a train step with sparse tables.
    ``forward_loss(params) -> (loss, aux)`` runs the forward (the network
    reads its own parameters; ``params`` is the ``{name: parameter}``
    dict of :func:`grad_fn`), ``sparse_names`` maps ``id(parameter)`` to
    its name, ``table_shapes`` names the tables this step differentiates.

    Returns ``grad_fn(params) -> ((loss, aux), grads)``: ``grads`` holds
    the gradient of each parameter of ``params`` that requires grad
    (``None`` where the loss does not reach it) and a
    :class:`SelectedRows` for each tapped table.  The tables' own
    ``requires_grad`` is off during the forward and restored after it, so
    no read of a table but a lookup has a gradient (the CONTRACT above)."""
    names = set(table_shapes)

    def grad_fn(params):
        dense = {k: v for k, v in params.items()
                 if k not in names and v.requires_grad}
        frozen = [v for k, v in params.items()
                  if k in names and v.requires_grad]
        for v in frozen:
            v.requires_grad_(False)
        try:
            with sparse_tape() as tape:
                loss, aux = forward_loss(params)
        finally:
            for v in frozen:
                v.requires_grad_(True)
        deltas = [d for _, _, d in tape.taps]
        inputs = list(dense.values()) + deltas
        got = (torch.autograd.grad(loss, inputs, allow_unused=True)
               if inputs else ())
        grads: Dict[str, Any] = dict(zip(dense, got))
        for (box, ids, d), gd in zip(tape.taps, got[len(dense):]):
            name = sparse_names.get(id(box))
            if name is None or name not in names:
                continue  # a tapped table this step does not train
            if gd is None:  # the loss does not reach this lookup
                gd = torch.zeros_like(d)
            sr = SelectedRows(ids, gd, table_shapes[name][0])
            prev = grads.get(name)
            grads[name] = prev.concat(sr) if isinstance(
                prev, SelectedRows) else sr
        return (loss, aux), grads

    return grad_fn
