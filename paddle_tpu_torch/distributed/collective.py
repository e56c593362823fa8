"""User-facing collectives (port of ``paddle_tpu.distributed.collective``).

The JAX package is single-controller: a collective takes a *stacked*
array whose leading dimension indexes the ranks of a mesh axis, and
returns the stacked result.  The port runs one process per rank, so each
function here takes this rank's tensor and returns this rank's slot of
what the JAX function returns for the stacked input (rank ``i`` of the
axis plays slot ``i``).  ``group=`` is a mesh axis name (``"data"`` by
default), a tuple of axis names, or an :class:`~.mesh.AxisGroup`, as the
JAX ``_group_axis`` reads it.  ``all_reduce`` / ``broadcast`` /
``reduce`` / ``scatter`` also write the result into ``tensor``, as the
reference's in-place API does.

On a ``gloo`` group a CUDA tensor is staged through a pinned host buffer
for every operation (ranks sharing one card run over gloo); ``nccl``
groups never stage.  :func:`collective_stats` counts each operation's
calls and staged bytes (host copies both ways), as plain integers.
"""
from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..framework.errors import InvalidArgumentError
from .mesh import AxisGroup, get_mesh

__all__ = [
    "ReduceOp",
    "all_reduce",
    "all_gather",
    "reduce",
    "broadcast",
    "scatter",
    "alltoall",
    "barrier",
    "psum",
    "pmean",
    "pmax",
    "pmin",
    "ppermute",
    "all_to_all_single",
    "all_reduce_start",
    "all_reduce_finish",
    "get_overlap_schedule",
    "set_overlap_schedule",
    "overlap_schedule",
    "collective_stats",
    "reset_collective_stats",
]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"


_TORCH_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.MAX: dist.ReduceOp.MAX,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.PROD: dist.ReduceOp.PRODUCT,
}

_stats: Dict[str, Dict[str, int]] = defaultdict(
    lambda: {"calls": 0, "staged_bytes": 0})
_stats_lock = threading.Lock()


def collective_stats() -> Dict[str, Dict[str, int]]:
    """``{op: {"calls": n, "staged_bytes": b}}`` since the last
    :func:`reset_collective_stats` (a copy)."""
    with _stats_lock:
        return {k: dict(v) for k, v in sorted(_stats.items())}


def reset_collective_stats():
    with _stats_lock:
        _stats.clear()


def _count(op: str, staged: int = 0):
    with _stats_lock:
        s = _stats[op]
        s["calls"] += 1
        s["staged_bytes"] += int(staged)


def _group(group) -> AxisGroup:
    # the one seam every collective passes through — chaos plans inject
    # device/interconnect failures here (site "collective.call")
    from ..resilience.faults import fault_point

    fault_point("collective.call")
    if group is None:
        return get_mesh().group("data")
    if isinstance(group, AxisGroup):
        return group
    if isinstance(group, (str, tuple, list)):
        return get_mesh().group(group)
    axis = getattr(group, "axis", None)
    if axis is not None:
        return get_mesh().group(axis)
    raise InvalidArgumentError(
        f"group must be a mesh axis name or an AxisGroup, got {group!r}")


class _Host:
    """The tensors an operation hands its backend: pinned host copies of
    CUDA tensors on a gloo group, the tensors themselves otherwise;
    ``staged`` counts the bytes copied."""

    def __init__(self, g: AxisGroup, device: torch.device):
        self.stage = device.type == "cuda" and dist.get_backend(g.pg) == \
            "gloo"
        self.staged = 0

    def put(self, t: torch.Tensor) -> torch.Tensor:
        if not self.stage:
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        self.staged += h.numel() * h.element_size()
        return h

    def empty(self, shape, dtype, device) -> torch.Tensor:
        if not self.stage:
            return torch.empty(shape, dtype=dtype, device=device)
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def back(self, h: torch.Tensor, device) -> torch.Tensor:
        if not self.stage:
            return h
        self.staged += h.numel() * h.element_size()
        return h.to(device)


def _reduce_op(op: str):
    try:
        return _TORCH_OPS[op]
    except KeyError:
        raise InvalidArgumentError(
            f"unknown reduce op {op!r} (have {sorted(_TORCH_OPS)})") from None


def _widened(t: torch.Tensor, op: str, n: int) -> torch.Tensor:
    """A 16-bit float sum or product over more than two ranks runs in
    float32 and is rounded once, as XLA reduces them (the backend would
    round every partial result); over two ranks its one rounding is
    already that."""
    if n > 2 and t.dtype in (torch.bfloat16, torch.float16) and op in (
            ReduceOp.SUM, ReduceOp.PROD):
        return t.float()
    return t.contiguous()


def all_reduce(tensor, op: str = ReduceOp.SUM, group=None,
               sync_op: bool = True):
    """Every rank ends with the reduction over the group's ranks (in
    ``tensor``, which is returned)."""
    g = _group(group)
    if g.pg is None:
        _count("all_reduce")
        return tensor
    h = _Host(g, tensor.device)
    buf = h.put(_widened(tensor, op, g.size))
    dist.all_reduce(buf, op=_reduce_op(op), group=g.pg)
    out = h.back(buf, tensor.device)
    if out is not tensor:
        with torch.no_grad():
            tensor.copy_(out)
    _count("all_reduce", h.staged)
    return tensor


def _gather_list(g: AxisGroup, t: torch.Tensor, op: str) -> List[torch.Tensor]:
    if g.pg is None:
        _count(op)
        return [t]
    h = _Host(g, t.device)
    src = h.put(t.contiguous())
    outs = [h.empty(t.shape, t.dtype, t.device) for _ in range(g.size)]
    dist.all_gather(outs, src, group=g.pg)
    if h.stage:
        outs = list(h.back(torch.stack(outs), t.device).unbind(0))
    _count(op, h.staged)
    return outs


def all_gather(tensor_or_list, tensor=None, group=None,
               sync_op: bool = True) -> List[torch.Tensor]:
    """The list of every rank's tensor, in group order (the same list on
    every rank).  Call styles: ``all_gather(tensor)`` or paddle-style
    ``all_gather(out_list, tensor)``, which extends ``out_list``."""
    out_list = None
    if tensor is None:
        tensor = tensor_or_list
    else:
        out_list = tensor_or_list
    result = _gather_list(_group(group), tensor, "all_gather")
    if out_list is not None:
        out_list.extend(result)
    return result


def reduce(tensor, dst: int = 0, op: str = ReduceOp.SUM, group=None,
           sync_op: bool = True):
    """Rank ``dst`` of the group gets the reduction; the other ranks keep
    their value."""
    g = _group(group)
    if g.pg is None:
        _count("reduce")
        return tensor
    h = _Host(g, tensor.device)
    buf = h.put(_widened(tensor, op, g.size).clone())
    dist.reduce(buf, dst=g.ranks[dst], op=_reduce_op(op), group=g.pg)
    if g.index == dst:
        with torch.no_grad():
            tensor.copy_(h.back(buf, tensor.device))
    _count("reduce", h.staged)
    return tensor


def broadcast(tensor, src: int = 0, group=None, sync_op: bool = True):
    """Every rank ends with rank ``src``'s value."""
    g = _group(group)
    if g.pg is None:
        _count("broadcast")
        return tensor
    h = _Host(g, tensor.device)
    buf = h.put(tensor.contiguous())
    dist.broadcast(buf, src=g.ranks[src], group=g.pg)
    out = h.back(buf, tensor.device)
    if out is not tensor:
        with torch.no_grad():
            tensor.copy_(out)
    _count("broadcast", h.staged)
    return tensor


def scatter(tensor, tensor_list=None, src: int = 0, group=None,
            sync_op: bool = True):
    """Rank ``i`` gets ``tensor_list[i]`` of rank ``src`` (in ``tensor``,
    which is returned); only ``src`` needs a ``tensor_list``."""
    g = _group(group)
    if g.pg is None:
        _count("scatter")
        if tensor_list is not None:
            with torch.no_grad():
                tensor.copy_(tensor_list[0])
        return tensor
    h = _Host(g, tensor.device)
    buf = h.put(tensor.contiguous())
    parts = None
    if g.index == src:
        if tensor_list is None or len(tensor_list) != g.size:
            raise InvalidArgumentError(
                f"scatter: rank {src} needs a tensor_list of {g.size} "
                f"tensors")
        parts = [h.put(t.contiguous()) for t in tensor_list]
    dist.scatter(buf, parts, src=g.ranks[src], group=g.pg)
    out = h.back(buf, tensor.device)
    if out is not tensor:
        with torch.no_grad():
            tensor.copy_(out)
    _count("scatter", h.staged)
    return tensor


def _a2a_rows(g: AxisGroup, stacked: torch.Tensor, op: str) -> torch.Tensor:
    """Row ``j`` of ``stacked`` ``[n, ...]`` goes to rank ``j``; row ``j``
    of the result came from rank ``j``."""
    if g.pg is None:
        _count(op)
        return stacked.clone()
    h = _Host(g, stacked.device)
    src = h.put(stacked.contiguous())
    out = h.empty(stacked.shape, stacked.dtype, stacked.device)
    dist.all_to_all_single(out, src, group=g.pg)
    out = h.back(out, stacked.device)
    _count(op, h.staged)
    return out


def alltoall(in_tensor_list, out_tensor_list=None, group=None,
             sync_op: bool = True):
    """``result[j]`` is rank ``j``'s ``in_tensor_list[i]`` on rank ``i``
    (equal shapes)."""
    g = _group(group)
    if isinstance(in_tensor_list, (list, tuple)):
        stacked = torch.stack(list(in_tensor_list))
    else:
        stacked = in_tensor_list
    if stacked.shape[0] != g.size:
        raise InvalidArgumentError(
            f"alltoall needs {g.size} tensors (the group's size), got "
            f"{stacked.shape[0]}")
    result = list(_a2a_rows(g, stacked, "alltoall").unbind(0))
    if out_tensor_list is not None:
        out_tensor_list.extend(result)
    return result


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, split_axis, concat_axis):
        ctx.g, ctx.axes = g, (split_axis, concat_axis)
        return _all_to_all(x, g, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, dy):
        split_axis, concat_axis = ctx.axes
        return (_all_to_all(dy, ctx.g, concat_axis, split_axis), None, None,
                None)


def _all_to_all(x, g, split_axis, concat_axis):
    n = g.size
    if x.shape[split_axis] % n:
        raise InvalidArgumentError(
            f"all_to_all_single: dim {split_axis} of {tuple(x.shape)} is "
            f"not divisible by the group size {n}")
    stacked = torch.stack(x.chunk(n, split_axis))
    got = _a2a_rows(g, stacked, "all_to_all_single")
    return torch.cat(got.unbind(0), dim=concat_axis)


def all_to_all_single(x, axis_name: str, split_axis: int = 0,
                      concat_axis: int = 0):
    """``lax.all_to_all(tiled=True)``: ``x`` splits into the group's size
    chunks along ``split_axis``, chunk ``j`` goes to rank ``j``, and the
    chunks received concatenate along ``concat_axis`` in rank order.
    Differentiable (the backward is the reverse exchange)."""
    g = _group(axis_name)
    split_axis %= x.dim()
    concat_axis %= x.dim()
    return _AllToAll.apply(x, g, split_axis, concat_axis)


def barrier(group=None):
    """Block until every rank of the group has reached here and this
    rank's queued device work has finished."""
    g = _group(group)
    if g.pg is None:
        _count("barrier")
        return
    if dist.get_backend(g.pg) == "nccl":
        token = torch.zeros(1, device=torch.device(
            "cuda", torch.cuda.current_device()))
    else:
        token = torch.zeros(1)
    dist.all_reduce(token, group=g.pg)
    if token.device.type == "cuda":
        torch.cuda.synchronize(token.device)
    _count("barrier")


# -- in-graph primitives over a mesh axis ------------------------------------
class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, mean):
        ctx.g, ctx.mean = g, mean
        return _reduced(x, g, ReduceOp.SUM, mean)

    @staticmethod
    def backward(ctx, dy):
        return _reduced(dy, ctx.g, ReduceOp.SUM, ctx.mean), None, None


def _reduced(x, g, op, mean=False):
    y = all_reduce(x.detach().clone(), op, group=g)
    return y / g.size if mean else y


def psum(x, axis_name):
    """The sum over the axis, on every rank (differentiable: the
    gradient is summed back over the axis, ``lax.psum``'s transpose)."""
    return _PSum.apply(x, _group(axis_name), False)


def pmean(x, axis_name):
    """The mean over the axis, on every rank (differentiable)."""
    return _PSum.apply(x, _group(axis_name), True)


def pmax(x, axis_name):
    """The elementwise max over the axis, on every rank."""
    return _reduced(x, _group(axis_name), ReduceOp.MAX)


def pmin(x, axis_name):
    """The elementwise min over the axis, on every rank."""
    return _reduced(x, _group(axis_name), ReduceOp.MIN)


def ppermute(x, axis_name, perm: Sequence):
    """``lax.ppermute``: ``perm`` is ``(src, dst)`` pairs of axis indices;
    this rank gets the ``x`` of the rank that sends to it, zeros when
    none does.  One ``batch_isend_irecv``."""
    g = _group(axis_name)
    me = g.index
    send_to = [d for s, d in perm if s == me]
    recv_from = [s for s, d in perm if d == me]
    if len(recv_from) > 1 or len(send_to) > 1:
        raise InvalidArgumentError(
            f"ppermute: perm {list(perm)} is not a permutation")
    if g.pg is None or send_to == recv_from == [me]:
        _count("ppermute")
        return x.clone() if recv_from else torch.zeros_like(x)
    h = _Host(g, x.device)
    ops = []
    if send_to:
        ops.append(dist.P2POp(dist.isend, h.put(x.contiguous()),
                              g.ranks[send_to[0]], group=g.pg))
    out = None
    if recv_from:
        out = h.empty(x.shape, x.dtype, x.device)
        ops.append(dist.P2POp(dist.irecv, out, g.ranks[recv_from[0]],
                              group=g.pg))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    result = (h.back(out, x.device) if out is not None
              else torch.zeros_like(x))
    _count("ppermute", h.staged)
    return result


def _gather_cat(x: torch.Tensor, g: AxisGroup, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group order."""
    return torch.cat(_gather_list(g, x, "all_gather"), dim=dim)


def _all_reduce_coalesced(tensors: List[torch.Tensor], group,
                          op: str = ReduceOp.SUM):
    """All-reduce ``tensors`` in place, one call per dtype and device
    (flattened into one buffer each)."""
    g = _group(group)
    if g.pg is None or not tensors:
        return
    buckets: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for ts in buckets.values():
        flat = _flatten_dense_tensors(ts)
        all_reduce(flat, op, group=g)
        with torch.no_grad():
            for t, v in zip(ts, _unflatten_dense_tensors(flat, ts)):
                t.copy_(v)


def _broadcast_coalesced(tensors: List[torch.Tensor], group, src: int = 0):
    """Broadcast ``tensors`` in place from rank ``src`` of the group, one
    call per dtype and device."""
    g = _group(group)
    if g.pg is None or not tensors:
        return
    buckets: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for ts in buckets.values():
        flat = _flatten_dense_tensors(ts)
        broadcast(flat, src, group=g)
        with torch.no_grad():
            for t, v in zip(ts, _unflatten_dense_tensors(flat, ts)):
                t.copy_(v)


# ---------------------------------------------------------------------------
# Overlap schedules: WHERE the tensor-parallel reduces land, as a dial.
# The JAX layers annotate and GSPMD places the reduce at the annotation;
# the port's layers issue the collective at the same point, so the dials
# move the explicit all-reduce:
#   defer_row_reduce     — RowParallelLinear adds its bias to model rank
#                          0's partial sum and reduces after (the same
#                          sum, one reduce later in the layer);
#   mlp_collective_split — accepted for parity (the block's residual add
#                          and the reduce commute in eager execution).
_OVERLAP_DIALS = ("defer_row_reduce", "mlp_collective_split")
_overlap_schedule = {k: 0 for k in _OVERLAP_DIALS}
_overlap_lock = threading.Lock()


def get_overlap_schedule() -> dict:
    """The active overlap-schedule dials (a copy)."""
    with _overlap_lock:
        return dict(_overlap_schedule)


def set_overlap_schedule(config: Optional[dict] = None, **dials) -> dict:
    """Set overlap dials (unknown keys rejected; unset dials keep their
    value).  Returns the previous schedule."""
    merged = dict(config or ())
    merged.update(dials)
    for k in merged:
        if k not in _OVERLAP_DIALS:
            raise InvalidArgumentError(
                f"unknown overlap dial {k!r} (have {_OVERLAP_DIALS})")
    with _overlap_lock:
        prev = dict(_overlap_schedule)
        for k, v in merged.items():
            _overlap_schedule[k] = int(v)
    return prev


class overlap_schedule:
    """Context manager: apply overlap dials inside, restore the previous
    schedule on exit."""

    def __init__(self, config: Optional[dict] = None, **dials):
        self._new = dict(config or ())
        self._new.update(dials)

    def __enter__(self):
        self._prev = set_overlap_schedule(self._new)
        return get_overlap_schedule()

    def __exit__(self, *exc):
        set_overlap_schedule(self._prev)


class _Pending:
    __slots__ = ("work", "out", "host", "staged")

    def __init__(self, work, out, host, staged):
        self.work, self.out, self.host, self.staged = work, out, host, staged


def all_reduce_start(x, axis_name: str):
    """Start the sum of ``x`` over the axis without waiting (an
    ``async_op`` handle); :func:`all_reduce_finish` waits and returns
    it.  Work between the two overlaps the transfer."""
    g = _group(axis_name)
    if g.pg is None:
        return _Pending(None, x.clone(), None, 0)
    h = _Host(g, x.device)
    buf = h.put(x.detach().contiguous().clone())
    work = dist.all_reduce(buf, group=g.pg, async_op=True)
    return _Pending(work, x if h.stage else buf, buf if h.stage else None,
                    h.staged)


def all_reduce_finish(handle) -> torch.Tensor:
    """Wait for a staged all-reduce and return the sum."""
    if handle.work is None:
        _count("all_reduce")
        return handle.out
    handle.work.wait()
    if handle.host is not None:
        out = handle.host.to(handle.out.device)
        staged = handle.staged + handle.host.numel() * \
            handle.host.element_size()
    else:
        out, staged = handle.out, 0
    _count("all_reduce", staged)
    return out
