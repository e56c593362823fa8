"""Pipeline parallelism over the ``pipe`` mesh axis (port of
``paddle_tpu.distributed.pipeline_parallel``).

The JAX package runs the schedule as one differentiable ``lax.scan`` over
ticks, rotating activations with ``ppermute``.  The port runs one process
per rank, so each rank runs its stage's share of the schedule itself:

* stage ``s`` (this rank's ``pipe`` coordinate) owns blocks
  ``[s·L/pp, (s+1)·L/pp)`` of a homogeneous block stack;
* the batch splits into ``num_microbatches`` microbatches; activations
  travel to stage ``s+1`` and cotangents back to ``s-1`` by point-to-point
  sends over the ``pipe`` axis group, one batch of sends and receives a
  tick (CUDA tensors on a gloo group are staged through pinned host
  buffers, as every collective of ``collective`` is; ``collective_stats``
  counts them under ``pipeline_p2p``);
* each microbatch's stage forward keeps its autograd graph until its
  backward, so a block runs once forward and once backward a microbatch.

Schedules (JAX's tick rules):

* **GPipe** (:func:`pipeline_blocks`, and ``pipeline_train_step(schedule=
  "gpipe")``): all forwards (stage ``s`` forwards microbatch ``t - s`` at
  tick ``t``), then all backwards in reverse; every microbatch's graph is
  live at once;
* **1F1B** (:func:`pipeline_train_step`): at tick ``t`` stage ``s``
  forwards microbatch ``t - s`` and backwards microbatch
  ``t - (2·pp - 2 - s)``; the last stage backs a microbatch the tick it
  forwards it, and stage 0 holds at most :func:`ring_buffer_slots` =
  ``2·pp - 1`` microbatches' graphs.

Dropout inside the blocks draws from a generator of each (global block,
microbatch): its seed is derived from this rank's replicated stream
(``framework.random``), the step and the two indices, so the order in
which a schedule runs the microbatches never changes a mask (GPipe and
1F1B draw the same masks); the column-parallel stream is derived from it
by model rank.

Constraints, with JAX's errors: ``len(blocks) % pp == 0``, the batch
divisible by the microbatch count, structurally identical blocks, no
buffers.

Where JAX returns gradient pytrees (``{name: [L, ...]}``, the head's), the
port accumulates gradients into the parameters' ``.grad``, as
``backward`` does: a stage's blocks on that stage, the head's on the last
stage (``pipeline_train_step``'s docstring).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as tdist

from ..framework import random as _random
from ..framework.errors import InvalidArgumentError
from .mesh import get_mesh

__all__ = ["pipeline_degree", "pipeline_blocks", "pipeline_train_step",
           "ring_buffer_slots", "stage_bounds"]


def pipeline_degree(mesh=None) -> int:
    mesh = mesh or get_mesh()
    return mesh.shape.get("pipe", 1)


def ring_buffer_slots(pp: int) -> int:
    """Saved activations per stage under the 1F1B schedule: at most
    ``2·pp − 1`` microbatches are in flight at stage 0 — a constant in
    ``num_microbatches`` (GPipe holds all M)."""
    return 2 * pp - 1


def stage_bounds(num_blocks: int, pp: int, stage: int):
    """``(lo, hi)``: the blocks stage ``stage`` of ``pp`` owns."""
    per = num_blocks // pp
    return stage * per, (stage + 1) * per


def _check(blocks, pp: int, batch: int, M: int):
    L = len(blocks)
    if L % pp:
        raise InvalidArgumentError(
            f"pipeline: {L} blocks not divisible by pp={pp} stages")
    if list(blocks[0].named_buffers()):
        raise InvalidArgumentError(
            "pipeline blocks must be buffer-free (running-stat updates "
            "cannot cross the stage scan); use LayerNorm, not BatchNorm")
    names = {n for n, _ in blocks[0].named_parameters()}
    for i, b in enumerate(blocks):
        if {n for n, _ in b.named_parameters()} != names:
            raise InvalidArgumentError(
                f"pipeline stages must be structurally identical: block {i} "
                f"parameters differ from block 0")
    if batch % M:
        raise InvalidArgumentError(
            f"pipeline: batch {batch} not divisible by {M} microbatches")


# -- the per-(block, microbatch) dropout streams -----------------------------
_draws = {"seed": None, "count": 0}


def _step_base() -> int:
    """A seed for one pipelined step: this rank's replicated stream seed
    and the number of pipelined steps since the streams were last
    reseeded — equal on the ranks of one data coordinate, which run their
    steps in lockstep."""
    s = _random.stream_seed("replicated")
    key = (s, _random.reseeds())
    if _draws["seed"] != key:
        _draws["seed"], _draws["count"] = key, 0
    _draws["count"] += 1
    return _random.derive_seed(s, _draws["count"])


class _Link:
    """One tick's point-to-point exchange between neighbouring stages over
    the ``pipe`` group: the sends and receives start together and are
    waited for together."""

    def __init__(self, group):
        self.g = group

    def tick(self, sends, recvs, like):
        """``sends``: ``[(stage, tensor)]``; ``recvs``: ``[stage]`` —
        returns the received tensors (``like``'s shape, dtype and
        device) in ``recvs`` order."""
        from .collective import _count, _Host

        if not sends and not recvs:
            return []
        g = self.g
        h = _Host(g, like.device)
        ops, outs = [], []
        for stage, t in sends:
            ops.append(tdist.P2POp(tdist.isend, h.put(t.contiguous()),
                                   g.ranks[stage], group=g.pg))
        for stage in recvs:
            buf = h.empty(like.shape, like.dtype, like.device)
            outs.append(buf)
            ops.append(tdist.P2POp(tdist.irecv, buf, g.ranks[stage],
                                   group=g.pg))
        for w in tdist.batch_isend_irecv(ops):
            w.wait()
        got = [h.back(b, like.device) for b in outs]
        _count("pipeline_p2p", h.staged)
        return got


class _Stage:
    """This rank's stage of one pipelined pass: its blocks, the schedule's
    bookkeeping and the dropout streams."""

    def __init__(self, blocks, M: int, mesh, axis_name: str):
        self.g = mesh.group(axis_name)
        self.pp, self.s = self.g.size, self.g.index
        self.lo, self.hi = stage_bounds(len(blocks), self.pp, self.s)
        self.blocks = list(blocks)[self.lo:self.hi]
        self.M = M
        self.training = bool(getattr(blocks[0], "training", False))
        self.base = _step_base() if self.training else None
        self.link = _Link(self.g)
        self.max_live = 0

    @property
    def first(self) -> bool:
        return self.s == 0

    @property
    def last(self) -> bool:
        return self.s == self.pp - 1

    def apply(self, h, mb: int):
        """This stage's blocks on microbatch ``mb``'s activation."""
        for j, blk in enumerate(self.blocks):
            if self.base is None:
                h = blk(h)
            else:
                with _random.scope(_random.derive_seed(
                        self.base, self.lo + j, mb)):
                    h = blk(h)
        return h

    def exchange(self, sends, fwd_from: Optional[int], bwd_from:
                 Optional[int], like):
        """Send ``sends``; receive the next forward input (``fwd_from``:
        its microbatch) from the previous stage and the next cotangent
        (``bwd_from``) from the next one.  Returns ``(fwd, bwd)``."""
        recvs = []
        if fwd_from is not None:
            recvs.append(self.s - 1)
        if bwd_from is not None:
            recvs.append(self.s + 1)
        got = self.link.tick(sends, recvs, like)
        fwd = got.pop(0) if fwd_from is not None else None
        bwd = got.pop(0) if bwd_from is not None else None
        return fwd, bwd

    def broadcast(self, t, src: int):
        """``t`` of pipe stage ``src`` on every stage (in place)."""
        from .collective import broadcast

        return broadcast(t, src=src, group=self.g)


def _valid(i: int, M: int) -> Optional[int]:
    return i if 0 <= i < M else None


def _gpipe_forward(st: _Stage, micro, like, keep_graph: bool, head=None):
    """The GPipe forward ticks: ``{mb: (input, output)}`` on this stage
    (graphs kept when ``keep_graph``); on the last stage ``head(y, mb)``,
    where given, turns the output into the microbatch's scaled loss."""
    pp, s, M = st.pp, st.s, st.M
    live, fwd_in = {}, {}
    for t in range(M + pp - 1):
        f = _valid(t - s, M)
        sends = []
        if f is not None:
            h = micro[f] if st.first else fwd_in.pop(f)
            if keep_graph and not st.first:
                h.requires_grad_(True)
            y = st.apply(h, f)
            live[f] = (h, head(y, f) if head is not None else y)
            st.max_live = max(st.max_live, len(live))
            if not st.last:
                sends.append((s + 1, y.detach()))
        nxt = _valid(t + 1 - s, M) if not st.first else None
        got, _ = st.exchange(sends, nxt, None, like)
        if nxt is not None:
            fwd_in[nxt] = got
    return live


def _gpipe_backward(st: _Stage, live, dys, like):
    """The GPipe backward ticks, microbatches in reverse: the last stage
    takes ``dys[mb]`` (or backs its scaled loss where ``dys`` is None);
    returns stage 0's input cotangents (``None`` elsewhere, or where the
    input takes no gradient)."""
    pp, s, M = st.pp, st.s, st.M
    dx: List[Optional[torch.Tensor]] = [None] * M
    bwd_in = {}

    def rev(t, stage):
        i = t - (pp - 1 - stage)
        return M - 1 - i if 0 <= i < M else None

    for t in range(M + pp - 1):
        b = rev(t, s)
        sends = []
        if b is not None:
            h, out = live.pop(b)
            if st.last and dys is None:
                out.backward()
            else:
                cot = dys[b] if st.last else bwd_in.pop(b)
                out.backward(cot.to(out.dtype))
            if not st.first:
                sends.append((s - 1, h.grad))
            elif h.requires_grad:
                dx[b] = h.grad
        nxt = rev(t, s + 1) if not st.last else None
        _, got = st.exchange(sends, None, nxt, like)
        if nxt is not None:
            bwd_in[nxt] = got
    return dx


class _GPipe(torch.autograd.Function):
    """``pipeline_blocks`` with gradients: the forward ticks keep each
    microbatch's graph; the backward runs the reverse ticks and hands the
    input's cotangent (stage 0's) to every stage, as the replicated input
    takes it in JAX."""

    @staticmethod
    def forward(ctx, x, st, like):
        micro = [m.detach().requires_grad_(True)
                 for m in x.chunk(st.M, 0)] if st.first else None
        with torch.enable_grad():
            live = _gpipe_forward(st, micro, like, keep_graph=True)
        out = torch.empty_like(x)
        if st.last:
            out.copy_(torch.cat([live[f][1].detach() for f in range(st.M)]))
        st.broadcast(out, st.pp - 1)
        ctx.st, ctx.live, ctx.like = st, live, like
        return out

    @staticmethod
    def backward(ctx, dy):
        st = ctx.st
        dys = dy.chunk(st.M, 0) if st.last else None
        with torch.enable_grad():
            dx = _gpipe_backward(st, ctx.live, dys, ctx.like)
        out = torch.cat(dx) if st.first else torch.empty(
            (st.M * ctx.like.shape[0],) + tuple(ctx.like.shape[1:]),
            dtype=dy.dtype, device=dy.device)
        st.broadcast(out, 0)
        ctx.live = None
        return out, None, None


def pipeline_blocks(
    blocks: Sequence,
    x: torch.Tensor,
    *,
    num_microbatches: Optional[int] = None,
    mesh=None,
    axis_name: str = "pipe",
):
    """Run ``x`` through ``blocks`` (a homogeneous Layer stack) pipelined
    over the ``pipe`` mesh axis — the same function as ``for b in blocks:
    x = b(x)``, executed as a GPipe microbatch schedule: stage ``s`` runs
    blocks ``[s·L/pp, (s+1)·L/pp)`` and the last stage's output reaches
    every stage (the head runs replicated over ``pipe``, as in JAX).
    Differentiable: the backward is the reverse schedule, the blocks'
    gradients accumulate on their own stage and ``x``'s cotangent reaches
    every stage.  The blocks compute with their own parameters (JAX's
    ``params``, stacked for a functional call, has no counterpart)."""
    mesh = mesh or get_mesh()
    pp = mesh.shape.get(axis_name, 1)
    if pp == 1:
        for b in blocks:
            x = b(x)
        return x
    M = int(num_microbatches or pp)
    _check(blocks, pp, x.shape[0], M)
    st = _Stage(blocks, M, mesh, axis_name)
    like = torch.empty((x.shape[0] // M,) + tuple(x.shape[1:]),
                       dtype=x.dtype, device=x.device)
    if torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for b in st.blocks for p in b.parameters())):
        if not x.requires_grad:  # the blocks' gradients need a backward
            x = x.detach().requires_grad_(True)
        return _GPipe.apply(x, st, like)
    micro = list(x.chunk(M, 0)) if st.first else None
    live = _gpipe_forward(st, micro, like, keep_graph=False)
    out = torch.empty_like(x)
    if st.last:
        out.copy_(torch.cat([live[f][1] for f in range(M)]))
    return st.broadcast(out, pp - 1)


def _split_labels(labels, M: int):
    """Each label array split into ``M`` microbatches: ``[(mb's labels)]``."""
    labels = tuple(labels) if isinstance(labels, (tuple, list)) \
        else (labels,)
    for lbl in labels:
        if lbl.shape[0] % M:
            raise InvalidArgumentError(
                f"pipeline: label batch {lbl.shape[0]} not divisible by "
                f"{M} microbatches")
    parts = [lbl.chunk(M, 0) for lbl in labels]
    return [tuple(p[i] for p in parts) for i in range(M)]


def pipeline_train_step(
    blocks: Sequence,
    x: torch.Tensor,
    labels,
    loss_fn=None,
    *,
    num_microbatches: Optional[int] = None,
    schedule: str = "1f1b",
    mesh=None,
    axis_name: str = "pipe",
    head_params=None,
    head_loss_fn=None,
    head_aux_fn=None,
    return_dx: bool = False,
    stats: Optional[dict] = None,
):
    """One pipelined forward + backward pass of this rank's stage.

    ``x`` is the block stack's input: stage 0 reads it; the other stages
    read only its shape, dtype and device (it may be ``torch.empty``).
    ``labels``: a tensor or a tuple of tensors with the batch first.
    ``head_loss_fn(y_mb, labels_mb, head_params)`` is the head and loss of
    one microbatch on the last stage (``loss_fn(y_mb, labels_mb)`` where no
    head is given); it must mean over its microbatch, and the step's loss
    is the mean over microbatches.  ``head_aux_fn(y_mb, labels_mb)``: a
    per-microbatch computation without gradient on the last stage (a
    metric's ``compute``), its rows joined in batch order and handed to
    every stage.

    Gradients accumulate into ``.grad``: this stage's blocks, the head's
    parameters (what ``head_loss_fn`` reads) on the last stage.  Returns
    ``(loss, dx)`` — the loss on every stage, ``dx`` the input's
    cotangent on stage 0 (``None`` elsewhere, and where ``return_dx`` is
    false) — and the aux rows as a third element where ``head_aux_fn`` is
    given.  ``schedule``: ``"1f1b"``, ``"gpipe"`` or ``"F-then-B"``
    (GPipe's reference name).  The blocks compute with their own
    parameters and draw dropout from the rank's streams (JAX's functional
    ``params`` / ``rng_key`` have no counterpart; module docstring).
    ``stats``: a dict, where given, that the step fills with
    ``max_live``, the most microbatches whose activations this stage held
    at once (at most :func:`ring_buffer_slots` under 1F1B).
    """
    schedule = str(schedule).lower()
    if schedule == "f-then-b":
        schedule = "gpipe"
    if schedule not in ("1f1b", "gpipe"):
        raise InvalidArgumentError(
            f"pipeline schedule must be '1f1b', 'gpipe' or 'F-then-B', "
            f"got {schedule!r}")
    if head_loss_fn is None:
        if loss_fn is None:
            raise InvalidArgumentError(
                "pipeline_train_step needs loss_fn or head_loss_fn")
        head_loss_fn = lambda y, lbl, _hp: loss_fn(y, *lbl)  # noqa: E731
    mesh = mesh or get_mesh()
    pp = mesh.shape.get(axis_name, 1)
    M = int(num_microbatches or pp)
    if pp == 1:
        if stats is not None:  # one pass over the whole batch
            stats["max_live"] = 1
        return _single_stage(blocks, x, labels, head_loss_fn, head_params,
                             head_aux_fn, return_dx)
    _check(blocks, pp, x.shape[0], M)
    st = _Stage(blocks, M, mesh, axis_name)
    lbl = _split_labels(labels, M)
    like = torch.empty((x.shape[0] // M,) + tuple(x.shape[1:]),
                       dtype=x.dtype, device=x.device)
    micro = None
    if st.first:
        micro = [m.detach().requires_grad_(return_dx)
                 for m in x.chunk(M, 0)]
    head = lambda y, f: head_loss_fn(y, lbl[f], head_params)  # noqa: E731
    if schedule == "1f1b":
        loss, dx, aux = _one_f_one_b(st, micro, like, lbl, head,
                                     head_aux_fn)
    else:
        loss, dx, aux = _gpipe_train(st, micro, like, lbl, head,
                                     head_aux_fn)
    loss = st.broadcast(loss, pp - 1)
    dx = torch.cat(dx) if st.first and return_dx else None
    if stats is not None:
        stats["max_live"] = st.max_live
    if head_aux_fn is not None:
        return loss, dx, _aux_rows(st, aux, like)
    return loss, dx


def _single_stage(blocks, x, labels, head_loss_fn, head_params, aux_fn,
                  return_dx):
    """pp = 1: the blocks and the head over the whole batch (JAX's
    degenerate case)."""
    x = x.detach().requires_grad_(return_dx)
    y = x
    for b in blocks:
        y = b(y)
    lbl = tuple(labels) if isinstance(labels, (tuple, list)) else (labels,)
    loss = head_loss_fn(y, lbl, head_params)
    aux = None
    if aux_fn is not None:
        with torch.no_grad():
            aux = aux_fn(y.detach(), lbl)
    loss.backward()
    out = (loss.detach(), x.grad if return_dx else None)
    return out + (aux,) if aux_fn is not None else out


def _head_step(y, f: int, head, aux_fn, lbl, aux):
    """The last stage's loss of microbatch ``f`` (scaled by ``1/M`` for
    the backward) and its aux rows."""
    loss = head(y, f)
    if aux_fn is not None:
        with torch.no_grad():
            aux[f] = aux_fn(y.detach(), lbl[f])
    return loss


def _one_f_one_b(st: _Stage, micro, like, lbl, head, aux_fn):
    pp, s, M = st.pp, st.s, st.M
    live, fwd_in, bwd_in = {}, {}, {}
    dx: List[Optional[torch.Tensor]] = [None] * M
    aux: List = [None] * M
    loss_sum = torch.zeros((), dtype=torch.float32, device=like.device)
    lag = 2 * pp - 2
    for t in range(M + lag):
        f, b = _valid(t - s, M), _valid(t - (lag - s), M)
        sends = []
        if f is not None:
            h = micro[f] if st.first else fwd_in.pop(f).requires_grad_(True)
            with torch.enable_grad():
                y = st.apply(h, f)
                if st.last:
                    loss = _head_step(y, f, head, aux_fn, lbl, aux)
                    loss_sum = loss_sum + loss.detach().float()
                    live[f] = (h, loss / M)
                else:
                    live[f] = (h, y)
                    sends.append((s + 1, y.detach()))
            st.max_live = max(st.max_live, len(live))
        if b is not None:
            h, out = live.pop(b)
            if st.last:
                out.backward()
            else:
                out.backward(bwd_in.pop(b).to(out.dtype))
            if not st.first:
                sends.append((s - 1, h.grad))
            elif h.requires_grad:
                dx[b] = h.grad
        nf = _valid(t + 1 - s, M) if not st.first else None
        nb = _valid(t - (lag - s - 1), M) if not st.last else None
        got_f, got_b = st.exchange(sends, nf, nb, like)
        if nf is not None:
            fwd_in[nf] = got_f
        if nb is not None:
            bwd_in[nb] = got_b
    return loss_sum / M, dx, aux


def _gpipe_train(st: _Stage, micro, like, lbl, head, aux_fn):
    aux: List = [None] * st.M
    losses = []

    def scaled(y, f):
        loss = _head_step(y, f, head, aux_fn, lbl, aux)
        losses.append(loss.detach().float())
        return loss / st.M

    with torch.enable_grad():
        live = _gpipe_forward(st, micro, like, keep_graph=True,
                              head=scaled if st.last else None)
    dx = _gpipe_backward(st, live, None, like)
    loss = torch.stack(losses).sum() / st.M if losses else torch.zeros(
        (), dtype=torch.float32, device=like.device)
    return loss, dx, aux


def _aux_rows(st: _Stage, aux, like):
    """The last stage's per-microbatch aux rows, joined in batch order,
    on every stage (JAX psums them over ``pipe``).  An aux value is a
    tensor or a tuple whose items are tensors or tuples of tensors; the
    result keeps that nesting."""
    def flat(a):
        a = tuple(a) if isinstance(a, (tuple, list)) else (a,)
        return [tuple(x) if isinstance(x, (tuple, list)) else x for x in a]

    if st.last:
        per_mb = [flat(a) for a in aux]
        struct = [len(x) if isinstance(x, tuple) else None
                  for x in per_mb[0]]
        leaves = [[v for x in mb for v in (x if isinstance(x, tuple)
                                            else (x,))] for mb in per_mb]
        rows = [torch.cat([torch.as_tensor(leaves[f][i])
                           for f in range(st.M)])
                for i in range(len(leaves[0]))]
        meta = (struct, [(tuple(r.shape), r.dtype) for r in rows])
    else:
        meta = None
    box = [meta]
    tdist.broadcast_object_list(box, src=st.g.ranks[st.pp - 1],
                                group=st.g.pg)
    struct, shapes = box[0]
    if not st.last:
        rows = [torch.empty(shape, dtype=dt, device=like.device)
                for shape, dt in shapes]
    rows = [st.broadcast(r.to(like.device).contiguous(), st.pp - 1)
            for r in rows]
    out, k = [], 0
    for n in struct:
        if n is None:
            out.append(rows[k])
            k += 1
        else:
            out.append(tuple(rows[k:k + n]))
            k += n
    return tuple(out)
