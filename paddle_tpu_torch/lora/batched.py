"""Batched multi-LoRA: fixed-capacity adapter tables, ragged grouped apply
(port of ``paddle_tpu.lora.batched``).

Serving N adapters from one continuously batched engine beats N
per-adapter replicas when the per-row adapter gather is one ragged grouped
computation instead of a per-request branch (S-LoRA, Sheng et al., MLSys
2024).  As in the JAX package:

* each targeted parallel linear carries THREE buffers — ``lora_A [cap,
  in, r]``, ``lora_B [cap, r, out]``, ``lora_scale [cap]`` (float32) —
  a fixed-capacity table of ``cap`` adapter slots, under the JAX names, so
  ``bridge.load_jax_params(..., buffers=)`` maps them 1:1.  Hot add /
  remove of an adapter edits table rows (``write_adapter`` /
  ``clear_slot`` on a flat dict; the engine writes its own tables in
  place), never a shape;
* per step the engine scopes a ``[B]`` id vector
  (``runtime.adapter_scope``); the linear's base product is untouched and
  the delta is ``grouped(grouped(scatter(x), A), B)`` over the table —
  the compacted one-hot / exclusive-cumsum dispatch of the MoE layer into
  a ``[cap, N, D]`` buffer, both low-rank hops grouped, each row's result
  gathered back and multiplied by its slot's scale;
* slot id ``-1`` = no adapter: the final combine is a ``torch.where`` that
  SELECTS the base output for dead rows, so a base-tenant row is bitwise
  the output of a model without LoRA.

The scatter: the JAX package adds every row into a zeroed buffer, dead
rows adding exact zeros at slot ``(0, 0)``; here the dead rows are copied
into one spare row past the buffer instead (``index_copy_``, no atomics),
so each live row lands in its own buffer row unchanged and the result is
bit-equal whatever the order of the rows.  Every adapted linear of one
call derives the same dispatch from the same ids: it is computed once a
call and kept on the scope (``adapter_scope.plans``).

**The gate** (``_grouped``) is decided afresh for the port: every CUDA
activation takes the ``grouped_matmul`` CUDA kernel (kernel 10) for both
hops — hop 1 ``[cap, N, D] x [cap, D, r]`` with the rank as the output
width, hop 2 ``[cap, N, r] x [cap, r, F]`` with the rank as the inner
width; on the CPU the masked einsum runs, as the JAX package's does off
the TPU.  JAX's lane clause (``fused_epilogues_eligible``: both widths
multiples of 128) is a limit of the TPU's tiles; the CUDA kernel checks
its edges and takes any width, as the MoE slice decided for the expert
FFN (``moe/layer.py`` ``_use_kernel``).  A LoRA engine scopes ids on
every call, so the kernel runs even when every row is ``-1`` (two
launches a site, zero-sized groups).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..framework.errors import InvalidArgumentError
from ..ops.grouped_matmul import grouped_matmul

__all__ = [
    "DEFAULT_TARGETS", "lora_targets", "enable_lora", "apply_lora",
    "lora_delta", "write_adapter", "clear_slot", "adapter_capacity",
]

#: leaf names of the parallel linears that take adapter deltas — the
#: transformer block projections, NOT the (tied) embedding / LM head
DEFAULT_TARGETS = ("qkv", "out", "fc1", "fc2")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def lora_targets(model, targets: Sequence[str] = DEFAULT_TARGETS
                 ) -> List[Tuple[str, object]]:
    """``(dotted_name, layer)`` for every parallel linear whose leaf name
    is in ``targets`` (``None`` = every parallel linear)."""
    from ..distributed.meta_parallel import (ColumnParallelLinear,
                                             RowParallelLinear)

    out = []
    for name, layer in model.named_modules():
        if not isinstance(layer, (ColumnParallelLinear, RowParallelLinear)):
            continue
        leaf = name.rsplit(".", 1)[-1]
        if targets is not None and leaf not in tuple(targets):
            continue
        out.append((name, layer))
    return out


def enable_lora(model, capacity: int, rank: int, alpha: float = None,
                targets: Sequence[str] = DEFAULT_TARGETS,
                dtype="float32") -> List[str]:
    """Register zero-initialized adapter tables on every target linear,
    on the linear's device; ``lora_A`` / ``lora_B`` in ``dtype``,
    ``lora_scale`` float32 (``alpha / rank``; ``alpha`` defaults to the
    rank).

    Zero tables mean an enabled-but-empty model computes ``base + 0`` on
    live rows and exactly ``base`` on ``-1`` rows — safe to enable at model
    construction.  Returns the dotted site names (the keys adapters must
    address)."""
    capacity = int(capacity)
    rank = int(rank)
    if capacity < 1:
        raise InvalidArgumentError(
            f"lora capacity must be >= 1, got {capacity}")
    if rank < 1:
        raise InvalidArgumentError(f"lora rank must be >= 1, got {rank}")
    dt = _DTYPES.get(str(dtype).replace("torch.", ""))
    if dt is None:
        raise InvalidArgumentError(
            f"enable_lora: tables are float32 or bfloat16, got {dtype!r}")
    scale = (float(alpha) if alpha is not None else float(rank)) / float(rank)
    sites = lora_targets(model, targets)
    if not sites:
        raise InvalidArgumentError(
            f"enable_lora: no parallel-linear targets matching "
            f"{tuple(targets)!r} under {type(model).__name__}")
    for name, layer in sites:
        if "lora_A" in layer._buffers:
            raise InvalidArgumentError(
                f"enable_lora: {name} already has an adapter table")
        din, dout = (int(s) for s in layer.weight.shape)
        dev = layer.weight.device
        layer.register_buffer(
            "lora_A", torch.zeros((capacity, din, rank), dtype=dt,
                                  device=dev))
        layer.register_buffer(
            "lora_B", torch.zeros((capacity, rank, dout), dtype=dt,
                                  device=dev))
        layer.register_buffer(
            "lora_scale", torch.full((capacity,), scale,
                                     dtype=torch.float32, device=dev))
    return [n for n, _ in sites]


def _grouped(xe, w, counts):
    """``[G, C, D] x [G, D, F]`` with per-group valid-row counts: the
    ``grouped_matmul`` CUDA kernel for every CUDA activation, the masked
    einsum (the JAX package's route off the TPU) on the CPU — see the
    module docstring for why the port has no width clause."""
    if xe.device.type == "cuda":
        return grouped_matmul(xe, w, counts)
    rows = xe.shape[1]
    mask = (torch.arange(rows, device=xe.device)[None, :]
            < counts[:, None]).to(xe.dtype)
    return torch.matmul(xe * mask[..., None], w)


def _plan(ids_row, cap: int):
    """The compacted dispatch of ``[N]`` row ids over ``cap`` slots:
    ``(counts [cap], cid [N], src [N], dst [N], live [N])`` — ``src`` is
    each row's place in the flat ``[cap * N]`` group-major buffer (dead
    rows read place 0, as in JAX, and are never selected), ``dst`` the
    same with dead rows sent to the spare row ``cap * N``."""
    n = int(ids_row.shape[0])
    ids = ids_row.long()
    live = ids >= 0
    cid = ids.clamp(0, cap - 1)
    # one_hot(-1) is a zero row, as jax.nn.one_hot's
    onehot = (ids[:, None] == torch.arange(cap, device=ids.device)).long()
    counts = onehot.sum(dim=0).to(torch.int32)  # the kernel's dtype
    posn = onehot.cumsum(dim=0) - onehot           # exclusive cumsum
    idx = (onehot * posn).sum(dim=-1)
    src = cid * n + idx
    dst = torch.where(onehot.sum(dim=-1) > 0, src,
                      torch.full_like(src, cap * n))
    return counts, cid, src, dst, live


def _delta(A, B, scale, x2, plan):
    counts, cid, src, dst, live = plan
    cap, n, D = int(A.shape[0]), int(x2.shape[0]), int(x2.shape[-1])
    buf = torch.zeros((cap * n + 1, D), dtype=A.dtype, device=x2.device)
    buf.index_copy_(0, dst, x2.to(A.dtype))
    xd = buf[:cap * n].view(cap, n, D)
    h = _grouped(xd, A, counts)        # [cap, N, r]
    z = _grouped(h, B, counts)         # [cap, N, F]
    d = z.reshape(cap * n, -1).index_select(0, src)
    return d * scale.index_select(0, cid)[:, None].to(z.dtype), live


def lora_delta(A, B, scale, x2, ids_row):
    """Per-row adapter delta over the fixed table.

    ``x2 [N, D]`` rows carry ``ids_row [N]`` adapter ids (-1 = none).  The
    compacted dispatch (one-hot + exclusive cumsum = position within the
    group, as in ``moe.layer``) places live rows group-major into ``[cap,
    N, D]``, both low-rank hops run grouped, and each row's delta is
    gathered back.  Returns ``(delta [N, F], live [N] bool)``; callers
    ``where`` on ``live`` for a bitwise base output on dead rows."""
    return _delta(A, B, scale, x2,
                  _plan(ids_row.to(x2.device), int(A.shape[0])))


def apply_lora(layer, x, y):
    """Add the scoped batched-LoRA delta to a parallel-linear output.

    Called from ``ColumnParallelLinear.forward`` /
    ``RowParallelLinear.forward`` when the layer carries a ``lora_A``
    buffer.  Outside any ``runtime.adapter_scope`` this returns ``y``
    untouched."""
    from . import runtime

    sc = runtime.current()
    if sc is None:
        return y
    ids = sc._ids
    b = int(ids.shape[0])
    lead = tuple(x.shape[:-1])
    if not lead or int(lead[0]) != b:
        raise InvalidArgumentError(
            f"apply_lora: input leading dim {lead} does not start with "
            f"the scoped batch {b}")
    A = layer._buffers["lora_A"]
    cap = int(A.shape[0])
    key = (lead, cap, x.device)
    plan = sc.plans.get(key)
    if plan is None:
        ids_row = ids.to(x.device).view(
            (b,) + (1,) * (len(lead) - 1)).expand(lead).reshape(-1)
        plan = sc.plans[key] = _plan(ids_row, cap)
    d, live = _delta(A, layer._buffers["lora_B"],
                     layer._buffers["lora_scale"],
                     x.reshape(-1, x.shape[-1]), plan)
    y2 = y.reshape(-1, y.shape[-1])
    # where, not a masked add: selects the untouched base row at id -1, so
    # a base-tenant row is bitwise the no-LoRA model's
    y2 = torch.where(live[:, None], y2 + d.to(y2.dtype), y2)
    return y2.reshape(y.shape)


# -- host-side table edits ----------------------------------------------------

def adapter_capacity(buffers: Dict[str, object]) -> int:
    """Adapter-table capacity from a flat buffer dict (0 = no LoRA)."""
    for k, v in buffers.items():
        if k.endswith(".lora_A") or k == "lora_A":
            return int(tuple(v.shape)[0])
    return 0


def _checked_sites(tables: Dict[str, object], slot: int, adapter):
    """Validate ``adapter`` against the tables of a flat dict (tensors or
    arrays) for ``slot``, every site before any write: ``[(A key, B key,
    scale key, A [in, r], B [r, out])]``."""
    out = []
    for site, (a_np, b_np) in adapter.sites.items():
        ak, bk, sk = (site + ".lora_A", site + ".lora_B",
                      site + ".lora_scale")
        if ak not in tables or bk not in tables or sk not in tables:
            raise InvalidArgumentError(
                f"adapter {adapter.name!r} addresses unknown site "
                f"{site!r} (no {ak} buffer — was the model built with "
                f"lora_capacity > 0 and matching targets?)")
        cap, din, r_tab = (int(s) for s in tables[ak].shape)
        dout = int(tables[bk].shape[2])
        if not 0 <= slot < cap:
            raise InvalidArgumentError(
                f"adapter slot {slot} out of range [0, {cap})")
        if adapter.rank > r_tab:
            raise InvalidArgumentError(
                f"adapter {adapter.name!r} rank {adapter.rank} exceeds "
                f"table rank {r_tab} at {site}")
        if a_np.shape != (din, adapter.rank) or \
                b_np.shape != (adapter.rank, dout):
            raise InvalidArgumentError(
                f"adapter {adapter.name!r} site {site}: A{a_np.shape} / "
                f"B{b_np.shape} do not match layer [{din} -> {dout}] at "
                f"rank {adapter.rank}")
        out.append((ak, bk, sk, a_np, b_np))
    if not out:
        raise InvalidArgumentError(
            f"adapter {adapter.name!r} has no sites")
    return out


def _put(t, idx, a):
    """``t[idx] = a`` for a tensor or an array, ``a`` cast to ``t``'s
    dtype (round to nearest even, as numpy's ``astype`` rounds)."""
    if isinstance(t, torch.Tensor):
        t[idx] = torch.as_tensor(np.asarray(a)).to(device=t.device,
                                                  dtype=t.dtype)
    else:
        t[idx] = np.asarray(a).astype(t.dtype)


def _write_slot(tables: Dict[str, object], slot: int, adapter) -> None:
    """Write ``adapter`` into table ``slot`` of ``tables`` IN PLACE (every
    site validated first, so a refused adapter touches nothing).  Adapters
    of rank ``r <= table rank`` zero-pad: padded A columns meet padded B
    rows, so the delta is unchanged."""
    slot = int(slot)
    sites = _checked_sites(tables, slot, adapter)
    r = adapter.rank
    for ak, bk, sk, a_np, b_np in sites:
        tables[ak][slot] = 0
        _put(tables[ak], (slot, slice(None), slice(0, r)), a_np)
        tables[bk][slot] = 0
        _put(tables[bk], (slot, slice(0, r)), b_np)
        tables[sk][slot] = adapter.scale


def _clear_slot(tables: Dict[str, object], slot: int) -> None:
    """Zero table ``slot`` of every ``lora_A`` / ``lora_B`` in
    ``tables``, IN PLACE (range checked first)."""
    slot = int(slot)
    keys = [k for k in tables
            if k.endswith(".lora_A") or k.endswith(".lora_B")]
    if not keys:
        raise InvalidArgumentError("clear_slot: tree has no adapter tables")
    for k in keys:
        cap = int(tables[k].shape[0])
        if not 0 <= slot < cap:
            raise InvalidArgumentError(
                f"adapter slot {slot} out of range [0, {cap})")
    for k in keys:
        tables[k][slot] = 0


def _copy(v):
    return v.clone() if isinstance(v, torch.Tensor) else np.array(v,
                                                                  copy=True)


def write_adapter(buffers: Dict[str, object], slot: int, adapter
                  ) -> Dict[str, object]:
    """New flat buffer dict with ``adapter`` written into table ``slot``.

    Pure with respect to the input dict (touched leaves are copies: tensors
    cloned on their device, arrays copied); shapes and dtypes are kept.
    Adapters of rank ``r <= table rank`` zero-pad."""
    out = dict(buffers)
    for site in adapter.sites:
        for k in (site + ".lora_A", site + ".lora_B", site + ".lora_scale"):
            if k in out:
                out[k] = _copy(out[k])
    _write_slot(out, slot, adapter)
    return out


def clear_slot(buffers: Dict[str, object], slot: int) -> Dict[str, object]:
    """New flat buffer dict with table ``slot`` zeroed at every site — id
    ``slot`` then computes a zero delta (base output on live rows)."""
    out = dict(buffers)
    for k in out:
        if k.endswith(".lora_A") or k.endswith(".lora_B"):
            out[k] = _copy(out[k])
    _clear_slot(out, slot)
    return out
