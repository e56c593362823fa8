"""MoE side channel — aux losses and routing counters (port of
``paddle_tpu.moe.stats``).

``MoELayer.forward`` stays signature-compatible with the dense
``ParallelMLP`` (``(x) -> y``), so its auxiliary outputs — the
load-balance loss every MoE block contributes and the per-expert
routed / dropped counters the serving loop publishes — cannot ride the
return value.  They ride this collector instead: whoever owns the call
(``GPTForCausalLM.forward`` for training, the serving engine's decode
step) opens :class:`collect` around the model call and reads the recorded
tensors back after it.  Everything recorded stays a device tensor: nothing
here synchronises with the card.

The stack is thread-local: the serving decode loop runs in its own thread
while a training step runs in the main thread, and neither may see the
other's entries.
"""
from __future__ import annotations

import threading
from typing import List

import torch

__all__ = ["MoEStats", "collect", "record", "active"]

_local = threading.local()


def _stack() -> List["MoEStats"]:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class MoEStats:
    """One call's MoE entries: per-layer ``(aux, routed [E], dropped [E])``
    triples, all tensors on the activations' device."""

    def __init__(self):
        self.entries: List[tuple] = []

    def add(self, aux, routed, dropped):
        self.entries.append((aux, routed, dropped))

    def total_aux(self):
        """Sum of the recorded load-balance losses (a 0-dim tensor), or
        ``None`` when no MoE layer ran."""
        if not self.entries:
            return None
        out = self.entries[0][0]
        for aux, _, _ in self.entries[1:]:
            out = out + aux
        return out

    def counts(self, num_experts: int) -> torch.Tensor:
        """``[2, E]`` int32 — row 0 routed tokens per expert, row 1
        dropped (capacity-overflow) tokens, summed over layers.  Zeros
        (on the CPU) when no MoE layer ran."""
        if not self.entries:
            return torch.zeros(2, num_experts, dtype=torch.int32)
        # one stack and one sum, whatever the layer count
        pairs = torch.stack([t for _, r, d in self.entries for t in (r, d)])
        return pairs.view(-1, 2, num_experts).sum(0, dtype=torch.int32)


class collect:
    """``with collect() as ms:`` — capture MoE records from the model
    calls inside the block (re-entrant; inner collectors shadow)."""

    def __enter__(self) -> MoEStats:
        st = MoEStats()
        _stack().append(st)
        return st

    def __exit__(self, *exc):
        _stack().pop()
        return False


def record(aux, routed, dropped):
    """Called by ``MoELayer.forward``; a no-op when nobody collects."""
    st = _stack()
    if st:
        st[-1].add(aux, routed, dropped)


def active() -> bool:
    """True while some :class:`collect` block of this thread is open."""
    return bool(_stack())
