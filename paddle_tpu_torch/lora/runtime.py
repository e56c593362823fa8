"""Scoped per-slot adapter ids for the batched multi-LoRA path (port of
``paddle_tpu.lora.runtime``).

The serving engine decides *per step* which adapter each batch slot uses;
the model's linear layers are many call frames below and their signatures
should not grow a LoRA argument apiece.  Same shape as ``moe.stats``: a
thread-local scope, pushed by the caller that owns the step, read by
whoever runs inside it.

``adapter_scope(ids)`` installs a ``[B]`` int32 tensor (slot id ``-1`` =
no adapter); ``active_ids()`` returns the innermost one or ``None``.  A
tensor passed in keeps its device (``GPTModel`` uploads the engine's host
ids to the model's device once a call); anything else becomes a CPU
tensor.  Scopes are per thread, so a serving loop and a training step on
another thread never see each other's ids.  Nesting is allowed, the
innermost scope wins.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..framework.errors import InvalidArgumentError

__all__ = ["adapter_scope", "active_ids", "active"]

_local = threading.local()


def _stack():
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class adapter_scope:
    """Context manager binding a per-slot adapter-id vector ``[B]``.

    Nesting is allowed (innermost wins), so a caller can disable LoRA for
    a while by pushing an all ``-1`` vector."""

    def __init__(self, ids):
        if isinstance(ids, torch.Tensor):
            t = ids.to(torch.int32)
        else:
            t = torch.from_numpy(np.array(ids, np.int32))
        if t.dim() != 1:
            raise InvalidArgumentError(
                f"adapter_scope expects a [B] id vector, got shape "
                f"{tuple(t.shape)}")
        self._ids = t
        #: the dispatch plans ``lora_delta`` derived from these ids, by
        #: (rows, capacity): every adapted linear of a call shares one
        self.plans = {}

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        _stack().pop()
        return False


def current():
    """The innermost :class:`adapter_scope`, or ``None``."""
    st = _stack()
    return st[-1] if st else None


def active_ids():
    """The innermost scoped id vector, or ``None`` outside any scope."""
    sc = current()
    return None if sc is None else sc._ids


def active() -> bool:
    return bool(_stack())
