"""Recompute (activation checkpointing) — port of
``paddle_tpu.nn.recompute``: ``recompute``, ``mark_recompute``,
``unmark_recompute`` and ``apply_recompute`` over
``torch.utils.checkpoint`` (non-reentrant): a recomputed block keeps only
its inputs from the forward and runs its forward again in the backward.

The JAX policy names map to torch's selective checkpointing, which saves
the outputs of the ops a policy names instead of recomputing them:
``None`` / ``"none"`` save nothing inside the block; ``"dots"`` (JAX's
``dots_with_no_batch_dims_saveable``) the 2-D products (``aten.mm``,
``aten.addmm``); ``"dots_saveable"`` those and the batched ones
(``aten.bmm``, ``aten.baddbmm``); ``"everything_saveable"`` every op's
but the in-place ones and allocations (a dropout mask is redrawn).
A callable is a torch selective-checkpoint policy ``(ctx, op, *args,
**kwargs) -> CheckpointPolicy``.  A policy changes what is saved, never a
value.

What the recomputation must see as the forward did:

* the random draws: torch's ``preserve_rng_state`` restores only torch's
  default generators, and the port draws from its own
  (``framework.random``).  A block's forward saves the state of every
  generator of ``framework.random`` (the CPU one and one per device; the
  devices of its tensor arguments first made); the recomputation sets
  them to it, runs, and sets them back to where they were, so it draws the
  forward's very masks and the generators advance once, as without
  recompute.  A CUDA generator's state is its seed and Philox offset, read
  and set on the host; inside a CUDA graph capture (``hapi``'s k-step
  runner) the same calls move the capture's offsets, so a replay redraws
  the forward's masks too;
* the amp policy: the backward runs outside ``auto_cast``, so the
  recomputation restores the policy the forward ran under, and the
  wrapped layer's own cast of its parameters.
"""
from __future__ import annotations

import contextlib
import functools
from collections import Counter
from typing import Iterable, Optional

import torch
import torch.utils.checkpoint as _ckpt

from ..amp.auto_cast import amp_state, cast_layer_call
from ..framework.errors import InvalidArgumentError
from ..framework.random import generator_for, generators
from .container import LayerList, Sequential
from .layer import Layer

__all__ = ["recompute", "mark_recompute", "unmark_recompute",
           "apply_recompute"]

_SAVED_OPS = {
    "dots": ("mm", "addmm"),
    "dots_saveable": ("mm", "addmm", "bmm", "baddbmm"),
}
_POLICY_NAMES = (None, "none", "dots", "dots_saveable", "everything_saveable")


def _policy(policy):
    """``policy`` as a torch selective-checkpoint policy function, or None
    (save nothing)."""
    if callable(policy):
        return policy
    if policy not in _POLICY_NAMES:
        raise InvalidArgumentError(
            f"recompute policy must be one of {_POLICY_NAMES} or a callable, "
            f"got {policy!r}")
    if policy in (None, "none"):
        return None
    CP = _ckpt.CheckpointPolicy
    if policy == "everything_saveable":
        return lambda ctx, op, *a, **k: (CP.PREFER_RECOMPUTE if _fills(op)
                                         else CP.MUST_SAVE)
    saved = {getattr(torch.ops.aten, name).default
             for name in _SAVED_OPS[policy]}
    return lambda ctx, op, *a, **k: (CP.MUST_SAVE if op in saved
                                     else CP.PREFER_RECOMPUTE)


def _fills(op):
    """An op whose output is filled afterwards: an in-place op (a dropout
    mask's ``bernoulli_``) or an allocation (``empty_like``).  Selective
    checkpointing may not cache a tensor that is then mutated, so these
    are recomputed, from the forward's generator states."""
    name = op._schema.name
    return name.endswith("_") or name.startswith("aten::empty")


@contextlib.contextmanager
def _amp_as(saved):
    st = amp_state()
    prev = (st.enabled, st.dtype, st.level, st.white, st.black)
    (st.enabled, st.dtype, st.level, st.white, st.black) = saved
    try:
        yield
    finally:
        (st.enabled, st.dtype, st.level, st.white, st.black) = prev


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


@contextlib.contextmanager
def _generators_at(gens, states):
    """``gens`` set to ``states`` for the block, then back to where they
    were."""
    now = [g.get_state() for g in gens]
    for g, st in zip(gens, states):
        g.set_state(st)
    try:
        yield
    finally:
        for g, st in zip(gens, now):
            g.set_state(st)


def _checkpointed(fn, args, kwargs, policy, layer=None):
    """``fn(*args, **kwargs)`` under non-reentrant checkpointing, its
    recomputation from the forward's generator states and amp policy
    (module docstring)."""
    for t in _tensors((args, kwargs)):
        generator_for(t.device)
    gens = generators()
    states = [g.get_state() for g in gens]
    st = amp_state()
    amp = (st.enabled, st.dtype, st.level, st.white, st.black)
    ran = []

    def run(*a, **kw):
        if not ran:
            ran.append(True)
            return fn(*a, **kw)
        with contextlib.ExitStack() as stack:  # the recomputation
            stack.enter_context(_generators_at(gens, states))
            stack.enter_context(_amp_as(amp))
            if layer is not None:
                stack.enter_context(cast_layer_call(layer, (), {}))
            return fn(*a, **kw)

    pol = _policy(policy)
    extra = ({} if pol is None else {"context_fn": functools.partial(
        _ckpt.create_selective_checkpoint_contexts, pol)})
    return _ckpt.checkpoint(run, *args, use_reentrant=False,
                            preserve_rng_state=False, **extra, **kwargs)


def recompute(function, *args, policy=None, **kwargs):
    """``function(*args, **kwargs)``, its activations recomputed in the
    backward (paddle's ``fleet.utils.recompute``)."""
    return _checkpointed(function, args, kwargs, policy)


def mark_recompute(layer: Layer, policy=None) -> Layer:
    """Recompute ``layer``'s forward in the backward (idempotent)."""
    if getattr(layer, "_recompute_wrapped", False):
        return layer
    orig = layer.forward

    def forward_with_recompute(*args, **kwargs):
        return _checkpointed(orig, args, kwargs, policy, layer)

    layer.forward = forward_with_recompute
    layer._recompute_wrapped = True
    layer._recompute_orig_forward = orig
    return layer


def unmark_recompute(layer: Layer) -> Layer:
    if getattr(layer, "_recompute_wrapped", False):
        del layer.forward  # the class's forward again
        del layer._recompute_orig_forward
        layer._recompute_wrapped = False
    return layer


def _repeated_blocks(network: Layer):
    """The children of any ``LayerList`` / ``Sequential`` whose class
    repeats there (transformer blocks, ResNet stages, ...)."""
    blocks = []
    for sub in network.modules():
        if isinstance(sub, (LayerList, Sequential)):
            children = list(sub)
            counts = Counter(type(c) for c in children)
            blocks += [c for c in children
                       if isinstance(c, Layer) and counts[type(c)] >= 2]
    return blocks


def apply_recompute(network: Layer,
                    layer_classes: Optional[Iterable[str]] = None,
                    policy=None) -> int:
    """Mark the sublayers (``network`` included) whose class name is in
    ``layer_classes`` — by default the repeated blocks — for recompute;
    returns how many were marked."""
    if layer_classes:
        wanted = set(layer_classes)
        targets = [m for m in network.modules()
                   if type(m).__name__ in wanted]
    else:
        targets = _repeated_blocks(network)
    for layer in targets:
        mark_recompute(layer, policy=policy)
    return len(targets)
