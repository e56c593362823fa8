"""RNG seed management mapped onto ``torch.Generator``.

Parity with ``paddle.seed`` (reference: paddle/fluid/framework/generator.cc,
python/paddle/framework/random.py): one generator per device, all
reseeded by :func:`seed`.  Parameter initialization draws from an explicit
generator — the caller's, or the CPU one — on the CPU, so the same seed
gives the same weights whichever device the model then moves to.  Random
ops on a device's tensors (dropout) draw from :func:`generator_for` that
device; nothing in the port draws from torch's global RNG.  Inside an
:func:`scope` (``nn.rng_scope``) :func:`generator_for` answers with the
scope's generator instead, so the random ops there draw from it and leave
the device streams as they were.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict

import torch

__all__ = ["seed", "default_generator", "generator_for", "generators",
           "scope", "current_scope"]

_seed = 0
_default = torch.Generator().manual_seed(_seed)
_by_device: Dict[torch.device, torch.Generator] = {
    torch.device("cpu"): _default}
_lock = threading.Lock()


class _Scopes(threading.local):
    def __init__(self):
        self.stack = []


_scopes = _Scopes()


class Scope:
    """The generators of one ``rng_scope``: ``key`` is a
    ``torch.Generator`` (used for its own device only) or an int seed (a
    generator a device, made on first use and seeded with it)."""

    def __init__(self, key):
        if isinstance(key, torch.Generator):
            self._gens = {torch.device(key.device): key}
            self._seed = None
        else:
            self._gens = {}
            self._seed = int(key)

    def generator(self, device) -> torch.Generator:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        gen = self._gens.get(dev)
        if gen is None:
            if self._seed is None:
                from .errors import InvalidArgumentError

                raise InvalidArgumentError(
                    f"rng_scope's generator is on {next(iter(self._gens))}"
                    f"; a random op inside the scope draws on {dev} (pass "
                    f"a generator of that device, or an int seed)")
            gen = self._gens[dev] = torch.Generator(device=dev).manual_seed(
                self._seed)
        return gen


@contextlib.contextmanager
def scope(key):
    """Every :func:`generator_for` inside the block answers with a
    generator of ``key`` (see :class:`Scope`); yields the scope."""
    ctx = Scope(key)
    _scopes.stack.append(ctx)
    try:
        yield ctx
    finally:
        _scopes.stack.pop()


def current_scope():
    """The innermost active :class:`Scope`, or None."""
    return _scopes.stack[-1] if _scopes.stack else None


def default_generator() -> torch.Generator:
    """The CPU generator (parameter initialization, CPU dropout)."""
    return _default


def generator_for(device) -> torch.Generator:
    """The generator of ``device`` — a tensor's ``.device`` (created on
    first use, seeded with the last :func:`seed`); a CUDA tensor needs a
    CUDA generator.  Inside :func:`scope`, the scope's generator."""
    if _scopes.stack:
        return _scopes.stack[-1].generator(device)
    dev = torch.device(device)
    with _lock:
        gen = _by_device.get(dev)
        if gen is None:
            gen = _by_device[dev] = torch.Generator(device=dev).manual_seed(
                _seed)
        return gen


def generators():
    """Every generator made so far (the CPU one and one per device used)."""
    with _lock:
        return list(_by_device.values())


def seed(seed_: int) -> torch.Generator:
    """Parity: ``paddle.seed`` — reseeds every device's generator; returns
    the CPU one."""
    global _seed
    with _lock:
        _seed = int(seed_)
        for gen in _by_device.values():
            gen.manual_seed(_seed)
    return _default
