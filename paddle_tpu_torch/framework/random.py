"""RNG seed management mapped onto ``torch.Generator``.

Parity with ``paddle.seed`` (reference: paddle/fluid/framework/generator.cc,
python/paddle/framework/random.py): one generator per device, all
reseeded by :func:`seed`.  Parameter initialization draws from an explicit
generator — the caller's, or the CPU one — on the CPU, so the same seed
gives the same weights whichever device the model then moves to.  Random
ops on a device's tensors (dropout) draw from :func:`generator_for` that
device; nothing in the port draws from torch's global RNG.
"""
from __future__ import annotations

import threading
from typing import Dict

import torch

__all__ = ["seed", "default_generator", "generator_for", "generators"]

_seed = 0
_default = torch.Generator().manual_seed(_seed)
_by_device: Dict[torch.device, torch.Generator] = {
    torch.device("cpu"): _default}
_lock = threading.Lock()


def default_generator() -> torch.Generator:
    """The CPU generator (parameter initialization, CPU dropout)."""
    return _default


def generator_for(device) -> torch.Generator:
    """The generator of ``device`` — a tensor's ``.device`` (created on
    first use, seeded with the last :func:`seed`); a CUDA tensor needs a
    CUDA generator."""
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
