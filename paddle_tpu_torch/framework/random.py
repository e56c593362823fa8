"""RNG seed management mapped onto ``torch.Generator``.

Parity with ``paddle.seed`` (reference: paddle/fluid/framework/generator.cc,
python/paddle/framework/random.py): one process-global generator that
:func:`seed` reseeds.  Parameter initialization draws from an explicit
generator — the caller's, or this default — on the CPU, so the same seed
gives the same weights whichever device the model then moves to.
"""
from __future__ import annotations

import torch

__all__ = ["seed", "default_generator"]

_default = torch.Generator().manual_seed(0)


def default_generator() -> torch.Generator:
    return _default


def seed(seed_: int) -> torch.Generator:
    """Parity: ``paddle.seed`` — reseeds the global generator."""
    return _default.manual_seed(int(seed_))
