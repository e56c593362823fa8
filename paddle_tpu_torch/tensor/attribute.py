"""Tensor attributes and ``einsum`` — port of
``paddle_tpu.tensor.attribute``."""
from __future__ import annotations

import torch

from ._common import t

__all__ = ["shape", "rank", "is_complex", "is_floating_point", "is_integer",
           "einsum"]


def shape(x, name=None):
    x = t(x)
    return torch.tensor(list(x.shape), dtype=torch.int32, device=x.device)


def rank(x, name=None):
    x = t(x)
    return torch.tensor(x.dim(), device=x.device)


def is_complex(x):
    return t(x).is_complex()


def is_floating_point(x):
    return t(x).is_floating_point()


def is_integer(x):
    x = t(x)
    return not (x.is_floating_point() or x.is_complex()
                or x.dtype == torch.bool)


def einsum(equation, *operands):
    ops = [t(o) for o in operands]
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(equation, *[o.to(dt) for o in ops])
