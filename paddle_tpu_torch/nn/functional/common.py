"""``embedding`` — port of ``paddle_tpu.nn.functional.common.embedding``.

The lookup is ``jnp.take``'s: ids in ``[-n, 0)`` wrap to ``id + n``, any
other id outside ``[0, n)`` gives a NaN row — on the card through a
clamped gather and a mask, never an out-of-range index (a device
assert).  ``padding_idx`` positions give zeros, and no gradient reaches
the table through them.
"""
from __future__ import annotations

import torch

from ...framework.selected_rows import _ids, take_rows

__all__ = ["embedding"]


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Parity: paddle.nn.functional.embedding.  ``sparse`` is accepted and
    ignored here, as in the JAX package: SelectedRows gradients come from
    ``nn.Embedding(sparse=True)`` inside a sparse-aware train step."""
    ids = _ids(x, weight.device)
    out = take_rows(weight, ids, float("nan"))
    if padding_idx is not None:
        out = out.masked_fill((ids == padding_idx).unsqueeze(-1), 0.0)
    return out
