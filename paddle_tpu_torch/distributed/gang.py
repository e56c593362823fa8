"""``mean_trees`` (port of ``paddle_tpu.distributed.gang.mean_trees``).

The rest of the JAX module — the gang supervisor and its transports — is
ROADMAP item 7 (control plane and operations); the package binds those
names to errors that say so (``distributed/__init__.py``).
"""
from __future__ import annotations

import numpy as np

__all__ = ["mean_trees"]


def _map(fn, trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        out = [_map(fn, [t[i] for t in trees]) for i in range(len(first))]
        return type(first)(out) if isinstance(first, tuple) else out
    return fn(*trees)


def mean_trees(trees: list):
    """Rank-ordered mean of trees (dicts, lists, tuples) of numpy arrays —
    the reduction the gang and a one-process baseline share, so the two
    agree bit for bit: a left fold in list order in float32, no pairwise
    reassociation, then one division."""
    def _mean(*leaves):
        acc = np.asarray(leaves[0], dtype=np.float32).copy()
        for leaf in leaves[1:]:
            acc += np.asarray(leaf, dtype=np.float32)
        return acc / np.float32(len(leaves))

    return _map(_mean, list(trees))
