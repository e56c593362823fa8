"""fleet.metrics — globally-reduced evaluation metrics (port of
``paddle_tpu.distributed.fleet.metrics``).

Parity: python/paddle/distributed/fleet/metrics/metric.py (sum / max /
min / auc / mae / rmse / mse / acc over an all-reduce of scope tensors).
Each rank evaluates its own data shard and holds host-side numpy
accumulators; the values of every rank of the world are gathered with
``torch.distributed.all_gather_object`` (the JAX module gathers over
processes with ``process_allgather``).  Outside a joined world of more
than one rank the reduction is the identity.

The ``scope`` parameter of the reference (a static-graph Variable lookup)
is accepted and ignored — pass arrays directly.
"""
from __future__ import annotations

import numpy as np
import torch.distributed as dist

__all__ = ["sum", "max", "min", "auc", "mae", "rmse", "mse", "acc"]

_py_max = max  # the paddle API shadows builtins


def _allgather(arr: np.ndarray) -> np.ndarray:
    """``[world, *arr.shape]`` — every rank's value, in rank order."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return arr[None]
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, arr)
    return np.stack(got)


def _to_np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().double().numpy()
    return np.asarray(x, dtype=np.float64)


def sum(input, scope=None, util=None):  # noqa: A001 — paddle API name
    """Global elementwise sum of ``input`` across ranks."""
    return _allgather(_to_np(input)).sum(axis=0)


def max(input, scope=None, util=None):  # noqa: A001
    return _allgather(_to_np(input)).max(axis=0)


def min(input, scope=None, util=None):  # noqa: A001
    return _allgather(_to_np(input)).min(axis=0)


def auc(stat_pos, stat_neg, scope=None, util=None) -> float:
    """AUC from bucketed score histograms (reference: metric.py:140 —
    the bucket-trapezoid estimate of the distributed auc op).
    ``stat_pos[i]`` / ``stat_neg[i]``: counts of positive / negative
    examples whose score fell into bucket ``i``."""
    from ...metric import bucket_auc

    # reference metric.py:214 returns 0.5 when one class is empty
    return bucket_auc(sum(stat_pos), sum(stat_neg), degenerate=0.5)


def mae(abserr, total_ins_num, scope=None, util=None) -> float:
    """Global mean absolute error: sum(abserr) / sum(total_ins_num)."""
    err = float(sum(abserr).sum())
    n = float(sum(_to_np(total_ins_num)).sum())
    return err / _py_max(n, 1.0)


def mse(sqrerr, total_ins_num, scope=None, util=None) -> float:
    err = float(sum(sqrerr).sum())
    n = float(sum(_to_np(total_ins_num)).sum())
    return err / _py_max(n, 1.0)


def rmse(sqrerr, total_ins_num, scope=None, util=None) -> float:
    return float(np.sqrt(mse(sqrerr, total_ins_num)))


def acc(correct, total, scope=None, util=None) -> float:
    c = float(sum(_to_np(correct)).sum())
    t = float(sum(_to_np(total)).sum())
    return c / _py_max(t, 1.0)
