"""Datasets — port of ``paddle_tpu.io.dataset``: ``Dataset``,
``IterableDataset``, ``TensorDataset``, ``ComposeDataset``,
``ChainDataset``, ``ConcatDataset``, ``Subset`` and ``random_split``.

Samples are host values (numpy arrays, scalars); ``DataLoader`` collates
and stages them onto the device.  ``random_split`` permutes with an
explicit ``torch.Generator`` (default: the CPU generator that
``paddle_tpu_torch.seed`` reseeds), where the JAX package draws a JAX key:
the two packages split differently for the same seed.

``DEFAULT_DATA_ROOT`` is where the vision datasets look for their files
when no path is given: the JAX package's directory, so both packages read
one copy.  Nothing is downloaded.
"""
from __future__ import annotations

import bisect
import os
from typing import Iterable, List, Sequence

import numpy as np
import torch

from ..framework.dtype import to_numpy
from ..framework.errors import InvalidArgumentError
from ..framework.random import default_generator

#: the one on-disk root of every dataset family's files
DEFAULT_DATA_ROOT = os.path.expanduser("~/.cache/paddle_tpu/datasets")

__all__ = [
    "Dataset",
    "IterableDataset",
    "TensorDataset",
    "ComposeDataset",
    "ChainDataset",
    "ConcatDataset",
    "Subset",
    "random_split",
]


class Dataset:
    """Map-style dataset: implement __getitem__ and __len__."""

    def __getitem__(self, idx):
        raise NotImplementedError("'{}' must implement __getitem__".format(type(self).__name__))

    def __len__(self):
        raise NotImplementedError("'{}' must implement __len__".format(type(self).__name__))


class IterableDataset(Dataset):
    """Stream-style dataset: implement __iter__."""

    def __iter__(self):
        raise NotImplementedError("'{}' must implement __iter__".format(type(self).__name__))

    def __getitem__(self, idx):
        raise TypeError("IterableDataset is not indexable")

    def __len__(self):
        # TypeError, not RuntimeError: list()/length_hint probe __len__ and
        # only swallow TypeError for unsized objects
        raise TypeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Wrap equal-first-dim arrays; sample i is a tuple of row i of each."""

    def __init__(self, tensors: Sequence):
        arrays = [to_numpy(t) for t in tensors]
        if not arrays:
            raise InvalidArgumentError("TensorDataset needs at least one tensor")
        n = arrays[0].shape[0]
        for a in arrays:
            if a.shape[0] != n:
                raise InvalidArgumentError("all tensors must share dim 0")
        self.tensors = arrays

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    """Zip datasets of equal length; sample i concatenates their fields."""

    def __init__(self, datasets: Sequence[Dataset]):
        if not datasets:
            raise InvalidArgumentError("ComposeDataset needs datasets")
        self.datasets = list(datasets)
        n = len(self.datasets[0])
        for d in self.datasets:
            if len(d) != n:
                raise InvalidArgumentError("all datasets must share length")

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, (tuple, list)):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)


class ChainDataset(IterableDataset):
    """Concatenate iterable datasets back-to-back (streaming)."""

    def __init__(self, datasets: Sequence[IterableDataset]):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    """Concatenate map-style datasets (paddle 2.x / torch semantics)."""

    def __init__(self, datasets: Iterable[Dataset]):
        self.datasets = list(datasets)
        if not self.datasets:
            raise InvalidArgumentError("ConcatDataset needs datasets")
        self.cumulative_sizes: List[int] = []
        s = 0
        for d in self.datasets:
            s += len(d)
            self.cumulative_sizes.append(s)

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = self.cumulative_sizes[ds_idx - 1] if ds_idx > 0 else 0
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset: Dataset, lengths: Sequence[int],
                 generator: torch.Generator = None):
    """Split into non-overlapping subsets of the given lengths, by one
    permutation drawn from ``generator`` (default: the CPU generator)."""
    if sum(lengths) != len(dataset):
        raise InvalidArgumentError(
            f"sum of lengths {sum(lengths)} != dataset size {len(dataset)}"
        )
    gen = generator if generator is not None else default_generator()
    perm = torch.randperm(len(dataset), generator=gen).tolist()
    out = []
    offset = 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n]))
        offset += n
    return out
