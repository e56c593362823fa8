"""Cifar10 / Cifar100 — port of ``paddle_tpu.vision.datasets.cifar``.

Reads the python-version ``tar.gz`` archives (pickled batches) from a
local file; nothing is downloaded.
"""
from __future__ import annotations

import os
import pickle
import tarfile

import numpy as np

from ...io import Dataset

__all__ = ["Cifar10", "Cifar100"]

from ...io.dataset import DEFAULT_DATA_ROOT as _DEFAULT_ROOT


class Cifar10(Dataset):
    """Samples are ``(image, label)`` — image float32 [3, 32, 32], label
    int64."""

    NAME = "cifar-10-python.tar.gz"
    _MEMBER_PREFIX = "cifar-10-batches-py"
    _LABEL_KEY = b"labels"

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        if mode not in ("train", "test"):
            raise ValueError(f"mode must be 'train' or 'test', got {mode!r}")
        self.mode = mode
        self.transform = transform
        data_file = data_file or os.path.join(_DEFAULT_ROOT, self.NAME)
        if not os.path.exists(data_file):
            raise FileNotFoundError(
                f"{data_file} not found and this environment has no network "
                f"egress: place the standard python-version archive there "
                f"(or pass data_file)")
        images, labels = [], []
        with tarfile.open(data_file, "r:*") as tar:
            for member in sorted(tar.getmembers(), key=lambda m: m.name):
                name = os.path.basename(member.name)
                keep = (name.startswith("data_batch") or name == "train"
                        if mode == "train"
                        else name.startswith("test_batch") or name == "test")
                if not keep:
                    continue
                batch = pickle.load(tar.extractfile(member), encoding="bytes")
                images.append(np.asarray(batch[b"data"], np.uint8))
                labels.extend(batch[self._LABEL_KEY])
        self.images = np.concatenate(images).reshape(-1, 3, 32, 32)
        self.labels = np.asarray(labels, np.int64)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32)
        label = np.asarray(self.labels[idx], np.int64)
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    NAME = "cifar-100-python.tar.gz"
    _MEMBER_PREFIX = "cifar-100-python"
    _LABEL_KEY = b"fine_labels"
