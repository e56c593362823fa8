"""MNIST / FashionMNIST — port of ``paddle_tpu.vision.datasets.mnist``.

Reads the IDX gzip files from local paths; nothing is downloaded, so a
missing file raises ``FileNotFoundError`` naming it.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ...io import Dataset

__all__ = ["MNIST", "FashionMNIST"]

from ...io.dataset import DEFAULT_DATA_ROOT as _DEFAULT_ROOT


def _read_idx_images(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: bad IDX image magic {magic}")
        data = np.frombuffer(f.read(n * rows * cols), np.uint8)
    return data.reshape(n, rows, cols)


def _read_idx_labels(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"{path}: bad IDX label magic {magic}")
        return np.frombuffer(f.read(n), np.uint8)


class MNIST(Dataset):
    """Each sample is ``(image, label)`` — image float32 [1, 28, 28] scaled
    to [-1, 1] when ``backend='cv2'``-style raw, or whatever ``transform``
    returns; label int64 scalar (paddle parity)."""

    NAME = "mnist"
    _FILES = {
        "train": ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"),
        "test": ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz"),
    }

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        if mode not in ("train", "test"):
            raise ValueError(f"mode must be 'train' or 'test', got {mode!r}")
        self.mode = mode
        self.transform = transform
        self.backend = backend or "numpy"
        root = os.path.join(_DEFAULT_ROOT, self.NAME)
        img_file, lbl_file = self._FILES[mode]
        image_path = image_path or os.path.join(root, img_file)
        label_path = label_path or os.path.join(root, lbl_file)
        for p in (image_path, label_path):
            if not os.path.exists(p):
                raise FileNotFoundError(
                    f"{self.NAME} file {p} not found and this environment "
                    f"has no network egress: place the standard IDX .gz "
                    f"files there (or pass image_path/label_path)")
        self.images = _read_idx_images(image_path)
        self.labels = _read_idx_labels(label_path)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32)[None, :, :]  # [1,28,28]
        label = np.asarray(self.labels[idx], np.int64)
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    """Same IDX format, different files (parity:
    python/paddle/vision/datasets/__init__.py FashionMNIST)."""

    NAME = "fashion-mnist"
