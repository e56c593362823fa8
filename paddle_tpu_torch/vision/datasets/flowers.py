"""Flowers-102 — port of ``paddle_tpu.vision.datasets.flowers``.

Reads the Oxford 102-flowers artifacts from local files:
``102flowers.tgz`` (the jpg archive), ``imagelabels.mat`` and
``setid.mat`` (``scipy.io``); images are decoded with PIL.  Nothing is
downloaded.
"""
from __future__ import annotations

import io
import os
import tarfile

import numpy as np

from ...io import Dataset

__all__ = ["Flowers"]

from ...io.dataset import DEFAULT_DATA_ROOT as _DEFAULT_ROOT

# reference flowers.py:38 MODE_FLAG_MAP: the setid.mat split keys
_MODE_FLAG = {"train": "trnid", "valid": "valid", "test": "tstid"}


class Flowers(Dataset):
    """Samples are ``(image, label)``; label int64 in [0, 102) (the .mat
    labels are 1-based — shifted down, unlike the reference which keeps
    them raw)."""

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend=None):
        import scipy.io as scio

        if mode not in _MODE_FLAG:
            raise ValueError(f"mode must be one of {sorted(_MODE_FLAG)}")
        if backend not in (None, "pil", "cv2"):
            raise ValueError(
                f"backend must be 'pil' or 'cv2', got {backend!r}")
        self.mode = mode
        self.transform = transform
        self.backend = backend or "cv2"
        data_file = data_file or os.path.join(_DEFAULT_ROOT,
                                              "102flowers.tgz")
        label_file = label_file or os.path.join(_DEFAULT_ROOT,
                                                "imagelabels.mat")
        setid_file = setid_file or os.path.join(_DEFAULT_ROOT, "setid.mat")
        for p in (data_file, label_file, setid_file):
            if not os.path.exists(p):
                raise FileNotFoundError(
                    f"{p} not found and this environment has no network "
                    f"egress: place the Oxford 102-flowers artifacts there "
                    f"(or pass data_file/label_file/setid_file)")
        self.data_file = data_file
        self._tar = None  # opened lazily, per process (tar handles don't
        #                   pickle — DataLoader workers re-open their own)
        self.labels = scio.loadmat(label_file)["labels"][0]
        self.indexes = scio.loadmat(setid_file)[_MODE_FLAG[mode]][0]

    def _archive(self):
        if self._tar is None:
            self._tar = tarfile.open(self.data_file, "r:*")
        return self._tar

    def __getstate__(self):
        return {**self.__dict__, "_tar": None}

    def __getitem__(self, idx):
        from PIL import Image

        index = int(self.indexes[idx])
        label = np.int64(self.labels[index - 1] - 1)
        blob = self._archive().extractfile(
            "jpg/image_%05d.jpg" % index).read()
        img = Image.open(io.BytesIO(blob))
        if self.backend == "cv2":
            img = np.asarray(img)
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.indexes)
