"""VOC2012 segmentation — port of ``paddle_tpu.vision.datasets.voc2012``.

Reads the ``VOCtrainval_11-May-2012.tar`` layout from a local archive:
the image-set lists under ImageSets/Segmentation, jpgs under JPEGImages,
png label masks under SegmentationClass, decoded with PIL.  Nothing is
downloaded.
"""
from __future__ import annotations

import io
import os
import tarfile

import numpy as np

from ...io import Dataset

__all__ = ["VOC2012"]

from ...io.dataset import DEFAULT_DATA_ROOT as _DEFAULT_ROOT

_SET_FILE = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
_DATA_FILE = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
_LABEL_FILE = "VOCdevkit/VOC2012/SegmentationClass/{}.png"
# reference voc2012.py:38 — yes, 'test' maps to the 'train' list there too
_MODE_FLAG = {"train": "trainval", "test": "train", "valid": "val"}


class VOC2012(Dataset):
    """Samples are ``(image, label_mask)`` numpy arrays (HWC uint8 /
    HW uint8)."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        if mode not in _MODE_FLAG:
            raise ValueError(f"mode must be one of {sorted(_MODE_FLAG)}")
        if backend not in (None, "pil", "cv2"):
            raise ValueError(
                f"backend must be 'pil' or 'cv2', got {backend!r}")
        self.mode = mode
        self.transform = transform
        self.backend = backend or "cv2"
        data_file = data_file or os.path.join(
            _DEFAULT_ROOT, "VOCtrainval_11-May-2012.tar")
        if not os.path.exists(data_file):
            raise FileNotFoundError(
                f"{data_file} not found and this environment has no network "
                f"egress: place the VOCtrainval archive there (or pass "
                f"data_file)")
        self.data_file = data_file
        self._tar = None  # opened lazily, per process (tar handles don't
        #                   pickle — DataLoader workers re-open their own)
        listing = self._archive().extractfile(
            _SET_FILE.format(_MODE_FLAG[mode])).read()
        self.names = [l.strip() for l in listing.decode().splitlines()
                      if l.strip()]

    def _archive(self):
        if self._tar is None:
            self._tar = tarfile.open(self.data_file, "r:*")
        return self._tar

    def __getstate__(self):
        return {**self.__dict__, "_tar": None}

    def _read(self, path):
        from PIL import Image

        blob = self._archive().extractfile(path).read()
        img = Image.open(io.BytesIO(blob))
        return np.asarray(img) if self.backend == "cv2" else img

    def __getitem__(self, idx):
        name = self.names[idx]
        img = self._read(_DATA_FILE.format(name))
        label = self._read(_LABEL_FILE.format(name))
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.names)
