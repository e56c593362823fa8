"""DatasetFolder / ImageFolder — port of
``paddle_tpu.vision.datasets.folder``.

A directory per class gives ``(sample, class_index)``; a flat directory of
images gives samples only.  The loaders read through ``vision.image``'s
backend; any callable (``numpy.load`` for ``.npy`` files) may stand in.
"""
from __future__ import annotations

import os

import numpy as np

from ...io import Dataset
from ..image import image_load

__all__ = ["DatasetFolder", "ImageFolder", "pil_loader", "cv2_loader", "default_loader"]

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif",
                  ".tiff", ".webp")


def has_valid_extension(filename, extensions=IMG_EXTENSIONS):
    return filename.lower().endswith(tuple(extensions))


def pil_loader(path):
    """Reference folder.py pil_loader — a PIL RGB image."""
    from PIL import Image

    with open(path, "rb") as f:
        return Image.open(f).convert("RGB")


def cv2_loader(path):
    """Reference folder.py cv2_loader — cv2.imread, i.e. an HWC **BGR**
    ndarray (matching image_load's cv2 backend; pil_loader is RGB)."""
    import cv2

    return cv2.imread(path)


def default_loader(path):
    """Reference folder.py default_loader: backend-dispatched read."""
    img = image_load(path)
    if hasattr(img, "convert"):
        img = img.convert("RGB")
    return np.asarray(img)


_default_loader = default_loader


def make_dataset(directory, class_to_idx, extensions=None, is_valid_file=None):
    instances = []
    if is_valid_file is None:
        def is_valid_file(p):
            return has_valid_extension(p, extensions or IMG_EXTENSIONS)
    for target_class in sorted(class_to_idx):
        class_index = class_to_idx[target_class]
        target_dir = os.path.join(directory, target_class)
        if not os.path.isdir(target_dir):
            continue
        for root, _, fnames in sorted(os.walk(target_dir, followlinks=True)):
            for fname in sorted(fnames):
                path = os.path.join(root, fname)
                if is_valid_file(path):
                    instances.append((path, class_index))
    return instances


class DatasetFolder(Dataset):
    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or _default_loader
        classes, class_to_idx = self._find_classes(root)
        samples = make_dataset(root, class_to_idx, extensions, is_valid_file)
        if not samples:
            raise RuntimeError(f"found no valid files under {root}")
        self.classes = classes
        self.class_to_idx = class_to_idx
        self.samples = samples
        self.targets = [s[1] for s in samples]

    @staticmethod
    def _find_classes(directory):
        classes = sorted(e.name for e in os.scandir(directory) if e.is_dir())
        if not classes:
            raise RuntimeError(f"no class folders found in {directory}")
        return classes, {c: i for i, c in enumerate(classes)}

    def __getitem__(self, index):
        path, target = self.samples[index]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, np.asarray(target, np.int64)

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Flat folder of images — samples only, no labels."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or _default_loader
        if is_valid_file is None:
            def is_valid_file(p):
                return has_valid_extension(p, extensions or IMG_EXTENSIONS)
        samples = []
        for path_root, _, fnames in sorted(os.walk(root, followlinks=True)):
            for fname in sorted(fnames):
                path = os.path.join(path_root, fname)
                if is_valid_file(path):
                    samples.append(path)
        if not samples:
            raise RuntimeError(f"found no valid files under {root}")
        self.samples = samples

    def __getitem__(self, index):
        sample = self.loader(self.samples[index])
        if self.transform is not None:
            sample = self.transform(sample)
        return (sample,)

    def __len__(self):
        return len(self.samples)
