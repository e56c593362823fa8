"""Image backend selection — port of ``paddle_tpu.vision.image``.

Backends: ``'pil'`` (default) and ``'cv2'``.  ``image_load`` returns the
backend's own image object (a PIL image, or cv2's HWC BGR ndarray); the
datasets turn it into numpy before batching.  PIL and cv2 are imported
inside the call, so neither is needed until an image is read.
"""
from __future__ import annotations

__all__ = ["set_image_backend", "get_image_backend", "image_load"]

_image_backend = "pil"


def _check(backend):
    if backend not in ("pil", "cv2"):
        raise ValueError(f"backend must be 'pil' or 'cv2', got {backend!r}")


def set_image_backend(backend: str) -> None:
    _check(backend)
    global _image_backend
    _image_backend = backend


def get_image_backend() -> str:
    return _image_backend


def image_load(path, backend=None):
    backend = backend or _image_backend
    _check(backend)
    if backend == "pil":
        from PIL import Image

        return Image.open(path)
    import cv2

    return cv2.imread(str(path))
