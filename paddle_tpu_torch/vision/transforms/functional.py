"""Functional image transforms — port of
``paddle_tpu.vision.transforms.functional``.

Host-side preprocessing on HWC numpy arrays or PIL images, run in
``DataLoader`` workers: each function takes and returns the caller's type
(PIL in, PIL out) with the JAX package's arithmetic.  ``resize``,
``rotate`` and ``adjust_hue`` go through PIL, as in JAX (PIL's resampling
is the reference); the rest is numpy.  A PIL image is recognised only
once ``PIL.Image`` has been imported, so an ndarray pipeline never
imports or probes for PIL.
"""
from __future__ import annotations

import numbers
import sys

import numpy as np

__all__ = [
    "to_tensor", "resize", "pad", "crop", "center_crop", "hflip", "vflip",
    "normalize", "transpose", "adjust_brightness", "adjust_contrast",
    "adjust_saturation", "adjust_hue", "rotate", "to_grayscale",
]


def _is_pil(img):
    image = sys.modules.get("PIL.Image")  # a PIL image implies the import
    return image is not None and isinstance(img, image.Image)


def _to_numpy(img):
    """PIL.Image | ndarray → HWC uint8/float ndarray."""
    if _is_pil(img):
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def to_tensor(pic, data_format="CHW"):
    """Image → float32 array in [0, 1] (CHW by default, matching the
    reference's ToTensor semantics)."""
    arr = _to_numpy(pic)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    else:
        arr = arr.astype(np.float32)
    if data_format == "CHW":
        arr = arr.transpose(2, 0, 1)
    elif data_format != "HWC":
        raise ValueError(f"data_format must be CHW or HWC, got {data_format}")
    return arr


def _pil_interp(interpolation):
    from PIL import Image

    return {
        "nearest": Image.NEAREST,
        "bilinear": Image.BILINEAR,
        "bicubic": Image.BICUBIC,
        "lanczos": Image.LANCZOS,
        "box": Image.BOX,
        "hamming": Image.HAMMING,
    }[interpolation]


def resize(img, size, interpolation="bilinear"):
    """size: int (short side) or (h, w)."""
    from PIL import Image

    pil = img if _is_pil(img) else Image.fromarray(np.squeeze(_to_numpy(img)))
    w, h = pil.size
    if isinstance(size, int):
        if (w <= h and w == size) or (h <= w and h == size):
            out = pil
        elif w < h:
            out = pil.resize((size, int(size * h / w)), _pil_interp(interpolation))
        else:
            out = pil.resize((int(size * w / h), size), _pil_interp(interpolation))
    else:
        out = pil.resize((size[1], size[0]), _pil_interp(interpolation))
    return out if _is_pil(img) else _to_numpy(out)


def pad(img, padding, fill=0, padding_mode="constant"):
    """padding: int | (pad_lr, pad_tb) | (left, top, right, bottom)."""
    arr = _to_numpy(img)
    if isinstance(padding, numbers.Number):
        left = top = right = bottom = int(padding)
    elif len(padding) == 2:
        left = right = int(padding[0])
        top = bottom = int(padding[1])
    else:
        left, top, right, bottom = (int(p) for p in padding)
    mode = {"constant": "constant", "edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    kw = {"constant_values": fill} if mode == "constant" else {}
    out = np.pad(arr, ((top, bottom), (left, right), (0, 0)), mode=mode, **kw)
    return _back(img, out)


def _back(orig, arr):
    """Return in the caller's type (PIL in → PIL out)."""
    if _is_pil(orig):
        from PIL import Image

        return Image.fromarray(np.squeeze(arr))
    return arr


def crop(img, top, left, height, width):
    arr = _to_numpy(img)
    return _back(img, arr[top:top + height, left:left + width])


def center_crop(img, output_size):
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    arr = _to_numpy(img)
    h, w = arr.shape[:2]
    th, tw = output_size
    top = int(round((h - th) / 2.0))
    left = int(round((w - tw) / 2.0))
    return crop(img, top, left, th, tw)


def hflip(img):
    return _back(img, _to_numpy(img)[:, ::-1])


def vflip(img):
    return _back(img, _to_numpy(img)[::-1])


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    arr = np.asarray(img, np.float32)
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if data_format == "CHW":
        shape = (-1, 1, 1)
    else:
        shape = (1, 1, -1)
    if to_rgb:
        ch_axis = 0 if data_format == "CHW" else -1
        arr = np.flip(arr, axis=ch_axis)
    return (arr - mean.reshape(shape)) / std.reshape(shape)


def transpose(img, order=(2, 0, 1)):
    return _to_numpy(img).transpose(order)


def adjust_brightness(img, brightness_factor):
    arr = _to_numpy(img).astype(np.float32)
    out = np.clip(arr * brightness_factor, 0, 255)
    return _back(img, out.astype(np.uint8) if _to_numpy(img).dtype == np.uint8 else out)


def adjust_contrast(img, contrast_factor):
    arr = _to_numpy(img).astype(np.float32)
    gray_mean = _rgb_to_gray(arr).mean()
    out = np.clip(gray_mean + contrast_factor * (arr - gray_mean), 0, 255)
    return _back(img, out.astype(np.uint8) if _to_numpy(img).dtype == np.uint8 else out)


def _rgb_to_gray(arr):
    if arr.shape[-1] == 1:
        return arr[..., 0]
    return 0.299 * arr[..., 0] + 0.587 * arr[..., 1] + 0.114 * arr[..., 2]


def adjust_saturation(img, saturation_factor):
    arr = _to_numpy(img).astype(np.float32)
    gray = _rgb_to_gray(arr)[..., None]
    out = np.clip(gray + saturation_factor * (arr - gray), 0, 255)
    return _back(img, out.astype(np.uint8) if _to_numpy(img).dtype == np.uint8 else out)


def adjust_hue(img, hue_factor):
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    from PIL import Image

    pil = img if _is_pil(img) else Image.fromarray(np.squeeze(_to_numpy(img)))
    if pil.mode in ("L", "1", "I", "F"):
        out = pil
    else:
        h, s, v = pil.convert("HSV").split()
        h_arr = np.asarray(h, np.uint8)
        h_arr = (h_arr.astype(np.int16) + int(hue_factor * 255)).astype(np.uint8)
        out = Image.merge("HSV", (Image.fromarray(h_arr, "L"), s, v)).convert(pil.mode)
    return out if _is_pil(img) else _to_numpy(out)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    from PIL import Image

    pil = img if _is_pil(img) else Image.fromarray(np.squeeze(_to_numpy(img)))
    interp = {"nearest": Image.NEAREST, "bilinear": Image.BILINEAR,
              "bicubic": Image.BICUBIC}[interpolation]
    out = pil.rotate(angle, interp, expand, center, fillcolor=fill)
    return out if _is_pil(img) else _to_numpy(out)


def to_grayscale(img, num_output_channels=1):
    arr = _to_numpy(img).astype(np.float32)
    gray = _rgb_to_gray(arr)[..., None]
    if num_output_channels == 3:
        gray = np.repeat(gray, 3, axis=-1)
    elif num_output_channels != 1:
        raise ValueError("num_output_channels must be 1 or 3")
    out = gray.astype(np.uint8) if _to_numpy(img).dtype == np.uint8 else gray
    return _back(img, out)
