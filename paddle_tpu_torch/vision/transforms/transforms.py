"""Transform classes — port of ``paddle_tpu.vision.transforms.transforms``.

Each transform is a callable object; ``Compose`` chains them.
``BaseTransform``'s ``keys`` name the fields of a tuple sample
(``'image'`` gets the image op, ``None`` passes through).  The random
transforms draw from Python's ``random`` module in the JAX package's
calls and order, so ``random.seed`` gives both packages the same crops,
flips, angles and jitter.
"""
from __future__ import annotations

import numbers
import random as _pyrandom

import numpy as np

from . import functional as F

__all__ = [
    "Compose", "BaseTransform", "ToTensor", "Resize", "RandomResizedCrop",
    "CenterCrop", "RandomHorizontalFlip", "RandomVerticalFlip", "Normalize",
    "Transpose", "BrightnessTransform", "ContrastTransform",
    "SaturationTransform", "HueTransform", "ColorJitter", "RandomCrop",
    "Pad", "RandomRotation", "Grayscale",
]


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data

    def __repr__(self):
        inner = ", ".join(repr(t) for t in self.transforms)
        return f"Compose([{inner}])"


class BaseTransform:
    """Apply `_apply_image` to the image field(s) of a sample.

    ``keys``: like the reference (transforms.py:134), a tuple naming each
    element of a tuple-sample ('image', 'coords', 'boxes', 'mask', or None
    to pass through).  A bare (non-tuple) input is treated as one image.
    """

    def __init__(self, keys=None):
        self.keys = keys if keys is not None else ("image",)
        self.params = None

    def _get_params(self, inputs):
        return None

    def __call__(self, inputs):
        bare = not isinstance(inputs, (tuple, list))
        sample = (inputs,) if bare else tuple(inputs)
        self.params = self._get_params(sample)
        outputs = []
        for key, data in zip(self.keys, sample):
            if key is None:
                outputs.append(data)
            else:
                apply = getattr(self, f"_apply_{key}", None)
                outputs.append(apply(data) if apply is not None else data)
        outputs.extend(sample[len(self.keys):])
        if bare:
            return outputs[0]
        return tuple(outputs)

    def _apply_image(self, image):
        raise NotImplementedError

    def __repr__(self):
        return type(self).__name__


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        return F.to_tensor(img, self.data_format)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return F.resize(img, self.size, self.interpolation)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4, 4.0 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        if isinstance(size, int):
            size = (size, size)
        self.size = size
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _sample_crop(self, h, w):
        area = h * w
        for _ in range(10):
            target_area = area * _pyrandom.uniform(*self.scale)
            log_ratio = (np.log(self.ratio[0]), np.log(self.ratio[1]))
            aspect = np.exp(_pyrandom.uniform(*log_ratio))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                top = _pyrandom.randint(0, h - ch)
                left = _pyrandom.randint(0, w - cw)
                return top, left, ch, cw
        # fallback: center crop at the clamped aspect
        in_ratio = w / h
        if in_ratio < self.ratio[0]:
            cw, ch = w, int(round(w / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            ch, cw = h, int(round(h * self.ratio[1]))
        else:
            cw, ch = w, h
        return (h - ch) // 2, (w - cw) // 2, ch, cw

    def _apply_image(self, img):
        arr = np.asarray(img) if not hasattr(img, "size") else None
        if arr is not None:
            h, w = arr.shape[:2]
        else:
            w, h = img.size
        top, left, ch, cw = self._sample_crop(h, w)
        out = F.crop(img, top, left, ch, cw)
        return F.resize(out, self.size, self.interpolation)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = size

    def _apply_image(self, img):
        return F.center_crop(img, self.size)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if _pyrandom.random() < self.prob:
            return F.hflip(img)
        return img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if _pyrandom.random() < self.prob:
            return F.vflip(img)
        return img


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        super().__init__(keys)
        if isinstance(mean, numbers.Number):
            mean = [mean, mean, mean]
        if isinstance(std, numbers.Number):
            std = [std, std, std]
        self.mean = mean
        self.std = std
        self.data_format = data_format
        self.to_rgb = to_rgb

    def _apply_image(self, img):
        return F.normalize(img, self.mean, self.std, self.data_format,
                           self.to_rgb)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        return F.transpose(img, self.order)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = _check_jitter(value, "brightness")

    def _apply_image(self, img):
        if self.value is None:
            return img
        return F.adjust_brightness(img, _pyrandom.uniform(*self.value))


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = _check_jitter(value, "contrast")

    def _apply_image(self, img):
        if self.value is None:
            return img
        return F.adjust_contrast(img, _pyrandom.uniform(*self.value))


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = _check_jitter(value, "saturation")

    def _apply_image(self, img):
        if self.value is None:
            return img
        return F.adjust_saturation(img, _pyrandom.uniform(*self.value))


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = _check_jitter(value, "hue", center=0,
                                   bound=(-0.5, 0.5))

    def _apply_image(self, img):
        if self.value is None:
            return img
        return F.adjust_hue(img, _pyrandom.uniform(*self.value))


def _check_jitter(value, name, center=1, bound=(0, float("inf"))):
    if isinstance(value, numbers.Number):
        if value < 0:
            raise ValueError(f"{name} value must be non-negative")
        value = [max(center - value, bound[0]), min(center + value, bound[1])]
    elif len(value) != 2:
        raise ValueError(f"{name} must be a number or a 2-tuple")
    if value[0] == value[1] == center:
        return None
    return tuple(float(v) for v in value)


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        super().__init__(keys)
        self._ops = [
            BrightnessTransform(brightness), ContrastTransform(contrast),
            SaturationTransform(saturation), HueTransform(hue),
        ]

    def _apply_image(self, img):
        ops = list(self._ops)
        _pyrandom.shuffle(ops)
        for op in ops:
            img = op._apply_image(img)
        return img


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        super().__init__(keys)
        if isinstance(size, numbers.Number):
            size = (int(size), int(size))
        self.size = size
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        if self.padding is not None:
            img = F.pad(img, self.padding, self.fill, self.padding_mode)
        arr = F._to_numpy(img)
        h, w = arr.shape[:2]
        th, tw = self.size
        if self.pad_if_needed and w < tw:
            img = F.pad(img, (tw - w, 0), self.fill, self.padding_mode)
        if self.pad_if_needed and h < th:
            img = F.pad(img, (0, th - h), self.fill, self.padding_mode)
        arr = F._to_numpy(img)
        h, w = arr.shape[:2]
        if h == th and w == tw:
            return img
        top = _pyrandom.randint(0, h - th)
        left = _pyrandom.randint(0, w - tw)
        return F.crop(img, top, left, th, tw)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return F.pad(img, self.padding, self.fill, self.padding_mode)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            if degrees < 0:
                raise ValueError("degrees must be non-negative")
            degrees = (-degrees, degrees)
        self.degrees = tuple(float(d) for d in degrees)
        self.interpolation = interpolation
        self.expand = expand
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        angle = _pyrandom.uniform(*self.degrees)
        return F.rotate(img, angle, self.interpolation, self.expand,
                        self.center, self.fill)


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return F.to_grayscale(img, self.num_output_channels)
