"""Image transforms — port of ``paddle_tpu.vision.transforms``: host-side
numpy / PIL preprocessing that runs in ``DataLoader`` workers."""
from .functional import (  # noqa: F401
    adjust_brightness,
    adjust_contrast,
    adjust_hue,
    adjust_saturation,
    center_crop,
    crop,
    hflip,
    normalize,
    pad,
    resize,
    rotate,
    to_grayscale,
    to_tensor,
    transpose,
    vflip,
)
from .transforms import (  # noqa: F401
    BaseTransform,
    BrightnessTransform,
    CenterCrop,
    ColorJitter,
    Compose,
    ContrastTransform,
    Grayscale,
    HueTransform,
    Normalize,
    Pad,
    RandomCrop,
    RandomHorizontalFlip,
    RandomResizedCrop,
    RandomRotation,
    RandomVerticalFlip,
    Resize,
    SaturationTransform,
    ToTensor,
    Transpose,
)
from . import functional, transforms  # noqa: F401,E402

__all__ = functional.__all__ + transforms.__all__
