"""Vision datasets — port of ``paddle_tpu.vision.datasets``: MNIST /
FashionMNIST (IDX gzip), Cifar10 / Cifar100 (python-pickle tar archives),
Flowers (the Oxford 102-flowers archive and its ``.mat`` files), VOC2012
(the VOCtrainval tar) and ``DatasetFolder`` / ``ImageFolder`` over a
directory.  Every dataset reads local files only (default root
``io.dataset.DEFAULT_DATA_ROOT``); a missing file raises
``FileNotFoundError``, nothing is downloaded.  Samples are numpy arrays,
so datasets pickle into ``DataLoader`` workers."""
from .cifar import Cifar10, Cifar100  # noqa: F401
from .folder import (  # noqa: F401
    DatasetFolder,
    ImageFolder,
    cv2_loader,
    default_loader,
    pil_loader,
)
from .flowers import Flowers  # noqa: F401
from .voc2012 import VOC2012  # noqa: F401
from .mnist import MNIST, FashionMNIST  # noqa: F401

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "DatasetFolder",
           "ImageFolder", "Flowers", "VOC2012", "pil_loader", "cv2_loader",
           "default_loader"]
