"""paddle_tpu_torch.tensor — the tensor function library (port of
``paddle_tpu.tensor``): the paddle-parity free functions over torch
tensors, with the JAX package's semantics (names, defaults, argument
conventions).  Tensors are created on the default device (the card
unless ``set_device("cpu")``); every function keeps its inputs' device.
Re-exported at the package's top level, as the JAX package does."""
from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .attribute import *  # noqa: F401,F403
from .to_string import *  # noqa: F401,F403

from . import (attribute, creation, linalg, logic, manipulation,  # noqa: F401
               math, random, search, stat)

# stat's mean is math's; its other names
from .stat import histogramdd, nanquantile, quantile, std, var  # noqa: F401
