"""Layers of the port: ``nn.Layer`` subclasses (``torch.nn.Module``\\ s
whose call applies the amp policy) with the JAX package's class names,
parameter names and layouts, and every name the JAX ``nn`` exports,
``layer_base``'s ``Parameter``, ``Buffer``, ``functional_call``,
``rng_scope`` and ``current_rng_key`` among them (``nn/layer.py``)."""
import torch

from . import functional, initializer
from .initializer import ParamAttr
from .layer import (Buffer, Layer, Parameter, current_rng_key,
                    functional_call, rng_scope)
from .recompute import (apply_recompute, mark_recompute, recompute,
                        unmark_recompute)
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .activation import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .container import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403
from .decode import *  # noqa: F401,F403
from ..optimizer.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                              ClipGradByValue)
from . import utils
from . import utils as weight_norm_hook
from .utils import remove_weight_norm, weight_norm
from .functional import extension
from . import vision
from ..tensor.math import clip
from . import (activation as _activation, common as _common,
               container as _container, conv as _conv, decode as _decode,
               loss as _loss, norm as _norm, pooling as _pooling,
               rnn as _rnn, transformer as _transformer)


def clip_by_norm(x, max_norm, name=None):
    """L2-norm clip: ``x · max_norm / max(‖x‖, max_norm)``."""
    from ..tensor._common import t

    x = t(x)
    norm = (x * x).sum().sqrt()
    return x * (max_norm / torch.clamp_min(norm, max_norm))

__all__ = sorted(
    {"Layer", "Parameter", "Buffer", "functional_call", "rng_scope",
     "current_rng_key", "ParamAttr", "functional", "initializer", "recompute",
     "mark_recompute", "unmark_recompute", "apply_recompute",
     "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm", "utils",
     "weight_norm_hook", "weight_norm", "remove_weight_norm", "extension",
     "vision", "clip", "clip_by_norm"}
    | {n for m in (_activation, _common, _container, _conv, _decode, _loss,
                   _norm, _pooling, _rnn, _transformer) for n in m.__all__})
