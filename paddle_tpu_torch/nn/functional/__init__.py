"""Functional ops of the port: the names of the JAX package's
``nn.functional`` from its activation, common, conv, pooling, norm, loss,
attention and extension modules and
detection's ``sigmoid_focal_loss``, which shadows loss.py's as in the JAX
package (the rest of detection and the sequence, CRF, extras, ROI and
deformable-conv modules are still to port, ROADMAP queue A)."""
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .attention import *  # noqa: F401,F403
from .extension import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403  (its sigmoid_focal_loss wins)
from . import (activation as _activation, attention as _attention,
               common as _common, conv as _conv, detection as _detection,
               extension as _extension, loss as _loss, norm as _norm,
               pooling as _pooling)
from ...tensor.creation import assign  # noqa: F401  (re-exported, as paddle)

__all__ = sorted({"assign"} | {
    n for m in (_activation, _attention, _common, _conv, _detection,
                _extension, _loss, _norm, _pooling) for n in m.__all__})
