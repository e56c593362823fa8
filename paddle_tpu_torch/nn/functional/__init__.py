"""Functional ops of the port: the names of the JAX package's
``nn.functional`` from its activation, common, conv, pooling, norm, loss,
attention, CRF, extension, detection, detection-target, RoI, extras,
sequence and deformable-conv modules, in the JAX package's import order,
so that detection's ``sigmoid_focal_loss`` shadows loss.py's as there."""
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .attention import *  # noqa: F401,F403
from .crf import *  # noqa: F401,F403
from .extension import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403  (its sigmoid_focal_loss wins)
from .detection_targets import *  # noqa: F401,F403
from .roi_extra import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .deform_conv import *  # noqa: F401,F403
from . import (activation as _activation, attention as _attention,
               common as _common, conv as _conv, crf as _crf,
               deform_conv as _deform_conv, detection as _detection,
               detection_targets as _detection_targets,
               extension as _extension, extras as _extras, loss as _loss,
               norm as _norm, pooling as _pooling, roi_extra as _roi_extra,
               sequence as _sequence)
from ...tensor.creation import assign  # noqa: F401  (re-exported, as paddle)

__all__ = sorted({"assign"} | {
    n for m in (_activation, _attention, _common, _conv, _crf, _deform_conv,
                _detection, _detection_targets, _extension, _extras, _loss,
                _norm, _pooling, _roi_extra, _sequence) for n in m.__all__})
