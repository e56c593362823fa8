"""Request traces of the serving workload (port of the host half of
``paddle_tpu.tuning``): :class:`RequestTrace` (``synthetic`` — bench.py's
fixed-seed sweep, draw for draw — ``key``, ``save`` / ``load``),
:class:`TraceRecorder` and :func:`replay`.  The measured search
(``tuning/engine.py``, ``plan_space.py``, ``serving_space.py``) is not
ported yet (ROADMAP queue A, control plane)."""
from .trace import RequestTrace, TraceRecorder, replay

__all__ = ["RequestTrace", "TraceRecorder", "replay"]
