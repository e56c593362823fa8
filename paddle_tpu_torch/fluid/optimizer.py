"""paddle.fluid.optimizer — the 1.x optimizer names and argument spellings
(``SGDOptimizer(learning_rate, parameter_list=, regularization=)`` …)
over the port's optimizers (port of ``paddle_tpu.fluid.optimizer``).  The
Program-rewriting wrappers (Pipeline, Recompute, GradientMerge, DGC, …)
raise, naming the strategy toggle that replaces them, as in the JAX
package."""
from __future__ import annotations

import inspect

from .. import optimizer as _opt
from ..framework.errors import UnimplementedError

__all__ = [
    "SGD", "SGDOptimizer", "Momentum", "MomentumOptimizer", "Adam",
    "AdamOptimizer", "Adamax", "AdamaxOptimizer", "Adagrad",
    "AdagradOptimizer", "Adadelta", "AdadeltaOptimizer", "RMSProp",
    "RMSPropOptimizer", "Ftrl", "FtrlOptimizer", "Lamb", "LambOptimizer",
    "LarsMomentum", "LarsMomentumOptimizer", "ExponentialMovingAverage",
    "ModelAverage", "LookaheadOptimizer", "PipelineOptimizer",
    "RecomputeOptimizer", "GradientMergeOptimizer", "DGCMomentumOptimizer",
    "DpsgdOptimizer", "DecayedAdagradOptimizer",
]


def _one_x(cls, lr_default=0.001):
    """A 1.x-convention subclass of a 2.0 optimizer: it takes the
    ``parameter_list`` and ``regularization`` spellings."""
    takes_decay = "weight_decay" in inspect.signature(cls.__init__).parameters

    class OneX(cls):
        def __init__(self, learning_rate=lr_default, *args,
                     parameter_list=None, regularization=None,
                     grad_clip=None, name=None, **kwargs):
            kwargs.setdefault("parameters", parameter_list)
            if takes_decay:
                kwargs.setdefault("weight_decay", regularization)
            kwargs.setdefault("grad_clip", grad_clip)
            super().__init__(learning_rate, *args, **kwargs)

    OneX.__name__ = cls.__name__ + "Optimizer"
    OneX.__qualname__ = OneX.__name__
    OneX.__doc__ = (f"1.x spelling of paddle.optimizer.{cls.__name__} "
                    f"(parameter_list / regularization argument names).")
    return OneX


SGDOptimizer = _one_x(_opt.SGD)
MomentumOptimizer = _one_x(_opt.Momentum)
AdamOptimizer = _one_x(_opt.Adam)
AdamaxOptimizer = _one_x(_opt.Adamax)
AdagradOptimizer = _one_x(_opt.Adagrad)
AdadeltaOptimizer = _one_x(_opt.Adadelta)
RMSPropOptimizer = _one_x(_opt.RMSProp)
LambOptimizer = _one_x(_opt.Lamb)
FtrlOptimizer = _one_x(_opt.Ftrl)
LarsMomentumOptimizer = _one_x(_opt.Lars)

SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
Adagrad = AdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Lamb = LambOptimizer
Ftrl = FtrlOptimizer
LarsMomentum = LarsMomentumOptimizer


class ExponentialMovingAverage(_opt.ExponentialMovingAverage):
    """1.x ``EMA(decay, thres_steps)`` harvested the global Program's
    parameters; here ``parameter_list`` is required."""

    def __init__(self, decay=0.999, thres_steps=None, name=None,
                 parameter_list=None):
        if parameter_list is None:
            raise UnimplementedError(
                "fluid.optimizer.ExponentialMovingAverage: pass "
                "parameter_list=layer.parameters() — no global Program "
                "exists to collect parameters from")
        super().__init__(parameter_list, decay=decay,
                         thres_steps=bool(thres_steps))


class ModelAverage(_opt.ModelAverage):
    """1.x ``ModelAverage(average_window_rate, ...)``; ``parameter_list``
    is required."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None,
                 parameter_list=None):
        if parameter_list is None:
            raise UnimplementedError(
                "fluid.optimizer.ModelAverage: pass "
                "parameter_list=layer.parameters()")
        super().__init__(parameter_list,
                         average_window_rate=average_window_rate,
                         min_average_window=min_average_window,
                         max_average_window=max_average_window)


class LookaheadOptimizer(_opt.Lookahead):
    """1.x spelling: ``LookaheadOptimizer(inner_optimizer, alpha, k)``."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        super().__init__(inner_optimizer, alpha=alpha, k=k)


def _strategy_shim(name, field, instead):
    class Shim:
        def __init__(self, *a, **k):
            raise UnimplementedError(
                f"fluid.optimizer.{name} rewrote the Program; here the "
                f"capability is a fleet strategy toggle: set "
                f"DistributedStrategy().{field} and pass the optimizer "
                f"through fleet.distributed_optimizer (see {instead}; "
                f"ROADMAP queue A, distributed execution)")

    Shim.__name__ = name
    Shim.__qualname__ = name
    Shim.__shim__ = True
    return Shim


PipelineOptimizer = _strategy_shim(
    "PipelineOptimizer", "pipeline=True, pipeline_configs={...}",
    "distributed/pipeline_parallel.py")
RecomputeOptimizer = _strategy_shim(
    "RecomputeOptimizer", "recompute=True, recompute_configs={...}",
    "nn/recompute.py")
GradientMergeOptimizer = _strategy_shim(
    "GradientMergeOptimizer", "gradient_merge=True",
    "optimizer/gradient_merge.py")
DGCMomentumOptimizer = _strategy_shim(
    "DGCMomentumOptimizer", "dgc=True, dgc_configs={...}",
    "distributed/fleet/dgc.py")
DpsgdOptimizer = _strategy_shim(
    "DpsgdOptimizer", "(differential privacy not implemented)",
    "paddle.optimizer")
DecayedAdagradOptimizer = _strategy_shim(
    "DecayedAdagradOptimizer", "(use Adagrad / RMSProp)", "paddle.optimizer")
