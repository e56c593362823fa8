"""paddle.jit — to_static, save, load (port of ``paddle_tpu.jit``).

Parity: python/paddle/fluid/dygraph/jit.py + dygraph_to_static/
(ProgramTranslator, program_translator.py:708; TranslatedLayer in
dygraph/io.py).

In the port the eager module is the counterpart of the compiled one:
PyTorch runs eagerly, and the card's hot loops are the hand kernels, so
``to_static`` wraps a Layer, a bound method or a function and runs it as
it is — parameters are read on every call (training goes on working) and
buffer updates (BatchNorm's running statistics) land in the layer, the
JAX semantics of its compiled call.  The dy2static transpiler is not
ported: a forward whose Python control flow depends on tensor values runs
eagerly here, and does not export (``jit.save`` raises
``UnimplementedError``).

``jit.save`` exports the eval-mode forward and the weights
(``paddle_tpu_torch.inference``: a ``torch.export`` graph that keeps the
hand kernels as operators); ``jit.load`` returns a ``TranslatedLayer``
over the loaded ``Predictor``.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.utils._pytree as pytree

from .framework.errors import InvalidArgumentError

__all__ = ["to_static", "not_to_static", "save", "load", "TranslatedLayer",
           "ProgramTranslator", "TracedLayer", "set_code_level",
           "get_code_level", "set_verbosity", "StaticFunction"]

#: global to_static switch (ref: ProgramTranslator.enable); both states run
#: eagerly in the port, so it only answers ``enable_to_static``
_to_static_enabled = True


class StaticFunction:
    """The wrapper ``to_static`` returns over a Layer, a bound method or a
    function; it runs the callee eagerly.  Also a descriptor, so the
    canonical paddle pattern works::

        class Net(nn.Layer):
            @jit.to_static
            def forward(self, x): ...
    """

    def __init__(self, fn, input_spec=None, _bound_layer=None):
        self._orig = fn
        self._input_spec = input_spec
        self._layer = fn if isinstance(fn, torch.nn.Module) else _bound_layer

    def __get__(self, obj, objtype=None):
        """Method-decorator support: the function bound to the Layer
        instance (one wrapper per instance)."""
        if obj is None:
            return self
        cache = obj.__dict__.setdefault("_static_methods", {})
        key = id(self)
        if key not in cache:
            if not isinstance(obj, torch.nn.Module):
                raise InvalidArgumentError(
                    "@to_static methods are supported on nn.Layer "
                    "subclasses")
            cache[key] = StaticFunction(self._orig, self._input_spec,
                                        _bound_layer=obj)
        return cache[key]

    def __call__(self, *args, **kwargs):
        iterations = kwargs.pop("iterations", None)
        if iterations is not None:  # the fused multi-step form
            return self.run_steps(
                *args, iterations=iterations,
                fetch_every=kwargs.pop("fetch_every", 1), **kwargs)
        if self._layer is not None and not isinstance(self._orig,
                                                      torch.nn.Module):
            return self._orig(self._layer, *args, **kwargs)
        return self._orig(*args, **kwargs)

    def run_steps(self, *stacked_args, iterations=None, fetch_every=1):
        """Run N steps, one a slice of the stacked arguments' leading
        axis (the superbatch format ``DataLoader(superbatch=k)`` yields);
        buffers carry across the steps in the layer, as in JAX's scanned
        chain.  ``fetch_every=k`` keeps every k-th step's outputs.  Returns
        the kept outputs stacked on a leading ``N // fetch_every`` axis.
        Equivalent to ``fn(..., iterations=N)``."""
        fetch_every = int(fetch_every)
        if fetch_every < 1:
            raise InvalidArgumentError("fetch_every must be >= 1")
        if iterations is None:
            for a in stacked_args:
                if hasattr(a, "shape") and len(a.shape) >= 1:
                    iterations = int(a.shape[0])
                    break
        if iterations is None:
            raise InvalidArgumentError(
                "run_steps needs iterations=N or at least one stacked "
                "array argument to infer the chain length from")
        n_steps = int(iterations)
        if n_steps < 1:
            raise InvalidArgumentError("run_steps needs iterations >= 1")
        for a in stacked_args:
            if hasattr(a, "shape") and (len(a.shape) < 1
                                        or int(a.shape[0]) != n_steps):
                raise InvalidArgumentError(
                    f"run_steps: stacked arg has leading dim "
                    f"{tuple(a.shape)[:1]}, expected iterations={n_steps}")
        outs = [self(*[torch.as_tensor(a)[t] for a in stacked_args])
                for t in range(n_steps)]
        outs = outs[fetch_every - 1::fetch_every]
        return pytree.tree_map(lambda *xs: torch.stack(xs, 0), *outs)

    @property
    def forward(self):
        return self


def to_static(function=None, input_spec=None, **kwargs):
    """Decorator / wrapper over a Layer, a bound method or a function
    (reference: paddle.jit.to_static).  The wrapped callee runs eagerly
    (see the module docstring); ``input_spec`` is kept for
    :func:`save`."""
    if function is None:
        return functools.partial(to_static, input_spec=input_spec, **kwargs)
    return StaticFunction(function, input_spec)


def not_to_static(fn):
    """Parity no-op: nothing is transpiled, so nothing needs excluding."""
    return fn


def save(layer, path: str, input_spec: Optional[Sequence] = None,
         **configs):
    """Export ``layer`` for inference (reference: paddle.jit.save):
    ``path.pdmodel`` + ``path.pdiparams``.  ``input_spec``: an InputSpec or
    example per forward input (default: the ``to_static`` wrapper's);
    ``configs`` may carry ``platforms`` (``inference.save_inference_model``)."""
    from .inference import save_inference_model

    target = layer._orig if isinstance(layer, StaticFunction) else layer
    spec = input_spec or (layer._input_spec
                          if isinstance(layer, StaticFunction) else None)
    if spec is None:
        raise InvalidArgumentError(
            "jit.save needs input_spec=[InputSpec(...)] (or wrap with "
            "to_static(input_spec=...))")
    if not isinstance(target, torch.nn.Module):
        raise InvalidArgumentError("jit.save exports Layers")
    return save_inference_model(path, target, spec,
                                platforms=configs.get("platforms"))


class TranslatedLayer:
    """A loaded inference module, callable like a Layer (reference:
    dygraph/io.py TranslatedLayer over the saved program): tensors or
    arrays in, tensors on the predictor's device out."""

    def __init__(self, predictor):
        self._predictor = predictor
        self.training = False

    def __call__(self, *inputs):
        outs = self._predictor.run_tensors(list(inputs))
        return outs[0] if len(outs) == 1 else tuple(outs)

    forward = __call__

    def eval(self):
        return self

    def train(self):
        raise InvalidArgumentError(
            "a loaded inference module is eval-only (the reference's "
            "TranslatedLayer trains only if exported with trainable "
            "programs — export params + rebuild the Layer to fine-tune)")


def load(path: str, device: Optional[str] = None) -> TranslatedLayer:
    """The artifact at ``path`` as a :class:`TranslatedLayer` on ``device``
    (``None``: the card)."""
    from .inference import Predictor

    return TranslatedLayer(Predictor(path, device=device))


class ProgramTranslator:
    """Global to_static control (ref: dygraph_to_static/
    program_translator.py:708): the enable / disable switch.  Wrapped code
    runs eagerly either way in the port."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    @classmethod
    def get_instance(cls):
        return cls()

    def enable(self, enable_to_static: bool):
        global _to_static_enabled
        if not isinstance(enable_to_static, bool):
            raise InvalidArgumentError(
                "ProgramTranslator.enable expects a bool")
        _to_static_enabled = enable_to_static

    @property
    def enable_to_static(self) -> bool:
        return _to_static_enabled


_code_level = 0


def set_code_level(level: int = 100):
    """Ref: dygraph_to_static logging_utils.set_code_level — the level is
    kept; nothing is transpiled, so nothing is printed."""
    global _code_level
    _code_level = level


def get_code_level() -> int:
    return _code_level


def set_verbosity(level: int = 0, also_to_stdout: bool = False):
    """Ref: logging_utils.set_verbosity (alias of :func:`set_code_level`,
    as in the JAX package)."""
    set_code_level(level)


class TracedLayer:
    """A dygraph Layer with example inputs, deployable by
    :meth:`save_inference_model` (ref: fluid/dygraph/jit.py TracedLayer);
    calling it runs the layer."""

    def __init__(self, layer, example_inputs):
        self._layer = layer
        self._inputs = list(example_inputs)

    @staticmethod
    def trace(layer, inputs):
        """→ (example_outputs, TracedLayer) — reference signature."""
        if not isinstance(layer, torch.nn.Module):
            raise InvalidArgumentError("TracedLayer.trace expects a Layer")
        traced = TracedLayer(layer, inputs)
        return traced(*inputs), traced

    def __call__(self, *args):
        return self._layer(*args)

    def save_inference_model(self, path, feed=None, fetch=None, **kwargs):
        """Export at the example inputs' shapes (the reference's feed /
        fetch index filters are accepted unchecked, as in JAX)."""
        from .inference import save_inference_model as _save
        from .static import InputSpec

        specs = [InputSpec.from_tensor(x, name=f"x{i}")
                 for i, x in enumerate(self._inputs)]
        return _save(path, self._layer, specs,
                     platforms=kwargs.get("platforms"))
