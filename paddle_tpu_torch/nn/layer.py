"""``Layer`` — the port's ``torch.nn.Module`` base (port of
``paddle_tpu.nn.layer_base.Layer``'s call, state and dtype surface).

* ``__call__`` applies the amp policy (``amp.auto_cast``) by class name,
  as the JAX ``Layer.__call__`` does; with amp off that is one
  thread-local check before the usual ``torch.nn.Module`` call.
* ``state_dict()`` is keyed by the dotted names the JAX package uses
  (``bert.layers.0.attn.qkv.weight``: the port keeps its module tree);
  ``set_state_dict`` / ``load_dict`` take such a dict — tensors, or the
  numpy leaves ``paddle_tpu_torch.load`` returns — casting each value to
  its target's dtype and device.
* ``astype`` is paddle's spelling of a dtype cast.
* paddle's own traversal and registration methods: ``named_sublayers`` /
  ``sublayers`` (the JAX order: depth first in registration order, and a
  layer shared at two paths is yielded at each, where torch's
  ``named_modules`` yields it once), ``add_sublayer``, ``add_parameter``,
  ``create_parameter`` and ``register_forward_post_hook`` (torch's forward
  hook: a returned value replaces the output, as in JAX; torch's
  ``register_forward_pre_hook`` already treats a returned value as JAX
  does: a tuple replaces the arguments, anything else is wrapped in one).

And the JAX ``layer_base``'s other names:

* ``Parameter`` — the class of every parameter the port registers: a
  ``torch.nn.Parameter`` subclass with the JAX box's surface (``value``,
  ``name``, ``trainable`` ↔ ``requires_grad``, ``partition_spec``,
  ``sparse``, ``set_value``, ``numpy``); ``deepcopy`` and pickling keep
  the class and those attributes.
* ``Buffer`` — a tensor box of non-trainable state with ``persistable``;
  assigned to a Layer's attribute it registers as a buffer (persistent
  when ``persistable``).  The registered storage is a plain tensor after
  a move (``Layer.to``), as torch's buffers are.
* ``functional_call(layer, params, *args, buffers=, rngs=, training=,
  return_buffers=, call=)`` over ``torch.func.functional_call``: the
  layer run with the given tensors in place of its parameters / buffers
  (JAX's restore rules, on the function's docstring).
* ``rng_scope(key)`` / ``current_rng_key()``: ``key`` is a
  ``torch.Generator`` (or an int seed); every random op inside the scope
  draws from it (``framework.random.generator_for``), none from the
  device streams.
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

import torch
from torch._C import _disabled_torch_function_impl

from ..amp.auto_cast import _state as _amp_state
from ..amp.auto_cast import cast_layer_call
from ..framework import random as _random
from ..framework.dtype import convert_dtype, numpy_to_tensor, to_numpy
from ..framework.errors import InvalidArgumentError, NotFoundError

__all__ = ["Layer", "Parameter", "Buffer", "functional_call", "rng_scope",
           "current_rng_key"]


class _Box:
    """The JAX box's surface shared by :class:`Parameter` and
    :class:`Buffer` (their attributes live in the tensor's ``__dict__``;
    torch's own ``Tensor.name`` is read-only)."""

    @property
    def value(self):
        return self

    @value.setter
    def value(self, v):
        with torch.no_grad():
            self.data = numpy_to_tensor(v).to(self.device)

    @property
    def name(self):
        return self.__dict__.get("_box_name", "")

    @name.setter
    def name(self, v):
        self.__dict__["_box_name"] = v

    @property
    def partition_spec(self):
        return self.__dict__.get("_partition_spec")

    @partition_spec.setter
    def partition_spec(self, v):
        self.__dict__["_partition_spec"] = v

    @property
    def sparse(self):
        return self.__dict__.get("_sparse", False)

    @sparse.setter
    def sparse(self, v):
        self.__dict__["_sparse"] = bool(v)

    def numpy(self, force=False):
        return to_numpy(self.detach())

    def set_value(self, v):
        """Copy ``v`` (a tensor or an array) in, cast to this dtype."""
        with torch.no_grad():
            self.copy_(numpy_to_tensor(v).to(device=self.device,
                                              dtype=self.dtype))

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = self._rebuilt(self.data.clone(
            memory_format=torch.preserve_format), self.requires_grad,
            dict(self.__dict__))
        memo[id(self)] = out
        return out

    def __reduce_ex__(self, proto):
        return (_rebuild_box, (type(self), self.data, self.requires_grad,
                               dict(self.__dict__)))


def _rebuild_box(cls, data, requires_grad, state):
    return cls._rebuilt(data, requires_grad, state)


class Parameter(_Box, torch.nn.Parameter):
    """Trainable tensor box (``trainable=False`` is paddle's
    ``stop_gradient``): ``Parameter(value, name="", trainable=True,
    partition_spec=None)``."""

    def __new__(cls, value=None, name="", trainable=True,
                partition_spec=None):
        if isinstance(value, torch.Tensor):
            t = value.detach()
        else:
            t = torch.empty(0) if value is None else numpy_to_tensor(value)
        p = torch.Tensor._make_subclass(cls, t, bool(trainable))
        p.__dict__["_box_name"] = name or ""
        if partition_spec is not None:
            p.__dict__["_partition_spec"] = partition_spec
        return p

    def __init__(self, *args, **kwargs):
        pass

    @classmethod
    def _rebuilt(cls, data, requires_grad, state):
        p = torch.Tensor._make_subclass(cls, data, requires_grad)
        p.__dict__.update(state)
        return p

    @property
    def trainable(self):
        return self.requires_grad

    @trainable.setter
    def trainable(self, v):
        self.requires_grad_(bool(v))


class Buffer(_Box, torch.Tensor):
    """Non-trainable state box (BatchNorm's statistics):
    ``Buffer(value, name="", persistable=True)``; ``persistable=False``
    keeps it out of ``state_dict``."""

    __torch_function__ = _disabled_torch_function_impl

    def __new__(cls, value=None, name="", persistable=True):
        if isinstance(value, torch.Tensor):
            t = value.detach()
        else:
            t = torch.empty(0) if value is None else numpy_to_tensor(value)
        b = torch.Tensor._make_subclass(cls, t, False)
        b.__dict__["_box_name"] = name or ""
        b.__dict__["persistable"] = bool(persistable)
        return b

    @classmethod
    def _rebuilt(cls, data, requires_grad, state):
        b = torch.Tensor._make_subclass(cls, data, False)
        b.__dict__.update(state)
        return b

    @property
    def trainable(self):
        return False


def rng_scope(key):
    """Context manager: every random op inside draws from ``key`` (a
    ``torch.Generator``, or an int seed giving one generator a device);
    the device streams are untouched.  Yields the scope."""
    return _random.scope(key)


def current_rng_key(device="cpu") -> torch.Generator:
    """The generator a random op on ``device`` draws from: the innermost
    ``rng_scope``'s, else the device's own
    (``framework.random.generator_for``)."""
    return _random.generator_for(device)


def _walk(module: torch.nn.Module, prefix: str):
    for name, sub in module._modules.items():
        if sub is None:
            continue
        path = f"{prefix}.{name}" if prefix else name
        yield path, sub
        yield from _walk(sub, path)


class Layer(torch.nn.Module):
    def __setattr__(self, name, value):
        if isinstance(value, Buffer):
            self.__dict__.pop(name, None)
            self.register_buffer(name, value, persistent=value.persistable)
            return
        super().__setattr__(name, value)

    def __call__(self, *args, **kwargs):
        if _amp_state.enabled:
            with cast_layer_call(self, args, kwargs) as (args, kwargs):
                return self._call_impl(*args, **kwargs)
        return self._call_impl(*args, **kwargs)

    def astype(self, dtype):
        """Cast every floating parameter and buffer to ``dtype`` (a paddle
        name such as ``"bfloat16"`` or a torch dtype), in place; returns
        ``self`` — ``BertForPretraining(cfg).astype("bfloat16")``."""
        return self.to(dtype=convert_dtype(dtype))

    def named_sublayers(self, prefix: str = "", include_self: bool = False):
        """``(dotted name, layer)`` of every sublayer, depth first in
        registration order (``include_self``: ``(prefix, self)`` first);
        a layer registered at two paths is yielded at each."""
        if include_self:
            yield prefix, self
        yield from _walk(self, prefix)

    def sublayers(self, include_self: bool = False) -> list:
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def add_sublayer(self, name: str, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def add_parameter(self, name: str, param):
        """Register ``param`` (a tensor is wrapped as a parameter; ``None``
        registers the name empty); returns it."""
        if param is not None and not isinstance(param, Parameter):
            param = Parameter(torch.as_tensor(param),
                              trainable=getattr(param, "requires_grad",
                                                True))
        self.register_parameter(name, param)
        return param

    def create_parameter(self, shape, dtype=None, attr=None, is_bias=False,
                         default_initializer=None):
        """An ``nn.Parameter`` of ``shape`` filled by ``attr``'s
        initializer, else ``default_initializer``, else zeros for a bias
        and Xavier-normal otherwise (not registered: assign it to an
        attribute)."""
        from .initializer import build_parameter

        return build_parameter(shape, dtype or "float32", attr, is_bias,
                               default_initializer)

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, output)`` after every forward; a value it
        returns replaces the output.  Returns a handle with ``remove()``."""
        return self.register_forward_hook(hook)

    def state_dict(self, *args, include_sublayers: bool = True, **kwargs):
        """``{dotted name: tensor}`` of the parameters and persistent
        buffers (torch's ``state_dict``; ``include_sublayers=False``: this
        layer's own only)."""
        if include_sublayers:
            return super().state_dict(*args, **kwargs)
        keep = kwargs.get("keep_vars", False)
        out: "OrderedDict[str, Any]" = OrderedDict()
        for name, t in list(self._parameters.items()) + [
                (n, b) for n, b in self._buffers.items()
                if n not in self._non_persistent_buffers_set]:
            if t is not None:
                out[name] = t if keep else t.detach()
        return out

    def set_state_dict(self, state_dict: Dict[str, Any],
                       use_structured_name: bool = True) -> List[str]:
        """Load ``state_dict`` (dotted name → tensor or numpy array) into
        the parameters and buffers of the same names, each value cast to
        its target's dtype and moved to its device.  Raises
        ``InvalidArgumentError`` on a shape mismatch; returns the names of
        ``state_dict`` that match nothing here (the JAX package's
        contract)."""
        own = dict(self.named_parameters())
        own.update(dict(self.named_buffers()))
        missing = []
        with torch.no_grad():
            for name, value in state_dict.items():
                tgt = own.get(name)
                if tgt is None:
                    missing.append(name)
                    continue
                value = numpy_to_tensor(value)
                if tuple(tgt.shape) != tuple(value.shape):
                    raise InvalidArgumentError(
                        f"shape mismatch for {name}: have "
                        f"{tuple(tgt.shape)}, loading {tuple(value.shape)}")
                tgt.copy_(value.to(device=tgt.device, dtype=tgt.dtype))
        return missing

    load_dict = set_state_dict


class _Call(torch.nn.Module):
    """What :func:`functional_call` hands ``torch.func.functional_call``:
    runs the layer (or ``call``) and reads its buffers before the
    substitution ends."""

    def __init__(self, layer, call):
        super().__init__()
        self.layer = layer
        self._fn = call

    def forward(self, args, kwargs, read_buffers):
        out = (self.layer if self._fn is None else self._fn)(*args, **kwargs)
        if read_buffers:
            return out, dict(self.layer.named_buffers(remove_duplicate=False))
        return out, None


def _entries(layer, kind):
    """``(module, attribute, tensor)`` of every registered parameter or
    buffer under ``layer`` (the registry objects, for restoring)."""
    return [(m, n, t) for m in layer.modules()
            for n, t in list(getattr(m, kind).items()) if t is not None]


def functional_call(layer, params: Dict[str, torch.Tensor], *args,
                    buffers: Optional[Dict[str, torch.Tensor]] = None,
                    rngs=None, training: Optional[bool] = None,
                    return_buffers: bool = False,
                    call: Optional[Callable] = None, **kwargs):
    """Run ``layer(*args, **kwargs)`` (or ``call(...)``) with the tensors
    of ``params`` / ``buffers`` (dotted name → tensor) in place of the
    layer's, through ``torch.func.functional_call``; autograd reaches the
    given tensors.

    The JAX package's restore rules: every parameter is restored
    afterwards, a derived one that a pre-hook rewrote too (weight norm's
    weight); ``training`` sets every sublayer's mode for the call and the
    modes are restored; ``rngs`` runs the call inside ``rng_scope``.
    Given ``buffers`` are copied in (the caller's tensors are never
    written).  With ``return_buffers=True`` every buffer is restored and
    ``(out, new_buffers)`` returned — the statistics the call updated;
    without it, a buffer updated in place keeps the update (eager paddle
    semantics) while a buffer the call replaced is restored."""
    own_p = dict(layer.named_parameters(remove_duplicate=False))
    own_b = dict(layer.named_buffers(remove_duplicate=False))
    for name in params:
        if name not in own_p:
            raise NotFoundError(
                f"no parameter named {name!r} in {type(layer).__name__}")
    for name in buffers or {}:
        if name not in own_b:
            raise NotFoundError(f"no buffer named {name!r}")
    tensors = {f"layer.{n}": v for n, v in params.items()}
    subst = dict(own_b) if return_buffers else {}
    subst.update(buffers or {})
    tensors.update({f"layer.{n}": v.clone() for n, v in subst.items()})
    saved_p = _entries(layer, "_parameters")
    saved_b = _entries(layer, "_buffers")
    saved_modes = None
    if training is not None:
        saved_modes = [(m, m.training) for m in layer.modules()]
        for m, _ in saved_modes:
            m.training = bool(training)
    ctx = rng_scope(rngs) if rngs is not None else contextlib.nullcontext()
    try:
        with ctx:
            out, new_buffers = torch.func.functional_call(
                _Call(layer, call), tensors,
                (args, kwargs, return_buffers), strict=False,
                tie_weights=True)
    finally:
        for m, n, p in saved_p:
            if m._parameters.get(n) is not p:
                m._parameters[n] = p
        for m, n, b in saved_b:
            if m._buffers.get(n) is not b:
                m._buffers[n] = b
        if saved_modes is not None:
            for m, mode in saved_modes:
                m.training = mode
    if return_buffers:
        return out, new_buffers
    return out
