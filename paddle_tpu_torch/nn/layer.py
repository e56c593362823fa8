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
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, List

import torch

from ..amp.auto_cast import _state as _amp_state
from ..amp.auto_cast import cast_layer_call
from ..framework.dtype import convert_dtype, numpy_to_tensor
from ..framework.errors import InvalidArgumentError

__all__ = ["Layer"]


def _walk(module: torch.nn.Module, prefix: str):
    for name, sub in module._modules.items():
        if sub is None:
            continue
        path = f"{prefix}.{name}" if prefix else name
        yield path, sub
        yield from _walk(sub, path)


class Layer(torch.nn.Module):
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
        if param is not None and not isinstance(param, torch.nn.Parameter):
            param = torch.nn.Parameter(torch.as_tensor(param))
        self.register_parameter(name, param)
        return param

    def create_parameter(self, shape, dtype=None, attr=None, is_bias=False,
                         default_initializer=None):
        """A parameter of ``shape`` filled by ``attr``'s initializer, else
        ``default_initializer``, else zeros for a bias and Xavier-normal
        otherwise (not registered: assign it to an attribute)."""
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
