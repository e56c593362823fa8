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
