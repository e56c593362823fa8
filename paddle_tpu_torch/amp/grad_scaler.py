"""GradScaler — dynamic loss scaling for float16 training (port of
``paddle_tpu.amp.grad_scaler``, its eager form).

The state machine is the JAX package's (the reference's
``update_loss_scaling`` op): the scale grows by ``incr_ratio`` after
``incr_every_n_steps`` finite steps in a row and shrinks by
``decr_ratio`` (never below 1) after ``decr_every_n_nan_or_inf``
non-finite ones; a step whose gradients hold an inf or a NaN is skipped.
The scale is a float32 and the counters int32, held on the host.

The eager flow, on the gradients that ``backward()`` left in the bound
parameters' ``.grad`` (or an explicit ``grads`` dict)::

    scaled = scaler.scale(loss)
    scaled.backward()
    scaler.step(opt)      # unscale, skip on inf / nan, else opt.step()
    scaler.update()       # advance the state machine
    opt.clear_grad()

``unscale(opt)`` divides the gradients in place first, so that a clip can
see them; ``step`` then does not divide again.  bfloat16 training needs no
scaling (float32's exponent range): build the scaler with
``enable=False``, or use none.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..framework.errors import InvalidArgumentError

__all__ = ["GradScaler", "AmpScaler"]


class GradScaler:
    def __init__(self, enable: bool = True,
                 init_loss_scaling: float = 2.0 ** 15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 use_dynamic_loss_scaling: bool = True):
        if incr_ratio <= 1.0 or not (0.0 < decr_ratio < 1.0):
            raise InvalidArgumentError(
                "incr_ratio>1 and 0<decr_ratio<1 required")
        self._enable = enable
        self._init_scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._state = self.init_state()
        self._found_inf = False
        self._unscaled = False     # unscale() ran since the last step()
        self._skipped_steps = 0    # non-finite steps step() skipped

    # -- the state machine ---------------------------------------------------
    def init_state(self) -> Dict[str, np.ndarray]:
        return {"scale": np.asarray(self._init_scale, np.float32),
                "good_steps": np.asarray(0, np.int32),
                "bad_steps": np.asarray(0, np.int32)}

    def next_state(self, state, found_inf: bool) -> Dict[str, np.ndarray]:
        """The update_loss_scaling state machine, in float32 / int32."""
        if not self._dynamic:
            return state
        good = 0 if found_inf else int(state["good_steps"]) + 1
        bad = int(state["bad_steps"]) + 1 if found_inf else 0
        scale = np.float32(state["scale"])
        if good >= self._incr_every:
            scale = np.float32(scale * np.float32(self._incr_ratio))
            good = 0
        if bad >= self._decr_every:
            scale = np.maximum(np.float32(scale * np.float32(
                self._decr_ratio)), np.float32(1.0))
            bad = 0
        return {"scale": np.asarray(scale, np.float32),
                "good_steps": np.asarray(good, np.int32),
                "bad_steps": np.asarray(bad, np.int32)}

    # -- eager API -----------------------------------------------------------
    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._dynamic

    def scale(self, loss: torch.Tensor) -> torch.Tensor:
        """``loss`` times the current scale, in the loss's dtype."""
        if not self._enable:
            return loss
        return loss * torch.tensor(float(self._state["scale"]),
                                   dtype=loss.dtype, device=loss.device)

    def _grads(self, optimizer, grads) -> Dict[str, Optional[torch.Tensor]]:
        if grads is not None:
            return (dict(grads) if isinstance(grads, Mapping)
                    else dict(enumerate(grads)))
        return {n: p.grad for n, p in optimizer._bound().items()}

    def _unscale(self, grads) -> Dict[str, Optional[torch.Tensor]]:
        """Each gradient divided by the scale in float32 and rounded to its
        own dtype; notes whether any is non-finite (one host sync)."""
        inv = 1.0 / np.float32(self._state["scale"])
        out, finite = {}, []
        with torch.no_grad():
            for k, g in grads.items():
                if g is None:
                    out[k] = None
                    continue
                u = (g.float() * float(inv)).to(g.dtype)
                out[k] = u
                finite.append(torch.isfinite(u).all())
        self._found_inf = bool(finite) and not bool(torch.stack(
            [f.to(finite[0].device) for f in finite]).all())
        return out

    def unscale(self, optimizer, grads=None):
        """Divide the gradients by the scale in place (the bound
        parameters' ``.grad``, or the tensors of ``grads``) and note
        whether any is non-finite; the next :meth:`step` takes them as
        they are."""
        if not self._enable:
            return
        g = self._grads(optimizer, grads)
        for k, u in self._unscale(g).items():
            if u is not None:
                g[k].copy_(u)
        self._unscaled = True

    def step(self, optimizer, grads=None):
        """Unscale the gradients (unless :meth:`unscale` did), then skip
        the step if any is non-finite, else ``optimizer.step``."""
        if not self._enable:
            optimizer.step(grads)
            return
        g = self._grads(optimizer, grads)
        if not self._unscaled:
            g = self._unscale(g)
        self._unscaled = False
        if self._found_inf:
            self._skipped_steps += 1
            return
        if grads is not None and not isinstance(grads, Mapping):
            optimizer.step([g[i] for i in range(len(g))])
        else:
            optimizer.step({k: v for k, v in g.items() if v is not None})

    def update(self):
        """Advance the state machine by the last step's finite check."""
        if self._enable and self._dynamic:
            self._state = self.next_state(self._state, self._found_inf)

    def minimize(self, optimizer, scaled_loss=None, grads=None):
        self.step(optimizer, grads)
        self.update()

    # -- introspection / persistence -----------------------------------------
    def get_loss_scaling(self) -> float:
        return float(self._state["scale"])

    def set_init_loss_scaling(self, v: float):
        self._state["scale"] = np.asarray(float(v), np.float32)

    def state_dict(self):
        return {k: np.asarray(v) for k, v in self._state.items()} | {
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
        }

    def load_state_dict(self, state):
        for k, dt in (("scale", np.float32), ("good_steps", np.int32),
                      ("bad_steps", np.int32)):
            if k in state:
                self._state[k] = np.asarray(state[k], dt)

    set_state_dict = load_state_dict


AmpScaler = GradScaler  # the legacy name
