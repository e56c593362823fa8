"""k training steps as one CUDA graph: the card's counterpart of the JAX
package's ``lax.scan`` of k steps in one dispatch — ``Model``'s
``prepare(steps_per_execution=k)`` and ``static.Executor.run_steps``
both run on :class:`GraphSteps`.

A caller hands it a step function ``step(inputs, plan)`` (one training
step on a tuple of tensors, given the optimizer step's host half; it
returns a tuple of tensors) and, for each execution, the k steps' inputs
and plans:

* the first execution runs its k steps eagerly, one by one, through the
  caller's own step: that creates the optimizer state, the cuBLAS /
  cuDNN handles and algorithm choices and the lazy autograd state, which
  a capture cannot (capturing runs no kernel, and a warm-up step would
  train);
* every later one is one copy of the k steps' inputs into static input
  buffers (stacked inputs, one slice a step, and constant ones, shared by
  the k steps), one copy of the k steps' scalars (learning rate, bias
  corrections, ...) into a static ``[k, n]`` table, and one
  ``graph.replay()``.  The graph of the k steps is captured the first
  time its key is met: the branch decisions of the k steps' host halves
  (``optimizer.StepPlan.key``: a ``Lookahead`` sync step, a gradient-merge
  apply step) and the inputs' shapes and dtypes.  A key repeats at
  least every lcm(k, period) / k executions, so the cache stays small.

What a capture would otherwise freeze is handled here:

* each step's host half (``Optimizer._plan``: the step counts, the
  scalars, the branches) runs on the host for every step, replayed or
  not; the device half reads the scalars from the table;
* dropout draws from the device generator of ``framework.random``, which
  is registered with every capture, so each replay draws new masks (the
  k steps of one execution different ones, as ``jax.random.split(key,
  k)`` gives) and a replay draws what the same steps run eagerly would;
* the kernels' launch counters (``<wrapper>.launches``) are Python ints
  bumped by the wrappers: the launches counted during a capture are
  added on every replay, so the counts read as after eager steps.

On a CUDA device a capture or replay that fails raises; nothing falls
back to the eager loop.  Off a CUDA device every execution runs eagerly.
The capture pool holds about one step's temporaries (step i + 1 reuses
what step i freed), not k of them.
"""
from __future__ import annotations

import sys
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..framework.errors import InvalidArgumentError
from ..framework.random import generator_for

__all__ = ["GraphSteps", "launch_counters"]


def launch_counters() -> List[Tuple[object, str]]:
    """``(wrapper, attribute)`` of every launch counter of the kernels'
    wrappers imported so far (``launches``, ``backward_launches``)."""
    prefix = __name__.rsplit(".", 2)[0] + ".ops."
    found = []
    for name, mod in list(sys.modules.items()):
        if not name.startswith(prefix) or mod is None:
            continue
        for obj in vars(mod).values():
            if getattr(obj, "__module__", None) != name:
                continue
            for attr in ("launches", "backward_launches"):
                if isinstance(getattr(obj, attr, None), int):
                    found.append((obj, attr))
    return found


def _signature(stacked, const, k: int) -> tuple:
    """The per-step shapes and dtypes of the inputs.  A stacked input is a
    ``[k, ...]`` tensor or a sequence of k tensors of one shape and
    dtype."""
    sig = []
    for x in stacked:
        if isinstance(x, torch.Tensor):
            n, one = int(x.shape[0]), (tuple(x.shape[1:]), x.dtype)
        else:
            n, one = len(x), (tuple(x[0].shape), x[0].dtype)
            if any((tuple(t.shape), t.dtype) != one for t in x[1:]):
                raise InvalidArgumentError(
                    "the batches of one execution must share their shapes "
                    "and dtypes")
        if n != k:
            raise InvalidArgumentError(
                f"an execution takes {k} batches, got {n}")
        sig.append(one)
    return tuple(sig), tuple((tuple(c.shape), c.dtype) for c in const)


class _Captured:
    """One captured execution: the graph, its static inputs (stacked and
    constant), scalar table and stacked outputs, and the launches it
    makes."""

    __slots__ = ("graph", "inputs", "consts", "table", "outputs",
                 "launches")

    def __init__(self, graph, inputs, consts, table, outputs, launches):
        self.graph, self.inputs, self.consts = graph, inputs, consts
        self.table, self.outputs, self.launches = table, outputs, launches


class GraphSteps:
    """The k-step executions of one training step function.

    ``step(inputs, plan)``: one step on ``inputs`` (the step's slices of
    the stacked inputs, then the constant ones) with ``plan`` (its
    ``StepPlan``); returns a tuple of tensors, stacked over the k steps by
    :meth:`run`.  ``device``: where the steps run; an execution off a
    CUDA device runs eagerly.  ``before_capture``: called before each
    capture (the model drops its parameters' ``.grad``)."""

    def __init__(self, k: int, step: Callable, device,
                 before_capture: Optional[Callable] = None):
        self.k = int(k)
        self._step = step
        self._device = torch.device(device)
        self._before_capture = before_capture
        self._graphs: Dict[tuple, _Captured] = {}
        self._pool = None
        self.executions = 0

    @property
    def captures(self) -> int:
        return len(self._graphs)

    def run(self, stacked: Sequence, plans: Sequence, const: Sequence = ()
            ) -> Tuple[torch.Tensor, ...]:
        """One execution: ``stacked`` (per input a ``[k, ...]`` tensor or k
        tensors), ``const`` (tensors every step reads whole) and the k
        steps' ``plans``; returns the step's outputs, each stacked into
        one ``[k, ...]`` device tensor."""
        sig = _signature(stacked, const, self.k)
        if len(plans) != self.k:
            raise InvalidArgumentError(
                f"an execution takes {self.k} plans, got {len(plans)}")
        if self.executions == 0 or self._device.type != "cuda":
            self.executions += 1
            outs = [self._step(tuple(x[i] for x in stacked) + tuple(const),
                               plans[i]) for i in range(self.k)]
            return tuple(torch.stack(col) for col in zip(*outs))
        key = (tuple(p.key for p in plans), sig)
        cap = self._graphs.get(key)
        if cap is None:
            cap = self._graphs[key] = self._capture(plans, sig)
        for x, static in zip(stacked, cap.inputs):
            if isinstance(x, torch.Tensor):
                static.copy_(x, non_blocking=True)
            else:
                torch.stack(list(x), out=static)
        for c, static in zip(const, cap.consts):
            static.copy_(c, non_blocking=True)
        width = cap.table.shape[1]
        host = torch.tensor([p.values + [0.0] * (width - len(p.values))
                             for p in plans], dtype=torch.float64)
        cap.table.copy_(host.pin_memory(), non_blocking=True)
        cap.graph.replay()
        for (obj, attr), n in cap.launches:
            setattr(obj, attr, getattr(obj, attr) + n)
        self.executions += 1
        return tuple(o.clone() for o in cap.outputs)

    def _capture(self, plans, sig) -> _Captured:
        dev = self._device
        stacked_sig, const_sig = sig
        inputs = [torch.zeros((self.k,) + shape, dtype=dtype, device=dev)
                  for shape, dtype in stacked_sig]
        consts = [torch.zeros(shape, dtype=dtype, device=dev)
                  for shape, dtype in const_sig]
        width = max(1, max(len(p.values) for p in plans))
        table = torch.zeros((self.k, width), dtype=torch.float64, device=dev)
        for i, p in enumerate(plans):
            p.bind(table[i])
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator_for(dev))
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        counters = launch_counters()
        before = [getattr(obj, attr) for obj, attr in counters]
        if self._before_capture is not None:
            self._before_capture()
        # thread-local: the DataLoader's staging thread goes on pinning and
        # copying the next batches on its own stream during a capture
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            outs = [self._step(tuple(x[i] for x in inputs) + tuple(consts),
                               plans[i]) for i in range(self.k)]
            outputs = tuple(torch.stack(col) for col in zip(*outs))
        launches = []
        for (obj, attr), b in zip(counters, before):
            n = getattr(obj, attr) - b
            setattr(obj, attr, b)  # the capture launched nothing
            if n:
                launches.append(((obj, attr), n))
        return _Captured(graph, inputs, consts, table, outputs, launches)
