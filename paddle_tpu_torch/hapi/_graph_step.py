"""k training steps as one CUDA graph: the card's counterpart of the JAX
package's ``prepare(steps_per_execution=k)``, which runs k steps under one
``lax.scan`` in one dispatch.

:class:`GraphSteps` runs the executions of one ``Model``:

* the first execution runs its k steps eagerly, one by one, through the
  same code as ``train_batch``: that creates the optimizer state, the
  cuBLAS / cuDNN handles and algorithm choices and the lazy autograd
  state, which a capture cannot (capturing runs no kernel, and a warm-up
  step would train);
* every later one is one copy of the k stacked batches into static input
  buffers, one copy of the k steps' scalars (learning rate, bias
  corrections, ...) into a static ``[k, n]`` table, and one
  ``graph.replay()``.  The graph of the k steps is captured the first
  time its key is met: the branch decisions of the k steps' host halves
  (``optimizer.StepPlan.key``: a ``Lookahead`` sync step, a gradient-merge
  apply step) and the batches' shapes and dtypes.  A key repeats at
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
back to the eager loop.  The capture pool holds about one step's
temporaries (step i + 1 reuses what step i freed), not k of them.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Sequence, Tuple

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


def _signature(batch) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in batch)


class _Captured:
    """One captured execution: the graph, its static inputs, scalar table
    and losses, and the launches it makes."""

    __slots__ = ("graph", "inputs", "table", "losses", "launches")

    def __init__(self, graph, inputs, table, losses, launches):
        self.graph, self.inputs, self.table = graph, inputs, table
        self.losses, self.launches = losses, launches


class GraphSteps:
    """The k-step executions of a prepared ``Model`` on a CUDA device."""

    def __init__(self, model, k: int):
        self._model = model
        self.k = int(k)
        self._graphs: Dict[tuple, _Captured] = {}
        self._pool = None
        self.executions = 0

    @property
    def captures(self) -> int:
        return len(self._graphs)

    def run(self, batches: Sequence[tuple], lr: float) -> torch.Tensor:
        """Train on ``batches`` (``k`` tuples of device tensors) at ``lr``;
        returns the k losses as one device tensor."""
        model = self._model
        if len(batches) != self.k:
            raise InvalidArgumentError(
                f"an execution takes {self.k} batches, got {len(batches)}")
        sig = _signature(batches[0])
        if any(_signature(b) != sig for b in batches[1:]):
            raise InvalidArgumentError(
                "the batches of one execution must share their shapes and "
                "dtypes")
        opt = model._optimizer
        if self.executions == 0:
            self.executions += 1
            return model._train_steps_eager(batches, lr)
        plans = [opt._plan(opt._state, lr) for _ in batches]
        key = (tuple(p.key for p in plans), sig)
        cap = self._graphs.get(key)
        if cap is None:
            cap = self._graphs[key] = self._capture(plans, sig)
        for j, static in enumerate(cap.inputs):
            torch.stack([b[j] for b in batches], out=static)
        width = cap.table.shape[1]
        host = torch.tensor([p.values + [0.0] * (width - len(p.values))
                             for p in plans], dtype=torch.float64)
        cap.table.copy_(host.pin_memory(), non_blocking=True)
        cap.graph.replay()
        for (obj, attr), n in cap.launches:
            setattr(obj, attr, getattr(obj, attr) + n)
        self.executions += 1
        return cap.losses.clone()

    def _capture(self, plans, sig) -> _Captured:
        model = self._model
        dev = model.device
        inputs = [torch.zeros((self.k,) + shape, dtype=dtype, device=dev)
                  for shape, dtype in sig]
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
        model._optimizer.clear_grad()
        # thread-local: the DataLoader's staging thread goes on pinning and
        # copying the next batches on its own stream during a capture
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            losses = torch.stack([
                model._train_step(tuple(x[i] for x in inputs), plans[i])[0]
                for i in range(self.k)])
        launches = []
        for (obj, attr), b in zip(counters, before):
            n = getattr(obj, attr) - b
            setattr(obj, attr, b)  # the capture launched nothing
            if n:
                launches.append(((obj, attr), n))
        return _Captured(graph, inputs, table, losses, launches)
