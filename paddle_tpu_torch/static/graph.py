"""The 1.x static graph: ``Program`` / ``program_guard`` / ``Executor``
(port of ``paddle_tpu.static.graph``).

A Program is a recorded list of eager callables: each builder call
appends an :class:`Op` whose ``fn`` is the same PyTorch function the
eager API runs, with :class:`Variable` s as named edges, and a data slot
(``data``) is a Variable no op produces.  ``optimizer.minimize(loss)``
binds the optimizer and the loss to the loss's Program.
``Executor.run(program, feed, fetch_list)`` replays the ops on the feeds;
with an optimizer bound it replays them under autograd, takes the
gradient of ``loss.float().sum()`` for the trainable parameters
(``torch.autograd.grad``: the counterpart of the JAX package's
``jax.grad`` of the recorded graph, which replaces the reference's
appended backward ops) and applies the optimizer's step, as ``jax.jit``
of the same step does there.

Shapes at build time come from running each recorded function on the
"meta" device (batch dims probed as 1): nothing is computed or allocated
and no card is touched, which is JAX's ``jax.eval_shape`` probe.  The
kernels' wrappers run their plain versions on meta tensors.

Parameters are created once, at build time, in the Program's scope: a
tensor of the scope's own (a builder's Layer, or the caller's Layer in
``layer_op``, keeps its values — training changes only the scope), with
a host copy of its initial value that never aliases the scope.
``exe.run(startup_program)`` copies the initial values back in.  Scope,
buffers and optimizer state are updated IN PLACE: their storage stays,
so a CUDA graph captured over them stays valid across runs and across a
startup run.  They live where the Executor runs: ``Executor()`` is the
card, ``Executor(CPUPlace())`` the CPU; a program's first run on another
place moves its scope, buffers and optimizer state there (new storage;
the graphs captured before belong to the old storage and are keyed
apart).

``Executor.run_steps`` chains N optimizer steps in one call, JAX's one
``lax.scan`` dispatch: on a CUDA card the first call of a signature runs
its N steps eagerly, and every later call is one replay of a CUDA graph
of the N steps (``hapi/_graph_step.py``, shared with
``Model(steps_per_execution=k)``): the feeds copied into static buffers,
each step's optimizer scalars (``Optimizer._plan``, the learning rate
from the scheduler stepped once per step) into the graph's table.  On
the CPU the N steps run eagerly.  Dropout draws from the device's
registered generator, so each replay draws new masks; the kernels'
launch counters advance per replay.

Not here (as in the JAX package): ``clone(for_test=True)`` pruning beyond
stopping parameter updates, per-op placement, LoD.  Not ported yet: the
trace-event and steptrace publication of the JAX Executor (cache
counters are on :meth:`Executor.cache_stats`), py_readers and the
control-flow blocks (ROADMAP queue A, static graph and the long tail).
"""
from __future__ import annotations

import contextlib
import copy
import functools
import itertools
import operator
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..framework.device import place_device, upload
from ..framework.dtype import convert_dtype, numpy_to_tensor, to_numpy
from ..framework.errors import InvalidArgumentError, NotFoundError

__all__ = [
    "Variable", "Op", "Program", "DefUseIndex", "Executor", "program_guard",
    "default_main_program", "default_startup_program", "data",
    "record_call", "maybe_record", "in_graph_mode", "reset_default_programs",
    "run_ops", "current_device", "enable_static", "disable_static",
    "in_dygraph_mode",
]


def _tree_map(fn, tree):
    """``fn`` over the leaves of nested tuples / lists / dicts (a Variable
    is a leaf)."""
    if isinstance(tree, Variable):
        return fn(tree)
    if isinstance(tree, tuple):
        mapped = [_tree_map(fn, x) for x in tree]
        return type(tree)(*mapped) if hasattr(tree, "_fields") \
            else tuple(mapped)
    if isinstance(tree, list):
        return [_tree_map(fn, x) for x in tree]
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, Variable):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _leaves(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _leaves(x)
    else:
        yield tree


class Variable:
    """A symbolic tensor: a named edge of the recorded graph, with the
    static (shape, dtype) of the build-time probe; a batch dim may be
    None / -1 (set by the feed at run time)."""

    @staticmethod
    def _normalize_shape(name: str, shape) -> tuple:
        """Dims must be ints (None / -1: the run-time batch dim); a string
        dim raises with a clear message."""
        dims = []
        for i, d in enumerate(shape):
            if d is None:
                dims.append(None)
                continue
            if isinstance(d, str):
                raise InvalidArgumentError(
                    f"Variable {name!r}: shape dim {i} is a string "
                    f"({d!r}); dims must be integers — use None or -1 "
                    f"for the run-time batch dimension")
            try:
                di = int(d)
            except (TypeError, ValueError) as e:
                raise InvalidArgumentError(
                    f"Variable {name!r}: shape dim {i} ({d!r}) is not "
                    f"convertible to an integer") from e
            if di != d:
                raise InvalidArgumentError(
                    f"Variable {name!r}: shape dim {i} ({d!r}) is not an "
                    f"integer")
            dims.append(None if di == -1 else di)
        return tuple(dims)

    def __init__(self, program: "Program", name: str, shape, dtype,
                 *, is_param: bool = False, stop_gradient: bool = False):
        self.program = program
        self.name = name
        self.shape = self._normalize_shape(name, shape)
        self.dtype = convert_dtype(dtype)
        self.is_parameter = is_param
        self.stop_gradient = stop_gradient
        self.persistable = is_param

    # -- operator sugar: every overload records the eager op ----------------
    def _bin(self, other, fn, reverse=False):
        a, b = (other, self) if reverse else (self, other)
        return record_call(fn, a, b)

    def __add__(self, o):
        return self._bin(o, operator.add)

    def __radd__(self, o):
        return self._bin(o, operator.add, reverse=True)

    def __sub__(self, o):
        return self._bin(o, operator.sub)

    def __rsub__(self, o):
        return self._bin(o, operator.sub, reverse=True)

    def __mul__(self, o):
        return self._bin(o, operator.mul)

    def __rmul__(self, o):
        return self._bin(o, operator.mul, reverse=True)

    def __truediv__(self, o):
        return self._bin(o, operator.truediv)

    def __rtruediv__(self, o):
        return self._bin(o, operator.truediv, reverse=True)

    def __pow__(self, o):
        return self._bin(o, operator.pow)

    def __neg__(self):
        return record_call(operator.neg, self)

    def __matmul__(self, o):
        return self._bin(o, operator.matmul)

    def __lt__(self, o):
        return self._bin(o, operator.lt)

    def __le__(self, o):
        return self._bin(o, operator.le)

    def __gt__(self, o):
        return self._bin(o, operator.gt)

    def __ge__(self, o):
        return self._bin(o, operator.ge)

    def __getitem__(self, idx):
        return record_call(lambda t: t[idx], self)

    def astype(self, dtype):
        dt = convert_dtype(dtype)
        return record_call(lambda t: t.to(dt), self)

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return record_call(lambda t: t.reshape(shape), self)

    @property
    def ndim(self):
        return len(self.shape)

    def numpy(self):
        raise InvalidArgumentError(
            f"Variable {self.name!r} is symbolic (graph mode): values exist "
            "only at Executor.run time — fetch it via fetch_list")

    def __repr__(self):
        kind = "Parameter" if self.is_parameter else "Variable"
        return f"{kind}(name={self.name}, shape={self.shape}, dtype={self.dtype})"

    def __hash__(self):
        return id(self)

    def __eq__(self, o):  # symbolic == records elementwise equal, like 1.x
        if isinstance(o, (Variable, int, float, np.ndarray, torch.Tensor)):
            return self._bin(o, operator.eq)
        return NotImplemented


class Op:
    """One recorded step: ``outs = fn(*subst(args), **subst(kwargs))``,
    the Variables of args / kwargs substituted from the run's
    environment.  ``param_names`` / ``buffer_names`` name scope entries
    ``fn`` also takes (layer-backed builders: ``fn(params, buffers, *args,
    training=...)``); ``writes_buffers`` marks an ``fn`` returning ``(out,
    {buffer name: tensor})``."""

    def __init__(self, fn: Callable, args, kwargs, out_names: List[str],
                 single: bool, param_names=(), buffer_names=(),
                 writes_buffers: bool = False, scoped: bool = None):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.out_names = out_names
        self.single = single
        self.param_names = tuple(param_names)
        self.buffer_names = tuple(buffer_names)
        self.writes_buffers = writes_buffers
        self.scoped = bool(param_names or buffer_names) if scoped is None \
            else scoped


class DefUseIndex:
    """Def-use view of a Program's op list: ``producers`` / ``consumers``
    map a name to op positions, ``op_inputs`` lists each op's input
    Variables; the record order is the topological order."""

    def __init__(self, program: "Program", producers, consumers, op_inputs):
        self.program = program
        self.producers: Dict[str, List[int]] = producers
        self.consumers: Dict[str, List[int]] = consumers
        self.op_inputs: List[List[Variable]] = op_inputs

    @property
    def order(self) -> List[int]:
        return list(range(len(self.program.ops)))

    def feed_names(self) -> List[str]:
        """Variables no op produces that are not parameters or buffers:
        the feeds the program expects."""
        prog = self.program
        return [n for n, v in prog.vars.items()
                if n not in self.producers and not v.is_parameter
                and n not in prog.scope and n not in prog.buffers]

    def sink_names(self) -> List[str]:
        """Produced but never consumed: the fetch candidates."""
        return [n for n in self.producers if n not in self.consumers]

    def ops_reaching(self, roots: Sequence[str]) -> set:
        """Op positions on a def-use path to any of ``roots``."""
        live_ops: set = set()
        stack = [n for n in roots if n in self.producers]
        seen = set(stack)
        while stack:
            name = stack.pop()
            for i in self.producers.get(name, ()):
                if i in live_ops:
                    continue
                live_ops.add(i)
                for v in self.op_inputs[i]:
                    if v.name not in seen:
                        seen.add(v.name)
                        stack.append(v.name)
        return live_ops


def _copy_into(dst, src):
    """Copy the state tree ``src`` into ``dst`` in place (tensors keep
    their storage; other leaves are replaced)."""
    for k, v in src.items():
        cur = dst.get(k)
        if isinstance(v, dict) and isinstance(cur, dict):
            _copy_into(cur, v)
        elif isinstance(v, torch.Tensor) and isinstance(cur, torch.Tensor):
            cur.copy_(v)
        else:
            dst[k] = v


class Program:
    """The recorded graph and its parameter / buffer scope (parity:
    ``fluid.framework.Program``: ``global_block``, ``all_parameters``,
    ``random_seed``, ``clone``)."""

    _counter = 0

    def __init__(self):
        Program._counter += 1
        self.idx = Program._counter
        self.ops: List[Op] = []
        self.vars: Dict[str, Variable] = {}
        # scope: name -> tensor (parameters; buffers apart)
        self.scope: Dict[str, torch.Tensor] = {}
        self.buffers: Dict[str, torch.Tensor] = {}
        self._init_values: Dict[str, torch.Tensor] = {}
        self._param_trainable: Dict[str, bool] = {}
        self._optimizer = None
        self._loss_name: Optional[str] = None
        self._opt_state = None
        self._opt_device = None
        self._minimize_only = None
        self._is_test_clone = False
        self._name_i = 0
        self.random_seed = None
        # bumped per recorded op and per minimize: runners are keyed on it
        self._version = 0
        # where the scope lives, and a count of its moves (shared with
        # test clones, which share the scope)
        self._placement = {"device": None, "moves": 0}

    # -- naming --------------------------------------------------------------
    def unique_name(self, prefix: str) -> str:
        self._name_i += 1
        return f"_{self.idx}_{prefix}_{self._name_i}"

    def add_var(self, var: Variable):
        self.vars[var.name] = var

    def append_op(self, op: Op):
        self.ops.append(op)
        self._version += 1

    # -- parameters ----------------------------------------------------------
    def register_param(self, name: str, value, trainable: bool = True):
        """A scope parameter initialised from ``value`` (a tensor or an
        array; copied: the caller's tensor is never the scope's)."""
        t = value.detach() if isinstance(value, torch.Tensor) \
            else numpy_to_tensor(value)
        from ..nn.layer import Parameter

        self._init_values[name] = t.to("cpu", copy=True)
        self.scope[name] = Parameter(
            t.clone(), name=name,
            trainable=bool(trainable) and t.is_floating_point())
        self._param_trainable[name] = bool(trainable)
        self._placement["device"] = None
        v = Variable(self, name, tuple(t.shape), t.dtype, is_param=True,
                     stop_gradient=not trainable)
        self.add_var(v)
        return v

    def register_buffer(self, name: str, value):
        t = value.detach() if isinstance(value, torch.Tensor) \
            else numpy_to_tensor(value)
        self._init_values[name] = t.to("cpu", copy=True)
        self.buffers[name] = t.clone()
        self._placement["device"] = None

    def all_parameters(self):
        return [self.vars[n] for n in self.scope]

    def list_vars(self):
        return list(self.vars.values())

    def global_block(self):
        return self  # one block: the Program is its global block

    @property
    def blocks(self):
        return [self]

    def def_use(self) -> DefUseIndex:
        """The def-use index over the recorded op list."""
        producers: Dict[str, List[int]] = {}
        consumers: Dict[str, List[int]] = {}
        op_inputs: List[List[Variable]] = []
        for i, op in enumerate(self.ops):
            ins = [leaf for leaf in _leaves((op.args, op.kwargs))
                   if isinstance(leaf, Variable)]
            op_inputs.append(ins)
            for v in ins:
                consumers.setdefault(v.name, []).append(i)
            for n in op.param_names + op.buffer_names:
                consumers.setdefault(n, []).append(i)
            for n in op.out_names:
                producers.setdefault(n, []).append(i)
        return DefUseIndex(program=self, producers=producers,
                           consumers=consumers, op_inputs=op_inputs)

    def parameters_numpy(self) -> Dict[str, np.ndarray]:
        """A host snapshot of the parameters (copies: training goes on in
        place)."""
        return {n: to_numpy(v).copy() for n, v in self.scope.items()}

    def state_dict(self, mode: str = "all") -> Dict[str, np.ndarray]:
        d = self.parameters_numpy()
        d.update({n: to_numpy(v).copy() for n, v in self.buffers.items()})
        return d

    def set_state_dict(self, state: Dict[str, Any]):
        """Copy ``state`` (name → array or tensor) into the scope and the
        buffers of those names, in place, each value cast to its target's
        dtype."""
        with torch.no_grad():
            for n, v in state.items():
                tgt = self.scope.get(n)
                if tgt is None:
                    tgt = self.buffers.get(n)
                if tgt is not None:
                    tgt.copy_(numpy_to_tensor(v).to(tgt.dtype))

    def clone(self, for_test: bool = False) -> "Program":
        """The 1.x test clone: it shares the parameters and records the
        same ops, never runs the optimizer and never writes its buffers
        back (frozen BatchNorm statistics)."""
        if not for_test:
            raise InvalidArgumentError(
                "Program.clone(for_test=False) would need desc copying; "
                "build a second program under program_guard instead")
        p = copy.copy(self)
        p._optimizer, p._loss_name, p._opt_state = None, None, None
        p._minimize_only = None
        p._is_test_clone = True
        # the op LIST is a snapshot (ops recorded on the original later do
        # not replay here) and the idx is fresh (runners are keyed on it);
        # vars and scope stay shared, as 1.x test clones share parameters
        p.ops = list(self.ops)
        Program._counter += 1
        p.idx = Program._counter
        return p

    def _bind_optimizer(self, optimizer, loss_name: str, only=None):
        """Bind ``optimizer`` and the loss to this program (``minimize``);
        ``only``: the names of the parameters it updates (None: every
        trainable one).  The state is built anew on the next run, and the
        version bump drops the runners captured against the old one."""
        self._optimizer, self._loss_name = optimizer, loss_name
        self._opt_state, self._minimize_only = None, only
        self._version += 1

    def _trainable(self) -> "OrderedDict[str, torch.Tensor]":
        """The parameters the bound optimizer updates (scope order)."""
        only = self._minimize_only
        return OrderedDict(
            (n, t) for n, t in self.scope.items()
            if self._param_trainable[n] and (only is None or n in only))

    def _ensure_opt_state(self):
        if self._opt_state is None:
            self._opt_state = self._optimizer.init(self._trainable())
            self._opt_device = self._placement["device"]
        return self._opt_state

    def _reinitialize(self):
        """Copy the initial values back into the scope and the buffers,
        and the optimizer's initial state into its state: in place."""
        with torch.no_grad():
            for n, host in self._init_values.items():
                tgt = self.scope.get(n)
                if tgt is None:
                    tgt = self.buffers[n]
                tgt.copy_(host)
            if self._opt_state is not None:
                _copy_into(self._opt_state,
                           self._optimizer.init(self._trainable()))

    def _to_device(self, device: torch.device):
        """Move the scope, the buffers and the optimizer state to
        ``device`` where they are elsewhere (new storage: counted in
        ``_placement["moves"]``, which keys the runners)."""
        pl = self._placement
        if pl["device"] != device:
            moved = False
            from ..nn.layer import Parameter

            for n, t in self.scope.items():
                if t.device != device:
                    self.scope[n] = Parameter(t.detach().to(device), name=n,
                                              trainable=t.requires_grad)
                    moved = True
            for n, t in self.buffers.items():
                if t.device != device:
                    self.buffers[n] = t.detach().to(device)
                    moved = True
            pl["device"] = device
            pl["moves"] += moved
        if self._opt_state is not None and self._opt_device != device:
            self._opt_state = _state_to(self._opt_state, device)
            self._opt_device = device


def _state_to(tree, device):
    """An optimizer state tree with its tensors on ``device`` (a step
    count kept on the host, as gradient merge keeps one, stays there)."""
    if isinstance(tree, dict):
        return {k: _state_to(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.dim() > 0 \
            and tree.device != device:
        return tree.to(device)
    return tree


# -- default-program plumbing ------------------------------------------------
_state = threading.local()


def _progs():
    if not hasattr(_state, "main"):
        _state.main = Program()
        _state.startup = Program()
    return _state


def default_main_program() -> Program:
    return _progs().main


def default_startup_program() -> Program:
    return _progs().startup


def reset_default_programs():
    if hasattr(_state, "main"):
        del _state.main, _state.startup


@contextlib.contextmanager
def program_guard(main_program: Program,
                  startup_program: Optional[Program] = None):
    s = _progs()
    prev = (s.main, s.startup)
    s.main = main_program
    s.startup = startup_program if startup_program is not None else s.startup
    if startup_program is not None:
        # exe.run(startup) reinitializes THIS main's parameters even when
        # run outside the guard (the 1.x flow)
        startup_program._paired_main = main_program
    s.guard_depth = getattr(s, "guard_depth", 0) + 1
    try:
        yield
    finally:
        s.main, s.startup = prev
        s.guard_depth -= 1


_static_mode = False


def set_static_mode(on: bool) -> None:
    global _static_mode
    _static_mode = bool(on)


def static_mode_enabled() -> bool:
    return _static_mode


def enable_static():
    """Enter 1.x graph-building mode: ``static.data`` returns graph
    Variables and builders record into the default Program
    (``program_guard`` works without it too)."""
    set_static_mode(True)


def disable_static(place=None):
    """Leave graph-building mode (a no-op when it was never entered)."""
    set_static_mode(False)


def in_dygraph_mode() -> bool:
    """Parity: ``paddle.in_dygraph_mode`` — True unless ``enable_static()``
    switched the process into graph-building mode."""
    return not _static_mode


def in_program_guard() -> bool:
    """True inside ``program_guard`` or after ``enable_static()``."""
    return _static_mode or getattr(_progs(), "guard_depth", 0) > 0


def in_graph_mode(*values) -> bool:
    """True if any leaf of ``values`` is a symbolic Variable."""
    return any(isinstance(leaf, Variable) for leaf in _leaves(values))


# -- recording ---------------------------------------------------------------
_device_state = threading.local()


def current_device() -> torch.device:
    """The device of the replay in progress ("meta" while a recorded
    function is probed for shapes): where an op with no tensor input makes
    its tensors."""
    return getattr(_device_state, "device", None) or torch.device("cpu")


@contextlib.contextmanager
def _on_device(device):
    prev = getattr(_device_state, "device", None)
    _device_state.device = torch.device(device)
    try:
        yield
    finally:
        _device_state.device = prev


def _meta(x):
    """A Variable (batch dims probed as 1) or a tensor as a meta tensor."""
    if isinstance(x, Variable):
        return torch.empty(tuple(1 if d is None else d for d in x.shape),
                           dtype=x.dtype, device="meta")
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta")
    return x


def record_call(fn: Callable, *args, out_names: Optional[Sequence[str]] = None,
                n_out: Optional[int] = None, prefix: str = "tmp",
                param_names=(), buffer_names=(), writes_buffers=False,
                scoped: Optional[bool] = None, **kwargs):
    """Append ``fn(*args, **kwargs)`` to the current program and return its
    symbolic output Variable(s).  Output shapes and dtypes come from
    ``fn`` run on meta tensors (batch dims as 1), the shape inference the
    run will see."""
    prog = default_main_program()
    _scoped = bool(param_names or buffer_names) if scoped is None else scoped
    with torch.no_grad(), _on_device("meta"):
        m_args = _tree_map(_meta, args)
        m_kwargs = _tree_map(_meta, kwargs)
        if _scoped:  # layer-backed / control-flow op convention
            pv = {n: _meta(prog.scope[n]) for n in param_names}
            bv = {n: _meta(prog.buffers[n]) for n in buffer_names}
            out = fn(pv, bv, *m_args, training=False, **m_kwargs)
        else:
            out = fn(*m_args, **m_kwargs)
    if writes_buffers:  # fn returns (out, new_buffers) — drop for shapes
        out = out[0]
    single = not isinstance(out, (tuple, list))
    probes = [out] if single else list(out)
    for o in probes:
        if not isinstance(o, torch.Tensor):
            raise InvalidArgumentError(
                f"record_call({getattr(fn, '__name__', fn)!r}): a recorded "
                f"function must return tensors, got {type(o).__name__}")
    if out_names is None:
        out_names = [prog.unique_name(prefix) for _ in probes]
    outs = []
    for name, o in zip(out_names, probes):
        v = Variable(prog, name, tuple(o.shape), o.dtype)
        prog.add_var(v)
        outs.append(v)
    prog.append_op(Op(fn, args, kwargs, list(out_names), single,
                      param_names, buffer_names, writes_buffers,
                      scoped=_scoped))
    return outs[0] if single else tuple(outs)


def maybe_record(fn: Callable):
    """Wrap an eager function: called with symbolic Variables it records
    into the current program, with tensors it runs."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if in_graph_mode(args, kwargs):
            return record_call(fn, *args, **kwargs)
        return fn(*args, **kwargs)

    return wrapped


def data(name: str, shape, dtype="float32", lod_level: int = 0) -> Variable:
    """``fluid.data`` / ``static.data``: a feed slot; a dim of -1 / None
    is set by the feed at run time."""
    prog = default_main_program()
    v = Variable(prog, name, shape, dtype)
    prog.add_var(v)
    return v


# -- execution ---------------------------------------------------------------
def run_ops(ops, env: Dict[str, Any], params: Dict[str, Any],
            buffers: Dict[str, Any], training: bool) -> None:
    """Play a recorded op list against a name environment (fills ``env``;
    ``buffers`` takes the buffers ops write)."""

    def subst(x):
        if isinstance(x, Variable):
            if x.name in env:
                return env[x.name]
            if x.name in params:
                return params[x.name]
            raise NotFoundError(
                f"Variable {x.name!r} used before produced — was it "
                f"created under a different program_guard, or is a feed "
                f"missing?")
        return x

    for op in ops:
        args = _tree_map(subst, op.args)
        kwargs = _tree_map(subst, op.kwargs)
        if op.scoped:
            pv = {n: params[n] for n in op.param_names}
            bv = {n: buffers[n] for n in op.buffer_names}
            out = op.fn(pv, bv, *args, training=training, **kwargs)
        else:
            out = op.fn(*args, **kwargs)
        if op.writes_buffers:
            out, nb = out
            buffers.update(nb)
        if op.single:
            env[op.out_names[0]] = out
        else:
            for n, o in zip(op.out_names, out):
                env[n] = o


class _CompileCache:
    """LRU-bounded map: run signature → runner (for ``run_steps``, the
    runner holds its captured CUDA graphs).  Unbounded, every distinct
    feed geometry would pin its graphs forever; churning, every run would
    capture again.  Hit / miss / eviction counters are on
    ``Executor.cache_stats()``."""

    def __init__(self, capacity: int):
        self.capacity = max(int(capacity), 1)
        self._entries: "OrderedDict[Tuple, Callable]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, sig) -> Optional[Callable]:
        runner = self._entries.get(sig)
        if runner is None:
            self.misses += 1
            return None
        self.hits += 1
        self._entries.move_to_end(sig)
        return runner

    def put(self, sig, runner) -> None:
        self._entries[sig] = runner
        self._entries.move_to_end(sig)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1

    def stats(self) -> Dict[str, int]:
        return {"capacity": self.capacity, "size": len(self._entries),
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}

    def clear(self) -> None:
        self._entries.clear()


def _names(vs) -> List[str]:
    return [v.name if isinstance(v, Variable) else str(v) for v in vs]


def _feed_sig(vals: Dict[str, torch.Tensor], lead: int = 0) -> tuple:
    return tuple(sorted((k, tuple(v.shape[lead:]), v.dtype)
                        for k, v in vals.items()))


class Executor:
    """Runs recorded Programs on a place (``None``: the card).

    ``run(program, feed, fetch_list)``: one replay of the ops; with an
    optimizer bound by ``minimize``, one training step (the gradient of
    the loss for the trainable parameters, then the optimizer's update).
    ``run_steps(program, feed, fetch_list, iterations=N,
    fetch_every=k)``: N chained optimizer steps in one call (one CUDA
    graph replay on the card once captured).  Runners are cached per
    (program version, feed signature, fetch set, mode) in a bounded LRU
    (capacity ``FLAGS_executor_cache_capacity`` or ``cache_capacity``;
    counters on :meth:`cache_stats`).  ``strategy``: an
    ``ExecutionStrategy``, whose ``num_iteration_per_run > 1`` is
    ``run_steps``'s default chain length."""

    def __init__(self, place=None, strategy=None,
                 cache_capacity: Optional[int] = None):
        self.place = place
        self.device = place_device(place)
        self.strategy = strategy
        if cache_capacity is None:
            from ..framework.flags import flag

            cache_capacity = flag("executor_cache_capacity")
        self._cache = _CompileCache(cache_capacity)
        self.dispatches = 0  # one per run / run_steps call

    def close(self):
        self._cache.clear()

    def cache_stats(self) -> Dict[str, int]:
        """Runner-cache counters plus the dispatch count."""
        s = self._cache.stats()
        s["dispatches"] = self.dispatches
        return s

    def _upload(self, v) -> torch.Tensor:
        if isinstance(v, torch.Tensor) and v.device == self.device:
            return v
        if not isinstance(v, torch.Tensor):
            v = numpy_to_tensor(v)
        return upload(v, self.device)

    # -- one step ------------------------------------------------------------
    def _replay(self, program, feeds, training, buffers):
        env: Dict[str, Any] = dict(feeds)
        with _on_device(self.device):
            run_ops(program.ops, env, program.scope, buffers, training)
        return env

    def _train_step(self, program, feeds, plan, training, fetch_names):
        """One optimizer step on ``feeds`` with the step's host half
        ``plan``; returns the fetched tensors."""
        params = program._trainable()
        with torch.enable_grad():
            env = self._replay(program, feeds, training, program.buffers)
            loss = env[program._loss_name].float().sum()
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
        # a parameter the loss does not reach gets a zero gradient, as
        # jax.grad gives it (its optimizer slots still decay)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), grads)}
        program._optimizer._apply(grads, program._opt_state, params,
                                  plan=plan)
        return [env[n].detach() for n in fetch_names]

    def _build(self, program, fetch_names, train, training):
        if train:
            opt = program._optimizer

            def runner(prog, feeds):
                state = prog._ensure_opt_state()
                plan = opt._plan(state, opt.get_lr())
                out = self._train_step(prog, feeds, plan, training,
                                       fetch_names)
                if opt.lr_scheduler is not None:
                    opt.lr_scheduler.step()
                return out

            return runner

        def runner(prog, feeds):
            # a test clone's buffers stay frozen: the ops write copies
            buffers = ({n: b.clone() for n, b in prog.buffers.items()}
                       if prog._is_test_clone else prog.buffers)
            with torch.no_grad():
                env = self._replay(prog, feeds, training, buffers)
            return [env[n] for n in fetch_names]

        return runner

    def run(self, program: Optional[Program] = None, feed=None,
            fetch_list=None, scope=None, return_numpy: bool = True,
            use_program_cache: bool = True, training: Optional[bool] = None):
        program = program or default_main_program()
        if not program.ops:
            # a startup program (re)initializes its paired main program
            # (builders register parameters on the MAIN program) and puts
            # its scope on this Executor's place
            program._reinitialize()
            target = getattr(program, "_paired_main", None)
            if target is None and program is default_startup_program():
                target = _progs().main
            if target is not None:
                target._reinitialize()
                target._to_device(self.device)
            return []
        fetch_names = _names(fetch_list or [])
        train = program._optimizer is not None
        training = train if training is None else bool(training)
        program._to_device(self.device)
        feeds = {k: self._upload(v) for k, v in dict(feed or {}).items()}
        sig = (program.idx, program._version, program._placement["moves"],
               train, training, tuple(fetch_names), _feed_sig(feeds))
        runner = self._cache.get(sig) if use_program_cache else None
        if runner is None:
            runner = self._build(program, fetch_names, train, training)
            if use_program_cache:
                self._cache.put(sig, runner)
        outs = runner(program, feeds)
        self.dispatches += 1
        if return_numpy:
            outs = [to_numpy(o) for o in outs]
        return outs

    # -- fused multi-step execution -----------------------------------------
    def run_steps(self, program: Optional[Program] = None, feed=None,
                  fetch_list=None, iterations: Optional[int] = None,
                  fetch_every: int = 1, constant_feeds=(),
                  return_numpy: bool = True, training: Optional[bool] = None,
                  use_program_cache: bool = True):
        """Chain N optimizer steps in one call.

        ``feed`` is a dict of batch-stacked ("superbatch") arrays — each
        feed not named in ``constant_feeds`` carries a leading
        ``iterations`` axis — or an iterator of per-step feed dicts
        (stacked on the host here).  ``constant_feeds`` names feeds held
        fixed across the chain, passed unstacked.  ``iterations`` defaults
        to the stacked leading dim, or to the bound
        ``ExecutionStrategy.num_iteration_per_run`` when > 1.  The
        learning rate of each step is the scheduler's after the steps
        before it (the scheduler is stepped once a step, as N ``run``
        calls step it).  ``fetch_every=k`` keeps every k-th step's
        fetches.  Returns one array per fetch with a leading
        ``N // fetch_every`` axis.

        On a CUDA card the first call of a signature runs the N steps
        eagerly and every later one replays a CUDA graph of them; a
        capture or replay that fails raises.
        """
        program = program or default_main_program()
        if program._optimizer is None:
            raise InvalidArgumentError(
                "run_steps chains optimizer steps: bind one via "
                "optimizer.minimize(loss) first (for eval loops, call "
                "run() per batch)")
        if not program.ops:
            raise InvalidArgumentError("run_steps on an empty program")
        fetch_names = _names(fetch_list or [])
        training = True if training is None else bool(training)
        fetch_every = int(fetch_every)
        if fetch_every < 1:
            raise InvalidArgumentError("fetch_every must be >= 1")
        constant = set(_names(constant_feeds or ()))

        if iterations is None and self.strategy is not None:
            n = int(getattr(self.strategy, "num_iteration_per_run", 1) or 1)
            if n > 1:
                iterations = n

        if feed is None:
            feed = {}
        if not isinstance(feed, dict):
            # an iterator / sequence of per-step feed dicts: stack on host
            steps = list(itertools.islice(iter(feed), iterations)
                         if iterations is not None else iter(feed))
            if not steps:
                raise InvalidArgumentError("run_steps: empty feed iterator")
            iterations = len(steps)
            feed = {k: (steps[0][k] if k in constant
                        else np.stack([to_numpy(s[k]) for s in steps], 0))
                    for k in steps[0]}

        program._to_device(self.device)
        const_vals = {k: self._upload(v) for k, v in feed.items()
                      if k in constant}
        stacked_vals = {k: self._upload(v) for k, v in feed.items()
                        if k not in constant}
        if iterations is None:
            if not stacked_vals:
                raise InvalidArgumentError(
                    "run_steps needs iterations=N when every feed is "
                    "constant (nothing to infer the chain length from)")
            iterations = int(next(iter(stacked_vals.values())).shape[0])
        n_steps = int(iterations)
        if n_steps < 1:
            raise InvalidArgumentError("run_steps needs iterations >= 1")
        for k, v in stacked_vals.items():
            if v.dim() < 1 or int(v.shape[0]) != n_steps:
                raise InvalidArgumentError(
                    f"run_steps: stacked feed {k!r} has leading dim "
                    f"{tuple(v.shape[:1])}, expected iterations={n_steps} — "
                    f"stack per-step batches along a new axis 0, or list it "
                    f"in constant_feeds")

        s_names, c_names = sorted(stacked_vals), sorted(const_vals)
        sig = (program.idx, "run_steps", program._version,
               program._placement["moves"], n_steps, training,
               tuple(fetch_names), _feed_sig(stacked_vals, 1),
               _feed_sig(const_vals))
        runner = self._cache.get(sig) if use_program_cache else None
        if runner is None:
            runner = self._build_steps(program, s_names + c_names,
                                       fetch_names, training, n_steps)
            if use_program_cache:
                self._cache.put(sig, runner)

        opt = program._optimizer
        sched = opt.lr_scheduler
        state = program._ensure_opt_state()
        plans = []
        for _ in range(n_steps):  # the N steps' host halves, in order
            plans.append(opt._plan(state, opt.get_lr()))
            if sched is not None:
                sched.step()
        outs = runner.run([stacked_vals[k] for k in s_names], plans,
                          const=[const_vals[k] for k in c_names])
        self.dispatches += 1
        if fetch_every > 1:
            outs = [o[fetch_every - 1::fetch_every] for o in outs]
        if return_numpy:
            outs = [to_numpy(o) for o in outs]
        return list(outs)

    def _build_steps(self, program, feed_names, fetch_names, training,
                     n_steps):
        from ..hapi._graph_step import GraphSteps

        def step(inputs, plan):
            return tuple(self._train_step(
                program, dict(zip(feed_names, inputs)), plan, training,
                fetch_names))

        return GraphSteps(n_steps, step, self.device)
