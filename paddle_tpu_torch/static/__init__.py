"""paddle.static — the static-graph surface (port of ``paddle_tpu.static``).

The 1.x build / run flow is ported (``static/graph.py``,
``static/builders.py``): ``Program``, ``program_guard``, ``data``, the
builders of ``static.nn``, ``optimizer.minimize``, ``Executor.run`` /
``run_steps`` and ``Program.clone(for_test=True)``.  Beside them:
``InputSpec``, ``cpu_places`` / ``cuda_places``, ``name_scope``, the
``BuildStrategy`` / ``ExecutionStrategy`` knob bags, ``Scope`` /
``global_scope`` / ``scope_guard``, ``CompiledProgram``,
``create_parameter`` / ``create_global_var``, and ``save`` / ``load`` /
``load_program_state`` / ``set_program_state`` in the JAX package's file
format (``framework/serialization.py``).

``save_inference_model`` / ``load_inference_model`` are the eager forms
over ``paddle_tpu_torch.inference`` (a ``torch.export`` artifact), and
``make_symbols`` gives an export's dynamic dims as ``torch.export.Dim``s
of one scope.

Not ported yet, each raising ``UnimplementedError`` naming ROADMAP queue
A, static graph and the long tail: ``py_func``, ``Print``,
``ParallelExecutor``, ``append_backward`` / ``gradients`` and
``WeightNormParamAttr``.
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional, Sequence

import torch

from ..framework.dtype import convert_dtype, numpy_to_tensor, to_numpy
from ..framework.errors import InvalidArgumentError
from .builders import unported
from .graph import (  # noqa: F401
    Executor, Program, Variable, default_main_program,
    default_startup_program, program_guard, reset_default_programs,
)

__all__ = [
    "append_backward", "gradients", "Executor", "global_scope",
    "scope_guard", "BuildStrategy", "CompiledProgram", "Print", "py_func",
    "ExecutionStrategy", "name_scope", "ParallelExecutor", "program_guard",
    "WeightNormParamAttr", "default_main_program",
    "default_startup_program", "Program", "data", "InputSpec", "save",
    "load", "save_inference_model", "load_inference_model",
    "load_program_state", "set_program_state", "cpu_places", "cuda_places",
    "Variable", "Scope", "create_parameter", "create_global_var",
    "make_symbols", "nn",
]


class InputSpec:
    """Declarative (shape, dtype, name) signature of a model input;
    ``None`` / ``-1`` dims are dynamic, a string dim is a named symbolic
    size (as in the JAX package)."""

    def __init__(self, shape: Sequence[Optional[int]], dtype="float32",
                 name: Optional[str] = None):
        self.shape = tuple(
            d if isinstance(d, str)
            else None if d in (None, -1)
            else int(d)
            for d in shape)
        self.dtype = convert_dtype(dtype)
        self.name = name

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name!r})")

    @classmethod
    def from_tensor(cls, tensor, name: Optional[str] = None) -> "InputSpec":
        t = tensor if isinstance(tensor, torch.Tensor) \
            else numpy_to_tensor(tensor)
        return cls(tuple(t.shape), t.dtype, name)

    def symbol_names(self):
        """One symbol name per dynamic dim: the declared name for a string
        dim, a generated one for None."""
        out = []
        for i, d in enumerate(self.shape):
            if isinstance(d, str):
                out.append(d)
            elif d is None:
                out.append(f"d_{self.name or 'in'}_{i}".replace("-", "_"))
        return out

    def dynamic_shape(self, symbols=None) -> dict:
        """``{axis: torch.export.Dim}`` of the dynamic dims — the export's
        ``dynamic_shapes`` entry of this input (the JAX ``shape_dtype``'s
        symbolic half).  ``symbols`` maps symbol name → Dim; every dynamic
        dim of a multi-input export must come from ONE :func:`make_symbols`
        call, so that two specs reusing a name share that size.  With
        ``symbols=None`` a private scope is made for this spec alone."""
        if symbols is None:
            symbols = make_symbols([self])
        names = iter(self.symbol_names())
        return {i: symbols[next(names)] for i, d in enumerate(self.shape)
                if not isinstance(d, int)}


def make_symbols(specs) -> dict:
    """Every dynamic dim of ``specs`` as a ``torch.export.Dim`` of one
    shared scope: ``{symbol name: Dim}``, one Dim per distinct name, so two
    specs that reuse a name share that size (the JAX package's
    ``jax.export.symbolic_shape`` scope).  A dynamic size is at least 1."""
    names = []
    for s in specs:
        for n in s.symbol_names():
            if n not in names:
                names.append(n)
    for n in names:
        if not n.isidentifier():
            raise InvalidArgumentError(
                f"symbolic dim name {n!r} is not an identifier")
    return {n: torch.export.Dim(n, min=1) for n in names}


def data(name, shape, dtype="float32", lod_level=0):
    """Declare a feed slot (ref: static/input.py data): under
    ``program_guard`` or after ``enable_static()`` a graph Variable of
    the default Program, else the slot's ``InputSpec``."""
    from .graph import data as _gdata, in_program_guard

    if in_program_guard():
        return _gdata(name, shape, dtype or "float32")
    return InputSpec(shape, dtype or "float32", name)


def cpu_places(device_count=None):
    """CPU places (ref: fluid/framework.py cpu_places); the count defaults
    to ``CPU_NUM`` or 1."""
    from ..framework.device import CPUPlace

    if device_count is None:
        device_count = int(os.environ.get("CPU_NUM", "1"))
    return [CPUPlace() for _ in range(device_count)]


def cuda_places(device_ids=None):
    """The visible cards' places (ref: fluid/framework.py cuda_places);
    ``device_ids`` defaults to every visible card."""
    from ..framework.device import CUDAPlace

    if device_ids is None:
        device_ids = range(torch.cuda.device_count())
    return [CUDAPlace(int(i)) for i in device_ids]


@contextlib.contextmanager
def name_scope(prefix=None):
    """Parity: fluid/framework.py:5616 name_scope — a debugging aid that
    prefixed op names; the recorded ops here are not named by it."""
    yield


class BuildStrategy:
    """Pass-tuning knob bag (ref: framework/details/build_strategy.h:50):
    the knobs are accepted and recorded but decide nothing; a knob never
    written reads the reference default."""

    _DEFAULTS = {
        "debug_graphviz_path": "",
        "enable_sequential_execution": False,
        "remove_unnecessary_lock": True,
        "fuse_elewise_add_act_ops": False,
        "fuse_bn_act_ops": False,
        "fuse_relu_depthwise_conv": False,
        "fuse_broadcast_ops": False,
        "fuse_all_optimizer_ops": False,
        "fuse_all_reduce_ops": False,
        "sync_batch_norm": False,
        "memory_optimize": False,
        "enable_inplace": True,
        "cache_runtime_context": False,
        "enable_backward_optimizer_op_deps": True,
        "trainer_id": 0,
        "num_trainers": 1,
        "use_hierarchical_allreduce": False,
        "hierarchical_allreduce_inter_nranks": 0,
        "gradient_scale_strategy": 0,
        "reduce_strategy": 0,
        "build_cinn_pass": False,
    }

    def __init__(self):
        self.__dict__["_opts"] = dict(self._DEFAULTS)

    def __setattr__(self, k, v):
        self._opts[k] = v

    def __getattr__(self, k):
        try:
            return self.__dict__["_opts"][k]
        except KeyError:
            raise AttributeError(k)


class ExecutionStrategy(BuildStrategy):
    """Executor knob bag (ref: details/execution_strategy.h:22), inert but
    for ``num_iteration_per_run``: > 1, passed as ``Executor(strategy=)``,
    it is the default chain length of ``Executor.run_steps``."""

    _DEFAULTS = {
        "num_threads": 0,
        "use_cuda": False,
        "allow_op_delay": False,
        "num_iteration_per_drop_scope": 100,
        "num_iteration_per_run": 1,
        "use_thread_barrier": False,
    }


class Scope:
    """The variable store of a Program (ref: fluid/executor.py
    global_scope): here the store is ``program.scope`` and
    ``program.buffers``; this view serves the ``find_var(name)
    .get_tensor()`` reading idiom."""

    def __init__(self, program=None):
        self._program = program

    class _Var:
        def __init__(self, value):
            self._value = value

        def get_tensor(self):
            return to_numpy(self._value)

    def find_var(self, name):
        prog = self._program or default_main_program()
        if name in prog.scope:
            return Scope._Var(prog.scope[name])
        if name in prog.buffers:
            return Scope._Var(prog.buffers[name])
        return None

    def var_names(self):
        prog = self._program or default_main_program()
        return list(prog.scope) + list(prog.buffers)


def global_scope() -> Scope:
    return Scope()


@contextlib.contextmanager
def scope_guard(scope):
    """Accepted for parity: programs own their scopes, so the guard has
    nothing to swap."""
    yield scope


def CompiledProgram(program, build_strategy=None):
    """ref: compiler.py CompiledProgram — the Executor prepares a program
    itself, so the 'compiled' program is the program."""
    return program


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """A parameter (ref: fluid/layers/tensor.py:75) of ``shape`` /
    ``dtype`` filled by ``attr``'s initializer, else
    ``default_initializer``, else zeros for a bias and Xavier-normal
    otherwise: an ``nn.Parameter``, or under ``program_guard`` a trainable
    parameter of the Program's scope (its Variable), as 1.x builds one
    (the JAX package returns the eager box there, which its graph holds as
    a constant)."""
    from ..nn.initializer import ParamAttr, build_parameter
    from .graph import default_main_program, in_program_guard

    if attr is None and name is not None:
        attr = ParamAttr(name=name)
    p = build_parameter(shape, dtype, attr, is_bias, default_initializer)
    if p is None or not in_program_guard():
        return p
    prog = default_main_program()
    return prog.register_param(prog.unique_name(name or "create_parameter"),
                               p, trainable=p.requires_grad)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A 'global variable': a named non-trainable parameter filled with
    ``value`` (ref: fluid/layers/tensor.py create_global_var)."""
    t = torch.full(tuple(int(d) for d in shape), value,
                   dtype=convert_dtype(dtype))
    from ..nn.layer import Parameter

    return Parameter(t, name=name or "", trainable=False)


def save(program, model_path, protocol=4, **configs):
    """Write the program's parameters and buffers to
    ``<model_path>.pdparams`` (ref: static/io.py save), in the JAX
    package's checkpoint format: ``{name: array}``."""
    from ..framework.serialization import save as _save

    path = model_path if model_path.endswith(".pdparams") \
        else model_path + ".pdparams"
    _save(program.state_dict(), path, protocol=protocol)


def load_program_state(model_path, var_list=None):
    """``{name: numpy}`` of a checkpoint written by :func:`save` (either
    package's; ref: fluid/io.py:1730).  ``var_list`` (Variables or names)
    keeps only those."""
    from ..framework.serialization import load as _load

    path = model_path
    if not os.path.isfile(path) and not path.endswith(".pdparams"):
        path = path + ".pdparams"
    state = _load(path)
    keep = None if var_list is None else {
        getattr(v, "name", v) for v in var_list}
    return {k: v for k, v in state.items() if keep is None or k in keep}


def set_program_state(program, state):
    """Copy a state dict into the program's parameters and buffers
    (ref: io.py set_program_state)."""
    program.set_state_dict(state)


def load(program, model_path, executor=None, var_list=None):
    """Read a checkpoint written by :func:`save` into ``program`` (ref:
    static/io.py load)."""
    state = load_program_state(model_path, var_list)
    missing = [n for n in program.scope if n not in state]
    if var_list is None and missing:
        raise InvalidArgumentError(
            f"static.load: {model_path} lacks {len(missing)} parameters of "
            f"the program, e.g. {missing[:3]}")
    set_program_state(program, state)


def save_inference_model(path_prefix, feed_vars, fetch_vars=None,
                         executor=None, **kwargs):
    """Ref: fluid/io.py:1164.  Eager form: ``feed_vars`` is the Layer and
    ``fetch_vars`` its InputSpecs (the Program / Executor arguments of the
    reference have no meaning here), or the two the other way round —
    delegates to :func:`paddle_tpu_torch.inference.save_inference_model`
    (``kwargs`` may carry its ``platforms``)."""
    from ..inference import save_inference_model as _save

    if isinstance(feed_vars, torch.nn.Module):
        return _save(path_prefix, feed_vars, fetch_vars, **kwargs)
    if isinstance(fetch_vars, torch.nn.Module):  # (specs, layer) order
        return _save(path_prefix, fetch_vars, feed_vars, **kwargs)
    raise InvalidArgumentError(
        "static.save_inference_model(path, layer, input_specs): pass the "
        "eager Layer to export (no Program exists to save)")


def load_inference_model(path_prefix, executor=None, **kwargs):
    """Ref: fluid/io.py:1374 — the loaded ``inference.Predictor`` (the
    eager counterpart of (program, feed_names, fetch_names)); ``kwargs``
    may carry its ``device`` / ``params_file``."""
    from ..inference import Predictor

    return Predictor(path_prefix, **kwargs)


_ITEM8 = "static graph and the long tail"
py_func = unported("paddle.static.py_func", _ITEM8)
Print = unported("paddle.static.Print", _ITEM8)
ParallelExecutor = unported("paddle.static.ParallelExecutor", _ITEM8)
append_backward = unported("paddle.static.append_backward", _ITEM8)
gradients = unported("paddle.static.gradients", _ITEM8)
WeightNormParamAttr = unported("paddle.static.WeightNormParamAttr", _ITEM8)

from . import nn  # noqa: E402,F401  (the builders)
