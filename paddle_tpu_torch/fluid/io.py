"""paddle.fluid.io — 1.x persistence (port of ``paddle_tpu.fluid.io``).

``save_persistables`` / ``save_params`` / ``save_vars`` write the
reference's binary format (``framework.paddle_format``: LoDTensor
streams, a sorted-name combined file with ``filename``, a ``__model__``
ProgramDesc) that the JAX package reads too, from a ``Program``'s scope
and buffers (the 1.x flow), a Layer or a ``{name: array}`` dict;
``load_persistables`` / ``load_params`` / ``load_vars`` read it back into
a Program (exact names first, then names without their per-Program
``_<idx>_`` prefix, so a checkpoint loads into an identically built fresh
Program) or a Layer.  ``save`` / ``load`` (the 2.x checkpoint format),
``DataLoader`` and the static inference names are re-exported; the 1.x
reader decorators raise ``UnimplementedError`` naming ROADMAP queue A's
static graph and the long tail.
"""
from __future__ import annotations

import re

from ..framework.dtype import to_numpy
from ..framework.errors import InvalidArgumentError, NotFoundError
from ..framework.paddle_format import (adapt_state_dict,
                                       load_reference_state_dict,
                                       save_reference_state)
from ..framework.serialization import load, save  # noqa: F401
from ..io import DataLoader  # noqa: F401
from ..static import (  # noqa: F401
    load_inference_model, load_program_state, save_inference_model,
    set_program_state,
)
from ..static.builders import unported as _unported

_ITEM8 = "static graph and the long tail"
for _name in ("cache", "map_readers", "buffered", "compose", "chain",
              "shuffle", "firstn", "xmap_readers", "multiprocess_reader",
              "batch"):
    globals()[_name] = _unported(f"fluid.io.{_name}", _ITEM8)
del _name


def _resolve_state(main_program, params_only: bool):
    """The state of a Program (its scope, and its buffers unless
    ``params_only``), a Layer, or a ``{name: array}`` dict: name → tensor
    or array."""
    from ..nn import Layer
    from ..static.graph import Program, default_main_program

    if main_program is None:
        main_program = default_main_program()
    if isinstance(main_program, Program):
        state = dict(main_program.scope)
        if not params_only:
            state.update(main_program.buffers)
        return state
    if isinstance(main_program, Layer):
        if params_only:
            return dict(main_program.named_parameters())
        return dict(main_program.state_dict())
    if isinstance(main_program, dict):
        return dict(main_program)
    raise InvalidArgumentError(
        "main_program must be a static Program, a Layer, or a "
        f"{{name: array}} dict, got {type(main_program).__name__}")


def save_persistables(executor, dirname, main_program=None, filename=None):
    """Every persistable (parameters and buffers) in the reference format:
    a file a variable, or one combined file when ``filename`` is given."""
    save_reference_state(_resolve_state(main_program, params_only=False),
                         dirname, filename=filename)


def save_params(executor, dirname, main_program=None, filename=None):
    """The parameters only."""
    save_reference_state(_resolve_state(main_program, params_only=True),
                         dirname, filename=filename)


class _VarView:
    """What a ``save_vars`` / ``load_vars`` predicate receives: the
    Variable attributes 1.x predicates read."""

    __slots__ = ("name", "shape", "persistable")

    def __init__(self, name, value):
        self.name = name
        self.shape = tuple(value.shape)
        self.persistable = True


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """An explicit variable list (names or Variables), filtered by
    ``predicate``."""
    state = _resolve_state(main_program, params_only=False)
    if vars is not None:
        names = [v if isinstance(v, str) else v.name for v in vars]
        missing = [n for n in names if n not in state]
        if missing:
            raise NotFoundError(f"save_vars: no such variables {missing}")
        state = {n: state[n] for n in names}
    if predicate is not None:
        state = {n: v for n, v in state.items()
                 if predicate(_VarView(n, v))}
    save_reference_state(state, dirname, filename=filename)


def _adapt_program_names(sd, program, partial: bool = False):
    """Checkpoint names onto ``program``'s: exact names first, then by the
    name without its per-Program ``_<idx>_`` prefix (the builders' order
    is deterministic, so those are unique a Program).  An entry that maps
    nowhere raises, unless ``partial`` (``load_vars``' explicit
    subsets)."""
    def strip(n):
        return re.sub(r"^_\d+_", "", n)

    by_stripped = {}
    for n in list(program.scope) + list(program.buffers):
        by_stripped.setdefault(strip(n), []).append(n)
    out, dropped = {}, []
    for n, v in sd.items():
        if n in program.scope or n in program.buffers:
            out[n] = v
            continue
        cands = by_stripped.get(strip(n), [])
        if len(cands) == 1:
            out[cands[0]] = v
        else:
            dropped.append(n)
    if dropped and not partial:
        raise InvalidArgumentError(
            f"checkpoint variables {dropped[:5]}"
            f"{'…' if len(dropped) > 5 else ''} have no (unique) "
            "counterpart in the target Program — was it built "
            "differently? (load_vars with an explicit list allows "
            "partial restores)")
    return out


def _load_state(sd, main_program, partial):
    from ..nn import Layer
    from ..static.graph import Program, default_main_program

    target = main_program if main_program is not None \
        else default_main_program()
    if isinstance(target, Program):
        target.set_state_dict(_adapt_program_names(sd, target, partial))
    elif isinstance(target, Layer):
        target.set_state_dict(sd if partial else adapt_state_dict(
            {n: to_numpy(v) for n, v in sd.items()}, target))
    else:
        raise InvalidArgumentError(
            "load target must be a static Program or a Layer")
    return sd


def load_persistables(executor, dirname, main_program=None, filename=None):
    """Read a reference-format checkpoint back into the Program / Layer
    (in place: a captured graph over the scope stays valid)."""
    sd = load_reference_state_dict(dirname, params_filename=filename)
    return _load_state(sd, main_program, partial=False)


def load_params(executor, dirname, main_program=None, filename=None):
    return load_persistables(executor, dirname, main_program, filename)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """An explicit subset (names or Variables, filtered by
    ``predicate``); exact names onto a Layer."""
    sd = load_reference_state_dict(dirname, params_filename=filename)
    if vars is not None:
        names = [v if isinstance(v, str) else v.name for v in vars]
        missing = [n for n in names if n not in sd]
        if missing:
            raise NotFoundError(
                f"load_vars: checkpoint at {dirname!r} has no variables "
                f"{missing}")
        sd = {n: sd[n] for n in names}
    if predicate is not None:
        sd = {n: v for n, v in sd.items() if predicate(_VarView(n, v))}
    return _load_state(sd, main_program, partial=True)
