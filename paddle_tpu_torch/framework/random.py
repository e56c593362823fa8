"""RNG seed management mapped onto ``torch.Generator``.

Parity with ``paddle.seed`` (reference: paddle/fluid/framework/generator.cc,
python/paddle/framework/random.py): one generator per device, all
reseeded by :func:`seed`.  Parameter initialization draws from an explicit
generator — the caller's, or the CPU one — on the CPU, so the same seed
gives the same weights whichever device the model then moves to.  Random
ops on a device's tensors (dropout) draw from :func:`generator_for` that
device; nothing in the port draws from torch's global RNG.  Inside an
:func:`scope` (``nn.rng_scope``) :func:`generator_for` answers with the
scope's generator instead, so the random ops there draw from it and leave
the device streams as they were.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict

import torch

__all__ = ["seed", "default_generator", "generator_for", "generators",
           "scope", "current_scope", "set_rank_coords", "rank_coords",
           "model_parallel_rng", "stream_seed", "derive_seed"]

_seed = 0
_default = torch.Generator().manual_seed(_seed)
_by_device: Dict[torch.device, torch.Generator] = {
    torch.device("cpu"): _default}
#: the model-parallel stream's generators, one a device
_model_by_device: Dict[torch.device, torch.Generator] = {}
#: this rank's (data x sharding index, model index, model axis size)
_coords = (0, 0, 1)
_lock = threading.Lock()
_MASK = (1 << 63) - 1
#: Megatron's offset of the model-parallel stream
_MODEL_OFFSET = 2718


def derive_seed(base: int, *parts: int) -> int:
    """A 63-bit seed mixed from ``base`` and ``parts`` (splitmix64 steps):
    the same numbers give the same seed in every process."""
    x = int(base) & ((1 << 64) - 1)
    for p in parts:
        x = (x + 0x9E3779B97F4A7C15 + (int(p) & ((1 << 64) - 1))) \
            & ((1 << 64) - 1)
        x ^= x >> 30
        x = (x * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
        x ^= x >> 27
        x = (x * 0x94D049BB133111EB) & ((1 << 64) - 1)
        x ^= x >> 31
    return x & _MASK


def stream_seed(stream: str = "replicated") -> int:
    """The seed of this rank's ``stream`` ("replicated" or "model") for
    the last :func:`seed`: the seed itself at data rank 0."""
    data, model, _ = _coords
    s = _seed if data == 0 else derive_seed(_seed, data)
    if stream == "model":
        s = derive_seed(s, _MODEL_OFFSET + model)
    return s


class _Scopes(threading.local):
    def __init__(self):
        self.stack = []
        self.model = 0


_scopes = _Scopes()


def _use_model_stream() -> bool:
    return _scopes.model > 0 and _coords[2] > 1


@contextlib.contextmanager
def model_parallel_rng():
    """Random ops inside the block draw from the model-parallel stream
    (Megatron's ``get_cuda_rng_tracker().fork()``): a column-parallel
    shard's dropout.  With a model axis of size 1 they draw from the
    replicated stream."""
    _scopes.model += 1
    try:
        yield
    finally:
        _scopes.model -= 1


class Scope:
    """The generators of one ``rng_scope``: ``key`` is a
    ``torch.Generator`` (used for its own device only) or an int seed (a
    generator a device, made on first use and seeded with it)."""

    def __init__(self, key):
        if isinstance(key, torch.Generator):
            self._gens = {torch.device(key.device): key}
            self._seed = None
        else:
            self._gens = {}
            self._seed = int(key)
        self._model_gens = {}

    def generator(self, device) -> torch.Generator:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if _use_model_stream() and self._seed is not None:
            # an int-seeded scope keeps a model-parallel stream too
            gen = self._model_gens.get(dev)
            if gen is None:
                gen = self._model_gens[dev] = torch.Generator(
                    device=dev).manual_seed(derive_seed(
                        self._seed, _MODEL_OFFSET + _coords[1]))
            return gen
        gen = self._gens.get(dev)
        if gen is None:
            if self._seed is None:
                from .errors import InvalidArgumentError

                raise InvalidArgumentError(
                    f"rng_scope's generator is on {next(iter(self._gens))}"
                    f"; a random op inside the scope draws on {dev} (pass "
                    f"a generator of that device, or an int seed)")
            gen = self._gens[dev] = torch.Generator(device=dev).manual_seed(
                self._seed)
        return gen


@contextlib.contextmanager
def scope(key):
    """Every :func:`generator_for` inside the block answers with a
    generator of ``key`` (see :class:`Scope`); yields the scope."""
    ctx = Scope(key)
    _scopes.stack.append(ctx)
    try:
        yield ctx
    finally:
        _scopes.stack.pop()


def current_scope():
    """The innermost active :class:`Scope`, or None."""
    return _scopes.stack[-1] if _scopes.stack else None


def default_generator() -> torch.Generator:
    """The CPU generator of parameter initialization (and of the CPU's
    random ops at data rank 0 and in one process)."""
    return _default


def generator_for(device) -> torch.Generator:
    """The generator of ``device`` — a tensor's ``.device`` (created on
    first use, seeded with the last :func:`seed`); a CUDA tensor needs a
    CUDA generator.  Inside :func:`scope`, the scope's generator."""
    if _scopes.stack:
        return _scopes.stack[-1].generator(device)
    dev = torch.device(device)
    model = _use_model_stream()
    table = _model_by_device if model else _by_device
    with _lock:
        gen = table.get(dev)
        if gen is None:
            gen = table[dev] = torch.Generator(device=dev).manual_seed(
                stream_seed("model" if model else "replicated"))
        return gen


def generators():
    """Every generator made so far (the CPU one, one per device used, and
    the model-parallel stream's)."""
    with _lock:
        return list(_by_device.values()) + list(_model_by_device.values())


def reseeds() -> int:
    """How many times the streams were reseeded (by :func:`seed` or new
    rank coordinates): a stream derived from them restarts when it
    changes."""
    return _reseeds[0]


_reseeds = [0]


def _reseed():
    """Reseed the rank's streams.  The CPU generator of parameter
    initialization is left as it is: :func:`seed` seeds it with the seed
    itself on every rank (equal weights, equal sampler orders), and new
    coordinates never rewind it, so ranks whose coordinates changed do
    not fall out of step with those whose did not.  Where the rank's
    replicated stream has another seed, the CPU's random ops draw from a
    CPU generator of their own."""
    _reseeds[0] += 1
    rep, mod = stream_seed("replicated"), stream_seed("model")
    cpu = torch.device("cpu")
    if rep == _seed:
        _by_device[cpu] = _default
    elif _by_device.get(cpu) is _default:
        _by_device[cpu] = torch.Generator()
    for gen in _by_device.values():
        if gen is not _default:
            gen.manual_seed(rep)
    for gen in _model_by_device.values():
        gen.manual_seed(mod)


def seed(seed_: int) -> torch.Generator:
    """Parity: ``paddle.seed`` — reseeds every device's generator (each
    rank's streams from the seed and its coordinates); returns the CPU
    one."""
    global _seed
    with _lock:
        _seed = int(seed_)
        _default.manual_seed(_seed)
        _reseed()
    return _default


def rank_coords():
    """This rank's ``(data index, model index, model axis size)``."""
    return _coords


def set_rank_coords(data: int = 0, model: int = 0, model_size: int = 1):
    """Give this rank's mesh coordinates (the mesh module does, when a
    mesh over the joined world is set); where they change, the device and
    model-parallel streams are reseeded from the last :func:`seed` and
    them (not the CPU generator of initialization: :func:`_reseed`)."""
    global _coords
    new = (int(data), int(model), int(model_size))
    with _lock:
        if new != _coords:
            _coords = new
            _reseed()
