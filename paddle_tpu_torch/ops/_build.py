"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``ops/csrc/<name>.cu`` has a plain C interface and compiles on first
use into ``ops/_build/<name>-<hash>.so``, the hash covering the source,
every shared header ``ops/csrc/*.cuh`` and the flags, so an edited source
or header rebuilds and an unchanged one loads from disk.  A file lock
serialises concurrent builders (two processes, or two threads of one);
:func:`build` starts one ``nvcc`` per missing source, all at once.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict

from ..framework.errors import UnavailableError

__all__ = ["NVCC_FLAGS", "PLAIN_DEVICES", "build", "entry", "library_path",
           "load", "nvcc", "sm_count"]

CSRC = Path(__file__).resolve().parent / "csrc"
OUT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: device types on which a wrapper runs its kernel's plain version: the
#: CPU, and "meta" (the static graph's shape inference, which computes
#: nothing: a meta tensor only carries the plain version's shapes)
PLAIN_DEVICES = ("cpu", "meta")

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()
_sms: Dict[int, int] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on
    PATH, or ``/usr/local/cuda/bin/nvcc``."""
    cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise UnavailableError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH) — the port's "
        "CUDA kernels build on first use on a machine with the toolkit")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu``'s library is built: keyed by the source,
    the headers it may include (every ``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return OUT / f"{name}-{digest.hexdigest()[:16]}.so"


def build(*names: str) -> Dict[str, Path]:
    """Compile every named source whose library is missing — one ``nvcc``
    process per source, started together — and return the library paths.
    Each compile's output (``-Xptxas=-v``: registers, shared memory,
    spills) is kept in ``<library>.log``."""
    OUT.mkdir(exist_ok=True)
    with open(OUT / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        jobs = []
        for name in names:
            so = library_path(name)
            if so.exists():
                continue
            tmp = so.with_name(so.stem + ".partial.so")
            with open(so.with_suffix(".log"), "w") as log:
                proc = subprocess.Popen(
                    [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                     str(CSRC / f"{name}.cu")],
                    stdout=log, stderr=subprocess.STDOUT)
            jobs.append((name, proc, tmp, so))
        failed = []
        for name, proc, tmp, so in jobs:
            if proc.wait() != 0:
                failed.append(f"{name}.cu: "
                              + so.with_suffix(".log").read_text()[-4000:])
            else:
                os.replace(tmp, so)
    if failed:
        raise UnavailableError("nvcc failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build(name)[name]))
        return lib


def entry(name: str, symbol: str, argtypes) -> Callable[..., None]:
    """A caller of the C entry ``symbol`` of ``csrc/<name>.cu`` (built and
    loaded on first use).  ``argtypes`` must give ``c_void_p`` for every
    pointer and the stream: a plain int would cut them to 32 bits.  The
    entry returns a ``cudaError_t``; the caller raises ``RuntimeError``
    with CUDA's message (from ``<symbol>_error_string``) when it is not
    0, since a refused launch never runs and a later synchronise would not
    report it."""
    lib = load(name)
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    err = getattr(lib, symbol + "_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p

    def call(*args):
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{symbol}: launch failed: "
                               f"{err(rc).decode()} (cudaError {rc})")

    return call


def sm_count(device) -> int:
    """Streaming multiprocessors of ``device``'s card (cached): what the
    kernels' persistent grids are sized by."""
    import torch

    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    n = _sms.get(index)
    if n is None:
        n = _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n
