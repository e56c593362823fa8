"""Native runtime components of the port (C++).

``ingest.cc`` is the port's copy of the JAX package's ingest engine (the
file → parse → shuffle → batch path of ``io.InMemoryDataset``, no Python
in the loop), bound with ctypes (:func:`ingest_lib`).  ``capi.cc`` /
``paddle_tpu_c.h`` is the C inference ABI (:func:`c_api_path`): a shared
library that C and Go programs link, which embeds CPython and drives
``paddle_tpu_torch.inference``.  Each builds on first use with ``g++ -O2
-std=c++17 -shared -fPIC -pthread`` into ``native/_build/<name>-<hash>.so``
(the hash covers the sources and the flags; a file lock serialises
concurrent builders), so a checkout builds its own library and reads
nothing outside it.  A failed build raises :class:`NativeBuildError`;
nothing falls back.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

from ..framework.errors import UnavailableError

__all__ = ["ingest_lib", "library_path", "c_api_path", "run_capi_example",
           "NativeBuildError", "CXX_FLAGS"]

SRC = Path(__file__).resolve().parent / "ingest.cc"
CAPI_SRC = Path(__file__).resolve().parent / "capi.cc"
#: a C client of the ABI (build and run it: ``run_capi_example``)
CAPI_EXAMPLE = Path(__file__).resolve().parent / "capi_example.c"
OUT = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None


class NativeBuildError(UnavailableError):
    """``g++`` is missing or refused the source."""


def library_path(src: Optional[Path] = None, tag: str = "ingest",
                 flags=(), headers=()) -> Path:
    """Where ``src``'s library (default: the ingest engine's) is built:
    keyed by the sources (``src`` and the ``headers`` it includes) and the
    flags."""
    src = SRC if src is None else src
    digest = hashlib.sha256(src.read_bytes())
    for header in headers:
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join((*CXX_FLAGS, *flags)).encode())
    return OUT / f"{tag}-{digest.hexdigest()[:16]}.so"


def _build(src: Optional[Path] = None, tag: str = "ingest", flags=(),
           headers=()) -> Path:
    src = SRC if src is None else src
    so = library_path(src, tag, flags, headers)
    OUT.mkdir(exist_ok=True)
    with open(OUT / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return so
        tmp = so.with_name(so.stem + f".partial{os.getpid()}.so")
        cmd = ["g++", *CXX_FLAGS, str(src), *flags, "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise NativeBuildError(f"g++ not available: {e}") from e
        if proc.returncode != 0:
            raise NativeBuildError(
                f"native build failed ({' '.join(cmd)}):\n"
                f"{proc.stderr[-2000:]}")
        os.replace(tmp, so)
    return so


def ingest_lib() -> ctypes.CDLL:
    """The ingest engine, built on first call and loaded once."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build()))
        c_void_p, c_int64 = ctypes.c_void_p, ctypes.c_int64
        p_int64 = ctypes.POINTER(ctypes.c_int64)
        for name, restype, argtypes in (
                ("ingest_create", c_void_p, [c_int64]),
                ("ingest_destroy", None, [c_void_p]),
                ("ingest_load", c_int64,
                 [c_void_p, ctypes.POINTER(ctypes.c_char_p), c_int64,
                  c_int64]),
                ("ingest_size", c_int64, [c_void_p]),
                ("ingest_error", ctypes.c_char_p, [c_void_p]),
                ("ingest_shuffle", None, [c_void_p, ctypes.c_uint64]),
                ("ingest_copy_rows", c_int64,
                 [c_void_p, ctypes.POINTER(ctypes.c_double), c_int64,
                  c_int64]),
                ("ingest_clear", None, [c_void_p]),
                ("ingest_create_multislot", c_void_p,
                 [c_int64, p_int64, p_int64]),
                ("ingest_copy_slot", c_int64,
                 [c_void_p, c_int64, c_int64, c_int64, c_void_p, p_int64])):
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return _lib


def c_api_path() -> str:
    """Build (once) and return the C inference ABI's shared library
    (``paddle_tpu_c.h``, beside it in this directory).  C / Go programs
    link it; it is not loaded here, since its embedded interpreter would
    clash with the running one.  The include and library flags come from
    the RUNNING interpreter (``sysconfig``: ``LIBDIR``, ``LDVERSION``), so
    the embedded runtime is the one that imports this package."""
    import sysconfig

    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ldver = (sysconfig.get_config_var("LDVERSION")
             or sysconfig.get_config_var("VERSION"))
    syslibs = ((sysconfig.get_config_var("LIBS") or "").split()
               + (sysconfig.get_config_var("SYSLIBS") or "").split())
    flags = [f"-I{inc}", f"-I{CAPI_SRC.parent}"]
    if libdir:
        flags += [f"-L{libdir}", f"-Wl,-rpath,{libdir}"]
    flags.append(f"-lpython{ldver}")
    flags += syslibs
    return str(_build(CAPI_SRC, "capi", tuple(flags),
                      (CAPI_SRC.parent / "paddle_tpu_c.h",)))


def run_capi_example(model_prefix: str, workdir: str, env=None):
    """Compile ``capi_example.c`` with ``gcc`` against :func:`c_api_path`
    in ``workdir`` and run it on ``model_prefix`` (an MLP export taking
    ``[2, 8]`` float32).  Returns the completed process (its stdout: the
    output's rank, dims and values, one a line); ``env`` is the child's
    environment (its ``PYTHONPATH`` must reach this package)."""
    lib = c_api_path()
    exe = os.path.join(workdir, "capi_example")
    cmd = ["gcc", str(CAPI_EXAMPLE), lib, f"-I{CAPI_SRC.parent}", "-o", exe,
           f"-Wl,-rpath,{os.path.dirname(lib)}"]
    build = subprocess.run(cmd, capture_output=True, text=True)
    if build.returncode != 0:
        raise NativeBuildError(
            f"capi_example build failed ({' '.join(cmd)}):\n"
            f"{build.stderr[-2000:]}")
    return subprocess.run([exe, model_prefix + ".pdmodel",
                           model_prefix + ".pdiparams"],
                          capture_output=True, text=True, env=env,
                          timeout=600)
