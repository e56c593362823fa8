"""Native runtime components of the port (C++, bound with ctypes).

``ingest.cc`` is the port's copy of the JAX package's ingest engine (the
file → parse → shuffle → batch path of ``io.InMemoryDataset``, no Python
in the loop).  It builds on first use with ``g++ -O2 -std=c++17 -shared
-fPIC -pthread`` into ``native/_build/ingest-<hash>.so`` (the hash covers
the source and the flags; a file lock serialises concurrent builders), so
a checkout builds its own library and reads nothing outside it.  A failed
build raises :class:`NativeBuildError`; nothing falls back to a Python
reader.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

from ..framework.errors import UnavailableError

__all__ = ["ingest_lib", "library_path", "NativeBuildError", "CXX_FLAGS"]

SRC = Path(__file__).resolve().parent / "ingest.cc"
OUT = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None


class NativeBuildError(UnavailableError):
    """``g++`` is missing or refused the source."""


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return OUT / f"ingest-{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    so = library_path()
    OUT.mkdir(exist_ok=True)
    with open(OUT / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return so
        tmp = so.with_name(so.stem + f".partial{os.getpid()}.so")
        cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
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
