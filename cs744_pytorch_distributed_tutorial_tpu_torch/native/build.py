"""Build a native component of the port on first use and load it.

``g++ -O3 -shared -fPIC -std=c++17 -pthread`` on ``<name>.cpp`` of this
directory, into ``build/torch_native/`` at the root of the checkout,
named by a hash of the source so an edited source rebuilds and a stale
library is never loaded. Concurrent builds (pytest workers, ranks on
one host) each write a tmp file of their own and ``os.replace`` it into
place. Without a working ``g++`` the library is None and every consumer
takes its NumPy version, which gives the same bytes;
``native_available()`` says which path runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parents[1] / "build" / "torch_native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_LOCK = threading.Lock()
_CACHE: dict[str, ctypes.CDLL | None] = {}


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update((NATIVE_DIR / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"_{name}_{h.hexdigest()[:12]}.so"


def _build(name: str) -> Path | None:
    lib = _lib_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp.{os.getpid()}")
    cmd = ["g++", *GXX_FLAGS, str(NATIVE_DIR / f"{name}.cpp"), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=120)
        os.replace(tmp, lib)
        return lib
    except (subprocess.SubprocessError, OSError):
        return None
    finally:
        tmp.unlink(missing_ok=True)


def load_library(name: str = "batcher") -> ctypes.CDLL | None:
    """The loaded library of ``<name>.cpp``, or None if it cannot be built."""
    with _LOCK:
        if name not in _CACHE:
            path = _build(name)
            lib = None
            if path is not None:
                try:
                    lib = ctypes.CDLL(str(path))
                except OSError:
                    lib = None
            _CACHE[name] = lib
        return _CACHE[name]


def native_available(name: str = "batcher") -> bool:
    return load_library(name) is not None
