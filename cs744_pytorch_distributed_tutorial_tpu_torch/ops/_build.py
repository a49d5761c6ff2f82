"""Build a CUDA source of ``csrc/`` into a shared library and load it.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
on first use, into ``build/torch_kernels/`` at the root of the checkout,
named by a hash of the source and the flags so an edited source
rebuilds. The library has a plain C interface and is loaded with
``ctypes``; no PyTorch headers are compiled, so a build takes seconds.
A failed build raises. Each source builds under its own lock, so
``build_all`` runs one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()  # guards _locks
_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}
# Seconds each library took to build in this process (0.0 when cached).
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin); the CUDA toolkit is needed "
        "to build the port's kernels"
    )


def load_library(source_name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source_name>``."""
    with _lock:
        lock = _locks.setdefault(source_name, threading.Lock())
    with lock:
        lib = _loaded.get(source_name)
        if lib is not None:
            return lib
        src = CSRC_DIR / source_name
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        out = BUILD_DIR / f"{src.stem}-{digest}.so"
        t0 = time.perf_counter()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # Build to a private name, then rename: ranks that build at
            # once never load a half-written library.
            tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {src.name} ({proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, out)
        build_seconds[source_name] = time.perf_counter() - t0
        lib = ctypes.CDLL(str(out))
        _loaded[source_name] = lib
        return lib


def build_all(source_names: list[str]) -> list[ctypes.CDLL]:
    """Build and load several sources, one ``nvcc`` each, all at once."""
    with ThreadPoolExecutor(max_workers=len(source_names)) as pool:
        return list(pool.map(load_library, source_names))
