"""Build a CUDA source of ``csrc/`` into a shared library and load it.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
-Xptxas -v`` on first use, into ``build/torch_kernels/`` at the root of
the checkout, named by a hash of the source, the headers of ``csrc/`` it
includes and the flags (``source_digest``), so an edited source or
header rebuilds; ``ptxas_report`` reads each kernel's registers and
spills from the compiler's output. The library has a plain C interface
and is loaded with ``ctypes``; no PyTorch headers are compiled, so a
build takes seconds.
A failed build raises. Each source builds under its own lock, so
``build_all`` runs one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)
_lock = threading.Lock()  # guards _locks
_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}
# Seconds each library took to build in this process (0.0 when cached).
build_seconds: dict[str, float] = {}
# The compiler's output for each library built in this process (ptxas -v:
# each kernel's registers, shared memory and spills).
build_log: dict[str, str] = {}
_ENTRY = re.compile(r"Compiling entry function '(\S+)'")


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


def source_digest(src: Path) -> str:
    """A hash of ``src``, of every header it includes with ``#include
    "..."`` from its own directory (and of theirs, in turn), and of the
    flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    seen: set[Path] = set()
    todo = [src]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.add(path)
        data = path.read_bytes()
        h.update(path.name.encode() + b"\0" + data)
        todo += [path.parent / name.decode() for name in _INCLUDE.findall(data)
                 if (path.parent / name.decode()).exists()]
    return h.hexdigest()[:16]


def load_library(source_name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source_name>``."""
    with _lock:
        lock = _locks.setdefault(source_name, threading.Lock())
    with lock:
        lib = _loaded.get(source_name)
        if lib is not None:
            return lib
        src = CSRC_DIR / source_name
        out = BUILD_DIR / f"{src.stem}-{source_digest(src)}.so"
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
            build_log[source_name] = proc.stdout + proc.stderr
        build_seconds[source_name] = time.perf_counter() - t0
        lib = ctypes.CDLL(str(out))
        _loaded[source_name] = lib
        return lib


def _kernel_name(mangled: str) -> str:
    """``name<args>`` of a mangled kernel name: its length-prefixed
    identifier ending in ``_kernel`` and its integer template arguments."""
    for m in re.finditer(r"(?=(\d+)([A-Za-z_]\w*))", mangled):
        n, ident = int(m.group(1)), m.group(2)[: int(m.group(1))]
        if len(ident) == n and ident.endswith("_kernel"):
            rest = mangled[m.start() + len(m.group(1)) + n :]
            args = re.findall(r"L[ib](\d+)E", rest.split("EE")[0] + "E") if rest[:1] == "I" else []
            return f"{ident}<{', '.join(args)}>"
    return mangled


def ptxas_report(source_name: str) -> dict[str, dict[str, int]]:
    """``{"name<template args>": {"registers", "spill_stores",
    "spill_loads"}}`` (spills in bytes) for each kernel of a source built
    in this process, from ptxas's report in ``build_log`` (empty if the
    library was cached)."""
    report, name, spills = {}, None, [0, 0]
    for line in build_log.get(source_name, "").splitlines():
        entry = _ENTRY.search(line)
        if entry:
            name = _kernel_name(entry.group(1))
        elif name and "spill" in line:
            spills = [int(n) for n in re.findall(r"(\d+) bytes spill", line)]
        elif name and "Used" in line:
            report[name] = {"registers": int(re.search(r"Used (\d+) registers", line).group(1)),
                            "spill_stores": spills[0], "spill_loads": spills[1]}
            name = None
    return report


def build_all(source_names: list[str]) -> list[ctypes.CDLL]:
    """Build and load several sources, one ``nvcc`` each, all at once."""
    with ThreadPoolExecutor(max_workers=len(source_names)) as pool:
        return list(pool.map(load_library, source_names))
