"""ctypes bridge to the native batch-assembly core.

``gather_rows`` assembles a batch by gathering example rows into one
contiguous buffer (the collate step the reference gets from libtorch's
DataLoader, ``master/part1/part1.py:80-93``), through the multithreaded
C++ gather (``native/batcher.cpp``) for C-contiguous uint8, int32 and
int64 arrays, else ``np.take``: the same bytes either way. ``out``
takes a caller's buffer, such as the ``.numpy()`` view of a pinned
staging tensor, so the rows land where the host-to-device copy reads
them, with no second host copy.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from cs744_pytorch_distributed_tutorial_tpu_torch.native import load_library

_DEFAULT_THREADS = min(os.cpu_count() or 1, 8)
_FUNCTIONS = {np.dtype(np.uint8): "gather_u8", np.dtype(np.int32): "gather_i32",
              np.dtype(np.int64): "gather_i64"}


@functools.cache
def _lib():
    lib = load_library("batcher")
    if lib is not None:
        for fn in _FUNCTIONS.values():
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
            ]
    return lib


def native_usable(array: np.ndarray) -> bool:
    """Whether ``gather_rows(array, ...)`` runs the native gather."""
    return (array.dtype in _FUNCTIONS and array.flags.c_contiguous
            and _lib() is not None)


def gather_rows(
    array: np.ndarray,
    indices: np.ndarray,
    *,
    out: np.ndarray | None = None,
    threads: int = _DEFAULT_THREADS,
) -> np.ndarray:
    """``out[i] = array[indices[i]]``: ``np.take(array, indices, axis=0)``,
    with the row copies spread over threads. ``out``, when given, must be
    C-contiguous with the result's shape and dtype; it is filled and
    returned."""
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    shape = (len(idx), *array.shape[1:])
    if out is not None and (out.shape != shape or out.dtype != array.dtype
                            or not out.flags.c_contiguous):
        raise ValueError(
            f"out must be C-contiguous {array.dtype} of shape {shape}; got "
            f"{out.dtype} {out.shape}"
        )
    if native_usable(array):
        if out is None:
            out = np.empty(shape, dtype=array.dtype)
        row_elems = int(np.prod(array.shape[1:], dtype=np.int64))
        fn = getattr(_lib(), _FUNCTIONS[array.dtype])
        rc = fn(array.ctypes.data, array.shape[0], row_elems, idx.ctypes.data, len(idx),
                out.ctypes.data, threads)
        if rc == 0:
            return out
        raise IndexError(f"gather index out of range [0, {array.shape[0]})")
    if out is None:
        return np.take(array, idx, axis=0)
    np.take(array, idx, axis=0, out=out)
    return out
