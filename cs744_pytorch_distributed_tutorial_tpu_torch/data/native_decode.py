"""ctypes bridge to the native CIFAR binary-format decoder.

``decode_cifar_records`` splits raw 3073-byte records (1 label byte +
CHW pixels) into int32 labels and NHWC uint8 images, through the
threaded C++ decoder (``native/decode.cpp``) when it builds, else the
equivalent NumPy transpose: the same bytes either way.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from cs744_pytorch_distributed_tutorial_tpu_torch.native import load_library

_DEFAULT_THREADS = min(os.cpu_count() or 1, 8)
RECORD_BYTES = 3073


@functools.cache
def _lib():
    lib = load_library("decode")
    if lib is not None:
        lib.decode_cifar_u8.restype = ctypes.c_int
        lib.decode_cifar_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
    return lib


def decode_cifar_records_numpy(raw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The NumPy version: [N * 3073] uint8 -> (images [N,32,32,3], labels [N] i32)."""
    recs = np.ascontiguousarray(raw, dtype=np.uint8).reshape(-1, RECORD_BYTES)
    images = recs[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).copy()
    return images, recs[:, 0].astype(np.int32)


def decode_cifar_records(
    raw: np.ndarray, *, threads: int = _DEFAULT_THREADS
) -> tuple[np.ndarray, np.ndarray]:
    """[N * 3073] (or [N, 3073]) uint8 records -> (images [N,32,32,3] u8,
    labels [N] i32)."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8).reshape(-1)
    if raw.size % RECORD_BYTES:
        raise ValueError(
            f"record buffer of {raw.size} bytes is not a multiple of "
            f"{RECORD_BYTES} (1 label byte + 3x32x32 pixels)"
        )
    n = raw.size // RECORD_BYTES
    lib = _lib()
    if lib is not None:
        images = np.empty((n, 32, 32, 3), np.uint8)
        labels = np.empty((n,), np.int32)
        rc = lib.decode_cifar_u8(raw.ctypes.data, n, labels.ctypes.data,
                                 images.ctypes.data, threads)
        if rc == 0:
            return images, labels
    return decode_cifar_records_numpy(raw)
