"""The port's native decoder and batcher, its CIFAR binary reader and its
loader against the JAX package's.

The C++ sources are the port's own copies, built into
``build/torch_native/``; ``g++`` is present here, so the native paths
run. Every comparison is bitwise: the decoder and the gather move bytes
and do no arithmetic.
"""

import pickle

import numpy as np
import pytest
import torch

from cs744_pytorch_distributed_tutorial_tpu.data import gather_rows as jax_gather_rows
from cs744_pytorch_distributed_tutorial_tpu.data import load_cifar10 as jax_load_cifar10
from cs744_pytorch_distributed_tutorial_tpu.data.native_decode import (
    decode_cifar_records as jax_decode,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.data import BatchLoader, gather_rows, load_cifar10
from cs744_pytorch_distributed_tutorial_tpu_torch.data.native_batcher import native_usable
from cs744_pytorch_distributed_tutorial_tpu_torch.data.native_decode import (
    RECORD_BYTES,
    decode_cifar_records,
    decode_cifar_records_numpy,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.native import build, native_available

BIN_FILES = [f"data_batch_{i}.bin" for i in range(1, 6)] + ["test_batch.bin"]


def test_native_libraries_build_into_the_ports_build_dir():
    assert native_available("batcher") and native_available("decode")
    for name in ("batcher", "decode"):
        path = build._lib_path(name)
        assert path.exists() and path.parent == build.BUILD_DIR
        assert path.parent.name == "torch_native"


def test_decoder_bitwise_against_jax_and_numpy():
    rng = np.random.default_rng(3)
    n = 500  # > 1 MiB of records: the threaded path
    raw = rng.integers(0, 256, size=n * RECORD_BYTES).astype(np.uint8)
    images, labels = decode_cifar_records(raw)
    want_images, want_labels = jax_decode(raw)
    np.testing.assert_array_equal(images, want_images)
    np.testing.assert_array_equal(labels, want_labels)
    assert images.dtype == np.uint8 and labels.dtype == np.int32
    np_images, np_labels = decode_cifar_records_numpy(raw)
    np.testing.assert_array_equal(images, np_images)
    np.testing.assert_array_equal(labels, np_labels)
    with pytest.raises(ValueError, match="multiple"):
        decode_cifar_records(raw[:-1])


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.int64])
def test_gather_bitwise_against_jax_and_numpy(dtype):
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 200, size=(1000, 3, 5)).astype(dtype)
    idx = rng.integers(0, 1000, size=256)
    assert native_usable(arr)
    got = gather_rows(arr, idx)
    np.testing.assert_array_equal(got, np.take(arr, idx, axis=0))
    np.testing.assert_array_equal(got, jax_gather_rows(arr, idx))
    assert got.dtype == arr.dtype


def test_gather_large_multithreaded_path_against_jax():
    """> 1 MiB of rows takes the threaded branch of the C++ gather."""
    rng = np.random.default_rng(1)
    arr = rng.integers(0, 255, size=(4096, 32 * 32 * 3), dtype=np.uint8)
    idx = rng.permutation(4096)
    got = gather_rows(arr, idx)
    np.testing.assert_array_equal(got, jax_gather_rows(arr, idx))
    np.testing.assert_array_equal(got, np.take(arr, idx, axis=0))


def test_gather_falls_back_for_unsupported_dtype():
    arr = np.arange(20, dtype=np.float64).reshape(10, 2)
    idx = np.array([3, 1, 4])
    assert not native_usable(arr)
    np.testing.assert_array_equal(gather_rows(arr, idx), jax_gather_rows(arr, idx))
    np.testing.assert_array_equal(gather_rows(arr[:, ::2], idx), np.take(arr[:, ::2], idx, 0))


def test_gather_into_a_callers_buffer():
    """``out`` (here a tensor's ``.numpy()`` view, as the loader passes a
    pinned staging tensor's) is filled in place and returned."""
    rng = np.random.default_rng(2)
    arr = rng.integers(0, 255, size=(50, 4, 4, 3), dtype=np.uint8)
    idx = rng.integers(0, 50, size=16)
    staging = torch.zeros((16, 4, 4, 3), dtype=torch.uint8)
    out = gather_rows(arr, idx, out=staging.numpy())
    assert out.ctypes.data == staging.data_ptr()
    np.testing.assert_array_equal(staging.numpy(), np.take(arr, idx, axis=0))
    with pytest.raises(ValueError, match="out must be"):
        gather_rows(arr, idx, out=np.zeros((15, 4, 4, 3), np.uint8))
    with pytest.raises(IndexError):
        gather_rows(arr, np.array([50]))


def _write_binary_tree(root, per_file, seed):
    rng = np.random.default_rng(seed)
    d = root / "cifar-10-batches-bin"
    d.mkdir()
    for name in BIN_FILES:
        recs = rng.integers(0, 256, size=(per_file, RECORD_BYTES)).astype(np.uint8)
        recs[:, 0] = rng.integers(0, 10, size=per_file)
        (d / name).write_bytes(recs.tobytes())


def _write_pickle_tree(root, per_file, seed):
    rng = np.random.default_rng(seed)
    d = root / "cifar-10-batches-py"
    d.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        data = rng.integers(0, 256, size=(per_file, 3072)).astype(np.uint8)
        labels = rng.integers(0, 10, size=per_file).tolist()
        with open(d / name, "wb") as f:
            pickle.dump({b"data": data, b"labels": labels}, f)


def _assert_same(a, b):
    assert a.synthetic == b.synthetic
    for field in ("train_images", "train_labels", "test_images", "test_labels"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.shape == y.shape, field
        np.testing.assert_array_equal(x, y, err_msg=field)


@pytest.mark.parametrize("synthetic", [False, None], ids=["strict", "auto"])
def test_load_cifar10_binary_layout_bitwise_against_jax(tmp_path, synthetic):
    _write_binary_tree(tmp_path, per_file=20, seed=4)
    ds = load_cifar10(str(tmp_path), synthetic=synthetic)
    _assert_same(ds, jax_load_cifar10(str(tmp_path), synthetic=synthetic))
    assert not ds.synthetic
    assert ds.train_images.shape == (100, 32, 32, 3) and ds.test_images.shape == (20, 32, 32, 3)
    raw = np.fromfile(tmp_path / "cifar-10-batches-bin" / "test_batch.bin", dtype=np.uint8)
    np_images, np_labels = decode_cifar_records_numpy(raw)
    np.testing.assert_array_equal(ds.test_images, np_images)
    np.testing.assert_array_equal(ds.test_labels, np_labels)


def test_load_cifar10_arbitration_against_jax(tmp_path):
    """Strict without data raises; auto without data is the synthetic set;
    with both layouts present the pickle one wins, as in JAX."""
    with pytest.raises(FileNotFoundError, match="binary layout"):
        load_cifar10(str(tmp_path), synthetic=False)
    kw = dict(synthetic_train_size=8, synthetic_test_size=4)
    _assert_same(load_cifar10(str(tmp_path), **kw), jax_load_cifar10(str(tmp_path), **kw))
    _write_binary_tree(tmp_path, per_file=4, seed=5)
    _write_pickle_tree(tmp_path, per_file=6, seed=6)
    ds = load_cifar10(str(tmp_path), synthetic=False)
    _assert_same(ds, jax_load_cifar10(str(tmp_path), synthetic=False))
    assert ds.train_images.shape[0] == 30  # the pickle tree's 5 x 6
    with pytest.raises(ValueError, match="CIFAR-10 only"):
        load_cifar10(str(tmp_path), synthetic=False, image_size=64)


def test_loader_gathers_natively_and_start_skips_by_index():
    """``epoch(e, start)`` yields the tail of ``epoch(e)`` and gathers
    only the batches it yields; every batch is a native gather."""
    rng = np.random.default_rng(7)
    images = rng.integers(0, 255, size=(40, 4, 4, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, size=40).astype(np.int32)
    full = BatchLoader(images, labels, 8, device=torch.device("cpu"), shuffle=True, seed=3)
    every = [(x.clone(), y.clone()) for x, y in full.epoch(2)]
    assert full.native_batches == len(every) == 5
    tail = BatchLoader(images, labels, 8, device=torch.device("cpu"), shuffle=True, seed=3)
    got = list(tail.epoch(2, start=3))
    assert tail.native_batches == 2
    for (x, y), (wx, wy) in zip(got, every[3:], strict=True):
        assert torch.equal(x, wx) and torch.equal(y, wy)
        assert y.dtype == torch.int64
