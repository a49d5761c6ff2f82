"""CIFAR-10: the pickle and binary readers and the synthetic set.

The reference loads CIFAR-10 through ``torchvision.datasets.CIFAR10``
(``master/part1/part1.py:78-79,86-87``). This reads the same on-disk
``cifar-10-batches-py`` pickle tree without torchvision, or the official
binary distribution ``cifar-10-batches-bin`` (3073-byte records, decoded
by the native decoder, ``data/native_decode.py``), and, where neither is
present, makes a deterministic learnable synthetic set. The synthetic generator
draws numpy random numbers in exactly the JAX package's order, so one
seed gives byte-identical images in both packages.
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np

_BATCH_DIR = "cifar-10-batches-py"
_TRAIN_FILES = [f"data_batch_{i}" for i in range(1, 6)]
_TEST_FILE = "test_batch"
_BIN_DIR = "cifar-10-batches-bin"
_BIN_TRAIN_FILES = [f"data_batch_{i}.bin" for i in range(1, 6)]
_BIN_TEST_FILE = "test_batch.bin"
NUM_CLASSES = 10


@dataclasses.dataclass(frozen=True)
class CIFAR10Dataset:
    """Raw uint8 NHWC images + int32 labels; augmentation runs on the
    device (``data/augment.py``), so the host ships bytes, not floats."""

    train_images: np.ndarray  # [N, 32, 32, 3] uint8
    train_labels: np.ndarray  # [N] int32
    test_images: np.ndarray
    test_labels: np.ndarray
    synthetic: bool = False


def _read_batch(path: str) -> tuple[np.ndarray, np.ndarray]:
    # The CIFAR-10 distribution is a pickle; read only files the user
    # placed under data_root.
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    data = np.asarray(d[b"data"], dtype=np.uint8)
    # stored as [N, 3072] = [N, C=3, H=32, W=32] row-major -> NHWC
    images = data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    labels = np.asarray(d[b"labels"], dtype=np.int32)
    return images, labels


def _read_binary_batch(path: str) -> tuple[np.ndarray, np.ndarray]:
    from cs744_pytorch_distributed_tutorial_tpu_torch.data.native_decode import (
        decode_cifar_records,
    )

    return decode_cifar_records(np.fromfile(path, dtype=np.uint8))


def synthetic_images(
    train_size: int,
    test_size: int,
    *,
    image_size: int = 32,
    num_classes: int = NUM_CLASSES,
    seed: int = 0,
) -> CIFAR10Dataset:
    """Deterministic synthetic image set with learnable structure: each
    class is a smooth random template, each sample its template plus
    pixel noise."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(40.0, 215.0, size=(num_classes, 8, 8, 3))
    factor = -(-image_size // 8)  # ceil: upsample then crop to size
    templates = (
        coarse.repeat(factor, axis=1).repeat(factor, axis=2)
    )[:, :image_size, :image_size, :]

    def make_split(n: int) -> tuple[np.ndarray, np.ndarray]:
        labels = rng.integers(0, num_classes, size=n, dtype=np.int32)
        noise = rng.normal(0.0, 24.0, size=(n, image_size, image_size, 3))
        images = np.clip(templates[labels] + noise, 0, 255).astype(np.uint8)
        return images, labels

    train_images, train_labels = make_split(train_size)
    test_images, test_labels = make_split(test_size)
    return CIFAR10Dataset(
        train_images, train_labels, test_images, test_labels, synthetic=True
    )


def synthetic_cifar10(
    train_size: int, test_size: int, seed: int = 0
) -> CIFAR10Dataset:
    """CIFAR-shaped synthetic set (32x32, 10 classes)."""
    return synthetic_images(train_size, test_size, seed=seed)


def load_cifar10(
    root: str,
    *,
    synthetic: bool | None = None,
    synthetic_train_size: int = 50_000,
    synthetic_test_size: int = 10_000,
    seed: int = 0,
    image_size: int = 32,
    num_classes: int = NUM_CLASSES,
) -> CIFAR10Dataset:
    """Load CIFAR-10 from ``root`` (torchvision's pickle layout or the
    binary one; pickle first when both are there), or fall back.

    ``synthetic``: ``None`` = real data if present, else synthetic;
    ``True`` = always synthetic; ``False`` = real data or
    ``FileNotFoundError``. Other shapes than 32x32 and 10 classes are
    synthetic only.
    """
    cifar_shaped = image_size == 32 and num_classes == NUM_CLASSES
    batch_dir = os.path.join(root, _BATCH_DIR)
    bin_dir = os.path.join(root, _BIN_DIR)
    have_pickle = cifar_shaped and all(
        os.path.exists(os.path.join(batch_dir, f))
        for f in _TRAIN_FILES + [_TEST_FILE]
    )
    have_binary = cifar_shaped and all(
        os.path.exists(os.path.join(bin_dir, f))
        for f in _BIN_TRAIN_FILES + [_BIN_TEST_FILE]
    )
    if synthetic is False and not cifar_shaped:
        raise ValueError(
            f"real data is CIFAR-10 only (32x32, 10 classes); got "
            f"image_size={image_size}, num_classes={num_classes} with "
            "synthetic=False"
        )
    if synthetic is True or (synthetic is None and not (have_pickle or have_binary)):
        return synthetic_images(
            synthetic_train_size,
            synthetic_test_size,
            image_size=image_size,
            num_classes=num_classes,
            seed=seed,
        )
    if not (have_pickle or have_binary):
        raise FileNotFoundError(
            f"CIFAR-10 batches not found under {batch_dir!r} (pickle layout) "
            f"or {bin_dir!r} (binary layout) and synthetic=False"
        )
    if have_pickle:
        read, train_files, test_file, d = _read_batch, _TRAIN_FILES, _TEST_FILE, batch_dir
    else:
        read, train_files, test_file, d = (
            _read_binary_batch, _BIN_TRAIN_FILES, _BIN_TEST_FILE, bin_dir)
    parts = [read(os.path.join(d, f)) for f in train_files]
    test_images, test_labels = read(os.path.join(d, test_file))
    return CIFAR10Dataset(
        np.concatenate([p[0] for p in parts]),
        np.concatenate([p[1] for p in parts]),
        test_images,
        test_labels,
        synthetic=False,
    )
