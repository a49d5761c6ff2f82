"""DDP-style gradient bucketing: a few flat buffers in place of one
collective a parameter.

Port of the JAX package's ``parallel/buckets.py``. The reference syncs
one tensor at a time (``for p in model.parameters():`` in part2a and
part2b); DDP's reducer coalesces gradients into buckets so a step issues
a collective a bucket (``master/part3/part3.py:116``). This module is
that reducer's layout: a deterministic, cached mapping from an ordered
list of tensors (``model.parameters()`` order) to flat buffers, and back.

Two layouts, chosen by ``rows``:

- ``rows=0`` (flat): a bucket is a 1-D buffer, the tensors concatenated.
  Right for elementwise collectives (an all-reduce mean), where the mean
  of a concatenation is the concatenation of the means.
- ``rows=n`` (row-chunked): a bucket is an ``[n, cols]`` matrix in which
  each tensor contributes its own ring layout (flat data zero-padded to
  ``n * chunk`` and reshaped ``[n, chunk]``) as a block of columns. The
  ring all-reduce (``collectives.py::ring_all_reduce_rows``) sums row
  ``r`` in an order set by ``r`` and the ring position alone, so every
  element keeps the row, and so the summation order, it had in the
  per-tensor call: the bucketed ring is bitwise equal to it.

Buckets hold one dtype each (no casts on the wire).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

#: Default bucket capacity, the JAX package's: DDP's default is 25 MB;
#: 4 MB keeps several buckets alive at CIFAR-model sizes.
DEFAULT_BUCKET_BYTES = 4 * 2**20


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """Where one tensor lives: columns [offset, offset+size) of ``bucket``."""

    bucket: int
    offset: int
    size: int  # elements when rows == 0; the per-row chunk when rows > 0
    shape: tuple[int, ...]
    dtype: str


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    slots: tuple[LeafSlot, ...]  # in the order of the tensors given
    bucket_cols: tuple[int, ...]
    bucket_dtypes: tuple[str, ...]
    rows: int


_LAYOUT_CACHE: dict[tuple, BucketLayout] = {}


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (numpy's name, as JAX keys it)."""
    return str(dtype).removeprefix("torch.")


def _signature(leaves) -> tuple[tuple[tuple[int, ...], torch.dtype], ...]:
    return tuple(
        (tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor) else (tuple(t[0]), t[1])
        for t in leaves
    )


def bucket_layout(
    leaves: Sequence,
    bucket_bytes: int = DEFAULT_BUCKET_BYTES,
    rows: int = 0,
    reverse: bool = False,
) -> BucketLayout:
    """Greedy layout: walk the tensors in order (reversed with
    ``reverse``, the overlapped schedule's order), appending each to the
    open bucket of its dtype; a bucket closes when the next tensor would
    pass ``bucket_bytes`` (an oversized tensor gets a bucket to itself).
    ``leaves`` are tensors or ``(shape, dtype)`` pairs. ``slots`` stays
    in the given order either way. Cached by signature."""
    sig = (_signature(leaves), int(bucket_bytes), int(rows), bool(reverse))
    cached = _LAYOUT_CACHE.get(sig)
    if cached is not None:
        return cached
    shapes = sig[0]
    slots: list[LeafSlot | None] = [None] * len(shapes)
    bucket_fill: list[int] = []
    bucket_dtypes: list[str] = []
    open_by_dtype: dict[str, int] = {}
    order = range(len(shapes) - 1, -1, -1) if reverse else range(len(shapes))
    for i in order:
        shape, dtype = shapes[i]
        name = dtype_name(dtype)
        size = math.prod(shape)
        cols = -(-size // rows) if rows else size
        row_bytes = dtype.itemsize * (rows if rows else 1)
        cap_cols = max(1, int(bucket_bytes) // row_bytes)
        b = open_by_dtype.get(name)
        if b is None or (bucket_fill[b] and bucket_fill[b] + cols > cap_cols):
            b = len(bucket_fill)
            bucket_fill.append(0)
            bucket_dtypes.append(name)
            open_by_dtype[name] = b
        slots[i] = LeafSlot(b, bucket_fill[b], cols, shape, name)
        bucket_fill[b] += cols
    layout = BucketLayout(tuple(slots), tuple(bucket_fill), tuple(bucket_dtypes), int(rows))
    _LAYOUT_CACHE[sig] = layout
    return layout


def bucket_members(layout: BucketLayout) -> list[list[int]]:
    """The tensor indices of each bucket, in offset order."""
    members: list[list[int]] = [[] for _ in layout.bucket_cols]
    for i, slot in enumerate(layout.slots):
        members[slot.bucket].append(i)
    for m in members:
        m.sort(key=lambda i: layout.slots[i].offset)
    return members


def flatten_bucket(tensors: Sequence[torch.Tensor], layout: BucketLayout,
                   bucket: int, members: Sequence[int]) -> torch.Tensor:
    """One bucket's buffer (1-D, or ``[rows, cols]``) from the tensors
    ``members`` (``bucket_members(layout)[bucket]``)."""
    rows = layout.rows
    parts = []
    for i in members:
        flat = tensors[i].reshape(-1)
        if rows:
            size = layout.slots[i].size
            flat = torch.nn.functional.pad(flat, (0, rows * size - flat.numel()))
            flat = flat.reshape(rows, size)
        parts.append(flat)
    return torch.cat(parts, dim=1 if rows else 0)


def flatten_for_sync(tensors: Sequence[torch.Tensor], layout: BucketLayout) -> list[torch.Tensor]:
    """Tensors -> the layout's bucket buffers."""
    if len(tensors) != len(layout.slots):
        raise ValueError(f"{len(tensors)} tensors, the layout has {len(layout.slots)}")
    return [flatten_bucket(tensors, layout, b, m)
            for b, m in enumerate(bucket_members(layout))]


def leaf_view(buf: torch.Tensor, layout: BucketLayout, slot: LeafSlot) -> torch.Tensor:
    """One tensor's values in its bucket buffer: a view for the flat
    layout, a copy for the row-chunked one."""
    size = math.prod(slot.shape)
    if layout.rows:
        flat = buf[:, slot.offset : slot.offset + slot.size].reshape(-1)[:size]
    else:
        flat = buf[slot.offset : slot.offset + slot.size]
    return flat.view(slot.shape)


def unflatten(bufs: Sequence[torch.Tensor], layout: BucketLayout) -> list[torch.Tensor]:
    """Inverse of ``flatten_for_sync``: bucket buffers -> tensors."""
    return [leaf_view(bufs[s.bucket], layout, s) for s in layout.slots]


def tree_bytes(leaves: Sequence) -> tuple[int, int]:
    """(total elements, total bytes) of a list of tensors or
    ``(shape, dtype)`` pairs."""
    elems = nbytes = 0
    for shape, dtype in _signature(leaves):
        size = math.prod(shape)
        elems += size
        nbytes += size * dtype.itemsize
    return elems, nbytes


def _int8_padded_elems(params, strategy: str, axis_size: int, bucket_bytes: int,
                       quant_chunk: int, reverse: bool = False) -> int:
    """The elements the int8 wire moves, padding included: each flat
    bucket padded to ``n * m * Q`` (all-to-all form) or to n rows of a
    Q-aligned width (ring form)."""
    layout = bucket_layout(params, bucket_bytes, rows=0, reverse=reverse)
    n = int(axis_size)
    total = 0
    for cols in layout.bucket_cols:
        if strategy == "int8_ring":
            c = -(-cols // n)
            c = -(-c // quant_chunk) * quant_chunk
            total += n * c
        else:
            m = -(-cols // (n * quant_chunk))
            total += n * m * quant_chunk
    return total


def sync_bytes_per_step(
    params,
    strategy: str,
    axis_size: int,
    *,
    quant_chunk: int = 256,
    bucket_bytes: int | None = None,
    reverse: bool = False,
) -> int:
    """Analytic gradient-sync payload bytes sent per rank per step.

    ``params`` is a list of tensors (or ``(shape, dtype)`` pairs), or an
    int: an fp32 element count. Ring-algorithm lowerings:

    - ``allreduce``/``ring``/``auto``/``zero1``/``fsdp``/``p2p_star``:
      2(n-1)/n of the gradient bytes (the star's cost is serialisation,
      not mean bytes);
    - ``gather_scatter``: (n-1) x the gradient bytes;
    - ``int8_allreduce``/``int8_ring``: 1 byte an element plus 4/Q of
      scale at the same 2(n-1)/n, over the padded element count when
      ``bucket_bytes`` is given;
    - ``zero1_int8``: the padded int8 wire plus the float delta
      all-gather, (n-1)/n of 4 bytes an element;
    - ``none`` or a world of one: 0.
    """
    if isinstance(params, int):
        elems, nbytes = params, 4 * params
        bucket_bytes = None  # no shapes to derive padding from
    else:
        elems, nbytes = tree_bytes(params)
    n = int(axis_size)
    if strategy == "none" or n <= 1:
        return 0
    ring_factor = 2.0 * (n - 1) / n
    if strategy in ("allreduce", "ring", "auto", "zero1", "fsdp", "p2p_star"):
        return int(ring_factor * nbytes)
    if strategy == "gather_scatter":
        return int((n - 1) * nbytes)
    if strategy in ("int8_allreduce", "int8_ring"):
        if bucket_bytes:
            elems = _int8_padded_elems(params, strategy, n, bucket_bytes, quant_chunk,
                                       reverse=reverse)
        return int(ring_factor * elems * (1.0 + 4.0 / quant_chunk))
    if strategy == "zero1_int8":
        if bucket_bytes:
            layout = bucket_layout(params, bucket_bytes, rows=n, reverse=reverse)
            padded = gathered = 0
            for cols in layout.bucket_cols:
                flat = n * cols
                m = -(-flat // (n * quant_chunk))
                padded += n * m * quant_chunk
                gathered += flat
        else:
            padded = gathered = elems
        wire = ring_factor * padded * (1.0 + 4.0 / quant_chunk)
        return int(wire + (n - 1) / n * 4.0 * gathered)
    raise ValueError(f"unknown sync strategy {strategy!r}")
