"""Metric sinks: ``emit(record)`` / ``close()``.

A copy of the JAX package's ``obs/sinks.py``: ``JsonlSink`` and
``StreamSink`` (one JSON line a record, non-finite floats written as
``null`` so a diverged run still gives a parseable stream), ``CsvSink``
(its header frozen at the first record), ``RingSink`` (the newest
records in memory, which the watchdog flushes), ``MultiSink``,
``NullSink``, and ``rank_zero``, which gates a sink to rank 0 of the
``torch.distributed`` group, read at each emit.
"""

from __future__ import annotations

import csv
import io
import json
import math
import threading
from collections import deque
from typing import Any, Iterable, Mapping

import torch.distributed as dist

__all__ = ["CsvSink", "JsonlSink", "MultiSink", "NullSink", "RingSink", "StreamSink",
           "rank_zero", "sanitize"]


def sanitize(record: Mapping[str, Any]) -> dict[str, Any]:
    """A record of JSON-safe scalars: non-finite floats become None,
    numpy scalars and 0-d arrays floats, anything else unknown its str."""
    out: dict[str, Any] = {}
    for k, v in record.items():
        if isinstance(v, float) and not math.isfinite(v):
            out[k] = None
        elif isinstance(v, (str, int, bool, float)) or v is None:
            out[k] = v
        else:
            try:
                f = float(v)
            except (TypeError, ValueError):
                out[k] = str(v)
            else:
                out[k] = f if math.isfinite(f) else None
    return out


class JsonlSink:
    """Append-mode newline-delimited JSON with a flush a record."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()

    def emit(self, record: Mapping[str, Any]) -> None:
        line = json.dumps(sanitize(record), allow_nan=False)
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


class CsvSink:
    """CSV with the header frozen at the first record: keys a later record
    lacks write as empty cells, keys the first record lacked are dropped."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a", encoding="utf-8", newline="")
        self._writer: csv.DictWriter | None = None
        self._lock = threading.Lock()

    def emit(self, record: Mapping[str, Any]) -> None:
        rec = sanitize(record)
        with self._lock:
            if self._writer is None:
                self._writer = csv.DictWriter(self._f, fieldnames=list(rec),
                                              extrasaction="ignore", restval="")
                self._writer.writeheader()
            self._writer.writerow(rec)
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


class RingSink:
    """Thread-safe bounded ring of the newest records."""

    def __init__(self, capacity: int = 256):
        if capacity <= 0:
            raise ValueError(f"ring capacity must be positive, got {capacity}")
        self.capacity = capacity
        self._ring: deque[dict[str, Any]] = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def emit(self, record: Mapping[str, Any]) -> None:
        with self._lock:
            self._ring.append(sanitize(record))

    def records(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def tail(self, n: int) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._ring)[-n:]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def close(self) -> None:
        pass


class NullSink:
    """Swallows everything."""

    def emit(self, record: Mapping[str, Any]) -> None:
        pass

    def close(self) -> None:
        pass


class MultiSink:
    """One emit to several sinks."""

    def __init__(self, sinks: Iterable[Any]):
        self.sinks = list(sinks)

    def emit(self, record: Mapping[str, Any]) -> None:
        for s in self.sinks:
            s.emit(record)

    def close(self) -> None:
        for s in self.sinks:
            s.close()


class StreamSink:
    """One JSON line a record to a text stream (stdout, usually)."""

    def __init__(self, stream: io.TextIOBase):
        self.stream = stream

    def emit(self, record: Mapping[str, Any]) -> None:
        self.stream.write(json.dumps(sanitize(record), allow_nan=False) + "\n")
        self.stream.flush()

    def close(self) -> None:
        pass  # never close a borrowed stream


def rank_zero(sink: Any) -> "_RankZeroSink":
    """Gate ``sink`` to rank 0 of the process group; the rank is read at
    each emit, since the group may be initialized after the sink is made."""
    return _RankZeroSink(sink)


class _RankZeroSink:
    def __init__(self, inner: Any):
        self.inner = inner

    def emit(self, record: Mapping[str, Any]) -> None:
        if not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0:
            self.inner.emit(record)

    def close(self) -> None:
        self.inner.close()
