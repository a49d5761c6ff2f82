"""Metric sinks: ``emit(record)`` / ``close()``.

A copy of the JAX package's ``obs/sinks.py``, its ``StreamSink``,
``JsonlSink`` and ``MultiSink`` and the ``sanitize`` they share: one
JSON line a record, non-finite floats written as ``null`` so a diverged
run still gives a parseable stream. The CSV, ring and rank-zero sinks
are not ported yet.
"""

from __future__ import annotations

import io
import json
import math
import threading
from typing import Any, Iterable, Mapping

__all__ = ["JsonlSink", "MultiSink", "StreamSink", "sanitize"]


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
