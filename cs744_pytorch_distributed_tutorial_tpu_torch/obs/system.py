"""System telemetry: device-memory snapshots and kernel-build counts.

The JAX package reads HBM through ``device.memory_stats()`` and counts
XLA's backend compiles. Here the memory comes from the caching
allocator (``torch.cuda.memory_stats``: bytes allocated now and at
peak, against the card's total), None on the CPU; and the counterpart
of a compile is a build of one of the port's kernels
(``ops/_build.py::build_seconds``): the count of libraries built since
the counter was made, and the seconds they took.
"""

from __future__ import annotations

from typing import Any

import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.ops import _build

__all__ = ["CompileCounter", "SystemMonitor", "hbm_stats"]


def _build_totals() -> tuple[int, float]:
    built = [s for s in list(_build.build_seconds.values()) if s > 0]
    return len(built), float(sum(built))


class CompileCounter:
    """Kernel builds (and their seconds) since this counter was made."""

    def __init__(self) -> None:
        self._base_count, self._base_secs = _build_totals()

    @property
    def count(self) -> int:
        return _build_totals()[0] - self._base_count

    @property
    def seconds(self) -> float:
        return _build_totals()[1] - self._base_secs


def hbm_stats(device: Any) -> dict[str, int] | None:
    """``bytes_in_use``, ``peak_bytes_in_use`` and ``bytes_limit`` of a
    CUDA device from its caching allocator; None for any other device."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory),
    }


class SystemMonitor:
    """Flat "system" records: the device's memory and the kernel builds."""

    def __init__(self, device: Any = None) -> None:
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.compiles = CompileCounter()

    def snapshot(self) -> dict[str, Any]:
        record: dict[str, Any] = {
            "compile_count": self.compiles.count,
            "compile_secs": round(self.compiles.seconds, 6),
        }
        on_card = self.device.type == "cuda"
        record["local_device_count"] = torch.cuda.device_count() if on_card else 1
        record["device_kind"] = torch.cuda.get_device_name(self.device) if on_card else "cpu"
        stats = hbm_stats(self.device) or {}
        record["hbm_bytes_in_use"] = stats.get("bytes_in_use")
        record["hbm_peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
        record["hbm_bytes_limit"] = stats.get("bytes_limit")
        return record
