"""Fault injection on fixed schedules: chaos-test the serving
recovery ladder (the serving half of the JAX package's ``utils/chaos.py``).

The serving engine's recovery (``serve/guard.py::run_serve_with_recovery``)
is only trustworthy if it is exercised. ``ServeChaosMonkey`` fires the
three serving fault shapes at deterministic decode steps, wrapping
``ServingEngine._decode``:

- ``"decode_nan"``: the step runs, then its sampled tokens are poisoned
  out of vocabulary (-1, the NaN-logits analog); the engine's host check
  raises ``DecodeNanError``.
- ``"slow_step"``: a stall before the step (a wedged card) through an
  injectable ``sleep``; it drives the watchdog's warn -> dump -> abort
  ladder.
- ``"engine_crash"``: ``EngineCrashError`` before the step runs, so the
  engine's host state stays snapshot-consistent.

Faults live in a ``FaultSchedule`` keyed by the cumulative decode-step
index. The monkey owns the counter, so it spans restarts: ``install`` the
same monkey on the replacement engine and a fault that fired never fires
again while the replayed steps count past it. Every injection is a
``kind:"event"`` record (``chaos_inject``) on the monkey's telemetry.

The training monkey's ``install``, ``trap_sigterm``, ``SigtermFailure``
and ``run_chaos`` are not ported yet.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np

from cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure import (
    EngineCrashError,
    emit_event,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.logging import get_logger

# The JAX package's training kinds ride on the training monkey, which is
# not ported: a schedule holds serving faults only.
SERVE_FAULT_KINDS = ("decode_nan", "slow_step", "engine_crash")


class FaultSchedule:
    """Faults keyed by cumulative decode-step index.

    Each entry fires exactly once (a transient fault, the kind recovery
    can beat). Values are a kind or a dict such as
    ``{"kind": "slow_step", "stall_s": 0.25}``.
    """

    def __init__(self, faults: dict[int, str | dict[str, Any]]):
        self.faults: dict[int, dict[str, Any]] = {}
        for idx, spec in faults.items():
            if isinstance(spec, str):
                spec = {"kind": spec}
            if spec.get("kind") not in SERVE_FAULT_KINDS:
                raise ValueError(
                    f"fault kind must be one of {SERVE_FAULT_KINDS}, got "
                    f"{spec.get('kind')!r} at call {idx}"
                )
            self.faults[int(idx)] = dict(spec)

    def pop(self, idx: int) -> dict[str, Any] | None:
        return self.faults.pop(idx, None)

    def __len__(self) -> int:
        return len(self.faults)


class ChaosMonkey:
    """The cumulative call counter and the injection record that every
    monkey shares. ``injected`` holds ``(call_index, kind)``;
    ``first_call`` offsets the index for a process that resumed mid-run.
    ``sleep`` is injectable so stalls are testable without wall time."""

    def __init__(self, schedule: FaultSchedule, telemetry: Any = None, *,
                 first_call: int = 0, sleep: Any = time.sleep):
        self.schedule = schedule
        self.telemetry = telemetry
        self.first_call = int(first_call)
        self.sleep = sleep
        self.calls = 0  # cumulative wrapped calls, over every restart
        self.injected: list[tuple[int, str]] = []
        self._log = get_logger()

    def _next(self) -> tuple[int, str | None, dict[str, Any] | None]:
        idx = self.first_call + self.calls
        self.calls += 1
        fault = self.schedule.pop(idx)
        return idx, (fault["kind"] if fault else None), fault

    def _inject(self, idx: int, kind: str) -> None:
        self.injected.append((idx, kind))
        self._log.warning("chaos: injecting %r at call %d", kind, idx)
        emit_event(self.telemetry, "chaos_inject", fault=kind, call=idx)


class ServeChaosMonkey(ChaosMonkey):
    """Fire a ``FaultSchedule`` on a ``ServingEngine``'s decode steps."""

    def install(self, engine: Any) -> Any:
        """Wrap ``engine._decode`` (the wrapper's ``__wrapped__`` is the
        original, as the JAX monkey sets it); returns the engine. The
        profiler never reaches the wrapper: it calls the engine's
        ``_decode_step`` itself."""
        orig = engine._decode

        def chaotic_decode(*args, **kwargs):
            idx, kind, fault = self._next()
            if kind == "engine_crash":
                self._inject(idx, kind)
                # Before the step: nothing on the card or the host moved,
                # so snapshot() after the raise describes the world before.
                raise EngineCrashError(step=idx)
            if kind == "slow_step":
                self._inject(idx, kind)
                self.sleep(float(fault.get("stall_s", 0.5)))
            tok = orig(*args, **kwargs)
            if kind == "decode_nan":
                self._inject(idx, kind)
                # -1 is the out-of-vocab poison the engine's host check
                # (DecodeNanError) is specified to catch.
                tok = np.full_like(tok, -1)
            return tok

        chaotic_decode.__wrapped__ = orig
        engine._decode = chaotic_decode
        return engine
