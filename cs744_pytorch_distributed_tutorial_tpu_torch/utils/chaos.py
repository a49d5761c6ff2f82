"""Fault injection on fixed or seeded schedules: chaos-test the recovery
ladders (a port of the JAX package's ``utils/chaos.py``).

Recovery (the watchdog, the non-finite halt, the tiered restore, the
re-mesh: ``utils/failure.py``) is only trustworthy if it is exercised.
The training kinds fire at deterministic train steps, through
``ChaosMonkey.install`` on a ``Trainer`` or an ``LMTrainer``:

- ``"nan"``: the step runs, then its loss is poisoned to NaN (a flaky
  card or a bad batch); ``fit`` raises ``NonFiniteLossError`` at the
  fetch and recovery restores the newest tier and replays.
- ``"device_loss"``: ``DeviceLossError`` raised before the step (a card
  or host dropped out); recovery re-meshes onto the survivors
  (``parallel/elastic.py``) when a ``remesh`` hook is armed.
- ``"sigterm"``: a real ``SIGTERM`` to this process (a preemption
  notice); under ``trap_sigterm`` it re-enters the run as a
  ``TrainingFailure``.
- ``"process_kill"``: a real ``SIGKILL`` to a scheduled GLOBAL rank (a
  machine's death, untrappable). The spec names the target
  (``{"kind": "process_kill", "rank": 2}``) and the monkey is told its own
  rank: only the matching rank dies, every other rank goes into the step
  and finds the death through the collective watchdog and the
  supervisor's re-election (``parallel/multihost.py``). The key is the
  cumulative step and the target a global rank, so a survivor that
  re-parses the schedule after a re-exec never fires it again.
- ``"slow_step"``: a stall before the step on one global rank, the
  seeded straggler whose late collective arrival ``obs/fleet.py`` names.

The serving kinds fire on a ``ServingEngine``'s decode steps, through
``ServeChaosMonkey`` (wrapping ``ServingEngine._decode``):

- ``"decode_nan"``: the step runs, then its sampled tokens are poisoned
  out of vocabulary (-1, the NaN-logits analog); the engine's host check
  raises ``DecodeNanError``.
- ``"slow_step"``: a stall before the step (a wedged card) through an
  injectable ``sleep``; it drives the watchdog's warn -> dump -> abort
  ladder.
- ``"engine_crash"``: ``EngineCrashError`` before the step runs, so the
  engine's host state stays snapshot-consistent.

Faults live in a ``FaultSchedule`` keyed by the cumulative call index.
The monkey owns the counter, so it spans restarts: ``install`` the same
monkey on the replacement trainer or engine (``run_chaos`` does it across
a re-mesh) and a fault that fired never fires again while the replayed
steps count past it. Schedules are explicit (``FaultSchedule({3:
"nan"})``) or seeded (``FaultSchedule.seeded``: the JAX package's draws,
so one seed gives one schedule in both). Every injection is a
``kind:"event"`` record (``chaos_inject``) on the monkey's telemetry.
"""

from __future__ import annotations

import contextlib
import os
import signal
import time
from typing import Any

import numpy as np
import torch

from cs744_pytorch_distributed_tutorial_tpu_torch.utils.failure import (
    DeviceLossError,
    EngineCrashError,
    TrainingFailure,
    emit_event,
    run_with_recovery,
)
from cs744_pytorch_distributed_tutorial_tpu_torch.utils.logging import get_logger

SERVE_FAULT_KINDS = ("decode_nan", "slow_step", "engine_crash")
FAULT_KINDS = ("nan", "device_loss", "sigterm", "process_kill") + SERVE_FAULT_KINDS


class SigtermFailure(TrainingFailure):
    """SIGTERM delivered mid-run (preemption): recoverable by restart."""


class FaultSchedule:
    """Faults keyed by cumulative call index (train steps, or decode
    steps for the serving monkey).

    Each entry fires exactly once (a transient fault, the kind recovery
    can beat; a persistent one replays after every restart and exhausts
    ``max_restarts``). Values are a kind or a dict such as
    ``{"kind": "device_loss", "lost": [2, 3]}`` or
    ``{"kind": "slow_step", "stall_s": 0.25}``.
    """

    def __init__(self, faults: dict[int, str | dict[str, Any]]):
        self.faults: dict[int, dict[str, Any]] = {}
        for idx, spec in faults.items():
            if isinstance(spec, str):
                spec = {"kind": spec}
            if spec.get("kind") not in FAULT_KINDS:
                raise ValueError(
                    f"fault kind must be one of {FAULT_KINDS}, got "
                    f"{spec.get('kind')!r} at call {idx}"
                )
            if spec["kind"] == "process_kill" and "rank" not in spec:
                raise ValueError(
                    f'process_kill at call {idx} needs a target: '
                    f'{{"kind": "process_kill", "rank": <global rank>}}'
                )
            self.faults[int(idx)] = dict(spec)

    @classmethod
    def seeded(
        cls,
        seed: int,
        n_calls: int,
        rate: float = 0.1,
        kinds: tuple[str, ...] = ("nan",),
        first_call: int = 1,
        lost: tuple[int, ...] = (),
        kill_rank: int | None = None,
    ) -> "FaultSchedule":
        """A random but reproducible schedule: each call index in
        ``[first_call, n_calls)`` faults with probability ``rate``, its
        kind drawn uniformly from ``kinds`` (numpy's ``default_rng(seed)``
        in the JAX package's order of draws)."""
        rng = np.random.default_rng(seed)
        faults: dict[int, dict[str, Any]] = {}
        for idx in range(first_call, n_calls):
            if rng.random() < rate:
                kind = kinds[int(rng.integers(len(kinds)))]
                spec: dict[str, Any] = {"kind": kind}
                if kind == "device_loss" and lost:
                    spec["lost"] = tuple(lost)
                if kind == "process_kill":
                    spec["rank"] = 0 if kill_rank is None else int(kill_rank)
                faults[idx] = spec
        return cls(faults)

    def pop(self, idx: int) -> dict[str, Any] | None:
        return self.faults.pop(idx, None)

    def __len__(self) -> int:
        return len(self.faults)


class ChaosMonkey:
    """Wrap a trainer's ``train_step`` to fire a ``FaultSchedule``.

    The call counter is the monkey's, not the wrapper's, so it is
    cumulative across restarts and re-meshes (``install`` the same monkey
    on the replacement trainer). ``injected`` records ``(call_index,
    kind)``. ``rank`` is this process's GLOBAL rank for ``process_kill``
    and ``slow_step`` (a fault aimed at another rank does not fire here);
    ``first_call`` offsets the index for a process that resumed mid-run
    (a re-exec'd survivor starting at step K passes K, so the keys stay
    absolute steps across generations). ``sleep`` is injectable so stalls
    are testable without wall time."""

    def __init__(self, schedule: FaultSchedule, telemetry: Any = None, *,
                 rank: int | None = None, first_call: int = 0, sleep: Any = time.sleep):
        self.schedule = schedule
        self.telemetry = telemetry
        self.rank = rank
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

    def install(self, trainer: Any) -> Any:
        """Wrap ``trainer.train_step`` (the CIFAR ``Trainer``'s returns the
        loss tensor, the ``LMTrainer``'s a metrics dict with ``"loss"``);
        returns the trainer, for chaining inside a ``remesh`` hook."""
        orig = trainer.train_step

        def chaotic_step(*args, **kwargs):
            idx, kind, fault = self._next()
            if kind == "process_kill":
                if self.rank is not None and int(fault["rank"]) == self.rank:
                    self._inject(idx, kind)
                    # SIGKILL cannot be trapped: the event above is
                    # already durable (the sinks flush a record at a time;
                    # the rendezvous store appends a line atomically).
                    os.kill(os.getpid(), signal.SIGKILL)
                # Another rank's death, or a re-parsed schedule whose
                # target is already dead: the step proceeds and the
                # collective watchdog reports what the peer's death did.
                kind = None
            if kind == "slow_step":
                target = fault.get("rank")
                if target is None or self.rank is None or int(target) == self.rank:
                    self._inject(idx, kind)
                    self.sleep(float(fault.get("stall_s", 0.5)))
                kind = None  # the step itself runs normally
            if kind == "device_loss":
                self._inject(idx, kind)
                raise DeviceLossError(step=idx, lost=fault.get("lost", ()))
            if kind == "sigterm":
                self._inject(idx, kind)
                # Delivered at the next bytecode: under trap_sigterm this
                # raises SigtermFailure before the step runs.
                os.kill(os.getpid(), signal.SIGTERM)
            result = orig(*args, **kwargs)
            if kind == "nan":
                self._inject(idx, kind)
                if isinstance(result, dict):
                    result = dict(result, loss=torch.full_like(result["loss"], float("nan")))
                else:
                    result = torch.full_like(result, float("nan"))
            return result

        trainer.train_step = chaotic_step
        return trainer


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


@contextlib.contextmanager
def trap_sigterm():
    """Turn SIGTERM into a catchable ``SigtermFailure`` for the scope.

    Python delivers the signal on the main thread between bytecodes, so
    the exception surfaces in the training loop and flows into
    ``run_with_recovery``'s ladder like any other ``TrainingFailure``.
    The previous handler (e.g. ``obs/flight.py``'s dumping one) is
    restored on exit."""

    def _raise(signum, frame):
        raise SigtermFailure("SIGTERM received (preemption)")

    prev = signal.signal(signal.SIGTERM, _raise)
    try:
        yield
    finally:
        signal.signal(signal.SIGTERM, prev)


def run_chaos(trainer: Any, schedule: FaultSchedule | ChaosMonkey, *, telemetry: Any = None,
              remesh: Any = None, **recovery_kwargs: Any):
    """Install the chaos monkey, trap SIGTERM and run the recovery ladder
    (``run_with_recovery``). ``remesh`` (``parallel/elastic.py::
    default_remesh``) is wrapped so the replacement trainer gets the same
    monkey: the schedule keeps firing across the re-mesh. Returns
    ``(*fit_result, restarts, monkey)``."""
    monkey = (schedule if isinstance(schedule, ChaosMonkey)
              else ChaosMonkey(schedule, telemetry=telemetry))
    monkey.install(trainer)

    chaotic_remesh = None
    if remesh is not None:

        def chaotic_remesh(tr, failure):
            return monkey.install(remesh(tr, failure))

    with trap_sigterm():
        result = run_with_recovery(trainer, telemetry=telemetry, remesh=chaotic_remesh,
                                   **recovery_kwargs)
    return (*result, monkey)
