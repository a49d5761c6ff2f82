"""Failure detection and recovery (the JAX package's ``utils/failure.py``).

The reference has no failure story: if a rank dies, its Gloo collectives
hang or error with no retry (SURVEY §5.3). A step can hang (a wedged
card, a dead peer inside a collective) or diverge (a non-finite loss).
This module supplies:

1. ``StepWatchdog``: hang detection from the host. The train loop arms
   it around each step; if the step outlives the timeout, its own
   thread logs, dumps every thread's Python stack (``faulthandler``),
   flushes the metric ring and the flight recorder, and calls an
   optional ``on_hang`` (the engine's ``hang_action="abort"`` exits the
   process so a supervisor restarts it). ``escalation`` climbs warn ->
   dump -> abort across successive expiries instead.
2. ``NonFiniteLossError``: ``Trainer.fit`` raises it when a fetched loss
   is NaN or inf (at the fetches logging already makes).
3. ``run_with_recovery``: restart recovery. On a ``TrainingFailure`` it
   calls ``fit`` again, which restores the newest recoverable state
   (the in-memory snapshot, ``utils/memstore.py``, when it is at least
   as new as the newest disk checkpoint, ``utils/checkpoint.py``) and
   resumes at the recorded step, up to ``max_restarts`` times, with
   exponential or decorrelated backoff. Every transition is a
   ``kind:"event"`` record.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import sys
import threading
import time
import traceback as _traceback
from typing import Any, Callable

import numpy as np
import torch.distributed as dist

from cs744_pytorch_distributed_tutorial_tpu_torch.utils.logging import get_logger


class TrainingFailure(RuntimeError):
    """Base class for detected training failures (recoverable by restart)."""


class NonFiniteLossError(TrainingFailure):
    """Loss came back NaN/inf — the run has diverged."""

    def __init__(self, step: int, loss: float):
        super().__init__(f"non-finite loss {loss!r} at step {step}")
        self.step = step
        self.loss = loss


class DeviceLossError(TrainingFailure):
    """A device (or its host) dropped out of the world mid-run.

    Retrying on the same process group cannot succeed: the survivors must
    form a new one (the JAX package's ``parallel/elastic.py``, not ported
    yet). ``lost`` carries the dead device ids; ``run_with_recovery``
    hands them to its ``remesh`` callback."""

    def __init__(self, step: int, lost=()):
        lost = tuple(lost)
        super().__init__(
            f"device loss at step {step}"
            + (f" (lost devices {list(lost)})" if lost else "")
        )
        self.step = step
        self.lost = lost


class ProcessLossError(TrainingFailure):
    """A peer process died mid-run (a killed rank, a dead host): every
    collective still names the dead rank, so the survivors must leave the
    group and resume from the newest durable tier in a new one. ``dead``
    carries the dead global ranks."""

    def __init__(self, generation: int = 0, dead=()):
        dead = tuple(int(r) for r in dead)
        super().__init__(
            f"process loss in generation {generation}"
            + (f" (dead ranks {list(dead)})" if dead else "")
        )
        self.generation = generation
        self.dead = dead


class StepWatchdog:
    """Detect hung training steps from the host side.

    Usage::

        wd = StepWatchdog(timeout_s=300)
        for batch in loader:
            with wd.watch():
                state, metrics = train_step(state, *batch)
        wd.close()

    If a watched section outlives ``timeout_s`` the watchdog — on its own
    long-lived monitor thread, since the training thread is the one
    that's stuck — logs a critical message, dumps every thread's Python
    stack to stderr, and calls ``on_hang(elapsed_s)``. It fires at most
    once per watched section and never interrupts the training thread
    itself: detection, not preemption (in multi-host runs the callback
    should abort the process and let the coordination service restart
    the job).

    One monitor thread serves the whole run (arm/disarm just move a
    deadline under a condition variable — no per-step thread churn), and
    once ``disarm`` returns, no fire for that section can happen: the
    deadline check AND the report itself run under the lock, so a
    concurrent ``disarm`` either cancels the fire or blocks until the
    report finishes. The deadline is consumed BEFORE the report, so one
    expired section fires exactly once — re-arming during an in-flight
    ``_fire`` (the lock is re-entrant, so even a stage callback may
    re-arm) starts a NEW section and can never double-fire the old one.

    ``escalation`` graduates successive fires instead of the all-at-once
    legacy report: fire #n runs stage ``escalation[min(n-1, len-1)]`` —
    ``"warn"`` logs only, ``"dump"`` adds the stack/ring/flight
    post-mortem, ``"abort"`` additionally invokes ``on_hang`` (the
    process-abort callback in the engines). While stages remain, an
    expired section re-arms itself for another ``timeout_s`` — a
    persistently wedged step climbs the whole ladder with no help from
    the (blocked) training thread, and ``disarm`` still cancels at any
    rung. ``None`` keeps the legacy behavior: every fire warns, dumps,
    and calls ``on_hang``, exactly once per section.
    """

    STAGES = ("warn", "dump", "abort")

    def __init__(
        self,
        timeout_s: float,
        on_hang: Callable[[float], None] | None = None,
        dump_stacks: bool = True,
        metric_ring: Any | None = None,
        ring_tail: int = 32,
        flight_recorder: Any | None = None,
        escalation: tuple[str, ...] | None = None,
    ):
        if escalation is not None:
            escalation = tuple(escalation)
            bad = [s for s in escalation if s not in self.STAGES]
            if bad or not escalation:
                raise ValueError(
                    f"escalation stages must be drawn from {self.STAGES}, "
                    f"got {escalation!r}"
                )
        self.escalation = escalation
        self.last_stage: str | None = None  # stage of the newest fire
        self.timeout_s = timeout_s
        self.on_hang = on_hang
        self.dump_stacks = dump_stacks
        # Any object with .tail(n) -> list[dict] (obs.sinks.RingSink):
        # on firing, the last N step records are flushed to the log so
        # the operator sees what the run was doing when it wedged —
        # stacks say WHERE the host is stuck, the ring says WHAT the
        # training was converging (or not) toward.
        self.metric_ring = metric_ring
        self.ring_tail = ring_tail
        # obs.flight.FlightRecorder (anything with .dump(reason, **kw)):
        # adds the phase-timing tail and straggler stats to the report —
        # the ring says what the LOSS was doing, the flight recorder
        # says what the STEP TIMES were doing before the hang.
        self.flight_recorder = flight_recorder
        self.fired = 0  # total hang detections (for tests/metrics)
        self._log = get_logger()
        # Re-entrant lock: a stage callback (which runs inside _fire,
        # under the lock, on the monitor thread) may legitimately
        # re-arm for the next section without deadlocking.
        self._cv = threading.Condition(threading.RLock())
        self._deadline: float | None = None  # None = disarmed
        self._armed_timeout = timeout_s
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="step-watchdog", daemon=True
        )
        self._thread.start()

    def arm(self, timeout_s: float | None = None) -> None:
        """Start the countdown for one section; ``timeout_s`` overrides the
        default for sections with a different latency envelope (e.g. a
        checkpoint save)."""
        with self._cv:
            self._armed_timeout = timeout_s if timeout_s is not None else self.timeout_s
            self._deadline = time.monotonic() + self._armed_timeout
            self._cv.notify()

    def disarm(self) -> None:
        """The step completed in time; stop the countdown."""
        with self._cv:
            self._deadline = None
            self._cv.notify()

    @contextlib.contextmanager
    def watch(self):
        """Context manager: ``arm`` on enter, ``disarm`` on exit (also on
        exception paths)."""
        self.arm()
        try:
            yield self
        finally:
            self.disarm()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._deadline = None
            self._cv.notify()
        self._thread.join(timeout=5)

    def _run(self) -> None:
        while True:
            with self._cv:
                if self._closed:
                    return
                if self._deadline is None:
                    self._cv.wait()
                    continue
                now = time.monotonic()
                remaining = self._deadline - now
                if remaining > 0:
                    self._cv.wait(timeout=remaining)
                    continue
                # Expired while still armed: consume the deadline (fire
                # once per section) and report WHILE HOLDING the lock, so
                # disarm() can never return with a fire still pending.
                elapsed = self._armed_timeout + (now - self._deadline)
                self._deadline = None
                self._fire(elapsed, self._armed_timeout)
                if (
                    self.escalation is not None
                    and self.fired < len(self.escalation)
                    and self._deadline is None
                    and not self._closed
                ):
                    # Ladder continuation: the hung thread cannot re-arm,
                    # so a still-wedged section escalates on its own —
                    # next stage after another timeout_s. disarm() (the
                    # section completed after all) cancels as usual; a
                    # stage callback that re-armed keeps ITS deadline.
                    self._deadline = (
                        time.monotonic() + self._armed_timeout
                    )

    def _fire(self, elapsed_s: float, timeout_s: float) -> None:
        self.fired += 1
        if self.escalation is None:
            stage = None  # legacy: warn + dump + callback, every fire
        else:
            stage = self.escalation[
                min(self.fired - 1, len(self.escalation) - 1)
            ]
        self.last_stage = stage
        do_dump = stage in (None, "dump", "abort")
        do_callback = stage in (None, "abort")
        self._log.critical(
            "watchdog: training step exceeded %.1fs (%.1fs elapsed) — host is "
            "likely blocked on a device transfer behind a hung collective"
            "%s",
            timeout_s,
            elapsed_s,
            "; dumping stacks" if do_dump else
            f" (escalation stage {stage!r}, fire #{self.fired})",
        )
        if not do_dump:
            return
        if self.dump_stacks:
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        if self.metric_ring is not None:
            try:
                records = self.metric_ring.tail(self.ring_tail)
            except Exception as e:  # never let telemetry break the report
                self._log.critical("watchdog: metric ring unreadable: %r", e)
                records = []
            if records:
                self._log.critical(
                    "watchdog: last %d metric records before hang:", len(records)
                )
                for rec in records:
                    self._log.critical("watchdog:   %s", json.dumps(rec, default=str))
        if self.flight_recorder is not None:
            try:
                self.flight_recorder.dump(
                    "watchdog", elapsed_s=elapsed_s, timeout_s=timeout_s
                )
            except Exception as e:  # never let telemetry break the report
                self._log.critical("watchdog: flight recorder dump failed: %r", e)
        if do_callback and self.on_hang is not None:
            self.on_hang(elapsed_s)


def _identity_fields() -> dict[str, int]:
    """``process_id``/``generation`` stamps for event records, so a
    multi-process recovery timeline is attributable per rank: the rank
    in the ``torch.distributed`` group (0 without one); generation 0, as
    the port restarts within one process group."""
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    return {"process_id": rank, "generation": 0}


def emit_event(target: Any, event: str, **fields: Any) -> None:
    """Put one ``kind:"event"`` record on ``target``: either a
    ``Telemetry`` (``obs/metrics.py``, has ``emit_event``) or a raw sink
    (``obs/sinks.py``, has ``emit``). None is a no-op — recovery never
    depends on telemetry being configured. Every record is stamped with
    ``process_id``/``generation`` (explicit fields win)."""
    if target is None:
        return
    fields = {**_identity_fields(), **fields}
    if hasattr(target, "emit_event"):
        target.emit_event(event, **fields)
    else:
        target.emit(
            {"kind": "event", "event": event, "time": time.time(), **fields}
        )


def run_with_recovery(
    trainer: Any,
    *,
    max_restarts: int = 2,
    fit_args: tuple = (),
    fit_kwargs: dict[str, Any] | None = None,
    backoff_s: float = 0.0,
    backoff_factor: float = 2.0,
    max_backoff_s: float = 60.0,
    backoff_jitter: str = "none",
    jitter_seed: int | None = None,
    jitter_rng: Any = None,
    sleep: Callable[[float], None] = time.sleep,
    telemetry: Any = None,
    remesh: Callable[[Any, TrainingFailure], Any] | None = None,
):
    """Run ``trainer.fit`` with restart recovery and a graduated
    escalation ladder.

    On a ``TrainingFailure`` (e.g. ``NonFiniteLossError``) the run is
    restarted: ``fit`` restores the newest recoverable state and resumes
    at the recorded step, so work since that state — including the steps
    that produced the divergence — is replayed from known-good state.
    The restore tier is ``fit``'s arbitration: the in-memory replicated
    snapshot (``trainer.memstore``, zero filesystem reads) when it is at
    least as new as the newest disk checkpoint, else the disk
    checkpoint. Requires at least one tier —
    ``trainer.cfg.checkpoint_dir`` or a ``trainer.memstore`` (without
    either there is nothing to restart FROM, and the failure re-raises
    immediately).

    ``backoff_s`` arms exponential backoff between restarts (attempt n
    sleeps ``backoff_s * backoff_factor**(n-1)``, capped at
    ``max_backoff_s``) — in a real deployment the fault is usually
    environmental and hammering the restart path makes it worse.
    ``sleep`` is injectable for tests.

    ``backoff_jitter="decorrelated"`` switches to decorrelated jitter
    (attempt n sleeps ``uniform(backoff_s, prev * 3)``, capped at
    ``max_backoff_s``): after a process loss, N surviving ranks all
    restart at once, and deterministic exponential backoff keeps them in
    lockstep — every survivor hammers the re-elected coordinator at the
    same instant, every attempt. The jitter stream is seeded per
    ``(jitter_seed, process_id, generation)`` so each rank draws a
    DIFFERENT (but reproducible) sequence; pass ``jitter_rng`` to inject
    the generator directly in tests. The default ``"none"`` keeps the
    deterministic schedule bit-for-bit.

    A ``DeviceLossError`` escalates past retry: when ``remesh`` is
    given, it is called as ``remesh(trainer, failure)`` and must return
    a NEW trainer on the surviving world (carrying the memstore over).
    Without ``remesh`` (the default: the elastic restore is not ported)
    the device loss restarts on the same group and will typically fail
    again until ``max_restarts`` gives up.

    Every transition emits a ``kind:"event"`` record on ``telemetry``
    (a ``Telemetry`` or raw obs sink): ``recovery_restart`` per attempt
    (with tier/backoff/failure), ``recovery_remesh`` on re-mesh,
    ``recovery_complete`` / ``recovery_giveup`` at the end.

    Works with a trainer whose ``fit`` restores from those tiers (the
    CIFAR ``Trainer``: ``fit()`` -> ``(state, history)``; the
    ``LMTrainer``: ``fit(tokens, steps)`` -> ``(model, optimizer,
    losses)``); returns ``fit``'s tuple with ``restarts`` appended.
    """
    log = get_logger()
    if not (
        getattr(trainer.cfg, "checkpoint_dir", None)
        or getattr(trainer, "memstore", None) is not None
    ):
        raise ValueError(
            "run_with_recovery needs cfg.checkpoint_dir or an in-memory "
            "snapshot tier (trainer.memstore): restart-based recovery "
            "resumes from the newest recoverable state"
        )
    if backoff_jitter not in ("none", "decorrelated"):
        raise ValueError(
            f'backoff_jitter must be "none" or "decorrelated", '
            f"got {backoff_jitter!r}"
        )
    rng = jitter_rng
    if backoff_jitter == "decorrelated" and rng is None:
        identity = _identity_fields()
        rng = np.random.default_rng(
            (
                0 if jitter_seed is None else int(jitter_seed),
                identity.get("process_id", 0),
                identity.get("generation", 0),
            )
        )
    prev_delay = backoff_s
    kwargs = fit_kwargs or {}
    restarts = 0
    while True:
        try:
            result = trainer.fit(*fit_args, **kwargs)
            if restarts:
                emit_event(
                    telemetry, "recovery_complete", restarts=restarts
                )
            return (*result, restarts)
        except TrainingFailure as e:
            restarts += 1
            if restarts > max_restarts:
                emit_event(
                    telemetry,
                    "recovery_giveup",
                    restarts=restarts - 1,
                    failure=repr(e),
                    # The full traceback string, not just repr(e): a
                    # giveup is the record the operator debugs FROM, and
                    # by then the process that could re-raise is gone.
                    traceback="".join(_traceback.format_exception(e)),
                )
                log.critical(
                    "giving up after %d restarts (last failure: %s)", restarts - 1, e
                )
                raise
            delay = 0.0
            if backoff_s > 0:
                if backoff_jitter == "decorrelated":
                    delay = min(
                        float(
                            rng.uniform(
                                backoff_s, max(backoff_s, prev_delay * 3.0)
                            )
                        ),
                        max_backoff_s,
                    )
                    prev_delay = delay
                else:
                    delay = min(
                        backoff_s * backoff_factor ** (restarts - 1),
                        max_backoff_s,
                    )
            tier = "restart"
            if isinstance(e, DeviceLossError) and remesh is not None:
                old_world = int(getattr(trainer, "world_size", 0))
                trainer = remesh(trainer, e)
                new_world = int(getattr(trainer, "world_size", 0))
                tier = "remesh"
                emit_event(
                    telemetry,
                    "recovery_remesh",
                    old_world=old_world,
                    new_world=new_world,
                    lost=list(e.lost),
                )
                log.error(
                    "device loss (%s): re-meshed %d -> %d devices",
                    e,
                    old_world,
                    new_world,
                )
            emit_event(
                telemetry,
                "recovery_restart",
                restart=restarts,
                max_restarts=max_restarts,
                failure=repr(e),
                tier=tier,
                backoff_s=delay,
            )
            log.error(
                "training failure (%s); restart %d/%d from newest "
                "recoverable state (backoff %.1fs)",
                e,
                restarts,
                max_restarts,
                delay,
            )
            if delay > 0:
                sleep(delay)
