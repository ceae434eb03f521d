"""Fault-tolerance runtime: preemption handling, step watchdog / straggler
log, failure injection for tests.

At 1000+ nodes the assumptions are: (a) preemptions are routine (handle
SIGTERM by checkpointing and exiting cleanly), (b) stragglers are detected
by step-time outliers (the watchdog keeps an EWMA and flags steps that
exceed ``straggler_factor``× the typical time), (c) hard failures are
recovered by restart-from-latest-checkpoint (exercised by the integration
tests through :class:`FailureInjector`).

Plain standard-library code, the same as ``repro.runtime.resilience``
apart from the logger's name.  The watchdog times what the host spends
in a step: on the card, kernel launches return before the kernels end,
so a step's duration covers its kernels only where the step waits for
them.
"""
from __future__ import annotations

import contextlib
import logging
import signal
import threading
import time
from dataclasses import dataclass, field

logger = logging.getLogger("repro_torch.resilience")

__all__ = ["PreemptionGuard", "StepWatchdog", "FailureInjector",
           "SimulatedFailure"]


class PreemptionGuard:
    """SIGTERM/SIGINT → ``should_stop`` flag (checkpoint-and-exit)."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._stop = threading.Event()
        self._installed = []
        for sig in signals:
            try:
                prev = signal.signal(sig, self._handler)
                self._installed.append((sig, prev))
            except ValueError:
                pass  # not the main thread — tests

    def _handler(self, signum, frame):
        logger.warning("preemption signal %s received — will checkpoint "
                       "and stop after this step", signum)
        self._stop.set()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def trigger(self):
        """Programmatic preemption (tests)."""
        self._stop.set()


@dataclass
class StepWatchdog:
    """Times steps; flags stragglers; optional hard timeout logging."""

    timeout: float = 0.0                # 0 → no hard timeout
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.1
    _ewma: float = field(default=0.0, init=False)
    _n: int = field(default=0, init=False)
    stragglers: list = field(default_factory=list, init=False)
    durations: list = field(default_factory=list, init=False)

    @contextlib.contextmanager
    def step(self, step_idx: int):
        t0 = time.monotonic()
        yield
        dt = time.monotonic() - t0
        self.durations.append(dt)
        if self._n > 3 and dt > self.straggler_factor * self._ewma:
            self.stragglers.append((step_idx, dt, self._ewma))
            logger.warning("straggler: step %d took %.3fs (typical %.3fs)",
                           step_idx, dt, self._ewma)
        if self.timeout and dt > self.timeout:
            logger.error("step %d exceeded hard timeout (%.1fs > %.1fs)",
                         step_idx, dt, self.timeout)
        self._ewma = (dt if self._n == 0
                      else (1 - self.ewma_alpha) * self._ewma
                      + self.ewma_alpha * dt)
        self._n += 1


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Deterministically raise at a given step (restart-recovery tests)."""

    fail_at_step: int = -1
    armed: bool = True

    def check(self, step: int):
        if self.armed and step == self.fail_at_step:
            self.armed = False
            raise SimulatedFailure(f"injected failure at step {step}")
