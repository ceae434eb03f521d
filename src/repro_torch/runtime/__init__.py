"""Resilience runtime: preemption, watchdog/straggler detection, injection
(:mod:`.resilience`)."""
from .resilience import (FailureInjector, PreemptionGuard, SimulatedFailure,
                         StepWatchdog)

__all__ = ["PreemptionGuard", "StepWatchdog", "FailureInjector",
           "SimulatedFailure"]
