"""Health / straggler monitoring for the training driver (own copy of
``repro/ft/health.py``).

Pure decision logic (unit-testable) + a wall-clock watchdog.  On a
multi-host deployment each host runs a monitor; step-time statistics are
exchanged via the regular metrics all-reduce, so no side channel is
needed.
"""
from __future__ import annotations

import enum
import statistics
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional


class Action(enum.Enum):
    CONTINUE = "continue"
    CHECKPOINT_NOW = "checkpoint_now"
    RESTART = "restart"


@dataclass
class HealthMonitor:
    straggler_factor: float = 2.0     # step > factor * median => straggler
    straggler_patience: int = 3       # consecutive slow steps before acting
    window: int = 50
    _times: List[float] = field(default_factory=list)
    _slow_streak: int = 0

    def record_step(self, seconds: float) -> Action:
        self._times.append(seconds)
        if len(self._times) > self.window:
            self._times.pop(0)
        if len(self._times) < 5:
            return Action.CONTINUE
        med = statistics.median(self._times)
        if seconds > self.straggler_factor * med:
            self._slow_streak += 1
        else:
            self._slow_streak = 0
        if self._slow_streak >= self.straggler_patience:
            # persistent straggler: snapshot then restart (the launcher
            # re-plans the mesh without the slow host)
            self._slow_streak = 0
            return Action.RESTART
        if self._slow_streak == 1:
            return Action.CHECKPOINT_NOW   # opportunistic safety snapshot
        return Action.CONTINUE

    @property
    def median_step(self) -> Optional[float]:
        return statistics.median(self._times) if self._times else None


class Watchdog:
    """Raises in the main thread's next check if a step hangs.

    ``clock`` defaults to wall time; the fault-injection harness
    (:mod:`repro_torch.ft.inject`) passes its fake monotonic clock so a hung
    collective is detected deterministically without sleeping."""

    def __init__(self, timeout_s: float, clock=time.monotonic):
        self.timeout = timeout_s
        self.clock = clock
        self._armed_at: Optional[float] = None
        self._lock = threading.Lock()

    def arm(self) -> None:
        with self._lock:
            self._armed_at = self.clock()

    def disarm(self) -> None:
        with self._lock:
            self._armed_at = None

    def check(self) -> bool:
        """True if the armed step exceeded the timeout (hung collective /
        dead host)."""
        with self._lock:
            if self._armed_at is None:
                return False
            return self.clock() - self._armed_at > self.timeout
