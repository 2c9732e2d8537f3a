"""Injectable clocks.

The reference threads deterministic time through every time-dependent
state machine (schedulercache/cache.go:106 takes `now`; util/wait uses a
real clock). Same seam here: production code takes a Clock, tests pass a
FakeClock they can step.

Copy of kubernetes_tpu/utils/clock.py: only the import package differs.
"""

from __future__ import annotations

import threading
import time


class Clock:
    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError


class RealClock(Clock):
    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


class FakeClock(Clock):
    """Manually stepped clock. sleep() advances time immediately so wait
    loops driven by a FakeClock run as fast as the test can schedule."""

    def __init__(self, start: float = 0.0):
        self._now = start
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._now

    def sleep(self, seconds: float) -> None:
        self.step(seconds)

    def step(self, seconds: float) -> None:
        with self._lock:
            self._now += seconds


DEFAULT_CLOCK = RealClock()
