"""Client-side flow control (pkg/util/flowcontrol).

TokenBucketRateLimiter backs the REST client's QPS/burst throttle
(throttle.go); Backoff is the per-key exponential backoff used for pod
rescheduling (backoff.go; factory.go:600-613 caps pods at 1s -> 60s).

Copy of kubernetes_tpu/utils/flowcontrol.py: only the import package differs.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional

from kubernetes_tpu_torch.utils.clock import Clock, DEFAULT_CLOCK


class TokenBucketRateLimiter:
    """qps tokens/sec with a burst-sized bucket; accept() blocks until a
    token is available, try_accept() doesn't."""

    def __init__(self, qps: float, burst: int, clock: Optional[Clock] = None):
        if qps <= 0:
            raise ValueError("qps must be positive")
        self.qps = qps
        self.burst = max(1, burst)
        self._clock = clock or DEFAULT_CLOCK
        self._tokens = float(self.burst)
        self._last = self._clock.now()
        self._lock = threading.Lock()

    def _refill(self) -> None:
        now = self._clock.now()
        self._tokens = min(
            float(self.burst), self._tokens + (now - self._last) * self.qps
        )
        self._last = now

    def try_accept(self) -> bool:
        with self._lock:
            self._refill()
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def accept(self) -> None:
        while True:
            with self._lock:
                self._refill()
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    return
                need = (1.0 - self._tokens) / self.qps
            self._clock.sleep(need)


@dataclass
class _BackoffEntry:
    duration: float
    last_update: float


class Backoff:
    """Per-key exponential backoff with garbage collection.

    next_(key): double the key's backoff (capped); is_in_backoff_period
    checks whether the key should still wait; gc() drops entries idle
    for 2*max (backoff.go:GC)."""

    def __init__(
        self, initial: float, max_duration: float, clock: Optional[Clock] = None
    ):
        self.initial = initial
        self.max = max_duration
        self._clock = clock or DEFAULT_CLOCK
        self._entries: Dict[str, _BackoffEntry] = {}
        self._lock = threading.Lock()

    def get(self, key: str) -> float:
        with self._lock:
            e = self._entries.get(key)
            return e.duration if e else 0.0

    def next_(self, key: str) -> float:
        now = self._clock.now()
        with self._lock:
            e = self._entries.get(key)
            if e is None or now - e.last_update > 2 * self.max:
                e = _BackoffEntry(self.initial, now)
            else:
                e = _BackoffEntry(min(e.duration * 2, self.max), now)
            self._entries[key] = e
            return e.duration

    def is_in_backoff_period(self, key: str) -> bool:
        now = self._clock.now()
        with self._lock:
            e = self._entries.get(key)
            return e is not None and now - e.last_update < e.duration

    def reset(self, key: str) -> None:
        with self._lock:
            self._entries.pop(key, None)

    def gc(self) -> None:
        now = self._clock.now()
        with self._lock:
            stale = [
                k
                for k, e in self._entries.items()
                if now - e.last_update > 2 * self.max
            ]
            for k in stale:
                del self._entries[k]
