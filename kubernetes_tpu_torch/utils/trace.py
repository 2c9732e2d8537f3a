"""In-process step tracer (pkg/util/trace.go:32-70).

The scheduler traces every cycle and logs steps if the cycle exceeds
20ms (generic_scheduler.go:73-79). Same idiom: Trace(name), .step(msg),
.log_if_long(threshold). On TPU this wraps the host shell around the
jitted program; device-side profiling is jax.profiler's job.

Copy of kubernetes_tpu/utils/trace.py: only the import package differs.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

from kubernetes_tpu_torch.utils.clock import Clock, DEFAULT_CLOCK

logger = logging.getLogger("kubernetes_tpu_torch.trace")


class Trace:
    def __init__(self, name: str, clock: Optional[Clock] = None):
        self.name = name
        self._clock = clock or DEFAULT_CLOCK
        self.start = self._clock.now()
        self.steps: List[Tuple[float, str]] = []

    def step(self, msg: str) -> None:
        self.steps.append((self._clock.now(), msg))

    def total_time(self) -> float:
        return self._clock.now() - self.start

    def log_if_long(self, threshold: float) -> None:
        if self.total_time() >= threshold:
            self.log()

    def log(self) -> None:
        end = self._clock.now()
        lines = [f'Trace "{self.name}" (total {end - self.start:.6f}s):']
        last = self.start
        for t, msg in self.steps:
            lines.append(f'  [{t - self.start:.6f}s] [{t - last:.6f}s] {msg}')
            last = t
        lines.append(f'  "{self.name}" [{end - last:.6f}s] END')
        logger.info("\n".join(lines))
