"""Scheduling-latency SLO watchdog.

Kant and Gavel (PAPERS.md) both argue AI-cluster schedulers live or die
by latency attribution against explicit objectives; the reference's
operational analogue is alerting on the scheduler_e2e_scheduling_latency
histogram. This watchdog closes that loop inside the daemon: it samples
the e2e histogram's upper quantile against a configured objective and,
on breach, emits a Warning API Event through the scheduler's recorder
(client/record.py) — visible in `kubectl get events` exactly like
FailedScheduling — and bumps scheduler_slo_breach_total.

Sampling reads two ints and a bucket walk under the histogram lock every
`interval` seconds: free at any scale. Only NEW observations since the
previous sample can fire (an idle daemon never re-alerts on history),
and the event sink's client-side aggregation collapses repeats.

Copy of kubernetes_tpu/trace/slo.py: only the import package differs.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from kubernetes_tpu_torch.metrics import (
    scheduler_e2e_latency,
    scheduler_slo_breach_total,
)

log = logging.getLogger(__name__)


class Scheduler:
    """The Event involvedObject for component-level (podless) events;
    the class name renders as the reference kind (record.py
    object_reference uses type(obj).__name__)."""

    def __init__(self, name: str = "kube-scheduler",
                 namespace: str = "kube-system"):
        from kubernetes_tpu_torch.api.types import ObjectMeta

        self.metadata = ObjectMeta(name=name, namespace=namespace)


class SLOWatchdog:
    """Sample e2e scheduling latency against `objective_seconds` and
    emit API Events on breach. objective_seconds <= 0 disables (the
    daemon constructs one unconditionally and lets config decide)."""

    def __init__(self, recorder, objective_seconds: float,
                 interval: float = 10.0, quantile: float = 0.99,
                 histogram=None):
        self.recorder = recorder
        self.objective = float(objective_seconds)
        self.interval = float(interval)
        self.quantile = float(quantile)
        self.histogram = histogram if histogram is not None \
            else scheduler_e2e_latency
        self._component = Scheduler()
        # start at the current bucket state: history observed before
        # the watchdog existed is not this objective's to judge — and
        # every sample judges only the DELTA since the previous one,
        # so one past latency spike can't keep re-firing forever out
        # of the cumulative histogram
        self._last_counts = self.histogram.bucket_counts()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.breaches = 0

    def _window_percentile(self) -> Optional[float]:
        """The quantile (microseconds) over observations since the last
        sample, from the bucket-count delta; None when nothing new."""
        counts = self.histogram.bucket_counts()
        delta = [c - p for c, p in zip(counts, self._last_counts)]
        self._last_counts = counts
        total = sum(delta)
        if total <= 0:
            return None
        target = self.quantile * total
        cum = 0
        for i, bound in enumerate(self.histogram.buckets):
            cum += delta[i]
            if cum >= target:
                return bound
        return float("inf")  # the overflow bucket

    def check_once(self) -> bool:
        """One sample; True when a breach fired (separable for tests)."""
        p_us = self._window_percentile()
        if p_us is None:
            return False
        # the histogram is microsecond-unit (metrics.py)
        p_seconds = p_us / 1e6
        if p_seconds <= self.objective:
            return False
        self.breaches += 1
        scheduler_slo_breach_total.inc()
        log.warning(
            "scheduling SLO breach: p%d e2e latency %.3fs > objective %.3fs",
            round(self.quantile * 100), p_seconds, self.objective,
        )
        if self.recorder is not None:
            try:
                self.recorder.eventf(
                    self._component,
                    "Warning",
                    "SchedulingSLOBreach",
                    "p%d e2e scheduling latency %.3fs exceeds the %.3fs "
                    "objective",
                    round(self.quantile * 100), p_seconds, self.objective,
                )
            except Exception:
                log.debug("SLO breach event emission failed", exc_info=True)
        return True

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.check_once()
            except Exception:
                log.debug("SLO sample failed", exc_info=True)

    def run(self) -> "SLOWatchdog":
        if self.objective <= 0:
            return self
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="sched-slo-watchdog"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
