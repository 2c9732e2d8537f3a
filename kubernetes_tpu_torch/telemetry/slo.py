"""Declarative SLO rules over the TSDB: burn-rate + threshold alerts.

The watchdog in trace/slo.py judges one histogram inside one daemon;
this engine judges the whole control plane from the scraped series
history. Two rule shapes:

- ``ThresholdRule``: a query value (a rate, or a histogram quantile
  over a recent window) compared against a static bound — the
  "scheduler e2e p99 vs its objective" class of alert.
- ``BurnRateRule``: the Google-SRE multi-window burn rate. The burn
  rate is (bad events / total events) / error budget over a window; a
  page fires only when BOTH the short window (fresh breach, fast
  reset) and the long window (sustained, not a blip) exceed their
  multipliers — the standard 14.4x/6x pairing scaled down to this
  repo's soak-length horizons.

Every evaluation tick updates ``telemetry_alerts_firing`` (one gauge
child per rule) and, on a fire transition, emits a
``TelemetrySLOBreach`` Warning Event through client/record.py and
invokes the engine's ``on_fire`` hook — which the flight recorder
registers to dump a bundle the moment an alert goes red.

Copy of kubernetes_tpu/telemetry/slo.py: only the import package differs.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from kubernetes_tpu_torch.analysis import races as _races
from kubernetes_tpu_torch.telemetry.tsdb import TSDB

log = logging.getLogger(__name__)


class Telemetry:
    """Event involvedObject for pipeline-level (podless) events; the
    class name renders as the Event kind (record.object_reference
    uses type(obj).__name__), mirroring trace/slo.py's shim."""

    def __init__(self, name: str = "telemetry",
                 namespace: str = "kube-system"):
        from kubernetes_tpu_torch.api.types import ObjectMeta

        self.metadata = ObjectMeta(name=name, namespace=namespace)


class ThresholdRule:
    """Fire while ``value(db, now) > threshold``. ``value`` is either
    a callable or a (kind, metric) pair handled by the built-ins."""

    def __init__(self, name: str,
                 value: Callable[[TSDB, float], Optional[float]],
                 threshold: float, description: str = ""):
        self.name = name
        self.value = value
        self.threshold = float(threshold)
        self.description = description or name

    def evaluate(self, db: TSDB, now: float):
        v = self.value(db, now)
        if v is None:
            return False, None
        return v > self.threshold, v


class BurnRateRule:
    """Multi-window burn rate: bad/total over each window, divided by
    the error budget; fires when both windows exceed their factors."""

    def __init__(self, name: str, bad: str, total: str,
                 budget: float = 0.01,
                 short_window: float = 300.0, long_window: float = 3600.0,
                 short_factor: float = 14.4, long_factor: float = 6.0,
                 description: str = ""):
        self.name = name
        self.bad = bad          # counter metric: the bad events
        self.total = total      # counter metric: all events
        self.budget = float(budget)
        self.short_window = float(short_window)
        self.long_window = float(long_window)
        self.short_factor = float(short_factor)
        self.long_factor = float(long_factor)
        self.description = description or name

    def _burn(self, db: TSDB, window: float,
              now: float) -> Optional[float]:
        bad = sum(v for _, v in db.rate(self.bad, window=window, now=now))
        total = sum(
            v for _, v in db.rate(self.total, window=window, now=now))
        if total <= 0:
            return None
        return (bad / total) / self.budget

    def evaluate(self, db: TSDB, now: float):
        short = self._burn(db, self.short_window, now)
        long_ = self._burn(db, self.long_window, now)
        if short is None or long_ is None:
            return False, short
        firing = (short > self.short_factor and long_ > self.long_factor)
        return firing, short


def _rate_value(metric: str,
                window: float = 60.0) -> Callable[[TSDB, float],
                                                  Optional[float]]:
    def value(db: TSDB, now: float) -> Optional[float]:
        rows = db.rate(metric, window=window, now=now)
        if not rows:
            return None
        return sum(v for _, v in rows)

    return value


def _quantile_value(q: float, metric: str,
                    window: float = 60.0) -> Callable[[TSDB, float],
                                                      Optional[float]]:
    def value(db: TSDB, now: float) -> Optional[float]:
        return db.quantile(q, metric, window=window, now=now)

    return value


def default_rules(slo_seconds: float = 5.0) -> List[object]:
    """The stock alert set over the families every profile exports.
    Rates tolerate short scrape histories (a rule with no samples in
    its window simply doesn't fire)."""
    return [
        # the headline objective: created->bound p99 against the soak
        # SLO, read from the scheduler's (microsecond-unit) histogram
        ThresholdRule(
            "scheduler-e2e-p99",
            _quantile_value(
                0.99, "scheduler_e2e_scheduling_latency_microseconds",
                window=60.0),
            slo_seconds * 1e6,
            description="p99 e2e scheduling latency vs objective",
        ),
        # created->bound error burn: pods that breached the objective
        # (scheduler_slo_breach_total) against pods scheduled, at the
        # SRE 5m/1h double window
        BurnRateRule(
            "bind-slo-burn-rate",
            bad="scheduler_slo_breach_total",
            total="scheduler_e2e_scheduling_latency_microseconds_count",
            budget=0.01, short_window=300.0, long_window=3600.0,
            description="created->bound SLO error-budget burn (5m+1h)",
        ),
        ThresholdRule(
            "apf-shed-rate",
            _rate_value("apiserver_flowcontrol_rejected_requests_total",
                        window=60.0),
            5.0,
            description="APF 429 sheds per second (sustained)",
        ),
        ThresholdRule(
            "quorum-leader-churn",
            _rate_value("quorum_leader_changes_total", window=300.0),
            1.0 / 60.0,
            description="leader changes per second over 5m",
        ),
        ThresholdRule(
            "watch-event-drops",
            _rate_value("storage_watch_events_dropped_total",
                        window=60.0),
            0.0,
            description="any dropped watch event",
        ),
        ThresholdRule(
            "preemption-storm",
            _rate_value("scheduler_preemption_victims_total",
                        window=60.0),
            50.0,
            description="preemption victims per second",
        ),
    ]


class Engine:
    """Evaluate the rule set each tick, track firing state, emit
    events + the firing gauge, and call ``on_fire`` on transitions.

    Thread contract: all mutable state guarded by ``self._lock`` (the
    collector tick and /debug readers race)."""

    HISTORY = 512

    def __init__(self, db: TSDB, rules: Optional[Sequence] = None,
                 recorder=None,
                 on_fire: Optional[Callable[[dict], None]] = None,
                 slo_seconds: float = 5.0):
        self.db = db
        self.rules = list(rules if rules is not None
                          else default_rules(slo_seconds))
        self.recorder = recorder
        self.on_fire = on_fire
        self._component = Telemetry()
        self._lock = threading.Lock()
        #: rule name -> {"firing", "since", "value"}  # guarded-by: self._lock
        self._state: Dict[str, dict] = {}
        #: alert transition ring (the bundle's timeline)  # guarded-by: self._lock
        self._history: deque = deque(maxlen=self.HISTORY)
        _races.track(self, "telemetry.slo-engine")

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One evaluation pass; returns the current per-rule states.
        Rule evaluation happens OUTSIDE the lock (it reads the TSDB,
        which has its own); only the state flip is locked."""
        if now is None:
            now = time.time()
        fired: List[dict] = []
        states: List[dict] = []
        for rule in self.rules:
            try:
                firing, value = rule.evaluate(self.db, now)
            except Exception:
                log.debug("rule %s evaluation failed", rule.name,
                          exc_info=True)
                continue
            with self._lock:
                st = self._state.setdefault(
                    rule.name, {"firing": False, "since": None,
                                "value": None})
                was = st["firing"]
                st["value"] = value
                if firing and not was:
                    st["firing"] = True
                    st["since"] = now
                    self._history.append({
                        "t": now, "alert": rule.name, "state": "firing",
                        "value": value,
                        "description": rule.description,
                    })
                elif not firing and was:
                    st["firing"] = False
                    st["since"] = None
                    self._history.append({
                        "t": now, "alert": rule.name,
                        "state": "resolved", "value": value,
                    })
                snap = {"alert": rule.name,
                        "description": rule.description, **st}
            self._gauge(rule.name).set(1.0 if firing else 0.0)
            if firing and not was:
                fired.append(snap)
            states.append(snap)
        for snap in fired:
            self._emit(snap)
        return states

    @staticmethod
    def _gauge(rule_name: str):
        from kubernetes_tpu_torch.metrics import telemetry_alerts_firing

        return telemetry_alerts_firing.labels(rule_name)

    def _emit(self, snap: dict) -> None:
        log.warning("telemetry alert firing: %s (value=%s)",
                    snap["alert"], snap["value"])
        if self.recorder is not None:
            try:
                self.recorder.eventf(
                    self._component, "Warning", "TelemetrySLOBreach",
                    "alert %s firing: %s (value %s)",
                    snap["alert"], snap["description"], snap["value"],
                )
            except Exception:
                log.debug("alert event emission failed", exc_info=True)
        if self.on_fire is not None:
            try:
                self.on_fire(dict(snap))
            except Exception:
                log.debug("on_fire hook failed", exc_info=True)

    def active(self) -> List[dict]:
        """Currently-firing alerts (kubectl alerts, /debug endpoint)."""
        with self._lock:
            return [
                {"alert": name, **st}
                for name, st in sorted(self._state.items())
                if st["firing"]
            ]

    def states(self) -> List[dict]:
        with self._lock:
            return [{"alert": name, **st}
                    for name, st in sorted(self._state.items())]

    def history(self) -> List[dict]:
        with self._lock:
            return list(self._history)
