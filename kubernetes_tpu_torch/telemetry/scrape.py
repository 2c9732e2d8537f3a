"""The telemetry collector: one thread, every component, fixed tick.

Targets come in two shapes, both funneled through the SAME exposition
parser (telemetry/expo.py):

- in-process ``metrics.Registry`` objects, scraped by rendering the
  registry text and parsing it back — so the in-process path
  exercises byte-identical code to the HTTP path and the two can
  never drift;
- ``ApiserverFleet`` replica processes (harness/procs.py), scraped
  over HTTP at ``<url>/metrics``, each stamped with its replica id as
  the ``job`` label. HTTP targets also cache their latest
  ``/healthz`` + ``/debug/flowcontrol`` state so a flight-recorder
  bundle can still testify about a process that died with the breach.

Each tick feeds the TSDB, then runs the SLO engine. The collector
publishes its own cost (``telemetry_scrape_duration_seconds``,
``telemetry_scrape_errors_total``) into the very registry it scrapes.

One collector per process is the norm: ``set_default``/``default``
register it for the /debug/telemetry endpoints on every mux, and
``ensure_default`` is the one-call attach used by the scheduler
daemon and controller manager (honoring the
``KUBERNETES_TPU_TELEMETRY=0`` kill switch).

Copy of kubernetes_tpu/telemetry/scrape.py: only the import package differs.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.analysis import races as _races
from kubernetes_tpu_torch.telemetry import expo
from kubernetes_tpu_torch.telemetry.tsdb import TSDB

log = logging.getLogger(__name__)


class _Target:
    """One scrape target. ``kind`` is "registry" or "http"."""

    __slots__ = ("job", "kind", "registry", "url", "state",
                 "state_every", "_state_countdown")

    def __init__(self, job: str, kind: str, registry=None,
                 url: str = "", state_every: int = 5):
        self.job = job
        self.kind = kind
        self.registry = registry
        self.url = url
        #: last cached /healthz + /debug/flowcontrol (http targets)
        self.state: Dict[str, object] = {}
        self.state_every = max(1, int(state_every))
        self._state_countdown = 0


class Collector:
    """Thread contract: the target list and tick accounting are
    guarded by ``self._lock``; the TSDB and engine carry their own
    locks. The scrape thread is the only writer of the TSDB, but
    queries race it, so everything stays behind locks anyway."""

    def __init__(self, db: Optional[TSDB] = None,
                 interval: float = 1.0,
                 engine=None, flight=None):
        self.interval = float(interval)
        self.db = db if db is not None else TSDB(interval=interval)
        self.engine = engine
        self.flight = flight
        self._lock = threading.Lock()
        #: scrape targets  # guarded-by: self._lock
        self._targets: List[_Target] = []
        #: completed tick count  # guarded-by: self._lock
        self._ticks = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._install_bounds()
        _races.track(self, "telemetry.collector")

    def _install_bounds(self) -> None:
        """Push every declared metric ``label_bound`` into the TSDB's
        ingest-time cardinality caps: the bound declared at the metric
        site (tests/test_metrics_lint.py enforces it exists) is the
        SAME bound the store enforces at scrape time. Histogram
        families fan out per ``le`` bucket, and a fleet multiplies
        series per replica, so the per-series-name cap scales by
        both."""
        from kubernetes_tpu_torch.metrics.metrics import (
            Histogram,
            HistogramVec,
            registry,
        )

        jobs = 8  # headroom for fleet replicas + driver + components
        for m in registry.metrics():
            bound = getattr(m, "label_bound", None)
            if not bound:
                continue
            if isinstance(m, (Histogram, HistogramVec)):
                buckets = getattr(m, "buckets", None) or \
                    getattr(m, "_buckets", None) or []
                per = max(len(buckets) + 1, 16)
                self.db.set_metric_bound(m.name + "_bucket",
                                         bound * per * jobs)
                self.db.set_metric_bound(m.name + "_sum", bound * jobs)
                self.db.set_metric_bound(m.name + "_count",
                                         bound * jobs)
            else:
                self.db.set_metric_bound(m.name, bound * jobs)

    # -- targets --------------------------------------------------------------

    def add_registry(self, job: str, registry=None) -> "Collector":
        if registry is None:
            from kubernetes_tpu_torch.metrics import registry as _global

            registry = _global
        with self._lock:
            self._targets.append(
                _Target(job, "registry", registry=registry))
        return self

    def add_url(self, job: str, url: str) -> "Collector":
        with self._lock:
            self._targets.append(_Target(job, "http", url=url))
        return self

    def attach_fleet(self, fleet) -> "Collector":
        """One HTTP target per ApiserverFleet replica, job = its
        quorum node id (survives restarts: the replica object keeps
        its url/port across restart())."""
        for r in fleet.replicas:
            self.add_url(r.node_id, r.url)
        return self

    def jobs(self) -> List[str]:
        with self._lock:
            return [t.job for t in self._targets]

    def proc_state(self) -> Dict[str, object]:
        """Last cached per-process /healthz + /debug/flowcontrol (the
        flight recorder's procs.json source for fleet targets)."""
        with self._lock:
            targets = list(self._targets)
        return {t.job: dict(t.state) for t in targets
                if t.kind == "http"}

    # -- the tick -------------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> int:
        """One scrape pass over every target (+ one SLO evaluation);
        returns samples stored. Separable from the thread for tests
        and for the soak driver's deterministic final scrape."""
        from kubernetes_tpu_torch.metrics import (
            telemetry_scrape_duration_seconds,
            telemetry_scrape_errors_total,
        )

        if now is None:
            now = time.time()
        with self._lock:
            targets = list(self._targets)
        stored = 0
        t0 = time.perf_counter()
        for target in targets:
            try:
                if target.kind == "registry":
                    rows = expo.parse_text(target.registry.render())
                else:
                    rows = expo.scrape_raw(target.url, timeout=2.0)
                    self._refresh_state(target)
            except Exception:
                telemetry_scrape_errors_total.inc(job=target.job)
                continue
            stored += self.db.ingest(rows, job=target.job, t=now)
        telemetry_scrape_duration_seconds.observe(
            time.perf_counter() - t0)
        if self.engine is not None:
            try:
                self.engine.evaluate(now)
            except Exception:
                log.debug("SLO evaluation failed", exc_info=True)
        with self._lock:
            self._ticks += 1
        return stored

    def _refresh_state(self, target: _Target) -> None:
        # /healthz + /debug/flowcontrol every Nth tick: cheap, and the
        # cache means a dead process still has a last-known state in
        # the bundle
        target._state_countdown -= 1
        if target._state_countdown > 0:
            return
        target._state_countdown = target.state_every
        state: Dict[str, object] = {}
        hz = expo.get_json(target.url, "/healthz", timeout=1.0)
        if hz is not None:
            state["healthz"] = hz
        fc = expo.get_json(target.url, "/debug/flowcontrol",
                           timeout=1.0)
        if fc is not None:
            state["flowcontrol"] = fc
        if state:
            state["wall_time"] = time.time()
            with self._lock:
                target.state = state

    def ticks(self) -> int:
        with self._lock:
            return self._ticks

    # -- lifecycle ------------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception:
                log.debug("telemetry tick failed", exc_info=True)

    def start(self) -> "Collector":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="telemetry-collector")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        th = self._thread
        if th is not None:
            th.join(timeout=5)


# -- the process-default collector --------------------------------------------

_default_lock = threading.Lock()
_default: Optional[Collector] = None


def default() -> Optional[Collector]:
    with _default_lock:
        return _default


def set_default(c: Optional[Collector]) -> None:
    global _default
    with _default_lock:
        _default = c


def ensure_default(job: str,
                   interval: float = 1.0,
                   slo_seconds: float = 5.0,
                   recorder=None,
                   flight_dir: str = "") -> Optional[Collector]:
    """Idempotent one-call attach for daemons: create, start, and
    register the process collector (registry target + SLO engine +
    flight recorder) unless one exists or telemetry is disabled.
    Returns the collector the process ended up with (None = kill
    switch). The CREATING caller owns shutdown via release_default."""
    from kubernetes_tpu_torch import telemetry

    if not telemetry.enabled():
        return None
    global _default
    with _default_lock:
        if _default is not None:
            return _default
        from kubernetes_tpu_torch.telemetry.flight import FlightRecorder
        from kubernetes_tpu_torch.telemetry.slo import Engine

        db = TSDB(interval=interval)
        engine = Engine(db, recorder=recorder, slo_seconds=slo_seconds)
        if not flight_dir:
            import tempfile

            flight_dir = tempfile.mkdtemp(prefix="flight-recorder-")
        flight = FlightRecorder(db, flight_dir, engine=engine)
        engine.on_fire = lambda alert: flight.record(
            f"alert-{alert['alert']}")
        c = Collector(db, interval=interval, engine=engine,
                      flight=flight)
        c.add_registry(job)
        c.start()
        _default = c
        return c


def release_default(c: Optional[Collector]) -> None:
    """Stop + unregister ``c`` if it is the process default (the
    creating daemon's stop() path; a non-owner passes what
    ensure_default returned and this is a no-op for it)."""
    global _default
    if c is None:
        return
    with _default_lock:
        if _default is not c:
            return
        _default = None
    c.stop()
