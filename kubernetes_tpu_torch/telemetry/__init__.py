"""Continuous telemetry pipeline (round 17).

Four layers over the PR 1/2 point-in-time observability stack:

- ``telemetry/tsdb.py``   — bounded in-memory time-series store
  (label interning, delta-encoded fixed-interval rings, count-bounded
  retention) with a rate/sum/quantile query surface;
- ``telemetry/scrape.py`` — one collector thread sampling every
  component (in-process registries AND fleet replica processes over
  HTTP) through the shared exposition parser (``telemetry/expo.py``);
- ``telemetry/slo.py``    — declarative recording/alert rules with
  Google-SRE multi-window burn-rate thresholds, emitting
  ``TelemetrySLOBreach`` Warning Events;
- ``telemetry/flight.py`` — the breach-triggered flight recorder:
  series + traces + audit + per-process quorum/flowcontrol state
  bundled to disk the moment an alert (or a soak gate) goes red.

``KUBERNETES_TPU_TELEMETRY=0`` is the kill switch: every attach point
(scheduler daemon, controller manager, soak harness) checks
``enabled()`` and stays dark when off.

This module also hosts the HTTP handlers behind
``/debug/telemetry/query``, ``/debug/telemetry/alerts`` and
``/debug/flightrecorder``, shared by the component mux
(trace/httpd.py) and the apiserver frontends.

Copy of kubernetes_tpu/telemetry/__init__.py: only the import package differs.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple


def enabled() -> bool:
    """The pipeline kill switch (KUBERNETES_TPU_TELEMETRY=0). Read
    per attach, not at import: tests and the bench A/B arm flip it."""
    return os.environ.get("KUBERNETES_TPU_TELEMETRY", "1").lower() \
        not in ("0", "false", "off")


def handle_query(query: Dict[str, str]) -> Tuple[int, dict]:
    """GET /debug/telemetry/query?q=<expr> against the process
    collector's store (503 when no collector is attached)."""
    from kubernetes_tpu_torch.telemetry import scrape
    from kubernetes_tpu_torch.telemetry.tsdb import QueryError, eval_query

    c = scrape.default()
    if c is None:
        return 503, {"message": "telemetry collector not running "
                                "(KUBERNETES_TPU_TELEMETRY=0, or no "
                                "component attached one)"}
    expr = query.get("q", "")
    if not expr:
        return 200, {
            "kind": "TelemetryIndex",
            "ticks": c.ticks(),
            "jobs": c.jobs(),
            "series": c.db.series_count(),
            "samples": c.db.sample_count(),
            "dropped": c.db.dropped(),
            "metrics": c.db.metric_names(),
        }
    try:
        payload = eval_query(c.db, expr)
    except QueryError as e:
        return 400, {"message": str(e)}
    # the evaluator's scalar/vector/matrix tag moves to resultType
    # (prometheus-style); kind names the API object like every other
    # endpoint payload here does
    payload["resultType"] = payload.pop("kind")
    payload["kind"] = "TelemetryQueryResult"
    return 200, payload


def handle_alerts(query: Dict[str, str]) -> Tuple[int, dict]:
    """GET /debug/telemetry/alerts: current rule states + the
    transition timeline (?firing=1 filters to active alerts)."""
    from kubernetes_tpu_torch.telemetry import scrape

    c = scrape.default()
    if c is None or c.engine is None:
        return 503, {"message": "no SLO engine attached"}
    firing_only = query.get("firing") in ("1", "true")
    return 200, {
        "kind": "TelemetryAlertList",
        "items": (c.engine.active() if firing_only
                  else c.engine.states()),
        "history": c.engine.history(),
    }


def handle_flight(query: Dict[str, str]) -> Tuple[int, dict]:
    """GET /debug/flightrecorder: the bundle index; ?dump=<reason>
    forces a bundle right now (the operator's "grab everything")."""
    from kubernetes_tpu_torch.telemetry import scrape

    c = scrape.default()
    if c is None or c.flight is None:
        return 503, {"message": "no flight recorder attached"}
    reason = query.get("dump", "")
    if reason:
        bundle = c.flight.record(f"manual-{reason}", force=True)
        return 200, {"kind": "FlightRecorderDump", "bundle": bundle}
    return 200, c.flight.index()
