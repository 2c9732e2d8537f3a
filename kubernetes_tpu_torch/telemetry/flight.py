"""Breach-triggered flight recorder: dump the last N minutes of state.

When an alert fires — or a soak gate breaches — the interesting
question is "what else was moving?", and by the time a human looks,
the process (or the whole fleet) is gone. The recorder answers it with
a bundle directory written at the moment of the breach:

    meta.json     reason, wall time, firing alerts at dump time
    series.jsonl  every TSDB series' last `window` seconds, one
                  JSON line per series ({"name","labels","samples"})
    alerts.json   the engine's full alert transition timeline
    traces.json   the /debug/traces ring (trace/httpd.render_traces)
    audit.json    the audit tail (audit.render_audit)
    procs.json    per-process /debug/flowcontrol + /healthz quorum
                  state — live-fetched when the processes still
                  answer, else the collector's last cached snapshot
                  (a kill -9'd replica can't testify at dump time)

Bundles are debounced (a storm of alerts produces one bundle, not
fifty), pruned oldest-first past ``max_bundles``, and indexed at
``/debug/flightrecorder`` on every component mux.

Copy of kubernetes_tpu/telemetry/flight.py: only the import package differs.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from kubernetes_tpu_torch.analysis import races as _races
from kubernetes_tpu_torch.telemetry.tsdb import TSDB

log = logging.getLogger(__name__)


class FlightRecorder:
    """Thread contract: bundle bookkeeping guarded by ``self._lock``;
    record() may be called from the collector tick, the SLO engine's
    on_fire hook, and the soak driver concurrently."""

    def __init__(self, db: TSDB, out_dir: str,
                 window: float = 300.0,
                 engine=None,
                 state_sources: Optional[
                     Dict[str, Callable[[], object]]] = None,
                 min_interval: float = 10.0,
                 max_bundles: int = 8):
        self.db = db
        self.out_dir = out_dir
        self.window = float(window)
        self.engine = engine
        self.state_sources = dict(state_sources or {})
        self.min_interval = float(min_interval)
        self.max_bundles = int(max_bundles)
        self._lock = threading.Lock()
        #: monotonic time of the last dump (debounce)  # guarded-by: self._lock
        self._last_dump = 0.0
        #: bundle dir names, oldest first  # guarded-by: self._lock
        self._bundles: List[str] = []
        #: bundle sequence number  # guarded-by: self._lock
        self._seq = 0
        _races.track(self, "telemetry.flight-recorder")

    def add_state_source(self, name: str,
                         fn: Callable[[], object]) -> None:
        with self._lock:
            self.state_sources[name] = fn

    def record(self, reason: str,
               extra: Optional[dict] = None,
               force: bool = False) -> Optional[str]:
        """Write one bundle; returns its directory, or None when the
        debounce swallowed the trigger. ``force`` bypasses the
        debounce (the soak's end-of-run gate breach must always leave
        a bundle, even seconds after an alert already dumped one)."""
        now_mono = time.monotonic()
        with self._lock:
            if not force and \
                    now_mono - self._last_dump < self.min_interval:
                return None
            self._last_dump = now_mono
            self._seq += 1
            seq = self._seq
        slug = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in reason)[:48]
        bundle = os.path.join(self.out_dir, f"bundle-{seq:03d}-{slug}")
        try:
            os.makedirs(bundle, exist_ok=True)
            self._write_meta(bundle, reason, extra)
            self._write_series(bundle)
            self._write_alerts(bundle)
            self._write_traces(bundle)
            self._write_audit(bundle)
            self._write_procs(bundle)
        except Exception:
            log.exception("flight-recorder dump failed (%s)", reason)
            return None
        with self._lock:
            self._bundles.append(bundle)
            doomed = []
            while len(self._bundles) > self.max_bundles:
                doomed.append(self._bundles.pop(0))
        for old in doomed:
            _rmtree_quiet(old)
        log.warning("flight-recorder bundle written: %s (%s)",
                    bundle, reason)
        return bundle

    # -- bundle sections ------------------------------------------------------

    def _write_meta(self, bundle: str, reason: str,
                    extra: Optional[dict]) -> None:
        meta = {
            "reason": reason,
            "wall_time": time.time(),
            "window_seconds": self.window,
            "series": self.db.series_count(),
            "samples": self.db.sample_count(),
            "firing": (self.engine.active()
                       if self.engine is not None else []),
        }
        if extra:
            meta["extra"] = extra
        _dump_json(os.path.join(bundle, "meta.json"), meta)

    def _write_series(self, bundle: str) -> None:
        with open(os.path.join(bundle, "series.jsonl"), "w") as f:
            for name in self.db.metric_names():
                for labels, samples in self.db.range(
                        name, window=self.window):
                    f.write(json.dumps({
                        "name": name, "labels": labels,
                        "samples": [[round(t, 3), v]
                                    for t, v in samples],
                    }) + "\n")

    def _write_alerts(self, bundle: str) -> None:
        timeline = (self.engine.history()
                    if self.engine is not None else [])
        _dump_json(os.path.join(bundle, "alerts.json"), timeline)

    def _write_traces(self, bundle: str) -> None:
        from kubernetes_tpu_torch.trace.httpd import render_traces

        _dump_json(os.path.join(bundle, "traces.json"),
                   render_traces({"limit": "2048"}))

    def _write_audit(self, bundle: str) -> None:
        from kubernetes_tpu_torch.audit import render_audit

        _dump_json(os.path.join(bundle, "audit.json"),
                   render_audit({"limit": "512"}))

    def _write_procs(self, bundle: str) -> None:
        with self._lock:
            sources = dict(self.state_sources)
        state: Dict[str, object] = {}
        for name, fn in sorted(sources.items()):
            try:
                state[name] = fn()
            except Exception as e:
                state[name] = {"error": str(e)}
        _dump_json(os.path.join(bundle, "procs.json"), state)

    # -- the /debug/flightrecorder index --------------------------------------

    def index(self) -> dict:
        with self._lock:
            bundles = list(self._bundles)
        items = []
        for b in bundles:
            meta_path = os.path.join(b, "meta.json")
            meta = {}
            try:
                with open(meta_path) as f:
                    meta = json.load(f)
            except (OSError, ValueError):
                pass
            try:
                files = sorted(os.listdir(b))
            except OSError:
                files = []
            items.append({"dir": b, "reason": meta.get("reason", ""),
                          "wall_time": meta.get("wall_time"),
                          "firing": meta.get("firing", []),
                          "files": files})
        return {"kind": "FlightRecorderIndex", "out_dir": self.out_dir,
                "bundles": items}


def _dump_json(path: str, payload) -> None:
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)


def _rmtree_quiet(path: str) -> None:
    import shutil

    try:
        shutil.rmtree(path, ignore_errors=True)
    except OSError:
        pass
