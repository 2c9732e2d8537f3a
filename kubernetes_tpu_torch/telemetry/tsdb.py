"""Bounded in-memory time-series store (the telemetry pipeline's TSDB).

Prometheus-shaped storage scaled to a single control-plane process:
label sets are interned once (a series key is (name, labelset-id), not
a dict per sample), every series is a fixed-interval ring buffer of
delta-encoded samples (counters — the dominant family — store small
int deltas, not absolute floats), and retention is by sample count so
the store's footprint is a hard bound, not a hope. On top sits a small
query surface: ``range`` (windowed samples), ``rate`` (counter-reset
aware per-series rates), ``sum_by`` (label aggregation), ``quantile``
(histogram-quantile estimation over ``_bucket`` series, the
prometheus ``histogram_quantile`` interpolation), and a one-line query
language (``rate(name{k="v"}[30s])``) shared by the
``/debug/telemetry/query`` endpoint and ``kubectl metrics query``.

Series cardinality is capped per metric at ingest: a metric whose
declared ``label_bound`` (metrics/metrics.py) — or the default cap —
is exceeded drops the sample and counts it in
``telemetry_series_dropped_total``, so a caller-controlled label can
never balloon the store (the same rule tests/test_metrics_lint.py
enforces statically at the declaration site).

Copy of kubernetes_tpu/telemetry/tsdb.py: only the import package differs.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.analysis import races as _races

Labels = Dict[str, str]
LabelsKey = Tuple[Tuple[str, str], ...]
Sample = Tuple[float, float]


def _labels_key(labels: Labels) -> LabelsKey:
    return tuple(sorted(labels.items()))


class Ring:
    """One series: a fixed-interval, fixed-capacity ring of
    delta-encoded samples. The first retained sample is stored
    absolute; each later sample is a delta from its predecessor (an
    int when both endpoints are integral — the counter case — else a
    float). Evicting the oldest sample folds its delta into the base,
    so the chain never breaks. NOT self-locking: the owning TSDB's
    lock guards every ring (one lock for the whole store, taken once
    per scrape batch, not per sample)."""

    __slots__ = ("interval", "capacity", "_v0", "_last", "_t_last",
                 "_deltas")

    def __init__(self, interval: float, capacity: int):
        self.interval = max(1e-3, float(interval))
        self.capacity = max(2, int(capacity))
        self._v0 = 0.0          # value of the oldest retained sample
        self._last = 0.0        # value of the newest sample
        self._t_last = 0.0      # wall time of the newest sample
        self._deltas: deque = deque()  # len == sample count - 1

    def __len__(self) -> int:
        if self._t_last == 0.0:
            return 0
        return len(self._deltas) + 1

    def append(self, t: float, v: float) -> None:
        v = float(v)
        if self._t_last == 0.0:
            self._v0 = self._last = v
            self._t_last = t
            return
        delta: float = v - self._last
        if float(v).is_integer() and float(self._last).is_integer():
            # the counter fast path: int deltas are small exact ints
            # (python ints), never accumulating float error over the
            # cumulative-sum decode
            delta = int(v) - int(self._last)
        self._deltas.append(delta)
        self._last = v
        self._t_last = t
        while len(self._deltas) > self.capacity - 1:
            self._v0 += self._deltas.popleft()

    def samples(self, since: Optional[float] = None) -> List[Sample]:
        """Decode to [(t, v)] oldest-first; ``since`` trims to samples
        at or after that wall time. Timestamps are reconstructed from
        the newest sample's time on the fixed interval grid (scrape
        jitter inside a tick is below the store's resolution)."""
        n = len(self)
        if n == 0:
            return []
        out: List[Sample] = []
        v = self._v0
        t = self._t_last - (n - 1) * self.interval
        if since is None or t >= since:
            out.append((t, float(v)))
        for d in self._deltas:
            v += d
            t += self.interval
            if since is None or t >= since:
                out.append((t, float(v)))
        if out:
            # pin the newest sample to its true wall time so windowed
            # rates divide by real elapsed time
            out[-1] = (self._t_last, out[-1][1])
        return out


class TSDB:
    """The store: interned label sets + one Ring per (name, labels).

    Thread contract: every piece of shared state is guarded by
    ``self._lock`` (one coarse lock — the write load is one scrape
    batch per tick, the read load an occasional query)."""

    DEFAULT_SERIES_CAP = 256

    def __init__(self, interval: float = 1.0,
                 retention_samples: int = 600,
                 max_series_per_metric: int = DEFAULT_SERIES_CAP,
                 clock: Callable[[], float] = time.time):
        self.interval = float(interval)
        self.retention_samples = int(retention_samples)
        self.max_series_per_metric = int(max_series_per_metric)
        self._clock = clock
        self._lock = threading.Lock()
        #: label-set intern table: key -> small id  # guarded-by: self._lock
        self._intern: Dict[LabelsKey, int] = {}
        #: id -> labels dict (decode side of the intern table)  # guarded-by: self._lock
        self._labels_by_id: List[Labels] = []
        #: (metric name, labelset id) -> Ring  # guarded-by: self._lock
        self._series: Dict[Tuple[str, int], Ring] = {}
        #: series count per metric name (cardinality cap)  # guarded-by: self._lock
        self._per_metric: Dict[str, int] = {}
        #: per-metric declared cardinality bounds  # guarded-by: self._lock
        self._bounds: Dict[str, int] = {}
        #: samples dropped by the cap, per metric  # guarded-by: self._lock
        self._dropped: Dict[str, int] = {}
        _races.track(self, "telemetry.tsdb")

    # -- ingest ---------------------------------------------------------------

    def set_metric_bound(self, name: str, bound: int) -> None:
        """Declare a series-cardinality cap for one metric (the scrape
        layer installs the registry's ``label_bound`` declarations)."""
        with self._lock:
            self._bounds[name] = int(bound)

    def append(self, name: str, labels: Labels, value: float,
               t: Optional[float] = None) -> bool:
        """Ingest one sample; False when the cardinality cap dropped
        it. New (name, labels) pairs intern the label set and open a
        ring; existing series append in O(1)."""
        if t is None:
            t = self._clock()
        key = _labels_key(labels)
        with self._lock:
            return self._append_locked(name, key, labels, value, t)

    def ingest(self, rows: Sequence[Tuple[str, Labels, float]],
               job: str = "", t: Optional[float] = None) -> int:
        """Ingest one scrape batch of exposition rows (the shared
        parser's output), stamping each with a ``job`` label; returns
        the number of samples stored. One lock acquisition for the
        whole batch."""
        if t is None:
            t = self._clock()
        stored = 0
        with self._lock:
            for name, labels, value in rows:
                if job:
                    labels = dict(labels)
                    labels["job"] = job
                if self._append_locked(name, _labels_key(labels),
                                       labels, value, t):
                    stored += 1
        return stored

    def _append_locked(self, name: str, key: LabelsKey, labels: Labels,
                       value: float, t: float) -> bool:
        lid = self._intern.get(key)
        if lid is None:
            lid = len(self._labels_by_id)
            self._intern[key] = lid
            self._labels_by_id.append(dict(labels))
        skey = (name, lid)
        ring = self._series.get(skey)
        if ring is None:
            cap = self._bounds.get(name, self.max_series_per_metric)
            if self._per_metric.get(name, 0) >= cap:
                self._dropped[name] = self._dropped.get(name, 0) + 1
                self._note_dropped(name)
                return False
            ring = Ring(self.interval, self.retention_samples)
            self._series[skey] = ring
            self._per_metric[name] = self._per_metric.get(name, 0) + 1
        ring.append(t, value)
        return True

    def _note_dropped(self, name: str) -> None:
        # local import: metrics/metrics.py must not import this module
        from kubernetes_tpu_torch.metrics import telemetry_series_dropped_total

        telemetry_series_dropped_total.inc(metric=name)

    # -- introspection --------------------------------------------------------

    def series_count(self) -> int:
        with self._lock:
            return len(self._series)

    def sample_count(self) -> int:
        with self._lock:
            return sum(len(r) for r in self._series.values())

    def metric_names(self) -> List[str]:
        with self._lock:
            return sorted({name for name, _ in self._series})

    def dropped(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._dropped)

    # -- queries --------------------------------------------------------------

    def range(self, name: str, matchers: Optional[Labels] = None,
              window: Optional[float] = None,
              now: Optional[float] = None
              ) -> List[Tuple[Labels, List[Sample]]]:
        """Windowed samples for every series of ``name`` whose labels
        include the matcher pairs: [(labels, [(t, v), ...])]."""
        if now is None:
            now = self._clock()
        since = None if window is None else now - window
        matchers = matchers or {}
        out: List[Tuple[Labels, List[Sample]]] = []
        with self._lock:
            hits = [
                (self._labels_by_id[lid], ring)
                for (n, lid), ring in self._series.items()
                if n == name and all(
                    self._labels_by_id[lid].get(k) == v
                    for k, v in matchers.items())
            ]
            for labels, ring in hits:
                samples = ring.samples(since)
                if samples:
                    out.append((dict(labels), samples))
        out.sort(key=lambda it: _labels_key(it[0]))
        return out

    def rate(self, name: str, matchers: Optional[Labels] = None,
             window: float = 60.0, now: Optional[float] = None
             ) -> List[Tuple[Labels, float]]:
        """Per-series counter rate over the window: the sum of
        POSITIVE sample-to-sample increases divided by the covered
        time (a process restart zeroes its counters; the negative jump
        is a reset, not a decrease — prometheus rate() semantics)."""
        out: List[Tuple[Labels, float]] = []
        for labels, samples in self.range(name, matchers, window, now):
            if len(samples) < 2:
                continue
            increase = 0.0
            for (_, a), (_, b) in zip(samples, samples[1:]):
                if b > a:
                    increase += b - a
            elapsed = samples[-1][0] - samples[0][0]
            if elapsed > 0:
                out.append((labels, increase / elapsed))
        return out

    def rate_over_time(self, name: str,
                       matchers: Optional[Labels] = None,
                       window: Optional[float] = None,
                       now: Optional[float] = None
                       ) -> List[Sample]:
        """The summed-across-series rate at every retained tick:
        [(t, pods-per-second-style rate)] — the shape a soak's
        "peak over the run" summary reads off."""
        per_t: Dict[float, float] = {}
        for _labels, samples in self.range(name, matchers, window, now):
            for (t0, a), (t1, b) in zip(samples, samples[1:]):
                if b > a and t1 > t0:
                    per_t[t1] = per_t.get(t1, 0.0) + (b - a) / (t1 - t0)
        return sorted(per_t.items())

    def quantile(self, q: float, name: str,
                 matchers: Optional[Labels] = None,
                 window: Optional[float] = None,
                 now: Optional[float] = None) -> Optional[float]:
        """histogram_quantile over ``<name>_bucket`` series: the
        windowed INCREASE of each cumulative ``le`` bucket (summed
        across series — e.g. across fleet replicas), then linear
        interpolation inside the target bucket. None when the window
        saw no observations. ``name`` may be the bare histogram name
        or the explicit ``*_bucket`` series name."""
        bname = name if name.endswith("_bucket") else name + "_bucket"
        increase: Dict[float, float] = {}
        for labels, samples in self.range(bname, matchers, window, now):
            le_s = labels.get("le", "")
            le = float("inf") if le_s in ("+Inf", "inf") else float(le_s)
            if len(samples) < 2:
                continue
            inc = 0.0
            for (_, a), (_, b) in zip(samples, samples[1:]):
                if b > a:
                    inc += b - a
            increase[le] = increase.get(le, 0.0) + inc
        if not increase:
            return None
        edges = sorted(increase)
        # cumulative per-le counts -> per-bucket counts
        total = increase[edges[-1]] if edges[-1] == float("inf") else \
            max(increase.values())
        if total <= 0:
            return None
        target = q * total
        prev_edge = 0.0
        prev_cum = 0.0
        for le in edges:
            cum = increase[le]
            if cum >= target:
                if le == float("inf"):
                    # the overflow bucket has no upper edge; answer
                    # its lower one (prometheus does the same)
                    return prev_edge
                span = cum - prev_cum
                if span <= 0:
                    return le
                frac = (target - prev_cum) / span
                return prev_edge + (le - prev_edge) * frac
            prev_edge, prev_cum = (0.0 if le == float("inf") else le), cum
        return edges[-1] if edges[-1] != float("inf") else prev_edge


def sum_by(values: Sequence[Tuple[Labels, float]],
           by: Sequence[str] = ()) -> List[Tuple[Labels, float]]:
    """Aggregate [(labels, value)] by the given label names (empty =
    collapse everything into one row) — prometheus ``sum by (...)``."""
    grouped: Dict[LabelsKey, float] = {}
    for labels, v in values:
        key = tuple((k, labels.get(k, "")) for k in sorted(by))
        grouped[key] = grouped.get(key, 0.0) + v
    return [(dict(k), v) for k, v in sorted(grouped.items())]


# -- the one-line query language ----------------------------------------------
#
#   name
#   name{k="v",k2="v2"}
#   name[30s]                      raw windowed samples
#   rate(name{k="v"}[5m])          per-series rate
#   sum(rate(name[1m]))            collapse label sets
#   sum_by(label, rate(name[1m]))  aggregate by one label
#   quantile(0.99, name[5m])       histogram quantile over _bucket
#
# Shared verbatim by /debug/telemetry/query and `kubectl metrics query`.

_SELECTOR_RE = re.compile(
    r"^\s*(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"(?:\[(?P<window>[0-9.]+)(?P<unit>s|m|h)\])?\s*$"
)

_UNIT_SECONDS = {"s": 1.0, "m": 60.0, "h": 3600.0}


class QueryError(ValueError):
    pass


def _parse_selector(expr: str) -> Tuple[str, Labels, Optional[float]]:
    m = _SELECTOR_RE.match(expr)
    if not m:
        raise QueryError(f"unparseable selector {expr!r}")
    labels: Labels = {}
    for pair in (m.group("labels") or "").split(","):
        pair = pair.strip()
        if not pair:
            continue
        if "=" not in pair:
            raise QueryError(f"bad matcher {pair!r}")
        k, _, v = pair.partition("=")
        labels[k.strip()] = v.strip().strip('"')
    window = None
    if m.group("window"):
        window = float(m.group("window")) * _UNIT_SECONDS[m.group("unit")]
    return m.group("name"), labels, window


def _split_call(expr: str, fn: str) -> Optional[str]:
    expr = expr.strip()
    if expr.startswith(fn + "(") and expr.endswith(")"):
        return expr[len(fn) + 1:-1]
    return None


def eval_query(db: TSDB, expr: str,
               now: Optional[float] = None) -> dict:
    """Evaluate one query against the store; returns a JSON-able
    {"expr", "kind", "result"} payload. Raises QueryError on syntax
    errors (the HTTP layer answers 400 with the message)."""
    expr = expr.strip()
    if not expr:
        raise QueryError("empty query")

    inner = _split_call(expr, "quantile")
    if inner is not None:
        q_s, _, sel = inner.partition(",")
        try:
            q = float(q_s)
        except ValueError:
            raise QueryError(f"quantile needs a float, got {q_s!r}")
        if not sel.strip():
            raise QueryError("quantile(q, selector) needs a selector")
        name, labels, window = _parse_selector(sel)
        value = db.quantile(q, name, labels, window or 300.0, now)
        return {"expr": expr, "kind": "scalar", "result": value}

    for agg in ("sum_by", "sum"):
        inner = _split_call(expr, agg)
        if inner is None:
            continue
        by: Tuple[str, ...] = ()
        if agg == "sum_by":
            by_s, _, inner = inner.partition(",")
            by = tuple(x.strip() for x in by_s.split()) if by_s.strip() \
                else ()
        sub = eval_query(db, inner, now)
        if sub["kind"] != "vector":
            raise QueryError(f"{agg}() needs a vector argument")
        rows = [(r["labels"], r["value"]) for r in sub["result"]]
        return {
            "expr": expr, "kind": "vector",
            "result": [{"labels": lb, "value": v}
                       for lb, v in sum_by(rows, by)],
        }

    inner = _split_call(expr, "rate")
    if inner is not None:
        name, labels, window = _parse_selector(inner)
        rows = db.rate(name, labels, window or 60.0, now)
        return {
            "expr": expr, "kind": "vector",
            "result": [{"labels": lb, "value": v} for lb, v in rows],
        }

    name, labels, window = _parse_selector(expr)
    series = db.range(name, labels, window, now)
    return {
        "expr": expr, "kind": "matrix",
        "result": [{"labels": lb,
                    "samples": [[round(t, 3), v] for t, v in ss]}
                   for lb, ss in series],
    }
