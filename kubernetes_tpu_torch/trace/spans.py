"""Span API: context-manager spans, a ring buffer, wire propagation.

Shape follows pkg/util/trace.go scaled up to cross-process traces: a
span records (trace_id, span_id, parent_id, name, start, duration,
attrs) into a process-global ring buffer served at /debug/traces and
exportable as JSON lines. Parent/child nesting propagates through a
contextvar (thread- and contextvars-safe). The trace id crosses the TLV
wire as a pod ANNOTATION (metadata.annotations is an ordinary dict field
of the registered ObjectMeta dataclass, so no wire schema change): the
creator stamps it with inject(), the apiserver and scheduler pick it up
with extract(), and one pod's journey apiserver -> scheduler -> bind
reads back as a single trace id across process boundaries.

Tracing is ON by default and force-disabled with KUBERNETES_TPU_TRACE=0
(the bench A/B knob for the overhead budget); when disabled, span()
returns a shared no-op and every record path returns after one global
read.

Copy of kubernetes_tpu/trace/spans.py: only the import package differs.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from contextvars import ContextVar
from typing import Any, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.utils.entropy import rand_hex

#: the annotation carrying the trace id across the wire (v1.3-era alpha
#: annotation idiom, api/types.py: affinity travels the same way)
TRACE_ID_ANNOTATION = "trace.alpha.kubernetes-tpu.io/trace-id"

# (trace_id, span_id) of the innermost open span on this execution context
_CTX: ContextVar[Optional[Tuple[str, str]]] = ContextVar(
    "kubernetes_tpu_trace", default=None
)


def _env_enabled() -> bool:
    raw = os.environ.get("KUBERNETES_TPU_TRACE", "1").strip().lower()
    return raw not in ("0", "false", "off", "no")


_ENABLED = _env_enabled()


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Runtime switch (tests, and the bench overhead A/B)."""
    global _ENABLED
    _ENABLED = bool(on)


def new_trace_id() -> str:
    # buffered thread-local entropy, not uuid4: a urandom syscall per
    # span id was ~0.6s of a 30k-pod wire rep under gVisor
    return rand_hex(16)


def _new_span_id() -> str:
    return rand_hex(8)


def current_trace_id() -> Optional[str]:
    ctx = _CTX.get()
    return ctx[0] if ctx else None


class TraceBuffer:
    """Thread-safe bounded ring of finished spans (oldest evicted).

    Deviation from kubernetes_tpu/trace/spans.py TraceBuffer: it also
    keeps, per span name, the count, seconds and self seconds of every
    span it recorded (totals(), whole across ring eviction, to diff over
    a window), and hands out the spans recorded after a given
    total_recorded (since()), raising where the ring has evicted any of
    them, so a window's spans are read whole or not at all. The ring
    holds 16,384 spans: a 51 s window of back-to-back backlog calls, ten
    spans a call, is some 2,400."""

    def __init__(self, capacity: int = 16384):
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=capacity)
        self._recorded = 0
        # name -> [count, seconds, self seconds]
        self._totals: Dict[str, List[float]] = {}

    def record(self, span_rec: Dict[str, Any]) -> None:
        name, dur = span_rec["name"], span_rec["duration"]
        own = span_rec.get("self", dur)
        with self._lock:
            self._spans.append(span_rec)
            self._recorded += 1
            tot = self._totals.get(name)
            if tot is None:
                tot = self._totals[name] = [0, 0.0, 0.0]
            tot[0] += 1
            tot[1] += dur
            tot[2] += own

    @property
    def total_recorded(self) -> int:
        with self._lock:
            return self._recorded

    def totals(self) -> Dict[str, Dict[str, float]]:
        """Cumulative {"count", "seconds", "self_seconds"} -> {span name:
        value} over every span recorded (evicted ones included)."""
        with self._lock:
            items = [(n, list(t)) for n, t in self._totals.items()]
        return {key: {n: t[i] for n, t in items}
                for i, key in enumerate(("count", "seconds",
                                         "self_seconds"))}

    def since(self, recorded: int) -> List[Dict[str, Any]]:
        """The spans recorded after total_recorded read `recorded`,
        oldest first. Raises LookupError where the ring has evicted any
        of them."""
        with self._lock:
            new = self._recorded - recorded
            if new > len(self._spans):
                raise LookupError(
                    f"{new} spans recorded since, the ring holds "
                    f"{len(self._spans)}")
            return list(self._spans)[len(self._spans) - new:]

    def snapshot(self, limit: int = 256,
                 trace_id: Optional[str] = None) -> List[Dict[str, Any]]:
        """Most-recent-first span dicts, optionally one trace only."""
        with self._lock:
            spans = list(self._spans)
        if trace_id:
            spans = [s for s in spans if s.get("trace_id") == trace_id]
        return spans[-max(limit, 0):][::-1]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def export_jsonl(self, fp) -> int:
        """Write buffered spans as JSON lines, oldest first; returns the
        count written."""
        with self._lock:
            spans = list(self._spans)
        for s in spans:
            fp.write(json.dumps(s) + "\n")
        return len(spans)


#: process-global buffer (the /debug/traces source on every daemon)
BUFFER = TraceBuffer()


class Span:
    """One span: opened and closed as a context manager.

    Deviation from kubernetes_tpu/trace/spans.py Span: besides the wall
    start, which crosses processes, it records its start and end in
    time.perf_counter_ns() ("start_ns", "end_ns": CLOCK_MONOTONIC on
    Linux), the clock a device trace's timeline is aligned to, and its
    self time ("self": its duration less what the child spans opened
    inside it on this context cover), which the buffer's totals sum."""

    __slots__ = ("name", "attrs", "trace_id", "span_id", "parent_id",
                 "start", "_t0", "_token", "_outer", "_outer_token",
                 "_child_ns")

    #: the innermost open Span of this execution context, whose child
    #: time a closing span adds to
    _OPEN: ContextVar = ContextVar("kubernetes_tpu_open_span",
                                   default=None)

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "Span":
        parent = _CTX.get()
        if parent is None:
            self.trace_id = new_trace_id()
            self.parent_id = None
        else:
            self.trace_id, self.parent_id = parent
        self.span_id = _new_span_id()
        self._token = _CTX.set((self.trace_id, self.span_id))
        self._outer = Span._OPEN.get()
        self._outer_token = Span._OPEN.set(self)
        self._child_ns = 0
        self.start = time.time()
        self._t0 = time.perf_counter_ns()
        return self

    def annotate(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter_ns()
        Span._OPEN.reset(self._outer_token)
        _CTX.reset(self._token)
        dur = t1 - self._t0
        outer = self._outer
        if outer is not None and outer.span_id == self.parent_id:
            outer._child_ns += dur
        rec = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start": self.start,
            "duration": dur / 1e9,
            "self": (dur - self._child_ns) / 1e9,
            "start_ns": self._t0,
            "end_ns": t1,
        }
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        if self.attrs:
            rec["attrs"] = self.attrs
        BUFFER.record(rec)
        return False


class _NullSpan:
    """Shared no-op span (tracing disabled). Stateless, so one instance
    serves every caller concurrently."""

    __slots__ = ()
    trace_id = span_id = parent_id = None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def annotate(self, **attrs: Any) -> None:
        pass


_NULL = _NullSpan()


def span(name: str, **attrs: Any):
    """Open a span: ``with span("scheduler.wave", pods=n) as s: ...``.
    Children opened inside inherit the trace id and parent to this
    span; the first span on a context starts a fresh trace."""
    if not _ENABLED:
        return _NULL
    return Span(name, attrs)


@contextlib.contextmanager
def trace_context(trace_id: Optional[str], span_id: str = ""):
    """Adopt a remote trace id (wire continuation): spans opened inside
    attach to `trace_id` instead of starting a fresh trace."""
    if not trace_id or not _ENABLED:
        yield
        return
    token = _CTX.set((trace_id, span_id or _new_span_id()))
    try:
        yield
    finally:
        _CTX.reset(token)


def record_span(name: str, trace_id: Optional[str], start: float,
                end: float, parent_id: Optional[str] = None,
                **attrs: Any) -> None:
    """Record a completed span retroactively. The wave paths time a
    phase once and attribute it to every traced pod in the wave without
    per-pod context switches — this is that attribution primitive."""
    if not _ENABLED or not trace_id:
        return
    rec = {
        "trace_id": trace_id,
        "span_id": _new_span_id(),
        "parent_id": parent_id,
        "name": name,
        "start": start,
        "duration": max(end - start, 0.0),
    }
    if attrs:
        rec["attrs"] = attrs
    BUFFER.record(rec)


def event_span(name: str, obj: Any, **attrs: Any) -> None:
    """Record an instantaneous marker span on an API object's trace
    (no-op unless the object carries the trace annotation)."""
    if not _ENABLED:
        return
    tid = extract(obj)
    if not tid:
        return
    now = time.time()
    record_span(name, tid, now, now, **attrs)


def inject(obj: Any, trace_id: Optional[str] = None) -> Optional[str]:
    """Stamp the trace id onto an API object's annotations so it rides
    the wire. Uses (in order) the explicit id, the current context's
    trace, or a fresh id; returns the id stamped, or None when tracing
    is disabled or the object has no metadata."""
    if not _ENABLED:
        return None
    meta = getattr(obj, "metadata", None)
    if meta is None:
        return None
    tid = trace_id or current_trace_id() or new_trace_id()
    if meta.annotations is None:
        meta.annotations = {}
    meta.annotations[TRACE_ID_ANNOTATION] = tid
    return tid


def extract(obj: Any) -> Optional[str]:
    """The trace id an object carries, or None."""
    meta = getattr(obj, "metadata", None)
    ann = getattr(meta, "annotations", None) if meta is not None else None
    if not ann:
        return None
    return ann.get(TRACE_ID_ANNOTATION)
