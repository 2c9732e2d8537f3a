"""Structured apiserver audit log (apiserver/pkg/audit).

One audit event per REST request handled by the apiserver: who (the
authenticated user), what (verb + resource + namespace/name), the
response code, and the request latency — the "who did what" record the
reference emits through its audit backend chain. Here the backend is a
bounded in-memory ring buffer served at /debug/audit on every
observability mux, with an optional JSON-lines file sink
(KUBERNETES_TPU_AUDIT_LOG=<path>) for durable trails.

Policy levels mirror audit.Level:

    None      — drop everything (auditing off)
    Metadata  — request metadata only (user/verb/resource/code/latency)
    Request   — metadata plus a compact request-body summary

Level comes from AuditPolicy (default Metadata; KUBERNETES_TPU_AUDIT
overrides). Observability paths (/healthz, /metrics, /debug/*, /configz,
/ui) are never audited — polling the audit log must not grow the audit
log.

Copy of kubernetes_tpu/audit/audit.py: only the import package differs.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from kubernetes_tpu_torch.metrics import apiserver_audit_event_total

LEVEL_NONE = "None"
LEVEL_METADATA = "Metadata"
LEVEL_REQUEST = "Request"

_LEVELS = (LEVEL_NONE, LEVEL_METADATA, LEVEL_REQUEST)

# exempt from auditing (the reference's default policy rules exclude
# health/metrics scrape noise the same way). /api and /apis appear only
# as EXACT discovery paths — as prefixes they would exempt every REST
# request.
_EXEMPT_EXACT = {"/api", "/api/", "/apis", "/apis/", "/api/v1"}
_EXEMPT_PREFIX = (
    "/healthz", "/metrics", "/debug", "/configz", "/ui", "/swaggerapi",
)


class AuditPolicy:
    """Which level a request is audited at (policy/v1alpha1 Policy with a
    single cluster-wide rule plus the built-in exemptions)."""

    def __init__(self, level: str = LEVEL_METADATA):
        if level not in _LEVELS:
            raise ValueError(
                f"audit level must be one of {_LEVELS}, not {level!r}"
            )
        self.level = level

    @classmethod
    def from_env(cls) -> "AuditPolicy":
        lvl = os.environ.get("KUBERNETES_TPU_AUDIT", LEVEL_METADATA)
        # tolerate common spellings: off/0/none -> None
        norm = {
            "off": LEVEL_NONE, "0": LEVEL_NONE, "none": LEVEL_NONE,
            "metadata": LEVEL_METADATA, "request": LEVEL_REQUEST,
        }.get(lvl.lower(), lvl)
        try:
            return cls(norm)
        except ValueError:
            return cls(LEVEL_METADATA)

    def level_for(self, path: str) -> str:
        if self.level == LEVEL_NONE:
            return LEVEL_NONE
        if path in _EXEMPT_EXACT or path.startswith(_EXEMPT_PREFIX):
            return LEVEL_NONE
        # bare discovery forms /apis/{group}[/{version}] (no resource)
        if path.startswith("/apis/") and len(
            [p for p in path.split("/") if p]
        ) <= 3:
            return LEVEL_NONE
        return self.level


_audit_seq = itertools.count(1)

_METHOD_VERBS = {
    "POST": "create", "PUT": "update", "PATCH": "patch",
    "DELETE": "delete",
}


def verb_for(method: str, query: Optional[Dict[str, str]] = None,
             has_name: bool = False) -> str:
    """Map an HTTP method (+ watch query / named-object context) to the
    audit verb vocabulary — the single copy both the apiserver's audit
    hook and the frontend's denied-request path use."""
    verb = _METHOD_VERBS.get(method)
    if verb is not None:
        return verb
    if query and query.get("watch") in ("true", "1"):
        return "watch"
    return "get" if has_name else "list"


def new_request_id() -> str:
    """Process-unique audit/request ID (the reference stamps a UID per
    audit event); monotonic so interleaved trails still sort."""
    return f"req-{next(_audit_seq):08x}"


class AuditLog:
    """Bounded ring of audit event dicts + optional JSON-lines sink.

    Appends are O(1) under one lock — this sits on the apiserver's
    request path, so the budget is a dict build and a deque append
    (the file sink, when configured, is line-buffered appends)."""

    def __init__(self, capacity: int = 2048, sink_path: str = ""):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._ring: "collections.deque[Dict[str, Any]]" = collections.deque(
            maxlen=capacity
        )
        self.total_recorded = 0
        self._sink = None
        if sink_path:
            try:
                self._sink = open(sink_path, "a", buffering=1)
            except OSError:
                self._sink = None

    def record(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            self._ring.append(ev)
            self.total_recorded += 1
            if self._sink is not None:
                # under the lock: TextIOWrapper writes are not
                # thread-safe, and interleaved JSON lines silently
                # corrupt the durable trail
                try:
                    self._sink.write(json.dumps(ev, default=str) + "\n")
                except (OSError, ValueError):
                    pass  # a full/closed sink must not fail the request

    def snapshot(
        self,
        limit: int = 256,
        user: Optional[str] = None,
        verb: Optional[str] = None,
        resource: Optional[str] = None,
    ) -> List[Dict[str, Any]]:
        """Newest-first slice, optionally filtered."""
        with self._lock:
            items = list(self._ring)
        items.reverse()
        if user:
            items = [e for e in items if e.get("user") == user]
        if verb:
            items = [e for e in items if e.get("verb") == verb]
        if resource:
            items = [e for e in items if e.get("resource") == resource]
        return items[: max(1, limit)]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.total_recorded = 0

    def close(self) -> None:
        with self._lock:
            if self._sink is not None:
                try:
                    self._sink.close()
                except OSError:
                    pass
                self._sink = None


def _default_capacity() -> int:
    try:
        return max(64, int(os.environ.get("KUBERNETES_TPU_AUDIT_RING", "2048")))
    except ValueError:
        return 2048


#: process-global audit ring (every daemon's /debug/audit serves this,
#: the way trace/spans.BUFFER backs /debug/traces)
LOG = AuditLog(
    capacity=_default_capacity(),
    sink_path=os.environ.get("KUBERNETES_TPU_AUDIT_LOG", ""),
)


def make_event(
    level: str,
    user: str,
    verb: str,
    resource: str,
    namespace: str,
    name: str,
    code: int,
    latency_seconds: float,
    request_id: str = "",
    path: str = "",
    subresource: str = "",
    request_object: Any = None,
) -> Dict[str, Any]:
    """Build one audit event dict (audit/v1 Event shape, flattened)."""
    ev: Dict[str, Any] = {
        "requestID": request_id or new_request_id(),
        "timestamp": time.time(),
        "level": level,
        "user": user,
        "verb": verb,
        "resource": resource,
        "namespace": namespace,
        "name": name,
        "code": code,
        "latencySeconds": round(latency_seconds, 6),
    }
    if subresource:
        ev["subresource"] = subresource
    if path:
        ev["path"] = path
    if level == LEVEL_REQUEST and request_object is not None:
        ev["requestObject"] = summarize_object(request_object)
    return ev


def summarize_object(body: Any, max_len: int = 512) -> Any:
    """Compact request-body summary for Request-level events: small dict
    bodies verbatim, big ones truncated to kind/metadata, API objects to
    their identity — an audit trail is evidence, not a byte mirror."""
    if isinstance(body, dict):
        text = json.dumps(body, default=str)
        if len(text) <= max_len:
            return body
        meta = body.get("metadata", {}) if isinstance(
            body.get("metadata"), dict
        ) else {}
        return {
            "kind": body.get("kind", ""),
            "metadata": {
                "name": meta.get("name", ""),
                "namespace": meta.get("namespace", ""),
            },
            "_truncated": True,
        }
    meta = getattr(body, "metadata", None)
    if meta is not None:
        return {
            "kind": type(body).__name__,
            "metadata": {
                "name": getattr(meta, "name", ""),
                "namespace": getattr(meta, "namespace", ""),
            },
        }
    return {"kind": type(body).__name__}


# bound counter children keyed by (level, verb): record() runs once per
# REST request, so the label-key sort must not be paid per call
_counter_children: Dict[tuple, Any] = {}


def record(
    level: str,
    user: str,
    verb: str,
    resource: str,
    namespace: str,
    name: str,
    code: int,
    latency_seconds: float,
    **kw: Any,
) -> Dict[str, Any]:
    """Record one event to the process ring + counter; the apiserver's
    per-request hook."""
    ev = make_event(
        level, user, verb, resource, namespace, name, code,
        latency_seconds, **kw,
    )
    LOG.record(ev)
    key = (level, verb)
    inc = _counter_children.get(key)
    if inc is None:
        inc = _counter_children[key] = apiserver_audit_event_total.child(
            level=level, verb=verb
        )
    inc()
    return ev


def render_audit(query: Dict[str, str]) -> Dict[str, Any]:
    """The /debug/audit payload: newest-first events; ?limit=N bounds
    the count (default 256), ?user=/&verb=/&resource= filter. Shared by
    the apiserver mux, the component mux, and the kubelet node API."""
    try:
        limit = int(query.get("limit", "256"))
    except ValueError:
        limit = 256
    items = LOG.snapshot(
        limit=max(1, min(limit, 4096)),
        user=query.get("user") or None,
        verb=query.get("verb") or None,
        resource=query.get("resource") or None,
    )
    return {
        "kind": "AuditEventList",
        "totalRecorded": LOG.total_recorded,
        "items": items,
    }
