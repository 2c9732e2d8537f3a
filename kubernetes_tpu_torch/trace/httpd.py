"""Component observability mux.

The reference scheduler runs its own :10251 mux serving /healthz and
prometheus /metrics (plugin/cmd/kube-scheduler/app/server.go:92-108);
in this framework only the apiserver's shared mux rendered the registry
until now. This module is that per-daemon mux: a tiny threaded HTTP
server any component can hang its /healthz, /metrics, /configz,
/debug/traces?limit=N, and /debug/audit endpoints on. The scheduler daemon serves it by
default (scheduler/server.py); the kubelet reuses render_traces() on
its existing node-API server.

Copy of kubernetes_tpu/trace/httpd.py: only the import package differs.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse


def render_traces(query: Dict[str, str]) -> dict:
    """The /debug/traces payload: most-recent spans, newest first.
    ?limit=N bounds the span count (default 256); ?trace=<id> filters
    to one trace. Shared by every daemon's frontend."""
    from kubernetes_tpu_torch.trace import spans as _span

    try:
        limit = int(query.get("limit", "256"))
    except ValueError:
        limit = 256
    items = _span.BUFFER.snapshot(
        limit=max(1, min(limit, 4096)),
        trace_id=query.get("trace") or None,
    )
    return {
        "kind": "TraceList",
        "enabled": _span.enabled(),
        "totalRecorded": _span.BUFFER.total_recorded,
        "items": items,
    }


def start_component_server(
    host: str = "127.0.0.1",
    port: int = 0,
    healthz: Optional[Callable[[], bool]] = None,
    name: str = "component",
):
    """Serve the observability mux on (host, port); port 0 binds an
    ephemeral port. Returns (server, bound_port); server.shutdown()
    stops it. `healthz` (optional) turns /healthz into a real probe —
    falsy/raising answers 500."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet, like the other muxes
            pass

        def _send(self, code: int, payload,
                  content_type: str = "application/json") -> None:
            if isinstance(payload, (dict, list)):
                data = json.dumps(payload).encode()
            elif isinstance(payload, str):
                data = payload.encode()
            else:
                data = payload
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            parsed = urlparse(self.path)
            query = {
                k: v[0] for k, v in parse_qs(parsed.query).items() if v
            }
            path = parsed.path.rstrip("/") or "/"
            try:
                if path == "/healthz":
                    ok = True
                    if healthz is not None:
                        try:
                            ok = bool(healthz())
                        except Exception:
                            ok = False
                    self._send(200 if ok else 500,
                               "ok" if ok else "unhealthy", "text/plain")
                    return
                if path == "/metrics":
                    from kubernetes_tpu_torch.metrics import registry

                    self._send(200, registry.render(),
                               "text/plain; version=0.0.4")
                    return
                if path == "/configz":
                    from kubernetes_tpu_torch.utils import configz

                    self._send(200, configz.snapshot())
                    return
                if path == "/debug/traces":
                    self._send(200, render_traces(query))
                    return
                if path == "/debug/audit":
                    from kubernetes_tpu_torch.audit import render_audit

                    self._send(200, render_audit(query))
                    return
                if path == "/debug/telemetry/query":
                    from kubernetes_tpu_torch import telemetry

                    self._send(*telemetry.handle_query(query))
                    return
                if path == "/debug/telemetry/alerts":
                    from kubernetes_tpu_torch import telemetry

                    self._send(*telemetry.handle_alerts(query))
                    return
                if path == "/debug/flightrecorder":
                    from kubernetes_tpu_torch import telemetry

                    self._send(*telemetry.handle_flight(query))
                    return
                self._send(404, {"message": f"unknown path {parsed.path}"})
            except Exception as e:  # a broken probe must not kill the mux
                try:
                    self._send(500, {"message": str(e)})
                except OSError:
                    pass

    class Server(ThreadingHTTPServer):
        daemon_threads = True
        allow_reuse_address = True

    server = Server((host, port), Handler)
    threading.Thread(
        target=server.serve_forever,
        name=f"{name}-observability",
        daemon=True,
    ).start()
    return server, server.server_address[1]
