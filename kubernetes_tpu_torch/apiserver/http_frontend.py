"""HTTP frontend for APIServer (pkg/genericapiserver serve path).

Threaded HTTP server translating requests to APIServer.handle(). Watches
stream as newline-delimited JSON frames over a chunked response, exactly
the reference's watch wire shape (pkg/apiserver/watch.go WatchServer):

    {"type": "ADDED", "object": {...}}\n

Copy of kubernetes_tpu/apiserver/http_frontend.py: only the import package differs.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from kubernetes_tpu_torch.apiserver.server import APIServer, WatchResponse
from kubernetes_tpu_torch.metrics import (
    apiserver_request_latency,
    apiserver_requests_total,
    apiserver_watch_coalesced_frame_bytes,
    apiserver_watch_coalesced_frame_objects,
    apiserver_watch_events_sent_total,
)
from kubernetes_tpu_torch.runtime import binary

_sent_events = apiserver_watch_events_sent_total.child()

# watch-burst coalescing (one segmented frame — one write syscall — per
# burst per connection); KUBERNETES_TPU_WATCH_COALESCE=0 reverts to
# per-event frames. Read per watch connection, not at import: the
# equivalence fuzz drives both modes against one live server.
import os as _os


def _coalesce_enabled() -> bool:
    return _os.environ.get(
        "KUBERNETES_TPU_WATCH_COALESCE", "1"
    ).lower() not in ("0", "false", "off")


def _is_long_running(path: str, query: dict) -> bool:
    """pkg/apiserver/handlers.go longRunningRE: watches (and the legacy
    /watch/ prefix) are exempt from the in-flight limit — they hold a
    connection for minutes by design. The prefix check mirrors
    server._route: the segment right after the API group, not any path
    segment that happens to be named "watch"."""
    if query.get("watch") in ("true", "1"):
        return True
    if path.startswith("/debug/pprof/profile"):
        # the sampler deliberately holds the request for `seconds`; it
        # must not eat a max-in-flight slot (pprof is long-running in
        # the reference's mux for the same reason)
        return True
    parts = [p for p in path.split("/") if p]
    if parts[:1] == ["api"]:
        parts = parts[2:]
    elif parts[:1] == ["apis"]:
        parts = parts[3:]
    else:
        return False
    if parts[:1] == ["watch"]:
        return True
    if parts[:1] == ["namespaces"] and len(parts) >= 3:
        parts = parts[2:]
    # the named-object subresource form: /{resource}/{name}/watch
    return len(parts) >= 3 and parts[2] == "watch"


def start_http_server(api: APIServer, host: str, port: int,
                      tls_cert: str = "", tls_key: str = "",
                      max_in_flight: int = 0,
                      enable_binary: bool = False):
    """tls_cert/tls_key enable HTTPS (genericapiserver serves TLS by
    default); max_in_flight > 0 bounds concurrent non-long-running
    requests (handlers.go MaxInFlightLimit — excess returns 429);
    enable_binary opts the listener into the TLV binary content type
    (runtime/binary.py; data-only, safe for untrusted callers) — off,
    binary bodies get 415 and Accept negotiation is ignored."""
    in_flight = (
        threading.Semaphore(max_in_flight) if max_in_flight > 0 else None
    )
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # an idle keep-alive connection releases its handler thread
        # after this long; pooled clients transparently retry a fresh
        # socket on the next request
        timeout = 120

        def log_message(self, fmt, *args):  # quiet; pkg/httplog is V-gated
            pass

        def setup(self):
            super().setup()
            # registered so shutdown can close live keep-alive
            # connections: a "killed" apiserver with pooled client
            # sockets must go dark, not keep serving as a zombie
            with self.server._conn_lock:
                self.server._conns.add(self.connection)

        def finish(self):
            with self.server._conn_lock:
                self.server._conns.discard(self.connection)
            try:
                super().finish()
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass

        def _dispatch(self, method: str):
            parsed = urlparse(self.path)
            query = {
                k: v[0] for k, v in parse_qs(parsed.query).items() if v
            }
            limited = (
                in_flight is not None
                and not _is_long_running(parsed.path, query)
            )
            if limited and not in_flight.acquire(blocking=False):
                # handlers.go MaxInFlightLimit: shed load instead of
                # queueing unboundedly. Drain the request body first or
                # the unread bytes corrupt the next keep-alive request.
                length = int(self.headers.get("Content-Length") or 0)
                while length > 0:
                    chunk = self.rfile.read(min(length, 65536))
                    if not chunk:
                        break
                    length -= len(chunk)
                self._send_json(429, {
                    "kind": "Status",
                    "status": "Failure",
                    "message": "too many requests, please try again later",
                    "reason": "TooManyRequests",
                    "code": 429,
                }, headers={"Retry-After": "1"})
                return
            # apiserver_request_latencies (pkg/apiserver/metrics.go):
            # non-long-running requests only — a watch holds its
            # connection for minutes by design and would drown the
            # histogram in stream lifetimes
            timed = not _is_long_running(parsed.path, query)
            apiserver_requests_total.inc(verb=method)
            t0 = time.perf_counter() if timed else 0.0
            try:
                self._dispatch_inner(method, parsed, query)
            finally:
                if timed:
                    apiserver_request_latency.labels(method).observe(
                        (time.perf_counter() - t0) * 1e6
                    )
                if limited:
                    in_flight.release()

        def _dispatch_inner(self, method: str, parsed, query):
            # audit context for this request (apiserver/pkg/audit
            # WithAudit): the handler thread's identity slot is reset per
            # request — keep-alive reuses threads, and a stale user on a
            # reused slot would mis-attribute the next request's trail
            ctx = api._audit_ctx
            ctx.user = ""
            ctx.groups = ()
            ctx.request_id = self.headers.get("X-Request-Id", "")
            if getattr(api, "authenticator", None) is None:
                # no authenticator = the insecure-port idiom: requests
                # are unauthenticated anyway, so the caller-declared
                # X-Remote-User/-Group identity headers are trusted for
                # flow classification and audit attribution (the
                # front-proxy request-header authenticator shape).
                # With an authenticator configured they are IGNORED —
                # only authenticated identity classifies.
                remote = self.headers.get("X-Remote-User", "")
                if remote:
                    ctx.user = remote
                    ctx.groups = tuple(
                        g.strip()
                        for g in (
                            self.headers.get("X-Remote-Group") or ""
                        ).split(",")
                        if g.strip()
                    )

            def audit_denied(code: int, user_name: str = "") -> None:
                # denied access IS the audit log's primary story (who
                # tried and failed): record 401/403 here because these
                # requests never reach api.handle()'s audit hook
                level = api.audit_policy.level_for(parsed.path)
                if level == "None":
                    return
                from kubernetes_tpu_torch import audit as _audit

                _audit.record(
                    level,
                    user_name or "system:anonymous",
                    _audit.verb_for(method, query),
                    "", "", "", code, 0.0,
                    request_id=ctx.request_id,
                    path=parsed.path,
                )

            # authn/authz when the server is configured with them
            # (handlers.go WithAuthentication/WithAuthorization shape)
            if getattr(api, "authenticator", None) is not None:
                from kubernetes_tpu_torch.auth.authn import AuthenticationError
                from kubernetes_tpu_torch.auth.authz import Attributes

                try:
                    user = api.authenticator.authenticate(dict(self.headers))
                except AuthenticationError as e:
                    audit_denied(401)
                    self._send_json(401, {"message": str(e)})
                    return
                if user is None:
                    audit_denied(401)
                    self._send_json(401, {"message": "unauthorized"})
                    return
                ctx.user = user.name
                ctx.groups = tuple(user.groups)
                authorizer = getattr(api, "authorizer", None)
                if authorizer is not None:
                    ns, info, _name, _sub, _grp, _ver = api._route(
                        parsed.path
                    )
                    resource = info.resource if info else ""
                    if parsed.path.rstrip("/") == "/api/v1/batch":
                        # the batch endpoint writes pods (bindings +
                        # status) across namespaces in one request; it
                        # authorizes as its own resource so admins
                        # grant it explicitly to scheduler-tier users —
                        # an empty resource would otherwise deny every
                        # non-wildcard policy AND let wildcard-only
                        # rules reach cross-resource writes unnamed
                        resource = "batchcommits"
                    attrs = Attributes(
                        user=user,
                        verb=method,
                        resource=resource,
                        namespace=ns,
                        name=_name or "",
                        api_group=info.group if info else "",
                        subresource=_sub or "",
                        path=parsed.path,
                        query_watch=query.get("watch") in ("true", "1"),
                    )
                    if not authorizer.authorize(attrs):
                        audit_denied(403, user.name)
                        self._send_json(
                            403,
                            {"message": f"user {user.name!r} cannot "
                             f"{method} {attrs.resource or parsed.path}"},
                        )
                        return
            # content negotiation (protobuf-content-type analogue):
            # binary bodies decode to API objects, binary Accept answers
            # with the object-protocol payload in a binary envelope
            wants_binary = enable_binary and binary.CONTENT_TYPE in (
                self.headers.get("Accept") or ""
            )
            body = None
            body_owned = False
            length = int(self.headers.get("Content-Length") or 0)
            if length:
                raw = self.rfile.read(length)
                if (self.headers.get("Content-Type") or "").startswith(
                    binary.CONTENT_TYPE
                ):
                    if not enable_binary:
                        self._send_json(415, {
                            "message": "binary wire format is not enabled "
                            "on this listener",
                        })
                        return
                    try:
                        body = binary.decode(raw)
                    except binary.BinaryDecodeError as e:
                        self._send_json(400, {"message": str(e)})
                        return
                    # freshly decoded off the wire, no reference kept
                    # here: the server may take ownership instead of
                    # making a second isolation copy
                    body_owned = True
                else:
                    try:
                        body = json.loads(raw)
                    except json.JSONDecodeError:
                        self._send_json(400, {"message": "invalid JSON body"})
                        return
            if wants_binary:
                # raw_mode: cache-served list/get responses arrive as
                # stored TLV bytes, spliced into the reply verbatim.
                # Only passed on the binary path so in-process handle()
                # stubs with the classic signature keep working.
                code, payload = api.handle(
                    method, parsed.path, query, body, obj_mode=True,
                    body_owned=body_owned, raw_mode=True,
                )
            else:
                code, payload = api.handle(
                    method, parsed.path, query, body, obj_mode=False,
                    body_owned=body_owned,
                )
            if isinstance(payload, WatchResponse):
                self._stream_watch(payload)
                return
            # APF sheds carry their Retry-After hint in the Status
            # details; surface it as the real HTTP header so clients
            # back off by the server's estimate, not a guess
            retry_after = ""
            if code == 429 and isinstance(payload, dict):
                details = payload.get("details")
                if isinstance(details, dict):
                    retry_after = str(
                        details.get("retryAfterSeconds") or ""
                    )
            if wants_binary:
                # Raw payloads (watch-cache hits) splice the stored TLV
                # bytes into the response verbatim — encode() is a byte
                # concatenation for them, zero re-encode
                data = binary.encode(payload)
                self.send_response(code)
                self.send_header("Content-Type", binary.CONTENT_TYPE)
                self.send_header("Content-Length", str(len(data)))
                if retry_after:
                    self.send_header("Retry-After", retry_after)
                self.end_headers()
                self.wfile.write(data)
                return
            if code == 200 and isinstance(payload, dict) and "_raw" in payload:
                raw_body = payload["_raw"]
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    payload.get("_content_type", "text/plain"),
                )
                self.send_header("Content-Length", str(len(raw_body)))
                self.end_headers()
                self.wfile.write(raw_body)
                return
            self._send_json(
                code, payload,
                headers={"Retry-After": retry_after} if retry_after
                else None,
            )

        def _send_json(self, code: int, payload, headers=None) -> None:
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _stream_watch(self, watch: WatchResponse) -> None:
            # registered so shutdown can terminate long-running streams:
            # a "killed" apiserver must not keep zombie watches alive
            # feeding keepalives to clients that should be reconnecting
            with self.server._watch_lock:
                if self.server._watches_closed:
                    # shutdown raced this stream's registration: end it
                    # now rather than serve from a "dead" apiserver
                    watch.stop()
                else:
                    self.server._active_watches.append(watch)
            binary_stream = watch.obj_mode
            self.send_response(200)
            self.send_header(
                "Content-Type",
                binary.CONTENT_TYPE if binary_stream else "application/json",
            )
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                # idle probes every few seconds detect departed clients so
                # quiet watches don't pin a thread + store watcher forever.
                # Events arrive in burst batches (everything momentarily
                # queued) and each batch is ONE coalesced socket write —
                # a wave-bulk bind emits tens of thousands of events
                # back-to-back, and per-event write+flush was the
                # frontend's throughput ceiling.
                coalesce = binary_stream and _coalesce_enabled()
                if coalesce:
                    batches = watch.burst_frames(idle_timeout=3.0)
                elif binary_stream:
                    batches = watch.frame_batches(idle_timeout=3.0)
                else:
                    batches = watch.event_batches(idle_timeout=3.0)
                for batch in batches:
                    if batch is None:
                        # keepalive: blank NDJSON line / zero-length frame
                        payload = (
                            binary.encode_frame(None) if binary_stream
                            else b"\n"
                        )
                    elif coalesce:
                        # the burst IS one frame already
                        payload, n_events = batch
                        _sent_events(n_events)
                        apiserver_watch_coalesced_frame_objects.observe(
                            n_events
                        )
                        apiserver_watch_coalesced_frame_bytes.observe(
                            len(payload)
                        )
                    elif binary_stream:
                        _sent_events(len(batch))
                        payload = b"".join(batch)  # already frame bytes
                    else:
                        _sent_events(len(batch))
                        payload = b"".join(
                            json.dumps(ev).encode() + b"\n" for ev in batch
                        )
                    # the whole batch is ONE http chunk: the client's
                    # dechunker pays one size-line parse per burst, not
                    # per event (frames/NDJSON lines carry their own
                    # boundaries, so chunking is pure transport here)
                    self.wfile.write(
                        b"%x\r\n%s\r\n" % (len(payload), payload)
                    )
                    self.wfile.flush()
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass
            finally:
                watch.stop()
                with self.server._watch_lock:
                    try:
                        self.server._active_watches.remove(watch)
                    except ValueError:
                        pass

        def do_GET(self):
            self._dispatch("GET")

        def do_POST(self):
            self._dispatch("POST")

        def do_PUT(self):
            self._dispatch("PUT")

        def do_PATCH(self):
            self._dispatch("PATCH")

        def do_DELETE(self):
            self._dispatch("DELETE")

    class Server(ThreadingHTTPServer):
        # the socketserver default backlog of 5 RSTs bursty clients
        # (30-way parallel pod creators); match a real server's depth
        request_queue_size = 128
        daemon_threads = True
        allow_reuse_address = True

        def stop_watches(self) -> None:
            with self._watch_lock:
                self._watches_closed = True
                watches = list(self._active_watches)
                del self._active_watches[:]
            for w in watches:
                w.stop()

        def close_connections(self) -> None:
            """Hard-close every live connection (keep-alive handlers
            included): a shut-down apiserver must refuse its pooled
            clients immediately, not serve them from beyond the grave
            or strand them in read timeouts."""
            with self._conn_lock:
                conns = list(self._conns)
                self._conns.clear()
            for c in conns:
                try:
                    c.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    c.close()
                except OSError:
                    pass

    server = Server((host, port), Handler)
    if tls_cert and tls_key:
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(tls_cert, tls_key)
        # handshake lazily in the per-connection handler thread — with
        # do_handshake_on_connect a silent client would block accept()
        # and wedge the whole server
        server.socket = ctx.wrap_socket(
            server.socket, server_side=True, do_handshake_on_connect=False
        )
    server._watch_lock = threading.Lock()
    server._active_watches = []
    server._watches_closed = False
    server._conn_lock = threading.Lock()
    server._conns = set()
    thread = threading.Thread(
        target=server.serve_forever, name="apiserver-http", daemon=True
    )
    thread.start()
    return server, server.server_address[1]
