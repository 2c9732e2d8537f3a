"""Client transports.

LocalTransport calls APIServer.handle() in-process — the analogue of the
reference's integration-test pattern of wrapping the master's handler in
an httptest server (test/integration/framework/master_utils.go:320),
minus the socket. HTTPTransport speaks real HTTP to serve_http().

Both return (status_code, payload) where payload is a JSON-like dict, or
an event iterator for watches.

Copy of kubernetes_tpu/client/transport.py: only the import package differs.
"""

from __future__ import annotations

import json
import random as _random
import threading
import time as _time

from kubernetes_tpu_torch.analysis import races as _races
from kubernetes_tpu_torch.metrics import (
    apiserver_endpoint_failovers_total,
    client_rate_limited_requests_total,
    client_request_retries_total,
)
from kubernetes_tpu_torch.runtime import binary as bin_codec
from kubernetes_tpu_torch.trace.profile import phase_timer
from typing import Any, Dict, Iterator, Optional, Tuple
from urllib import parse as urlparse

_rate_limited = client_rate_limited_requests_total.child()
_retries = client_request_retries_total.child()
_failovers = apiserver_endpoint_failovers_total.child()


class LocalTransport:
    def __init__(self, server, object_protocol: bool = True,
                 user: str = "", groups=()):
        # object protocol: bodies/responses are API objects (copied at
        # the server boundary), skipping the reflective wire codec — the
        # in-process analogue of the reference's protobuf content type
        # (kubemark defaults to protobuf for the same codec cost,
        # hollow-node.go:65)
        self.server = server
        self.object_protocol = object_protocol
        # flow identity: deposited in the server's per-thread context so
        # APF classification and the audit trail see the real caller.
        # Unnamed in-process callers are the loopback/integration-test
        # idiom -> system:unsecured (exempt, cluster-admin shaped).
        self.user = user or "system:unsecured"
        self.groups = tuple(groups)

    def _deposit_identity(self):
        ctx = getattr(self.server, "_audit_ctx", None)
        if ctx is not None:
            ctx.user = self.user
            ctx.groups = self.groups
        return ctx

    @staticmethod
    def _clear_identity(ctx) -> None:
        # restore the thread's virgin state: a LATER direct handle()
        # call on this thread must classify as loopback/unsecured
        # again, not as this transport's tenant
        if ctx is not None:
            ctx.user = None
            ctx.groups = None

    def request(
        self,
        method: str,
        path: str,
        query: Optional[Dict[str, str]] = None,
        body: Optional[Dict[str, Any]] = None,
    ) -> Tuple[int, Any]:
        ctx = self._deposit_identity()
        try:
            return self.server.handle(
                method, path, query, body, obj_mode=self.object_protocol
            )
        finally:
            self._clear_identity(ctx)

    def watch(
        self, path: str, query: Optional[Dict[str, str]] = None
    ) -> Iterator[Dict[str, Any]]:
        query = dict(query or {})
        query["watch"] = "true"
        ctx = self._deposit_identity()
        try:
            code, resp = self.server.handle(
                "GET", path, query, None, obj_mode=self.object_protocol
            )
        finally:
            self._clear_identity(ctx)
        if code != 200:
            raise WatchError(code, resp)
        return _StoppableEvents(resp)


class WatchError(Exception):
    def __init__(self, code: int, status: Any):
        super().__init__(f"watch failed: {code} {status}")
        self.code = code
        self.status = status


class _StoppableEvents:
    """Adapts a WatchResponse into a stoppable {"type","object"} iterator."""

    def __init__(self, watch_response):
        self._wr = watch_response
        self._it = watch_response.events()

    def __iter__(self):
        return self._it

    def stop(self) -> None:
        self._wr.stop()


def build_ssl_context(tls_ca: str = "", insecure: bool = False):
    """The one client TLS policy (kubeconfig idioms), shared by the
    apiserver transport and the kubelet node-API dialers:
    certificate-authority pins the CA and KEEPS hostname verification
    (anything signed by the CA for a different host must still be
    rejected); insecure-skip-tls-verify disables both; default is the
    system trust store."""
    import ssl

    if tls_ca:
        return ssl.create_default_context(cafile=tls_ca)
    if insecure:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        return ctx
    return ssl.create_default_context()


class _NoCloseReader:
    """A read proxy over one shared buffered socket reader: pipelined
    responses must parse sequentially from the SAME buffer (a fresh
    makefile per response could buffer-read into the next response and
    lose those bytes), and HTTPResponse.close() must not close it."""

    def __init__(self, fp):
        self._fp = fp

    def read(self, *a):
        return self._fp.read(*a)

    def read1(self, *a):
        return self._fp.read1(*a)

    def readinto(self, b):
        return self._fp.readinto(b)

    def readline(self, *a):
        return self._fp.readline(*a)

    def flush(self):
        pass

    def close(self):
        pass


def _is_conn_error(e: BaseException) -> bool:
    """Connection-level failure: nothing of the response arrived, so
    the failover/rotation logic may act. Read timeouts are NOT in this
    set — TimeoutError must propagate (the server may still be
    processing the write)."""
    import http.client as _hc

    if isinstance(e, TimeoutError):
        return False
    return isinstance(
        e, (ConnectionError, _hc.BadStatusLine, _hc.RemoteDisconnected,
            _hc.CannotSendRequest, OSError)
    )


class HTTPTransport:
    """Stdlib HTTP(S) transport with pooled keep-alive connections,
    chunked watch streaming, and request pipelining.

    request() and pipeline() draw from one keep-alive connection pool
    per base URL (a socket per CALL was the old cost: TCP setup + slow
    start on every request); watch() uses dedicated connections that
    live for the stream. tls_ca pins the server certificate (the
    kubeconfig certificate-authority idiom); insecure skips
    verification (insecure-skip-tls-verify)."""

    #: idle keep-alive connections retained per base URL
    POOL_MAX = 32
    #: ceiling on one 429 backoff sleep (Retry-After larger than this
    #: is clamped; the server's hint is an estimate, not a contract)
    BACKOFF_429_CAP = 8.0

    def __init__(self, base_url: str, timeout: float = 30.0,
                 tls_ca: str = "", insecure: bool = False,
                 binary: bool = False, bearer_token: str = "",
                 user: str = "", groups=(), retry_429: int = 4,
                 spread: bool = False):
        """binary=True negotiates the binary content type
        (runtime/binary.py) — the protobuf-at-scale analogue kubemark
        components default to. Implies the object protocol client-side
        (no reflective codec on either end). bearer_token attaches
        `Authorization: Bearer ...` to every request (the kubeconfig
        user.token idiom — restclient.Config.BearerToken).

        user/groups declare the caller's flow identity via the
        X-Remote-User/-Group headers (honored by an authenticator-less
        apiserver — the insecure-port idiom — for APF classification
        and audit attribution; an authenticator-backed server ignores
        them in favor of the authenticated identity).

        retry_429: a 429 response (the apiserver door shedding load)
        is retried up to this many times with the server's Retry-After
        hint (capped exponential backoff + jitter when absent) instead
        of surfacing as a hard failure; 0 disables. 429 means the
        request was shed BEFORE execution, so replay is safe for every
        verb. Sheds/retries are counted in self.stats.

        base_url may be a COMMA-SEPARATED list of servers (the HA
        apiserver idiom — etcd clients take endpoint lists the same
        way): a connection-level failure OR a 503 (an unpromoted
        standby; a quorum member that cannot reach its leader) rotates
        to the next server and retries, so a replica failover is
        invisible to callers beyond the retried request. A 503 whose
        body marks the outcome ``indeterminate`` (the write may have
        committed) still rotates but is NOT blind-replayed.

        spread=True round-robins ordinary requests across the endpoint
        list (each call picks the next server) instead of pinning one —
        the load-spreading mode for a replicated apiserver front door.
        Watches stay pinned to the connection they opened on either
        way."""
        urls = [u.strip().rstrip("/") for u in base_url.split(",")
                if u.strip()]
        self.base_urls = urls
        self.spread = spread and len(urls) > 1
        self._spread_i = 0  # guarded-by: self._active_lock
        self._active = 0  # guarded-by: self._active_lock
        # failover rotation races: watch threads and request threads
        # rotate concurrently, and torn read-modify-writes of _active
        # could skip a healthy server in the cycle; pipelined requests
        # sample base_url once and must not observe a half-rotated state
        self._active_lock = threading.Lock()
        self.timeout = timeout
        self.bearer_token = bearer_token
        self.user = user
        self.groups = tuple(groups)
        self.retry_429 = max(0, int(retry_429))
        self._stats_lock = threading.Lock()
        # sheds_429: 429 responses observed; retries_429: retries
        # performed; giveups_429: 429s surfaced to the caller after
        # retries ran out; failovers_503: endpoint rotations forced by
        # a 503 reply (a member refusing because it is not / cannot
        # reach the leader — treated like a dead socket)
        # retries_503: full endpoint cycles re-run after every member
        # answered a determinate 503 (a leader election in progress —
        # all members briefly refuse; bounded by retry_429's budget)
        self.stats = {"sheds_429": 0, "retries_429": 0,
                      "giveups_429": 0, "failovers_503": 0,
                      "retries_503": 0}  # guarded-by: self._stats_lock
        self.binary = binary
        self.object_protocol = binary
        self._ssl_ctx = None
        # ANY https endpoint needs the context — a mixed or
        # standby-first endpoint list must not fail the moment rotation
        # lands on the TLS member
        if any(u.startswith("https") for u in urls):
            self._ssl_ctx = build_ssl_context(tls_ca, insecure)
        self._pool_lock = threading.Lock()
        self._pool: Dict[str, list] = {}  # guarded-by: self._pool_lock
        _races.track(self, "client.HTTPTransport")

    @property
    def base_url(self) -> str:
        with self._active_lock:
            return self.base_urls[self._active]

    def _pick_base(self) -> str:
        """The server the NEXT request targets: the sticky active one,
        or — in spread mode — the next in round-robin order."""
        if not self.spread:
            return self.base_url
        with self._active_lock:
            self._spread_i = (self._spread_i + 1) % len(self.base_urls)
            return self.base_urls[self._spread_i]

    def _rotate(self) -> bool:
        """Advance to the next server; True while untried servers remain
        in this rotation cycle."""
        if len(self.base_urls) < 2:
            return False
        with self._active_lock:
            self._active = (self._active + 1) % len(self.base_urls)
        return True

    def _count_failover(self) -> None:
        _failovers()
        with self._stats_lock:
            self.stats["failovers_503"] += 1

    @staticmethod
    def _is_indeterminate_503(decoded) -> bool:
        """A 503 whose body says the outcome is unknown (the write may
        have committed on the quorum even though this member couldn't
        confirm it) — rotating is fine, blind replay is not."""
        if not isinstance(decoded, dict):
            return False
        details = decoded.get("details")
        return bool(isinstance(details, dict)
                    and details.get("indeterminate"))

    # -- connection pool -----------------------------------------------------

    def _new_conn(self, base: str, timeout):
        import http.client as _hc

        parts = urlparse.urlsplit(base)
        if parts.scheme == "https":
            ctx = self._ssl_ctx or build_ssl_context()
            return _hc.HTTPSConnection(
                parts.hostname, parts.port, timeout=timeout, context=ctx
            )
        return _hc.HTTPConnection(
            parts.hostname, parts.port, timeout=timeout
        )

    def _checkout(self, base: str):
        """-> (connection, reused). Reused connections may be stale
        (server closed the idle socket); request() retries those once
        on a fresh socket."""
        with self._pool_lock:
            conns = self._pool.get(base)
            if conns:
                return conns.pop(), True
        return self._new_conn(base, self.timeout), False

    def _checkin(self, base: str, conn) -> None:
        with self._pool_lock:
            conns = self._pool.setdefault(base, [])
            if len(conns) < self.POOL_MAX:
                conns.append(conn)
                return
        conn.close()

    def close(self) -> None:
        """Drop all pooled connections (tests / daemon shutdown)."""
        with self._pool_lock:
            pools, self._pool = self._pool, {}
        for conns in pools.values():
            for c in conns:
                c.close()

    # -- request/response ----------------------------------------------------

    def _headers(self, has_body: bool) -> Dict[str, str]:
        h: Dict[str, str] = {}
        if has_body:
            h["Content-Type"] = (
                bin_codec.CONTENT_TYPE if self.binary
                else "application/json"
            )
        if self.binary:
            h["Accept"] = bin_codec.CONTENT_TYPE
        if self.bearer_token:
            h["Authorization"] = f"Bearer {self.bearer_token}"
        if self.user:
            h["X-Remote-User"] = self.user
            if self.groups:
                h["X-Remote-Group"] = ",".join(self.groups)
        return h

    def _encode_body(self, body):
        if body is None:
            return None
        if isinstance(body, (bytes, bytearray)):
            # pre-encoded by the caller (bulk-create storms encode one
            # repeated-template body ONCE instead of per request)
            return bytes(body)
        if self.binary:
            return bin_codec.encode(body)
        return json.dumps(body).encode()

    @staticmethod
    def _target(path: str, query: Optional[Dict[str, str]]) -> str:
        if query:
            return path + "?" + urlparse.urlencode(query)
        return path

    def request(self, method, path, query=None, body=None):
        data = self._encode_body(body)
        headers = self._headers(data is not None)
        target = self._target(path, query)
        method = method.upper()
        shed_attempt = 0
        unavailable_attempt = 0
        while True:
            resp, decoded = self._request_once(method, target, data,
                                               headers)
            if (resp.status == 503
                    and unavailable_attempt < self.retry_429
                    and not self._is_indeterminate_503(decoded)):
                # every endpoint refused (leader election in flight):
                # a short jittered backoff outlives most elections —
                # bounded by the same retry budget as 429 sheds
                unavailable_attempt += 1
                with self._stats_lock:
                    self.stats["retries_503"] += 1
                _time.sleep(min(0.2 * (2 ** unavailable_attempt), 2.0)
                            * (0.5 + _random.random() * 0.5))
                continue
            if resp.status != 429:
                return resp.status, decoded
            # 429 = shed at the apiserver door BEFORE execution (APF or
            # the in-flight limit): replaying is safe for every verb.
            # Honor the server's Retry-After estimate; fall back to
            # capped exponential backoff, jittered either way so a
            # synchronized thundering herd doesn't re-shed itself.
            _rate_limited()
            with self._stats_lock:
                self.stats["sheds_429"] += 1
            if shed_attempt >= self.retry_429:
                with self._stats_lock:
                    self.stats["giveups_429"] += 1
                return resp.status, decoded
            _retries()
            with self._stats_lock:
                self.stats["retries_429"] += 1
            _time.sleep(self._backoff_429(resp, shed_attempt))
            shed_attempt += 1

    def _backoff_429(self, resp, attempt: int) -> float:
        try:
            hint = float(resp.headers.get("Retry-After", "") or 0.0)
        except (ValueError, AttributeError):
            hint = 0.0
        base = hint if hint > 0 else 0.25 * (2 ** attempt)
        base = min(base, self.BACKOFF_429_CAP)
        return base * (0.5 + _random.random() * 0.5)

    def _request_once(self, method, target, data, headers):
        """One request with endpoint-failover rotation (pre-encoded
        body + headers); -> (http response, decoded payload). Two
        failure classes rotate: connection-level errors (socket died)
        and 503 replies (the member told us it cannot serve — an
        unpromoted standby, or a quorum member with no reachable
        leader). A 503 is an explicit refusal BEFORE execution unless
        its body marks the outcome indeterminate, so unlike a dead
        socket it is safe to replay on the next server for every
        verb."""
        for attempt in range(max(len(self.base_urls), 1)):
            base = self._pick_base()
            try:
                resp, payload = self._roundtrip(
                    base, method, target, data, headers
                )
                decoded = self._decode_response(resp, payload)
            except Exception as e:
                if not _is_conn_error(e):
                    raise
                rotated = self._rotate()  # NEXT request targets a peer
                # a REFUSED connect never put the request on the wire
                # (the process is dead / not listening): replaying is
                # safe for EVERY verb, exactly like a 503 refusal
                refused = isinstance(e, ConnectionRefusedError)
                if ((method in ("GET", "HEAD") or refused) and rotated
                        and attempt + 1 < len(self.base_urls)):
                    if refused:
                        self._count_failover()
                    continue  # replay on the next server
                # other mid-flight failures on non-idempotent verbs
                # must NOT auto-replay across servers: the dead server
                # may have committed (and replicated) the write before
                # the connection dropped — replaying would
                # double-execute or 409 the caller's own success. The
                # caller's retry/requeue logic re-issues against the
                # already-rotated peer.
                raise
            if (resp.status == 503 and len(self.base_urls) > 1
                    and attempt + 1 < len(self.base_urls)):
                self._rotate()
                self._count_failover()
                if not self._is_indeterminate_503(decoded):
                    continue  # refused before execution: replay
                # outcome unknown (the write may have committed):
                # surface the 503 — the CALLER owns idempotency here
            return resp, decoded
        raise AssertionError("unreachable")

    def _roundtrip(self, base, method, target, data, headers):
        """One request/response on a pooled keep-alive connection. A
        REUSED connection that dies before any response byte arrives is
        retried once on a fresh socket — that is the idle-keep-alive
        race (the server closed the pooled socket between requests),
        not a server failure."""
        conn, reused = self._checkout(base)
        while True:
            try:
                conn.request(method, target, body=data, headers=headers)
                resp = conn.getresponse()
                payload = resp.read()
            except Exception as e:
                conn.close()
                if reused and _is_conn_error(e):
                    conn, reused = self._new_conn(base, self.timeout), False
                    continue
                raise
            if resp.will_close:
                conn.close()
            else:
                self._checkin(base, conn)
            return resp, payload

    def _decode_response(self, resp, payload):
        """Decode an http.client response body (4xx/5xx included — the
        caller maps status codes, never exceptions)."""
        if not payload:
            return {}
        if self.binary:
            ctype = resp.headers.get("Content-Type", "") or ""
            if ctype.startswith(bin_codec.CONTENT_TYPE):
                with phase_timer("wire"):
                    return bin_codec.decode(payload)
        try:
            return json.loads(payload)
        except ValueError:
            return {"message": payload.decode(errors="replace")}

    # kept for callers/tests that feed urllib-style response objects
    def _decode_payload(self, resp, payload):
        if not payload:
            return {}
        # only a client that OPTED INTO the binary protocol decodes it:
        # a JSON client shouldn't switch codecs on a server's say-so
        # (the TLV wire is data-only either way, runtime/binary.py)
        if self.binary:
            ctype = resp.headers.get("Content-Type", "") if hasattr(
                resp, "headers"
            ) else ""
            if ctype.startswith(bin_codec.CONTENT_TYPE):
                # response decode is "wire" work in the phase breakdown
                # (list/relist payloads are the big ones)
                with phase_timer("wire"):
                    return bin_codec.decode(payload)
        return json.loads(payload)

    # -- pipelining ----------------------------------------------------------

    def pipeline(self, requests):
        """HTTP/1.1 request pipelining: write every request of `requests`
        — [(method, path, query, body)] — onto ONE persistent
        connection back-to-back, then parse the responses in order.
        -> [(status, payload)]. One round-trip's latency covers the
        whole batch instead of one per request.

        Connection-level failure raises after rotating the active
        server (no partial auto-replay: the caller owns idempotency,
        and some requests may have committed). The connection is not
        returned to the pool (response framing after a manual pipeline
        is not worth re-validating)."""
        if not requests:
            return []
        base = self.base_url
        conn = self._new_conn(base, self.timeout)
        parts = urlparse.urlsplit(base)
        host = parts.netloc
        try:
            if conn.sock is None:
                conn.connect()
            buf = bytearray()
            methods = []
            for method, path, query, body in requests:
                data = self._encode_body(body)
                method = method.upper()
                methods.append(method)
                lines = [f"{method} {self._target(path, query)} HTTP/1.1",
                         f"Host: {host}"]
                for k, v in self._headers(data is not None).items():
                    lines.append(f"{k}: {v}")
                lines.append(f"Content-Length: {len(data or b'')}")
                buf += ("\r\n".join(lines) + "\r\n\r\n").encode()
                if data:
                    buf += data
            conn.sock.sendall(buf)
            import http.client as _hc

            shared = conn.sock.makefile("rb")
            out = []
            try:
                for method in methods:
                    resp = _hc.HTTPResponse(conn.sock, method=method)
                    resp.fp = _NoCloseReader(shared)
                    resp.begin()
                    payload = resp.read()
                    out.append(
                        (resp.status, self._decode_response(resp, payload))
                    )
                    resp.close()
            finally:
                shared.close()
            return out
        except Exception as e:
            if _is_conn_error(e):
                self._rotate()
            raise
        finally:
            conn.close()

    # -- watch ---------------------------------------------------------------

    def watch(self, path, query=None):
        query = dict(query or {})
        query["watch"] = "true"
        target = self._target(path, query)
        headers = self._headers(False)
        for attempt in range(max(len(self.base_urls), 1)):
            base = self.base_url
            # dedicated connection: a watch holds its socket for the
            # stream's lifetime (never pooled), with no read timeout
            conn = self._new_conn(base, None)
            try:
                conn.request("GET", target, headers=headers)
                resp = conn.getresponse()
            except Exception as e:
                conn.close()
                if (_is_conn_error(e) and attempt + 1 < len(self.base_urls)
                        and self._rotate()):
                    continue
                raise
            if resp.status != 200:
                payload = resp.read()
                conn.close()
                try:
                    status = self._decode_response(resp, payload)
                except Exception:
                    status = {"message": payload.decode(errors="replace")}
                if (resp.status == 503
                        and attempt + 1 < len(self.base_urls)
                        and self._rotate()):
                    # this member can't serve (unpromoted standby /
                    # lost leader): open the stream on a peer instead
                    self._count_failover()
                    continue
                raise WatchError(resp.status, status)
            if self.binary:
                return _BinaryEvents(resp, conn)
            return _HTTPEvents(resp, conn)
        raise AssertionError("unreachable")


class _BinaryEvents:
    """Length-prefixed binary watch frames (runtime/binary.py)."""

    def __init__(self, resp, conn=None):
        self._resp = resp
        self._conn = conn
        self._stopped = False

    def _close(self) -> None:
        try:
            self._resp.close()
        except Exception:
            pass
        if self._conn is not None:
            try:
                self._conn.close()
            except Exception:
                pass

    def __iter__(self):
        try:
            for frame in bin_codec.read_frames(self._resp):
                if self._stopped:
                    return
                if frame is None:
                    continue  # keepalive
                yield frame
        except Exception:
            if not self._stopped:
                raise
        finally:
            self._close()

    def stop(self) -> None:
        self._stopped = True
        self._close()


class _HTTPEvents:
    """Newline-delimited JSON watch frames (pkg/apiserver/watch.go)."""

    def __init__(self, resp, conn=None):
        self._resp = resp
        self._conn = conn
        self._stopped = False

    def _close(self) -> None:
        try:
            self._resp.close()
        except Exception:
            pass
        if self._conn is not None:
            try:
                self._conn.close()
            except Exception:
                pass

    def __iter__(self):
        try:
            for line in self._resp:
                if self._stopped:
                    return
                line = line.strip()
                if line:
                    yield json.loads(line)
        except Exception:
            if not self._stopped:
                raise
        finally:
            self._close()

    def stop(self) -> None:
        self._stopped = True
        self._close()
