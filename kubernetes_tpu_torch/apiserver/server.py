"""The API server core (pkg/apiserver resthandler.go + pkg/master).

Transport-agnostic request handling: handle(method, path, query, body)
implements GET/LIST/POST/PUT/PATCH/DELETE plus resumable filtered
watches and the pods/binding + <resource>/status subresources. Paths
follow the reference's URL space:

    /api/v1/namespaces/{ns}/pods[/{name}[/binding|/status]]
    /api/v1/nodes[/{name}[/status]]
    /apis/extensions/v1beta1/namespaces/{ns}/replicasets/...
    /healthz, /metrics

serve_http() puts a real threaded HTTP frontend on top (chunked watch
streaming); the client layer's LocalTransport skips the socket.

Copy of kubernetes_tpu/apiserver/server.py: only the import package differs.
"""

from __future__ import annotations

import time as _time

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api import labels as labelpkg
from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.apiserver import admission as adm
from kubernetes_tpu_torch.apiserver.flowcontrol import Rejected as _APFRejected
from kubernetes_tpu_torch.apiserver.flowcontrol import request_width as _apf_width
from kubernetes_tpu_torch.apiserver.fields import (
    matches_fields,
    matches_fields_wire,
    parse_field_selector,
)
from kubernetes_tpu_torch.apiserver.thirdparty import ThirdPartyInstaller
from kubernetes_tpu_torch.apiserver.registry import (
    ResourceInfo,
    ValidationError,
    default_resources,
    prepare_meta,
    validate_meta,
)
from kubernetes_tpu_torch.runtime import scheme as default_scheme
from kubernetes_tpu_torch.runtime.versioning import (
    ConversionError,
    codec_for,
    group_versions,
)
from kubernetes_tpu_torch.storage import (
    Cacher,
    Compacted,
    Conflict,
    KeyExists,
    KeyNotFound,
    MemoryStore,
    WatchStream,
)


def _merge_wire(dst: Dict[str, Any], patch: Dict[str, Any]) -> None:
    """JSON-merge-patch over wire dicts (resthandler.go:445 idiom),
    shared by PATCH and the batch status items."""
    for k, v in patch.items():
        if v is None:
            dst.pop(k, None)
        elif isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge_wire(dst[k], v)
        else:
            dst[k] = v


class APIError(Exception):
    def __init__(self, code: int, message: str, reason: str = ""):
        super().__init__(message)
        self.code = code
        self.reason = reason or {
            400: "BadRequest",
            404: "NotFound",
            409: "Conflict",
            410: "Gone",
            422: "Invalid",
            403: "Forbidden",
        }.get(code, "InternalError")

    def status(self) -> Dict[str, Any]:
        return {
            "kind": "Status",
            "apiVersion": "v1",
            "status": "Failure",
            "message": str(self),
            "reason": self.reason,
            "code": self.code,
        }


@dataclass
class WatchResponse:
    """A filtered, translated watch the frontends stream to the client."""

    stream: WatchStream
    label_selector: labelpkg.Selector
    field_clauses: List[Tuple[str, str, str]]
    scheme: Any
    # object protocol (LocalTransport): yield API objects instead of wire
    # dicts — the in-process analogue of the reference's protobuf content
    # type (kubemark runs protobuf for exactly this codec cost)
    obj_mode: bool = False

    def events(self, idle_timeout: Optional[float] = None):
        """Yield wire-format {"type", "object"} dicts, applying the
        selector-transition translation (etcd_watcher.go sendModify/
        sendDelete): MODIFIED entering the filter becomes ADDED, leaving
        it becomes DELETED. With idle_timeout set, yields None after that
        many idle seconds so streaming frontends can probe liveness."""
        for batch in self.event_batches(idle_timeout):
            if batch is None:
                yield None
            else:
                yield from batch

    def event_batches(self, idle_timeout: Optional[float] = None,
                      max_batch: int = 512):
        """Yield LISTS of translated wire events — everything momentarily
        queued, so a streaming frontend pays one socket write per burst
        instead of one per event (a wave-bulk bind commits tens of
        thousands of events back-to-back). Yields None for idle probes.
        The stream ends after an ERROR event (relist required)."""
        yield from self._batches(self._translate, idle_timeout, max_batch)

    def frame_batches(self, idle_timeout: Optional[float] = None,
                      max_batch: int = 512):
        """event_batches for the BINARY frontend: yields lists of
        ready-to-write frame BYTES. When the store committed the event
        with the TLV codec, the object's wire bytes are spliced verbatim
        from the store's one-per-commit encoding — a binary watcher
        costs a memcpy per event, not a decode + re-encode."""
        from kubernetes_tpu_torch.runtime import binary

        def to_frame(ev):
            out_type = self._filter(ev)
            if out_type is None:
                return None
            if out_type == "ERROR":
                return binary.encode_frame(self._error_event())
            oblob = getattr(ev, "tlv_obj_blob", None)
            if oblob is not None:
                return binary.splice_frame(out_type, oblob)
            return binary.encode_frame(
                {"type": out_type, "object": ev.object}
            )

        yield from self._batches(to_frame, idle_timeout, max_batch,
                                 stop_types=())

    def burst_frames(self, idle_timeout: Optional[float] = None,
                     max_batch: int = 4096):
        """frame_batches, coalesced: each yielded value is (bytes,
        event_count) — the whole burst as ONE segmented frame (one
        write syscall per connection per burst), every TLV-committed
        object spliced verbatim. None still marks idle probes."""
        from kubernetes_tpu_torch.runtime import binary, tlv

        def to_item(ev):
            out_type = self._filter(ev)
            if out_type is None:
                return None
            if out_type == "ERROR":
                return ("ERROR", tlv.dumps(self._error_event()["object"]))
            oblob = getattr(ev, "tlv_obj_blob", None)
            if oblob is None:
                # non-TLV payload: same re-encode the legacy per-event
                # frame fallback pays, inside the burst envelope
                oblob = tlv.dumps(ev.object)
            return (out_type, oblob)

        for batch in self._batches(to_item, idle_timeout, max_batch,
                                   stop_types=()):
            if batch is None:
                yield None
            else:
                yield binary.coalesce_burst(batch), len(batch)

    def _batches(self, translate, idle_timeout, max_batch,
                 stop_types=("ERROR",)):
        while True:
            try:
                evs = self.stream.next_events(
                    max_n=max_batch, timeout=idle_timeout)
            except TimeoutError:
                yield None  # idle probe
                continue
            if evs is None:
                return  # stopped
            stop = evs[-1] is None
            if stop:
                evs.pop()
            batch: List = []
            for ev in evs:
                raw_type = ev.type
                out = translate(ev)
                if out is not None:
                    batch.append(out)
                    if raw_type == "ERROR" or (
                        isinstance(out, dict) and out.get("type") in stop_types
                    ):
                        stop = True
                        break
            if batch:
                yield batch
            if stop:
                return

    @staticmethod
    def _error_event() -> dict:
        return {
            "type": "ERROR",
            "object": {
                "kind": "Status",
                "status": "Failure",
                "message": "watch window overflowed; relist required",
                "reason": "Expired",
                "code": 410,
            },
        }

    def _filter(self, ev) -> Optional[str]:
        """Selector-transition translation for one raw store event:
        returns the outgoing event type ("ERROR" for overflow), or None
        when the event is filtered out. Filters on the store's shared
        read-only refs when present — a filtered-out event must not pay
        a decode per watcher."""
        if ev.type == "ERROR":
            return "ERROR"
        mobj = getattr(ev, "match_object", None)
        if mobj is None:
            mobj = ev.object
        mprev = getattr(ev, "match_prev", None)
        if mprev is None and ev.type != "ADDED":
            mprev = ev.prev_object
        cur_match = mobj is not None and self._match(mobj)
        if ev.type == "ADDED":
            if not cur_match:
                return None
            return "ADDED"
        if ev.type == "MODIFIED":
            prev_match = mprev is not None and self._match(mprev)
            if cur_match and prev_match:
                return "MODIFIED"
            if cur_match:
                return "ADDED"
            if prev_match:
                return "DELETED"
            return None
        if ev.type == "DELETED":
            ref = mprev if mprev is not None else mobj
            if ref is None or not self._match(ref):
                return None
            return "DELETED"
        return None

    def _translate(self, ev) -> Optional[dict]:
        """One raw store event -> wire event dict (None = filtered)."""
        out_type = self._filter(ev)
        if out_type is None:
            return None
        if out_type == "ERROR":
            return self._error_event()
        mobj = getattr(ev, "match_object", None)
        if mobj is None:
            mobj = ev.object
        if self.obj_mode:
            # obj_mode consumers own the object: the isolated copy
            payload = ev.object
        else:
            # Wire consumers only need the encoding — a read-only
            # traversal of the shared ref, computed ONCE per event
            # and memoized across watchers (N watchers used to pay
            # N reflective encodes per event; racing writers write
            # the same value, so the memo needs no lock). Versioned
            # codecs key by group-version NAME: codec objects are
            # rebuilt per request while events now outlive them in the
            # watch cache's ring, and id() of a freed codec is
            # reusable by a different-gv codec.
            cache = getattr(ev, "wire_cache", None)
            gv = getattr(self.scheme, "gv", None)
            key = gv.name if gv is not None else id(self.scheme)
            payload = cache.get(key) if cache is not None else None
            if payload is None:
                payload = self.scheme.encode(
                    mobj if mobj is not None else ev.object
                )
                if cache is not None:
                    cache[key] = payload
        return {"type": out_type, "object": payload}

    def _match(self, obj: Any) -> bool:
        # _match runs up to 4x per event per watcher during a bind storm
        # (cur+prev on two pod watchers); skip the everything-selector
        # call entirely
        sel = self.label_selector
        if sel.requirements or sel.impossible:
            if not sel.matches(obj.metadata.labels):
                return False
        return matches_fields(obj, self.field_clauses)

    def stop(self) -> None:
        self.stream.stop()


class APIServer:
    def __init__(
        self,
        store: Optional[MemoryStore] = None,
        scheme=None,
        auto_provision_namespaces: bool = True,
        authenticator=None,
        authorizer=None,
        data_dir: Optional[str] = None,
        admission_control: str = "",
        flowcontrol: object = "auto",
    ):
        """data_dir: persist the store (WAL + snapshot) so a restarted
        apiserver resumes with full state and RV continuity — the role
        etcd plays for the reference (storage/durable.py).

        admission_control: comma-separated plugin names replacing the
        default chain (the --admission-control flag; names per
        admission.PLUGIN_FACTORIES).

        flowcontrol: API priority-and-fairness at the door. "auto"
        (default) builds the APFController from the environment
        (default-on; KUBERNETES_TPU_APF=0 kills it); pass an
        APFController to override, or None to disable for this
        server."""
        if store is None:
            if data_dir:
                from kubernetes_tpu_torch.storage.durable import FileStore

                store = FileStore(data_dir)
            else:
                store = MemoryStore()
        self.store = store
        self.scheme = scheme or default_scheme
        self.resources = default_resources()
        # PodGroup admission is default-on: priority-class resolution
        # and gang quota enforcement cost one label-dict get for pods
        # outside any gang
        self.admission = adm.AdmissionChain([
            adm.NamespaceLifecycle(self), adm.PodGroupAdmission(self),
        ])
        if admission_control:
            self.admission = adm.AdmissionChain([
                adm.make_plugin(name.strip(), self)
                for name in admission_control.split(",") if name.strip()
            ])
        self._auto_ns = auto_provision_namespaces
        self._ns_active: set = set()  # memoized active namespaces
        self._http_server = None
        # HTTP-path auth (genericapiserver authn/authz); in-process
        # transports bypass auth like the reference's integration masters
        self.authenticator = authenticator
        self.authorizer = authorizer
        # componentstatuses probes (componentstatus/rest.go validators):
        # name -> callable() -> (ok: bool, message: str). etcd-0 is the
        # embedded store (always present); daemons register theirs via
        # register_component (the in-process analogue of the reference's
        # well-known localhost health ports)
        self.component_probes: Dict[str, Callable] = {
            "etcd-0": lambda: (True, "{\"health\": \"true\"}"),
        }
        # per-request (per-thread) flag: the current request's object
        # body was decoded fresh off the wire and ownership transfers to
        # the server — _decode_body skips its isolation copy
        import threading as _threading

        self._body_owned = _threading.local()
        # audit subsystem (apiserver/pkg/audit): per-request who/what/
        # when events into the process ring, policy-leveled. The HTTP
        # frontend deposits the authenticated user + request ID in the
        # per-thread context before calling handle().
        from kubernetes_tpu_torch.audit import AuditPolicy

        self.audit_policy = AuditPolicy.from_env()
        self._audit_ctx = _threading.local()
        # per-resource watch caches (pkg/storage/cacher): lazily built
        # in front of the store, serving steady-state lists/gets and
        # all watch fan-out from commit-time TLV bytes. The store stays
        # the source of truth; KUBERNETES_TPU_WATCH_CACHE=0 disables
        # (every read falls straight through — the equivalence-test
        # escape hatch and the safety valve).
        import os as _os

        self._cachers: Dict[str, Cacher] = {}
        self._cacher_built: Dict[str, float] = {}  # rebuild backoff
        self._cacher_lock = _threading.Lock()
        self._watch_cache_on = _os.environ.get(
            "KUBERNETES_TPU_WATCH_CACHE", "1"
        ).lower() not in ("0", "false", "off")
        # per-resource event-ring capacity (the --watch-cache-sizes
        # flag analogue): "pods=16384,nodes=2048,default=8192". An
        # undersized ring forces resuming watchers into a store
        # fallback/relist (counted by
        # storage_watch_cache_ring_evictions_total), never silent loss.
        self._watch_cache_sizes: Dict[str, int] = {}
        sizes = _os.environ.get("KUBERNETES_TPU_WATCH_CACHE_SIZES", "")
        for part in sizes.split(","):
            part = part.strip()
            if not part or "=" not in part:
                continue
            res, _, val = part.partition("=")
            try:
                self._watch_cache_sizes[res.strip()] = int(val)
            except ValueError:
                pass
        # event TTL (kube-apiserver --event-ttl; the reference leans on
        # etcd leases): Events are per-bind operational exhaust — a
        # sustained-traffic control plane mints one per pod, so without
        # expiry the store grows without bound and an hours-long soak
        # fails its flat-RSS gate on Events alone. 0 disables.
        try:
            self._event_ttl = float(_os.environ.get(
                "KUBERNETES_TPU_EVENT_TTL", "3600") or 0.0)
        except ValueError:
            self._event_ttl = 3600.0
        self._event_gc_next = 0.0  # monotonic sweep deadline
        # API priority and fairness (apiserver/flowcontrol.py): the
        # handle() choke point classifies every resource request by
        # caller identity and takes a bounded-concurrency seat (or
        # sheds with 429 + Retry-After) before dispatch — both doors
        # (HTTP frontend and in-process transports) funnel through it
        if flowcontrol == "auto":
            from kubernetes_tpu_torch.apiserver.flowcontrol import APFController

            self.flowcontrol = APFController.from_env()
        else:
            self.flowcontrol = flowcontrol or None
        # dynamic third-party resources (master.go:610-766); re-install
        # any persisted ThirdPartyResource objects on startup
        self.thirdparty = ThirdPartyInstaller(self)
        for tpr in self.store.list("/thirdpartyresources/")[0]:
            try:
                self.thirdparty.install(tpr)
            except Exception:
                pass  # a broken persisted TPR must not block startup

    # -- namespace helpers ---------------------------------------------------

    def get_namespace(self, name: str) -> Optional[t.Namespace]:
        try:
            obj, _ = self.store.get(f"/namespaces/{name}")
            return obj
        except KeyNotFound:
            return None

    def namespace_active(self, name: str) -> bool:
        """Existence + not-Terminating, memoized: every object write
        consults the namespace (auto-provision + lifecycle admission),
        and a store.get deep-copies — two copies per create on the hot
        path for an object that almost never changes. Any namespace
        write invalidates (see _handle)."""
        if name in self._ns_active:
            return True
        ns = self.get_namespace(name)
        if ns is not None and ns.status.phase != "Terminating":
            self._ns_active.add(name)
            return True
        return False

    def _ensure_namespace(self, name: str) -> None:
        if not self._auto_ns or not name:
            return
        if name in self._ns_active:
            return
        existing = self.get_namespace(name)
        if existing is None:
            from kubernetes_tpu_torch.apiserver.registry import prepare_namespace

            ns = t.Namespace(metadata=t.ObjectMeta(name=name, namespace=""))
            prepare_meta(ns)
            prepare_namespace(ns)  # finalizer-gated deletion applies to
            # auto-provisioned namespaces too
            try:
                self.store.create(f"/namespaces/{name}", ns)
            except KeyExists:
                pass
            self._ns_active.add(name)
        elif existing.status.phase != "Terminating":
            self._ns_active.add(name)

    # -- request routing -----------------------------------------------------

    def handle(
        self,
        method: str,
        path: str,
        query: Optional[Dict[str, str]] = None,
        body: Optional[Dict[str, Any]] = None,
        obj_mode: bool = False,
        body_owned: bool = False,
        raw_mode: bool = False,
    ):
        """Handle one REST request, auditing it per the audit policy.

        Every request routed here — HTTP frontend or in-process
        transport — produces at most one audit event (batch commits add
        one per contained object), so "who did what" is answerable from
        /debug/audit no matter which door the request came through.
        Exempt paths (health/metrics/debug) skip straight to dispatch
        with zero overhead.

        raw_mode (binary HTTP frontend only): cache-served list/get
        responses may be binary.RawObject/RawList — the stored TLV
        bytes, spliced verbatim by the frontend with zero re-encode."""
        apf = self.flowcontrol
        if apf is not None and path.startswith(("/api/", "/apis/")):
            # APF admission: identity deposited by the door (HTTP
            # frontend or LocalTransport) in the per-thread context. A
            # direct in-process handle() caller with no door is the
            # loopback/integration idiom -> system:unsecured (exempt).
            ctx = self._audit_ctx
            user = getattr(ctx, "user", None)
            if user is None:
                user = "system:unsecured"
            groups = getattr(ctx, "groups", None) or ()
            try:
                # seat WIDTH classified from the request shape: a
                # selector LIST or a bulk batch body occupies several
                # seats, so heavy requests are charged what they cost
                verb = method.upper()
                ticket = apf.admit(
                    user, groups, verb, path,
                    width=_apf_width(verb, path, query, body))
            except _APFRejected as e:
                return 429, {
                    "kind": "Status",
                    "apiVersion": "v1",
                    "status": "Failure",
                    "message": str(e),
                    "reason": "TooManyRequests",
                    "code": 429,
                    "details": {"retryAfterSeconds": e.retry_after},
                }
            with ticket:
                # the seat spans the synchronous dispatch only: a watch
                # pays for its initialization, not its stream lifetime
                # (long-running requests hold connections by design)
                return self._handle_audited(
                    method, path, query, body, obj_mode, body_owned,
                    raw_mode,
                )
        return self._handle_audited(
            method, path, query, body, obj_mode, body_owned, raw_mode
        )

    def _handle_audited(
        self,
        method: str,
        path: str,
        query: Optional[Dict[str, str]] = None,
        body: Optional[Dict[str, Any]] = None,
        obj_mode: bool = False,
        body_owned: bool = False,
        raw_mode: bool = False,
    ):
        level = self.audit_policy.level_for(path)
        if level == "None":
            return self._handle_coded(
                method, path, query, body, obj_mode, body_owned, raw_mode
            )
        ctx = self._audit_ctx
        ctx.route = None  # _handle deposits its route here as it parses
        t0 = _time.perf_counter()
        code, payload = 500, None
        try:
            code, payload = result = self._handle_coded(
                method, path, query, body, obj_mode, body_owned, raw_mode
            )
            return result
        finally:
            self._audit_record(
                level, method, path, query or {}, body, code,
                _time.perf_counter() - t0, response=payload,
            )

    def _audit_record(self, level, method, path, query, body, code,
                      latency, response=None) -> None:
        from kubernetes_tpu_torch import audit as _audit

        method = method.upper()
        ctx = self._audit_ctx
        route = getattr(ctx, "route", None)
        if route is not None:
            # _handle already routed this request; don't pay it twice
            ns, info, name, subresource = route
            resource = info.resource if info is not None else ""
        else:
            ns = resource = name = subresource = ""
            try:
                ns, info, name, subresource, _g, _v = self._route(path)
                resource = info.resource if info is not None else ""
            except Exception:
                pass  # non-resource path: the event still carries `path`
        if not resource and path.rstrip("/").endswith("/bindings"):
            resource = "bindings"  # the collection-bind shortcut
        if not name and body is not None:
            # create: the object's name arrives in the body, not the path
            if isinstance(body, dict):
                meta = body.get("metadata")
                if isinstance(meta, dict):
                    name = meta.get("name", "")
            else:
                name = getattr(
                    getattr(body, "metadata", None), "name", ""
                ) or ""
        if not name and response is not None:
            # generateName create: the server minted the name — it only
            # exists on the response object
            if isinstance(response, dict):
                meta = response.get("metadata")
                if isinstance(meta, dict):
                    name = meta.get("name", "")
            else:
                name = getattr(
                    getattr(response, "metadata", None), "name", ""
                ) or ""
        verb = _audit.verb_for(method, query, has_name=bool(name))
        _audit.record(
            level,
            getattr(ctx, "user", "") or "system:unsecured",
            verb,
            resource,
            ns or "",
            name or "",
            code,
            latency,
            request_id=getattr(ctx, "request_id", "") or "",
            path=path,
            subresource=subresource or "",
            request_object=(
                body if level == "Request" and method in
                ("POST", "PUT", "PATCH") else None
            ),
        )

    def _handle_coded(
        self,
        method: str,
        path: str,
        query: Optional[Dict[str, str]] = None,
        body: Optional[Dict[str, Any]] = None,
        obj_mode: bool = False,
        body_owned: bool = False,
        raw_mode: bool = False,
    ):
        """Returns (status_code, payload_dict) or (200, WatchResponse).

        obj_mode is the in-process object protocol (LocalTransport): the
        body may be an API object and responses carry API objects — the
        reflective wire codec stays off the hot path, the way the
        reference switches to protobuf at kubemark scale. Isolation is
        preserved: object bodies are copied in, responses are the store's
        own copies.

        body_owned=True transfers ownership of an object body to the
        server: the caller decoded it fresh off the wire and keeps no
        reference (the HTTP binary frontend), so the isolation copy at
        the decode boundary is skipped."""
        query = query or {}
        if body_owned:
            self._body_owned.flag = True
        try:
            return self._handle(method.upper(), path, query, body, obj_mode,
                                raw_mode)
        except ValueError as e:
            return 400, APIError(400, str(e)).status()
        except APIError as e:
            return e.code, e.status()
        except ValidationError as e:
            return 422, APIError(422, str(e)).status()
        except adm.AdmissionDenied as e:
            return 403, APIError(403, str(e)).status()
        except KeyNotFound as e:
            return 404, APIError(404, f"not found: {e}").status()
        except KeyExists as e:
            return 409, APIError(409, f"already exists: {e}").status()
        except Conflict as e:
            return 409, APIError(409, str(e)).status()
        except Compacted as e:
            return 410, APIError(410, str(e), reason="Expired").status()
        except Exception as e:
            # NotPrimary (a write reached an unpromoted standby, or a
            # quorum member that cannot prove/reach a leader) -> 503 so
            # clients rotate through transport failover; imported
            # lazily to keep replication optional
            from kubernetes_tpu_torch.storage.replicated import NotPrimary

            if isinstance(e, NotPrimary):
                status = APIError(
                    503, str(e), reason="ServiceUnavailable"
                ).status()
                # replay safety for the multi-endpoint transport: an
                # indeterminate outcome (the write may have committed)
                # must not be blind-retried on another replica
                status["details"] = {
                    "indeterminate": bool(
                        getattr(e, "indeterminate", False)),
                }
                return 503, status
            raise
        finally:
            if body_owned:
                self._body_owned.flag = False

    def _handle(self, method, path, query, body, obj_mode=False,
                raw_mode=False):
        if path == "/healthz":
            # quorum-backed servers surface their member's identity
            # (role / leader / term) so operators and probes can tell
            # WHICH member answered — the etcd /health + leader idiom
            status_fn = getattr(self.store, "quorum_status", None)
            if status_fn is not None:
                return 200, {"ok": True, "quorum": status_fn()}
            return 200, {"ok": True}
        if path in ("/ui", "/ui/"):
            from kubernetes_tpu_torch.apiserver.ui import UI_HTML

            # raw-content marker: frontends serve _raw bytes verbatim
            return 200, {"_raw": UI_HTML.encode(),
                         "_content_type": "text/html; charset=utf-8"}
        if path == "/metrics":
            from kubernetes_tpu_torch.metrics import registry as metrics_registry

            return 200, {
                "_raw": metrics_registry.render().encode(),
                "_content_type": "text/plain; version=0.0.4",
                # kept for in-process callers reading the text directly
                "text": metrics_registry.render(),
            }
        if path == "/configz":
            from kubernetes_tpu_torch.utils import configz

            return 200, configz.snapshot()
        if path == "/debug/traces":
            # the span ring buffer (trace/spans.py), newest first;
            # ?limit=N bounds it, ?trace=<id> filters one trace
            from kubernetes_tpu_torch.trace.httpd import render_traces

            return 200, render_traces(query)
        if path == "/debug/flowcontrol":
            # live APF state: per-level seats/queues/shed counts plus
            # the flow-schema table (apiserver/flowcontrol.py)
            if self.flowcontrol is None:
                return 200, {"enabled": False}
            return 200, self.flowcontrol.state()
        if path == "/debug/audit":
            # the audit ring (audit/audit.py), newest first; ?limit=N
            # bounds it, ?user=/&verb=/&resource= filter
            from kubernetes_tpu_torch.audit import render_audit

            return 200, render_audit(query)
        if path == "/debug/telemetry/query":
            # the process telemetry store (telemetry/tsdb.py):
            # ?q=rate(...)/sum(...)/quantile(...)/selector, or the
            # store index with no query
            from kubernetes_tpu_torch import telemetry

            return telemetry.handle_query(query)
        if path == "/debug/telemetry/alerts":
            from kubernetes_tpu_torch import telemetry

            return telemetry.handle_alerts(query)
        if path == "/debug/flightrecorder":
            from kubernetes_tpu_torch import telemetry

            return telemetry.handle_flight(query)
        if path.startswith("/debug/pprof"):
            # net/http/pprof analogue (scheduler server.go:96-99 mounts
            # it on every daemon; here daemons share this mux)
            from kubernetes_tpu_torch.utils import pprof

            if path.rstrip("/").endswith(("goroutine", "threads")):
                body = pprof.thread_stacks()
            elif path.rstrip("/").endswith("profile"):
                try:
                    seconds = float(query.get("seconds", "5"))
                except ValueError:
                    raise APIError(400, "seconds must be a number")
                # bound the window: a profile request is a debugging
                # aid, not a thread-pinning primitive
                body = pprof.sample_profile(min(seconds, 30.0))
            else:
                body = (
                    "pprof endpoints:\n"
                    "  /debug/pprof/goroutine  thread stacks\n"
                    "  /debug/pprof/profile?seconds=N  sampled profile\n"
                )
            return 200, {"_raw": body.encode(),
                         "_content_type": "text/plain; charset=utf-8"}
        if path in ("/api", "/api/", "/apis", "/apis/", "/api/v1",
                    "/swaggerapi", "/swaggerapi/") or (
            path.startswith("/swaggerapi/")
        ) or (
            path.startswith("/apis/") and len(
                [p for p in path.split("/") if p]) == 3
        ):
            return self._discovery(path)

        # POST /api/v1/batch — the wave-commit endpoint: bindings AND
        # status updates applied in one request, one store transaction
        if method == "POST" and path.rstrip("/") == "/api/v1/batch":
            return self._batch_commit(body, path)

        # POST /api/v1/namespaces/{ns}/bindings — the collection form the
        # reference's binder uses (factory.go:537-543)
        if method == "POST" and path.rstrip("/").endswith("/bindings"):
            parts = [p for p in path.split("/") if p]
            # the collection shortcut still validates the wire version
            if parts[:1] == ["api"]:
                g, v = "", parts[1] if len(parts) > 1 else ""
            elif parts[:1] == ["apis"]:
                g = parts[1] if len(parts) > 1 else ""
                v = parts[2] if len(parts) > 2 else ""
            else:
                g = v = ""
            self._resolve_codec(g, v)
            ns = parts[parts.index("namespaces") + 1] if "namespaces" in parts else ""
            return self._bind(ns, "", body)

        ns, info, name, subresource, group, version = self._route(path)
        # deposit for the audit hook: handle()'s finally reads it back
        # instead of routing the path a second time
        self._audit_ctx.route = (ns, info, name, subresource)
        if info is None:
            raise APIError(404, f"unknown path {path!r}")
        codec = self._resolve_codec(group, version)

        if method != "GET" and info.resource == "namespaces" and name:
            # any namespace write may change existence/phase: drop the
            # fast-path entry AFTER the write commits (a pre-write
            # invalidation lets a concurrent reader re-cache the stale
            # pre-write state forever)
            try:
                return self._dispatch(
                    method, path, query, body, ns, info, name,
                    subresource, obj_mode, codec, raw_mode,
                )
            finally:
                self._ns_active.discard(name)
        return self._dispatch(
            method, path, query, body, ns, info, name, subresource,
            obj_mode, codec, raw_mode,
        )

    def _resolve_codec(self, group: str, version: str):
        """The wire codec for /apis/{group}/{version} (or /api/{version});
        404 for anything the server does not serve."""
        codec = codec_for(self.scheme, group, version)
        if codec is None:
            raise APIError(
                404,
                f"the server does not serve version {version!r} of "
                f"group {group or 'core'!r}",
            )
        return codec

    # resources serving the /scale subresource (the reference's
    # ScaleREST installs on rc/rs/deployment etc.)
    SCALABLE = {
        "replicationcontrollers", "replicasets", "deployments",
        "jobs", "petsets",
    }

    def _dispatch(self, method, path, query, body, ns, info, name,
                  subresource, obj_mode, codec, raw_mode=False):
        if (subresource == "scale" and name
                and info.resource in self.SCALABLE):
            return self._scale(info, ns, name, method, body, obj_mode,
                               codec)
        if info.resource in ("tokenreviews", "subjectaccessreviews"):
            # virtual review endpoints (the webhook SERVER side): POST
            # only, verdict from this server's authn/authz, no storage
            if method != "POST":
                raise APIError(405, f"{info.resource} only supports POST")
            if info.resource == "tokenreviews":
                return self._token_review(body)
            return self._subject_access_review(body)
        if info.resource == "componentstatuses":
            # virtual resource: every GET probes live component health
            # (registry/componentstatus/rest.go); writes are rejected
            # and so are watches — nothing is stored to watch
            if method != "GET":
                raise APIError(405, "componentstatuses is read-only")
            if query.get("watch") in ("true", "1") or subresource == "watch":
                raise APIError(
                    405, "componentstatuses does not support watch"
                )
            return self._component_statuses(name, obj_mode, codec)
        if method == "GET":
            if query.get("watch") in ("true", "1") or subresource == "watch":
                return 200, self._watch(info, ns, query, name, obj_mode,
                                        codec)
            if subresource and subresource not in ("status", "finalize"):
                # a GET probing an unserved subresource must not answer
                # with the main object (clients use this for discovery)
                raise APIError(
                    404, f"subresource {subresource!r} not found on "
                    f"{info.resource}"
                )
            if name:
                return 200, self._get(info, ns, name, obj_mode, codec,
                                      raw_mode)
            return 200, self._list(info, ns, query, obj_mode, codec,
                                   raw_mode)
        if method == "POST":
            if subresource == "binding" or (not name and info.resource == "bindings"):
                return self._bind(ns, name, body)
            if name:
                raise APIError(400, "POST to a named resource")
            return self._create(info, ns, body, obj_mode, codec)
        if method == "PUT":
            if not name:
                raise APIError(400, "PUT requires a resource name")
            return self._update(info, ns, name, body, subresource, obj_mode,
                                codec)
        if method == "PATCH":
            if not name:
                raise APIError(400, "PATCH requires a resource name")
            return self._patch(info, ns, name, body, subresource, obj_mode,
                               codec)
        if method == "DELETE":
            if not name:
                raise APIError(400, "DELETE requires a resource name")
            return self._delete(info, ns, name, obj_mode, codec)
        raise APIError(400, f"unsupported method {method}")

    def _route(
        self, path: str
    ):
        """-> (namespace, resource info, name, subresource,
        group, version)."""
        parts = [p for p in path.split("/") if p]
        # the API group prefix names the wire version:
        # api/<version> (core) | apis/<group>/<version>
        group = version = ""
        if parts[:1] == ["api"]:
            version = parts[1] if len(parts) > 1 else ""
            parts = parts[2:]
        elif parts[:1] == ["apis"]:
            group = parts[1] if len(parts) > 1 else ""
            version = parts[2] if len(parts) > 2 else ""
            parts = parts[3:]
        else:
            return "", None, "", "", group, version
        # optional 1.2-style watch prefix: /api/v1/watch/...
        watch_prefix = False
        if parts[:1] == ["watch"]:
            watch_prefix = True
            parts = parts[1:]
        ns = ""
        if (
            parts[:1] == ["namespaces"]
            and len(parts) >= 3
            and parts[2] in self.resources
        ):
            # /namespaces/{ns}/{resource}/... — a namespaced resource
            ns = parts[1]
            parts = parts[2:]
        # else /namespaces[/{name}[/status]] — the namespaces resource
        # itself (parts[2], if present, is its subresource)
        if not parts:
            return ns, None, "", "", group, version
        resource, rest = parts[0], parts[1:]
        info = self.resources.get(resource)
        if info is None:
            return ns, None, "", "", group, version
        name = rest[0] if rest else ""
        sub = rest[1] if len(rest) > 1 else ""
        if watch_prefix:
            sub = "watch"
        return ns, info, name, sub, group, version

    # -- watch cache ---------------------------------------------------------

    # resources never served from the store's read path (virtual)
    _UNCACHED = {"componentstatuses", "tokenreviews", "subjectaccessreviews"}

    # fan-out interest index per resource: the field kubelet-shaped
    # watchers pin with equality/in selectors (kubelet config sources
    # watch spec.nodeName == <self>) — one hollow-fleet node's stream
    # must cost O(its own pods), not O(all pods)
    _INDEX_FIELDS = {"pods": "spec.nodeName"}

    def _cacher_for(self, info: ResourceInfo) -> Optional[Cacher]:
        """The lazily-built per-resource watch cache, or None when the
        cache tier is disabled or the resource is virtual. A cacher
        whose feed died (store-watch overflow, feed exception) is
        REBUILT from a fresh store bootstrap — the reference cacher
        relists after a watch break; a dead feed must not silently
        revert the resource to the per-request store path forever —
        with a short backoff so a persistent failure can't turn every
        read into a bootstrap."""
        if not self._watch_cache_on or info.resource in self._UNCACHED:
            return None
        root = info.list_prefix("")
        cacher = self._cachers.get(root)
        # racy healthy reads (here and under the lock below): a stale
        # True serves one request from a dying cacher, whose own reads
        # re-check and fall back; a stale False only rebuilds early
        if cacher is not None and cacher.healthy:  # race: allow[racy healthy fast-path]
            return cacher
        with self._cacher_lock:
            cacher = self._cachers.get(root)
            if cacher is not None and cacher.healthy:  # race: allow[racy healthy fast-path]
                return cacher
            now = _time.monotonic()
            if cacher is not None:
                if now - self._cacher_built.get(root, 0.0) < 2.0:
                    return cacher  # backoff: serve the fallback path
                cacher.stop()
            cacher = Cacher(
                self.store, root,
                ring_size=self._watch_cache_sizes.get(
                    info.resource,
                    self._watch_cache_sizes.get("default", 8192),
                ),
                index_field=self._INDEX_FIELDS.get(info.resource, ""),
            )
            self._cachers[root] = cacher
            self._cacher_built[root] = now
        return cacher

    # -- verbs ---------------------------------------------------------------

    def _get(self, info: ResourceInfo, ns: str, name: str,
             obj_mode: bool, codec, raw_mode: bool = False):
        cacher = self._cacher_for(info)
        if cacher is not None:
            entry = cacher.get_entry(info.key(ns, name))
            if entry is not None:
                if raw_mode and entry.blob is not None:
                    from kubernetes_tpu_torch.runtime import binary

                    return binary.RawObject(entry.blob)
                if obj_mode or raw_mode:
                    return entry.isolation_copy()
                # shared per-commit wire dict — read-only downstream,
                # like the watch fan-out's wire_cache payloads
                return entry.wire(codec)
        obj, _ = self.store.get(info.key(ns, name))
        return obj if obj_mode or raw_mode else codec.encode(obj)

    def _list(self, info: ResourceInfo, ns: str, query,
              obj_mode: bool, codec, raw_mode: bool = False):
        sel = labelpkg.parse(query.get("labelSelector", ""))
        clauses = parse_field_selector(query.get("fieldSelector", ""))
        gv = getattr(codec, "gv", None)

        def head(rv) -> dict:
            return {
                "kind": f"{info.kind}List",
                "apiVersion": gv.name if gv is not None else "v1",
                "metadata": {"resourceVersion": str(rv)},
            }

        cacher = self._cacher_for(info)
        served = (
            cacher.list_entries(info.list_prefix(ns))
            if cacher is not None else None
        )
        if served is not None:
            entries, rv = served
            use_sel = sel.requirements or sel.impossible
            matched = [
                e for e in entries
                if (not use_sel or sel.matches(e.obj.metadata.labels))
                and matches_fields(e.obj, clauses)
            ]
            if raw_mode and all(e.blob is not None for e in matched):
                # zero re-encode: the response body is the commit-time
                # TLV bytes of every matched object, concatenated into
                # the segmented envelope by the frontend
                from kubernetes_tpu_torch.runtime import binary

                return binary.RawList(head(rv),
                                      [e.blob for e in matched])
            if obj_mode or raw_mode:
                items = [e.isolation_copy() for e in matched]
            else:
                items = [e.wire(codec) for e in matched]
            out = head(rv)
            out["items"] = items
            return out
        objs, rv = self.store.list(info.list_prefix(ns))
        items = []
        for o in objs:
            if not sel.matches(o.metadata.labels):
                continue
            if obj_mode or raw_mode:
                if matches_fields(o, clauses):
                    items.append(o)
                continue
            wire = codec.encode(o)
            if matches_fields_wire(wire, clauses):
                items.append(wire)
        out = head(rv)
        out["items"] = items
        return out

    def _watch(
        self, info: ResourceInfo, ns: str, query, name: str = "",
        obj_mode: bool = False, codec=None,
    ) -> WatchResponse:
        codec = codec or self.scheme  # named-watch helpers call directly
        sel = labelpkg.parse(query.get("labelSelector", ""))
        clauses = parse_field_selector(query.get("fieldSelector", ""))
        if name:
            # watch on a named object restricts to that object
            clauses.append(("metadata.name", "=", name))
        from_rv = int(query.get("resourceVersion", "0") or "0")
        stream = None
        cacher = self._cacher_for(info)
        if cacher is not None:
            # served from the cache: ONE store watch feeds every
            # client's stream, events splice the commit-time bytes, and
            # the field clauses turn on server-side fan-out filtering
            # (interest-indexed when they pin spec.nodeName)
            stream = cacher.watch(info.list_prefix(ns), from_rv=from_rv,
                                  clauses=clauses)
        if stream is None:
            stream = self.store.watch(info.list_prefix(ns),
                                      from_rv=from_rv)
        return WatchResponse(stream, sel, clauses, codec, obj_mode)

    def _decode_body(self, info: ResourceInfo, body, codec) -> Any:
        if body is None:
            raise APIError(400, "request body required")
        if not isinstance(body, dict):
            if not isinstance(body, info.cls):
                raise APIError(
                    400,
                    f"expected {info.cls.__name__}, got "
                    f"{type(body).__name__}",
                )
            if getattr(self._body_owned, "flag", False):
                # wire-decoded body: the decode WAS the isolation copy
                # and the frontend keeps no reference
                return body
            # object protocol: copy in (the caller keeps its object; the
            # server must be free to default/mutate)
            from kubernetes_tpu_torch.storage.store import deep_copy

            return deep_copy(body)
        try:
            return codec.decode(body, info.cls)
        except ConversionError:
            raise
        except Exception as e:
            raise APIError(400, f"decode error: {e}")

    def _create(self, info: ResourceInfo, ns: str, body, obj_mode,
                codec):
        if isinstance(body, dict) and "items" in body and str(
            body.get("kind", "")
        ).endswith("List"):
            # Bulk create: one request commits the whole list in ONE
            # store transaction (one lock acquisition, one WAL append,
            # one watch burst), item semantics independent (the
            # collection analogue of the BindingList wave commit).
            # Per-item per-request overhead — and per-item store-lock
            # churn under a parallel create storm — is what caps
            # density-harness pod creation otherwise.
            results: List = []
            pending = []  # (result index, key, prepared object)
            for item in body["items"]:
                try:
                    obj = self._prepare_create(info, ns, item, codec)
                    pending.append((len(results), info.key(
                        obj.metadata.namespace, obj.metadata.name
                    ), obj))
                    results.append(None)  # filled from the commit below
                except Exception as e:
                    # independent per-item semantics: admission and
                    # validation failures (not APIError subclasses) must
                    # not abort the remainder of the list
                    results.append(
                        {"status": "Failure", "message": str(e)}
                    )
            errs = self.store.create_batch(
                [(key, obj) for _i, key, obj in pending]
            )
            for (i, _key, obj), err in zip(pending, errs):
                if err is None:
                    self._post_create(info, obj)
                    results[i] = {
                        "status": "Success",
                        "name": obj.metadata.name,
                        "resourceVersion": obj.metadata.resource_version,
                    }
                elif isinstance(err, KeyExists):
                    # same wording as the single-create 409 mapping so
                    # callers' collision handling works on either path
                    results[i] = {
                        "status": "Failure",
                        "message": f"already exists: {err}",
                    }
                else:
                    results[i] = {"status": "Failure",
                                  "message": str(err)}
            if info.resource == "events":
                # the broadcaster's storm path is record_many ->
                # create_many: the TTL sweep must ride the bulk door
                # too or sustained traffic never triggers it
                self._maybe_gc_events()
            return 201, {"kind": "Status", "status": "Success",
                         "items": results}
        obj = self._create_obj(info, ns, body, codec)
        stored = self.store.get(
            info.key(obj.metadata.namespace, obj.metadata.name)
        )[0]
        if info.resource == "events":
            self._maybe_gc_events()
        return 201, stored if obj_mode else codec.encode(stored)

    @staticmethod
    def _rfc3339_epoch(ts: str):
        """'%Y-%m-%dT%H:%M:%SZ' -> epoch seconds, or None. Fixed-offset
        slicing, not strptime: the sweep parses every retained event
        and strptime's lazy _strptime import is thread-hostile."""
        import calendar

        try:
            return calendar.timegm((
                int(ts[0:4]), int(ts[5:7]), int(ts[8:10]),
                int(ts[11:13]), int(ts[14:16]), int(ts[17:19]),
                0, 0, 0,
            ))
        except (ValueError, IndexError):
            return None

    def _maybe_gc_events(self) -> None:
        """kube-apiserver --event-ttl analogue (the reference delegates
        to etcd leases): drop Events older than KUBERNETES_TPU_EVENT_TTL
        seconds. Amortized onto the events write path — at most one
        sweep per min(max(ttl/4, 1), 60) seconds, expirations in ONE
        batch transaction — so no background thread to manage and an
        idle server pays nothing."""
        ttl = self._event_ttl
        if ttl <= 0:
            return
        now = _time.monotonic()
        # racy check+set: two handler threads at the deadline sweep
        # twice; the second sweep finds nothing expired  # race: allow[amortized deadline]
        if now < self._event_gc_next:
            return
        self._event_gc_next = now + min(max(ttl / 4.0, 1.0), 60.0)
        cutoff = _time.time() - ttl
        expired = []
        # scan_refs, not list(): the sweep reads ONE metadata field per
        # event — paying a TLV decode per retained event would put ~1s
        # of sweep inside every create-storm window
        for key, ev in self.store.scan_refs("/events/"):
            t = self._rfc3339_epoch(
                getattr(ev.metadata, "creation_timestamp", "") or "")
            if t is not None and t < cutoff:
                expired.append(key)
        if expired:
            from kubernetes_tpu_torch.storage import DELETE_OBJECT

            # identity copier: no isolation decode for objects the
            # mutation immediately discards (a TTL boundary can expire
            # tens of thousands of Events in one transaction)
            self.store.update_batch(
                [(key, lambda _o: DELETE_OBJECT, lambda o: o)
                 for key in expired])

    # -- discovery (apiserver.go APIGroupVersion install + genericapiserver
    # swagger wiring, :332) --------------------------------------------------

    def _discovery(self, path: str):
        parts = [p for p in path.split("/") if p]
        gvs = group_versions()  # {group-or-"core": [versions]}
        if parts == ["api"]:
            # the legacy group's version list (apiserver.go APIVersions)
            return 200, {"kind": "APIVersions",
                         "versions": gvs.get("core", ["v1"])}
        if parts == ["apis"]:
            # APIGroupList (pkg/apis/meta; served by the group mux)
            groups = []
            for g in sorted(g for g in gvs if g != "core"):
                vs = gvs[g]
                versions = [
                    {"groupVersion": f"{g}/{v}", "version": v} for v in vs
                ]
                groups.append({
                    "name": g,
                    "versions": versions,
                    "preferredVersion": versions[-1],
                })
            return 200, {"kind": "APIGroupList", "groups": groups}
        if parts == ["swaggerapi"]:
            # swagger 1.2 resource listing (genericapiserver.go:332)
            apis = [{"path": "/api/v1"}] + [
                {"path": f"/apis/{g}/{v}"}
                for g in sorted(g for g in gvs if g != "core")
                for v in gvs[g]
            ]
            return 200, {"swaggerVersion": "1.2", "apis": apis}
        if parts[0] == "swaggerapi":
            # per-group-version api declaration WITH model schemas
            # (pkg/apiserver/api_installer.go:169 swagger route
            # registration; kubectl explain's data source)
            if parts[1:] == ["api", "v1"]:
                group, version = "", "v1"
            elif len(parts) == 4 and parts[1] == "apis":
                group, version = parts[2], parts[3]
            else:
                raise APIError(404, f"no swagger api at {path!r}")
            self._resolve_codec(group, version)
            return 200, {
                "swaggerVersion": "1.2",
                "apiVersion": f"{group}/{version}" if group else version,
                "models": self._swagger_models(group),
            }
        # APIResourceList for one group/version
        if parts == ["api", "v1"]:
            group, version = "", "v1"
        else:
            group, version = parts[1], parts[2]
        self._resolve_codec(group, version)  # 404s unknown versions
        resources = []
        for info in sorted(self.resources.values(),
                           key=lambda i: i.resource):
            if (info.group or "") != group:
                continue
            resources.append({
                "name": info.resource,
                "kind": info.kind,
                "namespaced": info.namespaced,
            })
            if info.has_status:
                resources.append({
                    "name": f"{info.resource}/status",
                    "kind": info.kind,
                    "namespaced": info.namespaced,
                })
            if info.resource == "pods":
                resources.append({
                    "name": "pods/binding",
                    "kind": "Binding",
                    "namespaced": True,
                })
        gv_name = f"{group}/{version}" if group else version
        return 200, {
            "kind": "APIResourceList",
            "groupVersion": gv_name,
            "resources": resources,
        }

    def _swagger_models(self, group: str) -> dict:
        """Swagger-1.2 model schemas for every kind of `group`, walked
        reflectively from the dataclass types (the generated-swagger
        analogue: the reference generates these from its types too).
        Cached per group — the schema is import-time static."""
        cache = getattr(self, "_swagger_cache", None)
        if cache is None:
            cache = self._swagger_cache = {}
        got = cache.get(group)
        if got is not None:
            return got
        import dataclasses
        import typing

        from kubernetes_tpu_torch.runtime.scheme import to_camel

        models: dict = {}

        def type_ref(tp):
            origin = typing.get_origin(tp)
            if origin in (list, tuple):
                args = typing.get_args(tp)
                item = type_ref(args[0]) if args else {"type": "string"}
                return {"type": "array", "items": item}
            if origin is dict:
                return {"type": "object"}
            if origin is typing.Union:
                args = [a for a in typing.get_args(tp)
                        if a is not type(None)]
                return type_ref(args[0]) if args else {"type": "object"}
            if tp is str:
                return {"type": "string"}
            if tp is bool:
                return {"type": "boolean"}
            if tp is int:
                return {"type": "integer", "format": "int64"}
            if tp is float:
                return {"type": "number", "format": "double"}
            if dataclasses.is_dataclass(tp):
                add_model(tp)
                return {"$ref": tp.__name__}
            return {"type": "object"}

        def add_model(cls) -> None:
            name = cls.__name__
            if name in models:
                return
            models[name] = {}  # cycle guard before recursion
            hints = typing.get_type_hints(cls)
            props = {}
            for f in dataclasses.fields(cls):
                props[to_camel(f.name)] = type_ref(
                    hints.get(f.name, str)
                )
            models[name] = {"id": name, "properties": props}

        for info in self.resources.values():
            if (info.group or "") != group:
                continue
            add_model(info.cls)
        cache[group] = models
        return models

    def _scale(self, info, ns, name, method, body, obj_mode, codec):
        """GET/PUT {resource}/{name}/scale (registry ScaleREST): the
        uniform Scale shape over any scalable resource — the seam HPA
        and `kubectl scale` drive without knowing the resource's own
        schema."""
        key = info.key(ns, name)
        # a Job's scale knob is parallelism (extensions jobs/scale);
        # everything else scales spec.replicas
        knob = "parallelism" if info.resource == "jobs" else "replicas"

        def to_scale(obj, rv) -> t.Scale:
            sel = getattr(obj.spec, "selector", None)
            if hasattr(sel, "match_labels"):
                sel = dict(sel.match_labels or {})
            elif not isinstance(sel, dict):
                sel = {}
            return t.Scale(
                metadata=t.ObjectMeta(
                    name=name, namespace=ns, resource_version=str(rv)
                ),
                spec=t.ScaleSpec(
                    replicas=getattr(obj.spec, knob, 0) or 0
                ),
                status=t.ScaleStatus(
                    replicas=getattr(obj.status, "replicas",
                                     getattr(obj.status, "active", 0)),
                    selector=sel,
                ),
            )

        if method == "GET":
            obj, rv = self.store.get(key)
            out = to_scale(obj, rv)
            return 200, (out if obj_mode else codec.encode(out))
        if method != "PUT":
            raise APIError(405, "scale supports GET and PUT")
        if body is None:
            raise APIError(400, "Scale body required")
        if isinstance(body, dict):
            want = int(((body.get("spec") or {}).get("replicas")) or 0)
            want_rv = (body.get("metadata") or {}).get(
                "resourceVersion", "")
        else:
            want = int(body.spec.replicas)
            want_rv = body.metadata.resource_version
        if want < 0:
            raise APIError(422, "spec.replicas: must be non-negative")

        written = {}

        def bump(obj):
            if obj is None:
                raise KeyNotFound(key)
            if want_rv and want_rv != obj.metadata.resource_version:
                raise Conflict(
                    f"{info.resource} {name!r}: the object has been "
                    "modified"
                )
            if getattr(obj.spec, knob, None) != want:
                setattr(obj.spec, knob, want)
                # a spec change through ANY write path moves the
                # generation sequence (strategy PrepareForUpdate)
                obj.metadata.generation += 1
            # admission sees scale writes like any other update
            self.admission.admit(adm.UPDATE, info.resource, ns, obj)
            written["obj"] = obj
            return obj

        rv = self.store.guaranteed_update(key, bump)
        out = to_scale(written["obj"], rv)
        return 200, (out if obj_mode else codec.encode(out))

    def _token_review(self, body):
        """POST tokenreviews: validate spec.token against this server's
        authenticator (the webhook TokenReview SERVER side — our
        WebhookTokenAuthenticator can point at another apiserver)."""
        if not isinstance(body, dict):
            raise APIError(400, "TokenReview body required")
        token = ((body.get("spec") or {}).get("token") or "")
        status: Dict[str, Any] = {"authenticated": False}
        if token and self.authenticator is not None:
            try:
                user = self.authenticator.authenticate(
                    {"Authorization": f"Bearer {token}"}
                )
            except Exception:
                user = None
            if user is not None:
                status = {
                    "authenticated": True,
                    "user": {
                        "username": user.name,
                        "uid": user.uid,
                        "groups": list(user.groups),
                    },
                }
        return 201, {
            "apiVersion": "authentication.k8s.io/v1beta1",
            "kind": "TokenReview",
            "spec": {"token": token},
            "status": status,
        }

    def _subject_access_review(self, body):
        """POST subjectaccessreviews: ask this server's authorizer (the
        webhook SubjectAccessReview SERVER side)."""
        if not isinstance(body, dict):
            raise APIError(400, "SubjectAccessReview body required")
        from kubernetes_tpu_torch.auth.authn import UserInfo
        from kubernetes_tpu_torch.auth.authz import Attributes

        spec = body.get("spec") or {}
        user = UserInfo(
            name=spec.get("user", ""),
            groups=tuple(spec.get("groups", ()) or ()),
        )
        ra = spec.get("resourceAttributes") or {}
        nra = spec.get("nonResourceAttributes") or {}
        attrs = Attributes(
            user=user,
            # no fabricated default: an absent verb evaluates as ""
            # (only a '*' rule can match it), like upstream
            verb=(ra.get("verb") or nra.get("verb") or ""),
            resource=ra.get("resource", ""),
            namespace=ra.get("namespace", ""),
            name=ra.get("name", ""),
            api_group=ra.get("group", ""),
            subresource=ra.get("subresource", ""),
            path=nra.get("path", ""),
        )
        allowed = False
        reason = "no authorizer configured"
        if self.authorizer is not None:
            try:
                allowed = bool(self.authorizer.authorize(attrs))
                reason = ""
            except Exception as e:
                allowed, reason = False, str(e)
        return 201, {
            "apiVersion": "authorization.k8s.io/v1beta1",
            "kind": "SubjectAccessReview",
            "spec": spec,
            "status": {"allowed": allowed,
                       **({"reason": reason} if reason else {})},
        }

    def register_component(self, name: str, probe: Callable) -> None:
        """Add a componentstatuses probe: probe() -> (ok, message).
        Daemons sharing the process (local-up, tests) register here the
        way the reference's master probes scheduler/controller-manager
        on their well-known localhost ports."""
        self.component_probes[name] = probe

    def _component_statuses(self, name, obj_mode, codec):
        """registry/componentstatus/rest.go: live health, not storage."""
        def one(cname: str) -> t.ComponentStatus:
            probe = self.component_probes[cname]
            try:
                ok, msg = probe()
            except Exception as e:  # a dead probe is an unhealthy report
                ok, msg = False, str(e)
            return t.ComponentStatus(
                metadata=t.ObjectMeta(name=cname, namespace=""),
                conditions=[t.ComponentCondition(
                    type="Healthy",
                    status="True" if ok else "False",
                    message=msg if ok else "",
                    error="" if ok else msg,
                )],
            )

        if name:
            if name not in self.component_probes:
                raise KeyNotFound(name)
            obj = one(name)
            return 200, (obj if obj_mode else codec.encode(obj))
        items = [one(n) for n in sorted(self.component_probes)]
        if obj_mode:
            return 200, ({"kind": "ComponentStatusList",
                          "items": items,
                          "metadata": {"resourceVersion": "0"}})
        return 200, {
            "kind": "ComponentStatusList",
            "apiVersion": "v1",
            "metadata": {"resourceVersion": "0"},
            "items": [codec.encode(o) for o in items],
        }

    def _allocate_node_ports(self, svc) -> None:
        """registry/service/rest.go + portallocator: NodePort and
        LoadBalancer services get a cluster-unique port per service port
        from the 30000-32767 range. Unique node ports are what let a
        cloud load balancer address one service's traffic on a node
        (multiple services routinely share spec.ports[].port)."""
        if getattr(svc.spec, "type", "ClusterIP") not in (
            "NodePort", "LoadBalancer"
        ):
            return
        used = set()
        objs, _ = self.store.list("/services/specs")
        for other in objs:
            if other.metadata.uid == svc.metadata.uid:
                continue
            for p in getattr(other.spec, "ports", ()):
                if getattr(p, "node_port", 0):
                    used.add(p.node_port)
        nxt = 30000
        for p in svc.spec.ports:
            if p.node_port:
                if p.node_port in used:
                    raise APIError(
                        422,
                        f"spec.ports: node port {p.node_port} is "
                        "already allocated",
                    )
                used.add(p.node_port)
                continue
            while nxt in used and nxt <= 32767:
                nxt += 1
            if nxt > 32767:
                raise APIError(422, "node port range exhausted")
            p.node_port = nxt
            used.add(nxt)

    def _create_obj(self, info: ResourceInfo, ns: str, body, codec):
        obj = self._prepare_create(info, ns, body, codec)
        # obj is the server's decode/copy-boundary object: ownership
        # transfers to the store (no second write copy). Reading its
        # meta right after is fine (the store stamps rv in place);
        # callers must not hand this reference out.
        self.store.create(
            info.key(obj.metadata.namespace, obj.metadata.name), obj,
            owned=True,
        )
        self._post_create(info, obj)
        return obj  # rv already stamped in place by the store

    def _prepare_create(self, info: ResourceInfo, ns: str, body, codec):
        """Everything BEFORE the store commit — decode, defaulting,
        validation, admission — so the bulk path can prepare a whole
        list and commit it as one store transaction."""
        obj = self._decode_body(info, body, codec)
        if info.namespaced:
            # only an EXPLICIT body namespace can conflict with the URL;
            # decode fills the dataclass default ("default") when absent
            if isinstance(body, dict):
                body_ns = (body.get("metadata") or {}).get("namespace", "")
            else:
                body_ns = body.metadata.namespace
            if body_ns and ns and body_ns != ns:
                raise APIError(
                    400,
                    f"namespace mismatch: body {body_ns!r}, url {ns!r}",
                )
            obj.metadata.namespace = ns or body_ns or "default"
        else:
            obj.metadata.namespace = ""
        prepare_meta(obj)
        if info.prepare:
            info.prepare(obj)
        if info.resource == "services":
            self._allocate_node_ports(obj)
        validate_meta(obj, info.namespaced)
        if info.validate:
            info.validate(obj)
        if info.namespaced:
            self._ensure_namespace(obj.metadata.namespace)
        self.admission.admit(
            adm.CREATE, info.resource, obj.metadata.namespace, obj
        )
        if info.resource == "thirdpartyresources":
            # reject invalid TPRs BEFORE persisting: a 400'd object must
            # not land in the store and re-fail install on every restart
            self.thirdparty.precheck(obj)
        return obj

    def _post_create(self, info: ResourceInfo, obj) -> None:
        if info.resource == "thirdpartyresources":
            # dynamic installation (master.go InstallThirdPartyResource)
            self.thirdparty.install(obj)
        if info.resource == "pods":
            # wire-trace continuity: a pod carrying the trace-id
            # annotation gets its persistence marked on that trace, so
            # the apiserver leg shows up in the same /debug/traces
            # record as the scheduler's schedule/bind legs. No-op (one
            # dict get) for unannotated pods.
            from kubernetes_tpu_torch.trace import spans as trace_span

            trace_span.event_span(
                "apiserver.create", obj,
                rv=obj.metadata.resource_version,
            )

    def _update(self, info: ResourceInfo, ns: str, name: str, body,
                subresource, obj_mode, codec):
        new = self._decode_body(info, body, codec)
        key = info.key(ns, name)
        cur, cur_rv = self.store.get(key)
        if new.metadata.resource_version:
            if new.metadata.resource_version != str(cur_rv):
                raise Conflict(
                    f"{info.resource} {name!r}: the object has been modified"
                )
        if subresource and subresource not in ("status", "finalize"):
            # an unknown subresource must not silently write the main
            # resource (a Scale body would mangle a ConfigMap)
            raise APIError(
                404, f"subresource {subresource!r} not found on "
                f"{info.resource}"
            )
        if subresource == "status":
            # status subresource: only .status moves (registry strategy
            # PrepareForStatusUpdate idiom)
            cur.status = new.status
            new = cur
        elif subresource == "finalize":
            # namespaces/{name}/finalize: only spec.finalizers moves
            # (registry/namespace/rest.go FinalizeREST)
            cur.spec.finalizers = list(new.spec.finalizers)
            new = cur
        else:
            # preserve immutable meta
            new.metadata.uid = cur.metadata.uid
            new.metadata.creation_timestamp = cur.metadata.creation_timestamp
            new.metadata.namespace = cur.metadata.namespace
            new.metadata.name = cur.metadata.name
            new.metadata.deletion_timestamp = cur.metadata.deletion_timestamp
            # the generation sequence moves only on a real spec change
            # (strategy PrepareForUpdate compares semantic specs), so
            # no-op writes don't churn observedGeneration consumers;
            # compare only the spec subtrees (wire form), not the whole
            # objects, on this hot path
            from kubernetes_tpu_torch.runtime.scheme import encode_value

            if encode_value(getattr(new, "spec", None)) == encode_value(
                getattr(cur, "spec", None)
            ):
                new.metadata.generation = cur.metadata.generation
            else:
                new.metadata.generation = cur.metadata.generation + 1
            if info.has_status:
                # status never moves through the main resource (pod
                # strategy PrepareForUpdate copies old status forward)
                new.status = cur.status
            if info.resource == "services":
                # keep allocated node ports across spec updates; a type
                # flip to NodePort/LoadBalancer allocates fresh ones
                for p_new in new.spec.ports:
                    if p_new.node_port:
                        continue
                    for p_cur in cur.spec.ports:
                        if (p_cur.name, p_cur.port) == (
                            p_new.name, p_new.port
                        ):
                            p_new.node_port = p_cur.node_port
                            break
                self._allocate_node_ports(new)
        self.admission.admit(adm.UPDATE, info.resource, ns, new)
        self.store.update(key, new, expect_rv=cur_rv if
                          new.metadata.resource_version else None,
                          owned=True)
        stored = self.store.get(key)[0]
        return 200, stored if obj_mode else codec.encode(stored)

    def _patch(self, info: ResourceInfo, ns: str, name: str, body,
               subresource, obj_mode, codec):
        """Strategic-merge-lite: JSON merge patch over the wire form
        (resthandler.go:445 PatchResource)."""
        if body is None:
            raise APIError(400, "patch body required")
        # the status/main separation holds for PATCH too
        if subresource and subresource not in ("status",):
            raise APIError(
                404, f"subresource {subresource!r} not found on "
                f"{info.resource}"
            )
        if subresource == "status":
            body = {"status": body.get("status", {})}
        elif info.has_status:
            body = {k: v for k, v in body.items() if k != "status"}
        key = info.key(ns, name)
        cur, cur_rv = self.store.get(key)
        wire = codec.encode(cur)
        _merge_wire(wire, body)
        new = codec.decode(wire, info.cls)
        new.metadata.namespace = cur.metadata.namespace
        new.metadata.name = cur.metadata.name
        new.metadata.uid = cur.metadata.uid
        self.admission.admit(adm.UPDATE, info.resource, ns, new)
        self.store.update(key, new, expect_rv=cur_rv, owned=True)
        stored = self.store.get(key)[0]
        return 200, stored if obj_mode else codec.encode(stored)

    def _delete(self, info: ResourceInfo, ns: str, name: str,
                obj_mode, codec):
        self.admission.admit(adm.DELETE, info.resource, ns, None)
        key = info.key(ns, name)
        if info.resource == "namespaces":
            # namespace deletion is finalizer-gated: the first DELETE only
            # stamps deletionTimestamp; the object disappears once the
            # namespace controller strips the finalizers
            # (registry/namespace/etcd/etcd.go Delete)
            cur, _rv = self.store.get(key)
            if cur.spec.finalizers and cur.metadata.deletion_timestamp is None:
                def stamp(obj):
                    from kubernetes_tpu_torch.apiserver.registry import now_rfc3339

                    obj.metadata.deletion_timestamp = now_rfc3339()
                    return obj

                self.store.guaranteed_update(key, stamp)
                stored = self.store.get(key)[0]
                return 200, stored if obj_mode else codec.encode(stored)
        obj = self.store.delete(key)
        if info.resource == "thirdpartyresources":
            self.thirdparty.uninstall(name)
        return 200, obj if obj_mode else codec.encode(obj)

    def _bind(self, ns: str, pod_name: str, body):
        """POST pods/{name}/binding: assign spec.nodeName under CAS
        (registry/pod/rest.go assignPod; the scheduler's Bind target,
        factory.go:537-543). A BindingList body commits a whole wave's
        bindings in one request — the wave scheduler's bulk form (per-pod
        semantics preserved: each item succeeds or fails independently)."""
        if body is None:
            raise APIError(400, "binding body required")
        if body.get("kind") == "BindingList" or "items" in body:
            return self._apply_batch_items(
                body.get("items", []), ns, "/bindings", force_bind=True
            )
        ns, name, target = self._binding_fields(body, ns)
        name = name or pod_name
        if not target or not name:
            raise APIError(400, "binding requires pod name and target node")
        key = f"/pods/{ns}/{name}"
        self.store.guaranteed_update(key, self._make_assign(name, target))
        return 201, {"kind": "Status", "status": "Success"}

    def _batch_commit(self, body, path: str):
        """POST /api/v1/batch (kind: BatchRequest): a wave's worth of
        writes — bindings and status updates — applied in ONE request
        and ONE store transaction (one lock acquisition, one WAL
        append, one watch-event burst). Per-item semantics preserved:
        each item succeeds or fails independently.

        Item shapes:
            {"op": "bind", "metadata": {"name", "namespace"},
             "target": {"name": <node>}}
            {"op": "status", "resource": "pods", "namespace", "name",
             "status": {<merge patch of .status>}}
            {"op": "delete", "resource": "pods", "namespace", "name"}
        """
        if not isinstance(body, dict):
            raise APIError(400, "BatchRequest body required")
        return self._apply_batch_items(body.get("items") or [], "", path)

    def _apply_batch_items(self, items, default_ns: str, path: str,
                           force_bind: bool = False):
        """The one owner of batched write application + per-object
        auditing, shared by /bindings (BindingList) and /api/v1/batch."""
        from kubernetes_tpu_torch.metrics import apiserver_batch_commit_size_objects

        ops: List = []
        metas: List = []  # (verb, resource, ns, name, subresource)
        bad: Dict[int, str] = {}
        for i, item in enumerate(items):
            if not isinstance(item, dict):
                bad[i] = "batch item must be an object"
                ops.append(None)
                metas.append(None)
                continue
            op = "bind" if force_bind else (
                item.get("op")
                or ("bind" if ("target" in item or "targetNode" in item)
                    else "")
            )
            if op == "bind":
                item_ns, name, target = self._binding_fields(
                    item, default_ns or "default"
                )
                if not target or not name:
                    bad[i] = "binding requires pod name and target node"
                    ops.append(None)
                    metas.append(None)
                    continue
                ops.append((f"/pods/{item_ns}/{name}",
                            self._make_assign(name, target),
                            self._bind_spine_copy))
                metas.append(("create", "pods", item_ns, name, "binding"))
            elif op == "status":
                resource = item.get("resource", "pods")
                info = self.resources.get(resource)
                name = item.get("name") or ""
                patch = item.get("status")
                if info is None or not name or not isinstance(patch, dict):
                    bad[i] = (
                        "status item requires a known resource, a name, "
                        "and a status object"
                    )
                    ops.append(None)
                    metas.append(None)
                    continue
                item_ns = (
                    (item.get("namespace") or default_ns or "default")
                    if info.namespaced else ""
                )
                ops.append((info.key(item_ns, name),
                            self._make_status_merge(patch)))
                metas.append(("update", resource, item_ns, name, "status"))
            elif op == "delete":
                # churn's delete half rides the same one-transaction
                # door: soak-scale balanced deletion must not regress to
                # one DELETE request per pod
                from kubernetes_tpu_torch.storage import DELETE_OBJECT

                resource = item.get("resource", "pods")
                info = self.resources.get(resource)
                name = item.get("name") or ""
                if info is None or not name:
                    bad[i] = "delete item requires a known resource and a name"
                    ops.append(None)
                    metas.append(None)
                    continue
                item_ns = (
                    (item.get("namespace") or default_ns or "default")
                    if info.namespaced else ""
                )
                # identity copier: the mutation discards its input, so
                # the default isolation decode (~30us/object) would be
                # pure waste inside the store lock on a churn batch
                ops.append((info.key(item_ns, name),
                            lambda _obj: DELETE_OBJECT,
                            lambda obj: obj))
                metas.append(("delete", resource, item_ns, name, ""))
            else:
                bad[i] = f"unknown batch op {op!r}"
                ops.append(None)
                metas.append(None)
        live = [op for op in ops if op is not None]
        apiserver_batch_commit_size_objects.observe(len(live))
        errs = iter(self.store.update_batch(live))
        results = []
        audit_rows = []
        for i, op in enumerate(ops):
            if op is None:
                results.append({"status": "Failure", "message": bad[i]})
                continue
            err = next(errs)
            if err is None:
                results.append({"status": "Success"})
                code = 201
            else:
                msg = (f"not found: {err}"
                       if isinstance(err, KeyNotFound) else str(err))
                results.append({"status": "Failure", "message": msg})
                code = 404 if isinstance(err, KeyNotFound) else 409
            verb, resource, item_ns, name, sub = metas[i]
            audit_rows.append((verb, resource, item_ns, name, sub, code))
        self._audit_batch_objects(path, audit_rows)
        return 201, {"kind": "Status", "status": "Success",
                     "items": results}

    def _make_status_merge(self, patch: Dict[str, Any]):
        """A store mutation applying a JSON-merge patch to .status via
        the wire form (the _patch idiom, scoped to the status subtree
        for batch status items)."""
        scheme = self.scheme

        def apply(obj):
            wire = scheme.encode(obj)
            dst = wire.setdefault("status", {})
            _merge_wire(dst, patch)
            return scheme.decode(wire, type(obj))

        return apply

    def _audit_batch_objects(self, path: str, rows) -> None:
        """One audit event per object contained in a batch commit, all
        sharing the request's id (apiserver/pkg/audit: a batch request
        must not hide who touched which object). The request-level
        event handle() records carries the same id."""
        level = self.audit_policy.level_for(path)
        if level == "None" or not rows:
            return
        from kubernetes_tpu_torch import audit as _audit

        ctx = self._audit_ctx
        rid = getattr(ctx, "request_id", "") or ""
        if not rid:
            # in-process door: mint one id so the batch still correlates
            rid = _audit.new_request_id()
            ctx.request_id = rid
        user = getattr(ctx, "user", "") or "system:unsecured"
        for verb, resource, ns, name, sub, code in rows:
            _audit.record(
                level, user, verb, resource, ns, name, code, 0.0,
                request_id=rid, path=path, subresource=sub,
            )

    @staticmethod
    def _binding_fields(body, default_ns: str):
        """-> (ns, pod name, target node) from a Binding body, with the
        metadata/podName and target.name/targetNode fallbacks — the one
        owner of that parse for both the single and bulk endpoints."""
        meta = body.get("metadata") or {}
        return (
            meta.get("namespace") or default_ns,
            meta.get("name") or body.get("podName"),
            (body.get("target") or {}).get("name") or body.get(
                "targetNode"
            ),
        )

    @staticmethod
    def _make_assign(name: str, target: str):
        """The binding mutation (registry/pod/rest.go assignPod): set
        spec.nodeName under the no-reassign precondition and flip the
        PodScheduled condition."""

        def assign(pod):
            if pod.spec.node_name:
                raise Conflict(
                    f"pod {name!r} is already assigned to node "
                    f"{pod.spec.node_name!r}"
                )
            pod.spec.node_name = target
            for c in pod.status.conditions:
                if c.type == "PodScheduled":
                    c.status = "True"
                    break
            else:
                pod.status.conditions.append(
                    t.PodCondition(type="PodScheduled", status="True")
                )
            return pod

        return assign

    @staticmethod
    def _bind_spine_copy(pod):
        """Isolation copy for the assign mutation: clone exactly the
        layers assign() writes (pod, metadata — _set_rv stamps it —
        spec, status, the conditions list and its elements) and share
        everything else (containers, labels, volumes) with the stored
        read-only object. Replaces the generic full TLV decode on the
        hot bulk-bind path (~30us -> ~3us per pod at 30k binds/wave
        burst)."""
        _shallow = t.shallow_copy
        new = _shallow(pod)
        new.metadata = _shallow(pod.metadata)
        new.spec = _shallow(pod.spec)
        new.status = _shallow(pod.status)
        new.status.conditions = [
            _shallow(c) for c in pod.status.conditions
        ]
        return new

    # -- HTTP frontend -------------------------------------------------------

    def serve_http(self, host: str = "127.0.0.1", port: int = 0,
                   tls_cert: str = "", tls_key: str = "",
                   max_in_flight: int = 0, enable_binary: bool = False):
        """Start a threaded HTTP(S) frontend; returns (host, actual_port).
        tls_cert/tls_key serve TLS (genericapiserver default posture);
        max_in_flight bounds concurrent non-watch requests
        (handlers.go MaxInFlightLimit; excess gets 429)."""
        from kubernetes_tpu_torch.apiserver.http_frontend import start_http_server

        self._http_server, actual_port = start_http_server(
            self, host, port, tls_cert=tls_cert, tls_key=tls_key,
            max_in_flight=max_in_flight, enable_binary=enable_binary,
        )
        return host, actual_port

    def close_cachers(self) -> None:
        """Stop the watch-cache feed threads and terminate their client
        streams (daemons call this at shutdown; orphaned cachers also
        self-collect via the feed thread's weakref)."""
        with self._cacher_lock:
            cachers = list(self._cachers.values())
            self._cachers.clear()
        for c in cachers:
            c.stop()

    def shutdown_http(self) -> None:
        self.close_cachers()
        if self._http_server is not None:
            self._http_server.shutdown()
            # terminate long-running watch streams (a dead apiserver must
            # not keep feeding keepalives to clients that should
            # reconnect) and release the listening socket so a restarted
            # apiserver can rebind the same port immediately
            if hasattr(self._http_server, "stop_watches"):
                self._http_server.stop_watches()
            if hasattr(self._http_server, "close_connections"):
                self._http_server.close_connections()
            self._http_server.server_close()
            self._http_server = None
