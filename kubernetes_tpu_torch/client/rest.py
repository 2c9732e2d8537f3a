"""Typed REST client (pkg/client/restclient + pkg/client/unversioned).

One RESTClient per server; resource() returns a namespaceable accessor
with the standard verbs. Client-side QPS/burst throttling mirrors
restclient's flowcontrol token bucket (the perf harness runs QPS/Burst
5000, perf/util.go:61-66).

Copy of kubernetes_tpu/client/rest.py: only the import package differs.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

from kubernetes_tpu_torch.runtime import scheme as default_scheme
from kubernetes_tpu_torch.utils.flowcontrol import TokenBucketRateLimiter

# resource -> API group prefix (extensions resources live under /apis)
_GROUPS = {
    "replicasets": "/apis/extensions/v1beta1",
    "deployments": "/apis/extensions/v1beta1",
    "daemonsets": "/apis/extensions/v1beta1",
    "jobs": "/apis/extensions/v1beta1",
    "horizontalpodautoscalers": "/apis/extensions/v1beta1",
    "ingresses": "/apis/extensions/v1beta1",
    "networkpolicies": "/apis/extensions/v1beta1",
    "podsecuritypolicies": "/apis/extensions/v1beta1",
    "poddisruptionbudgets": "/apis/policy/v1alpha1",
    "scheduledjobs": "/apis/batch/v2alpha1",
    "podgroups": "/apis/scheduling/v1alpha1",
    "priorityclasses": "/apis/scheduling/v1alpha1",
    "roles": "/apis/rbac/v1alpha1",
    "rolebindings": "/apis/rbac/v1alpha1",
    "clusterroles": "/apis/rbac/v1alpha1",
    "clusterrolebindings": "/apis/rbac/v1alpha1",
}
_CLUSTER_SCOPED = {
    "nodes", "namespaces", "persistentvolumes",
    "podsecuritypolicies", "componentstatuses",
    "clusterroles", "clusterrolebindings",
}


class APIStatusError(Exception):
    def __init__(self, code: int, status: Dict[str, Any]):
        super().__init__(status.get("message", f"status {code}"))
        self.code = code
        self.reason = status.get("reason", "")
        self.status = status


class ResourceClient:
    def __init__(self, client: "RESTClient", resource: str, namespace: str = ""):
        self.client = client
        self.resource = resource
        self.namespace = namespace
        self.cluster_scoped = resource in _CLUSTER_SCOPED

    def in_namespace(self, namespace: str) -> "ResourceClient":
        return ResourceClient(self.client, self.resource, namespace)

    def _path(self, name: str = "", subresource: str = "") -> str:
        prefix = _GROUPS.get(self.resource, "/api/v1")
        path = prefix
        if not self.cluster_scoped and self.namespace:
            path += f"/namespaces/{self.namespace}"
        path += f"/{self.resource}"
        if name:
            path += f"/{name}"
        if subresource:
            path += f"/{subresource}"
        return path

    # -- verbs ---------------------------------------------------------------

    def get(self, name: str):
        return self.client.do("GET", self._path(name))

    def list(
        self,
        label_selector: str = "",
        field_selector: str = "",
    ) -> Tuple[list, str]:
        """-> (items, list resourceVersion)."""
        query = {}
        if label_selector:
            query["labelSelector"] = label_selector
        if field_selector:
            query["fieldSelector"] = field_selector
        payload = self.client.do_raw("GET", self._path(), query=query)
        items = [
            i if not isinstance(i, dict) else self.client.scheme.decode(i)
            for i in payload.get("items", [])
        ]
        rv = payload.get("metadata", {}).get("resourceVersion", "0")
        return items, rv

    def create(self, obj):
        body = (
            obj if self.client.object_protocol
            else self.client.scheme.encode(obj)
        )
        return self.client.do("POST", self._path(), body=body)

    def create_many(self, objs) -> list:
        """Bulk create: one POST of a List body commits every item with
        independent per-item semantics; returns the per-item status
        dicts ({"status": "Success", "name", "resourceVersion"} or
        {"status": "Failure", "message"})."""
        enc = (
            (lambda o: o) if self.client.object_protocol
            else self.client.scheme.encode
        )
        body = {"kind": "List", "items": [enc(o) for o in objs]}
        payload = self.client.do_raw("POST", self._path(), body=body)
        return payload.get("items", [])

    def update(self, obj, subresource: str = ""):
        body = (
            obj if self.client.object_protocol
            else self.client.scheme.encode(obj)
        )
        return self.client.do(
            "PUT",
            self._path(obj.metadata.name, subresource),
            body=body,
        )

    def update_status(self, obj):
        return self.update(obj, subresource="status")

    def patch(self, name: str, patch: Dict[str, Any], subresource: str = ""):
        return self.client.do("PATCH", self._path(name, subresource), body=patch)

    def delete(self, name: str):
        return self.client.do("DELETE", self._path(name))

    def watch(
        self,
        resource_version: str = "0",
        label_selector: str = "",
        field_selector: str = "",
    ) -> Iterator[Tuple[str, Any]]:
        """Yield (event_type, decoded_object); raises WatchExpired on 410."""
        from kubernetes_tpu_torch.client.transport import WatchError

        query = {"resourceVersion": resource_version}
        if label_selector:
            query["labelSelector"] = label_selector
        if field_selector:
            query["fieldSelector"] = field_selector
        self.client.throttle()
        try:
            raw = self.client.transport.watch(self._path(), query)
        except WatchError as e:
            if e.code == 410 or (
                isinstance(e.status, dict) and e.status.get("reason") == "Expired"
            ):
                raise WatchExpired(str(e))
            raise
        return _DecodedWatch(raw, self.client.scheme)

    def bind(self, pod_name: str, node_name: str, namespace: str = ""):
        """POST the binding subresource (the scheduler's Bind target,
        factory.go:537-543)."""
        ns = namespace or self.namespace or "default"
        body = {
            "kind": "Binding",
            "metadata": {"name": pod_name, "namespace": ns},
            "target": {"kind": "Node", "name": node_name},
        }
        path = f"/api/v1/namespaces/{ns}/pods/{pod_name}/binding"
        return self.client.do_raw("POST", path, body=body)

    def bind_many(self, bindings, namespace: str = ""):
        """Bulk bindings: [(pod_name, node_name, ns)] in ONE request.
        Returns the per-item result list (Success/Failure)."""
        ns = namespace or self.namespace or "default"
        body = {
            "kind": "BindingList",
            "items": [
                {
                    "kind": "Binding",
                    "metadata": {"name": pn, "namespace": pns or ns},
                    "target": {"kind": "Node", "name": nn},
                }
                for pn, nn, pns in bindings
            ],
        }
        out = self.client.do_raw(
            "POST", f"/api/v1/namespaces/{ns}/bindings", body=body
        )
        return out.get("items", [])


def batch_bind_item(pod_name: str, node_name: str,
                    namespace: str = "default") -> Dict[str, Any]:
    """One /api/v1/batch bind item (the wave scheduler's per-pod op)."""
    return {
        "op": "bind",
        "metadata": {"name": pod_name, "namespace": namespace},
        "target": {"kind": "Node", "name": node_name},
    }


def batch_status_item(resource: str, name: str, status: Dict[str, Any],
                      namespace: str = "default") -> Dict[str, Any]:
    """One /api/v1/batch status item (merge-patched into .status)."""
    return {
        "op": "status",
        "resource": resource,
        "namespace": namespace,
        "name": name,
        "status": status,
    }


def batch_delete_item(resource: str, name: str,
                      namespace: str = "default") -> Dict[str, Any]:
    """One /api/v1/batch delete item (the soak's churn half)."""
    return {
        "op": "delete",
        "resource": resource,
        "namespace": namespace,
        "name": name,
    }


class WatchExpired(Exception):
    """410: the requested resourceVersion is compacted; relist."""


class _DecodedWatch:
    def __init__(self, raw, scheme):
        self._raw = raw
        self._scheme = scheme

    def __iter__(self):
        for frame in self._raw:
            if frame["type"] == "ERROR":
                obj = frame.get("object", {})
                if obj.get("code") == 410 or obj.get("reason") == "Expired":
                    raise WatchExpired(obj.get("message", "watch expired"))
                raise APIStatusError(obj.get("code", 500), obj)
            obj = frame["object"]
            if isinstance(obj, dict):
                obj = self._scheme.decode(obj)
            yield frame["type"], obj

    def stop(self) -> None:
        self._raw.stop()


class RESTClient:
    def __init__(
        self,
        transport,
        scheme=None,
        qps: float = 0.0,
        burst: int = 0,
    ):
        self.transport = transport
        self.scheme = scheme or default_scheme
        # object protocol (LocalTransport): skip the wire codec entirely
        self.object_protocol = bool(
            getattr(transport, "object_protocol", False)
        )
        self._limiter = (
            TokenBucketRateLimiter(qps, burst) if qps > 0 and burst > 0 else None
        )

    def throttle(self) -> None:
        if self._limiter is not None:
            self._limiter.accept()

    def resource(self, resource: str, namespace: str = "") -> ResourceClient:
        return ResourceClient(self, resource, namespace)

    # shorthands
    def pods(self, namespace: str = "default") -> ResourceClient:
        return self.resource("pods", namespace)

    def nodes(self) -> ResourceClient:
        return self.resource("nodes")

    def events(self, namespace: str = "default") -> ResourceClient:
        return self.resource("events", namespace)

    def commit_batch(self, items) -> list:
        """POST /api/v1/batch: a wave's bindings + status updates as ONE
        request and one store transaction. `items` are
        batch_bind_item/batch_status_item dicts; returns the per-item
        result list (Success/Failure) in order."""
        out = self.do_raw(
            "POST", "/api/v1/batch",
            body={"kind": "BatchRequest", "items": list(items)},
        )
        return out.get("items", [])

    def do(self, method: str, path: str, query=None, body=None):
        """Request + decode into an API object."""
        payload = self.do_raw(method, path, query=query, body=body)
        if not isinstance(payload, dict):
            return payload  # object protocol: already an API object
        if payload.get("kind") == "Status":
            return payload
        return self.scheme.decode(payload)

    def do_raw(self, method: str, path: str, query=None, body=None):
        self.throttle()
        code, payload = self.transport.request(method, path, query, body)
        if code >= 400:
            raise APIStatusError(code, payload)
        return payload

    def healthz(self) -> bool:
        """GET /healthz (pkg/healthz probe)."""
        try:
            self.do_raw("GET", "/healthz")
            return True
        except Exception:
            return False
