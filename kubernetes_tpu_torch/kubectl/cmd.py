"""kubectl verbs (pkg/kubectl/cmd/*.go).

Supported: get (incl. --watch streaming), describe, create -f, apply -f,
delete, scale, label, annotate, cordon, uncordon, drain, run, expose,
rollout-status, logs, exec, attach, port-forward, patch, edit,
rolling-update, proxy, top, audit tail, autoscale, explain, convert,
config, version.
Resource name aliases follow kubectl shortcuts (po, no, svc, rc, rs,
deploy, ds, ns, ev, hpa...).

Copy of kubernetes_tpu/kubectl/cmd.py: only the import package differs."""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.client.rest import APIStatusError, RESTClient, WatchExpired
from kubernetes_tpu_torch.client.transport import HTTPTransport
from kubernetes_tpu_torch.kubectl.printers import print_table
from kubernetes_tpu_torch.runtime.scheme import scheme


def _fmt_num(v) -> str:
    """Numeric cell or <unknown> — summary fields may be absent when a
    node runs a stats-less runtime."""
    if v is None:
        return "<unknown>"
    if isinstance(v, float):
        return f"{v:g}"
    return str(v)


def _tabulate(rows: List[List[str]]) -> str:
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    return "\n".join(
        "  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
        for r in rows
    )

ALIASES = {
    "po": "pods", "pod": "pods",
    "no": "nodes", "node": "nodes",
    "svc": "services", "service": "services",
    "rc": "replicationcontrollers", "replicationcontroller": "replicationcontrollers",
    "rs": "replicasets", "replicaset": "replicasets",
    "deploy": "deployments", "deployment": "deployments",
    "ds": "daemonsets", "daemonset": "daemonsets",
    "job": "jobs",
    "ns": "namespaces", "namespace": "namespaces",
    "ev": "events", "event": "events",
    "ep": "endpoints",
    "hpa": "horizontalpodautoscalers",
    "horizontalpodautoscaler": "horizontalpodautoscalers",
    "pv": "persistentvolumes", "persistentvolume": "persistentvolumes",
    "pvc": "persistentvolumeclaims",
    "persistentvolumeclaim": "persistentvolumeclaims",
    "quota": "resourcequotas", "resourcequota": "resourcequotas",
    "petset": "petsets",
    "secret": "secrets", "configmap": "configmaps", "cm": "configmaps",
    "sa": "serviceaccounts", "serviceaccount": "serviceaccounts",
    "limits": "limitranges", "limitrange": "limitranges",
    "ing": "ingresses", "ingress": "ingresses",
    "netpol": "networkpolicies", "networkpolicy": "networkpolicies",
    "pdb": "poddisruptionbudgets",
    "poddisruptionbudget": "poddisruptionbudgets",
    "psp": "podsecuritypolicies",
    "podsecuritypolicy": "podsecuritypolicies",
    "sj": "scheduledjobs", "scheduledjob": "scheduledjobs",
    "podtemplate": "podtemplates",
    "cs": "componentstatuses", "componentstatus": "componentstatuses",
    "role": "roles", "rolebinding": "rolebindings",
    "clusterrole": "clusterroles",
    "clusterrolebinding": "clusterrolebindings",
    "pg": "podgroups", "podgroup": "podgroups",
    "pc": "priorityclasses", "priorityclass": "priorityclasses",
}

SCALABLE = {
    "replicationcontrollers": "ReplicationController",
    "replicasets": "ReplicaSet",
    "deployments": "Deployment",
    "petsets": "PetSet",
    "jobs": "Job",
}

_KIND_TO_RESOURCE = {
    "Pod": "pods", "Node": "nodes", "Service": "services",
    "ReplicationController": "replicationcontrollers",
    "ReplicaSet": "replicasets", "Deployment": "deployments",
    "DaemonSet": "daemonsets", "Job": "jobs", "Namespace": "namespaces",
    "Endpoints": "endpoints", "Event": "events",
    "PersistentVolume": "persistentvolumes",
    "PersistentVolumeClaim": "persistentvolumeclaims",
    "HorizontalPodAutoscaler": "horizontalpodautoscalers",
    "PetSet": "petsets", "ResourceQuota": "resourcequotas",
    "LimitRange": "limitranges", "ServiceAccount": "serviceaccounts",
    "Secret": "secrets", "ConfigMap": "configmaps",
    "Ingress": "ingresses", "NetworkPolicy": "networkpolicies",
    "PodDisruptionBudget": "poddisruptionbudgets",
    "PodSecurityPolicy": "podsecuritypolicies",
    "ScheduledJob": "scheduledjobs", "PodTemplate": "podtemplates",
    "Role": "roles", "RoleBinding": "rolebindings",
    "ClusterRole": "clusterroles",
    "ClusterRoleBinding": "clusterrolebindings",
    "PodGroup": "podgroups", "PriorityClass": "priorityclasses",
}


def resolve(resource: str) -> str:
    return ALIASES.get(resource.lower(), resource.lower())


class Kubectl:
    """All verbs as methods returning output strings (testable without a
    process boundary; main() is the argv shell)."""

    def __init__(self, client: RESTClient, namespace: str = "default",
                 node_token: str = "", node_tls_ca: str = "",
                 node_insecure: bool = False):
        self.client = client
        self.namespace = namespace
        # node-API credentials (kubelet TLS + bearer authn): the
        # reference proxies node endpoints through the apiserver; here
        # kubectl dials the kubelet directly, so it carries the token
        # and trust anchor itself
        self.node_token = node_token
        self.node_tls_ca = node_tls_ca
        self.node_insecure = node_insecure
        self._node_ssl_ctx = None

    def _rc(self, resource: str, all_namespaces: bool = False):
        return self.client.resource(
            resource, "" if all_namespaces else self.namespace
        )

    # -- read verbs ----------------------------------------------------------

    def get(
        self,
        resource: str,
        name: str = "",
        selector: str = "",
        output: str = "",
        all_namespaces: bool = False,
    ) -> str:
        resource = resolve(resource)
        rc = self._rc(resource, all_namespaces)
        if name:
            objs = [rc.get(name)]
        else:
            objs, _rv = rc.list(label_selector=selector)
            objs.sort(key=lambda o: (o.metadata.namespace, o.metadata.name))
        if output == "json":
            items = [scheme.encode(o) for o in objs]
            if name:
                return json.dumps(items[0], indent=2, sort_keys=True)
            return json.dumps(
                {"kind": "List", "items": items}, indent=2, sort_keys=True
            )
        if output == "name":
            return "\n".join(f"{resource}/{o.metadata.name}" for o in objs)
        if output == "yaml":
            import yaml

            items = [scheme.encode(o) for o in objs]
            return yaml.safe_dump(
                items[0] if name else {"kind": "List", "items": items},
                sort_keys=True,
            )
        return print_table(resource, objs, namespace_col=all_namespaces)

    def get_watch(
        self,
        resource: str,
        name: str = "",
        selector: str = "",
        all_namespaces: bool = False,
        max_events: int = 0,
        out=None,
    ) -> str:
        """kubectl get --watch (resource_printer streaming): print the
        current rows, then one row per watch event as it arrives, until
        the stream closes (or `max_events` streamed rows for bounded
        runs — tests and scripts). A `name` narrows the stream to that
        object (the metadata.name field selector, like the reference's
        single-object watch). Returns everything emitted."""
        from kubernetes_tpu_torch.kubectl.printers import TABLES, _generic_row

        resource = resolve(resource)
        rc = self._rc(resource, all_namespaces)
        field_selector = f"metadata.name={name}" if name else ""
        headers, row_fn = TABLES.get(resource, (["NAME", "AGE"], _generic_row))
        lines: List[str] = []

        def emit(cells):
            line = "   ".join(str(c) for c in cells).rstrip()
            lines.append(line)
            if out is not None:
                out(line)
            else:
                print(line, flush=True)

        emit(headers)
        objs, rv = rc.list(
            label_selector=selector, field_selector=field_selector
        )
        objs.sort(key=lambda o: (o.metadata.namespace, o.metadata.name))
        for o in objs:
            emit(row_fn(o))
        streamed = 0
        while max_events <= 0 or streamed < max_events:
            try:
                stream = rc.watch(
                    resource_version=rv, label_selector=selector,
                    field_selector=field_selector,
                )
                for ev_type, obj in stream:
                    if ev_type == "DELETED":
                        emit([f"{resource}/{obj.metadata.name}", "deleted"])
                    else:
                        emit(row_fn(obj))
                    if obj.metadata.resource_version:
                        rv = obj.metadata.resource_version
                    streamed += 1
                    if max_events > 0 and streamed >= max_events:
                        break
                else:
                    # server closed the stream without hitting the cap:
                    # a bounded run keeps re-watching, an unbounded one
                    # is done (kubectl -w exits when the stream ends)
                    if max_events > 0:
                        continue
                    break
                break
            except WatchExpired:
                objs, rv = rc.list(
                    label_selector=selector, field_selector=field_selector
                )
        return "\n".join(lines)

    def describe(self, resource: str, name: str) -> str:
        resource = resolve(resource)
        obj = self._rc(resource).get(name)
        lines = [
            f"Name:\t{obj.metadata.name}",
            f"Namespace:\t{obj.metadata.namespace or '<none>'}",
            f"Labels:\t{','.join(f'{k}={v}' for k, v in obj.metadata.labels.items()) or '<none>'}",
            f"Annotations:\t{','.join(f'{k}={v}' for k, v in obj.metadata.annotations.items()) or '<none>'}",
        ]
        if resource == "pods":
            lines += [
                f"Node:\t{obj.spec.node_name or '<none>'}",
                f"Status:\t{obj.status.phase}",
                f"IP:\t{obj.status.pod_ip or '<none>'}",
                "Containers:",
            ]
            for c in obj.spec.containers:
                lines.append(f"  {c.name or '<unnamed>'}:")
                lines.append(f"    Image:\t{c.image or '<none>'}")
                if c.requests:
                    reqs = ", ".join(f"{k}={v}" for k, v in c.requests.items())
                    lines.append(f"    Requests:\t{reqs}")
        elif resource == "podgroups":
            lines += [
                f"Min Member:\t{obj.spec.min_member}",
                f"Priority:\t{obj.spec.priority}"
                + (f" ({obj.spec.priority_class_name})"
                   if obj.spec.priority_class_name else ""),
                f"Tenant:\t{obj.spec.queue or obj.metadata.namespace}",
            ]
            if obj.spec.quota:
                q = ", ".join(f"{k}={v}" for k, v in obj.spec.quota.items())
                lines.append(f"Quota:\t{q}")
            if obj.spec.workload_class:
                lines.append(f"Workload Class:\t{obj.spec.workload_class}")
            lines += [
                f"Phase:\t{obj.status.phase}",
                f"Members Bound:\t{obj.status.scheduled}/"
                f"{max(obj.status.members, obj.status.scheduled)}",
            ]
            if obj.status.preempted:
                lines.append(f"Preempted Victims:\t{obj.status.preempted}")
            if obj.status.phase in ("Parked", "Preempting"):
                # why the gang is parked: the unschedulable members and
                # the scheduler's human-readable reason
                lines.append(f"Parked:\t{obj.status.message or '<none>'}")
                if obj.status.unschedulable:
                    lines.append("Unschedulable Members:")
                    for m in obj.status.unschedulable:
                        lines.append(f"  {m}")
        elif resource == "nodes":
            lines.append("Conditions:")
            for c in obj.status.conditions:
                lines.append(f"  {c.type}\t{c.status}\t{c.reason}")
            alloc = ", ".join(
                f"{k}={v}" for k, v in obj.status.allocatable.items()
            )
            lines.append(f"Allocatable:\t{alloc}")
            lines.append(f"Unschedulable:\t{obj.spec.unschedulable}")
        # events for the object (describe.go tail)
        events, _ = self.client.resource(
            "events", obj.metadata.namespace or "default"
        ).list()
        related = [
            e for e in events if e.involved_object.name == obj.metadata.name
        ]
        if related:
            lines.append("Events:")
            for e in related[-10:]:
                lines.append(
                    f"  {e.type}\t{e.reason}\t{e.source_component}\t{e.message}"
                )
        return "\n".join(lines)

    # -- write verbs ---------------------------------------------------------

    def _load_manifests(self, path: str) -> List[Any]:
        if path == "-":
            raw = sys.stdin.read()
        else:
            with open(path) as f:
                raw = f.read()
        docs: List[Dict] = []
        if raw.lstrip().startswith(("{", "[")):
            data = json.loads(raw)
            docs = data if isinstance(data, list) else [data]
        else:
            import yaml

            docs = [d for d in yaml.safe_load_all(raw) if d]
        out = []
        for d in docs:
            if d.get("kind") == "List":
                docs.extend(d.get("items", []))
                continue
            out.append(scheme.decode(d))
        return out

    def _resource_for(self, obj: Any) -> str:
        kind = scheme.kind_for(obj) or type(obj).__name__
        return _KIND_TO_RESOURCE[kind]

    def create(self, filename: str) -> str:
        out = []
        for obj in self._load_manifests(filename):
            resource = self._resource_for(obj)
            ns = obj.metadata.namespace or self.namespace
            try:
                created = self.client.resource(resource, ns).create(obj)
            except APIStatusError as e:
                if e.code == 403:
                    # admission denial (gang quota, security policy):
                    # surface the server's readable message, the
                    # reference's "Error from server (Forbidden)" shape
                    out.append(
                        f"Error from server (Forbidden): error when "
                        f"creating {filename!r}: {e}"
                    )
                    continue
                raise
            out.append(f"{resource}/{created.metadata.name} created")
        return "\n".join(out)

    def apply(self, filename: str) -> str:
        """apply.go-lite: create or replace-spec by name."""
        out = []
        for obj in self._load_manifests(filename):
            resource = self._resource_for(obj)
            ns = obj.metadata.namespace or self.namespace
            rc = self.client.resource(resource, ns)
            try:
                existing = rc.get(obj.metadata.name)
            except APIStatusError as e:
                if e.code != 404:
                    raise
                created = rc.create(obj)
                out.append(f"{resource}/{created.metadata.name} created")
                continue
            obj.metadata.resource_version = existing.metadata.resource_version
            rc.update(obj)
            out.append(f"{resource}/{obj.metadata.name} configured")
        return "\n".join(out)

    def replace(self, filename: str, force: bool = False) -> str:
        """kubectl replace (cmd/replace.go): full update of existing
        objects from a manifest; --force deletes and re-creates."""
        out = []
        for obj in self._load_manifests(filename):
            resource = self._resource_for(obj)
            ns = obj.metadata.namespace or self.namespace
            rc = self.client.resource(resource, ns)
            if force:
                try:
                    rc.delete(obj.metadata.name)
                except APIStatusError as e:
                    if e.code != 404:
                        raise
                rc.create(obj)
                out.append(f"{resource}/{obj.metadata.name} replaced")
                continue
            existing = rc.get(obj.metadata.name)  # 404 propagates: replace
            # requires the object to exist (unlike apply)
            obj.metadata.resource_version = existing.metadata.resource_version
            rc.update(obj)
            out.append(f"{resource}/{obj.metadata.name} replaced")
        return "\n".join(out)

    def taint(self, node: str, *taints: str) -> str:
        """kubectl taint nodes (cmd/taint.go): key=value:Effect adds,
        key:Effect- (trailing dash) removes. Writes whichever form the
        node already carries — spec.taints when set, else the 1.3 alpha
        annotation (get_taints' own precedence, api/helpers.go)."""
        import json as jsonlib

        def mutate(n):
            from kubernetes_tpu_torch.api.types import get_taints

            cur = [
                {"key": x.key, "value": x.value, "effect": x.effect}
                for x in get_taints(n)
            ]
            for spec in taints:
                if spec.endswith("-"):
                    body = spec[:-1]
                    if "=" in body:
                        # `foo=bar-` is a malformed ADD, not a removal —
                        # silently dropping foo's taints would be worse
                        raise ValueError(
                            f"invalid taint removal {spec!r}: want "
                            "key[:Effect]-"
                        )
                    key, _, effect = body.partition(":")
                    cur = [
                        x for x in cur
                        if not (x.get("key") == key and
                                (not effect or x.get("effect") == effect))
                    ]
                    continue
                if ":" not in spec:
                    raise ValueError(
                        f"invalid taint {spec!r}: want key[=value]:Effect"
                    )
                body, effect = spec.rsplit(":", 1)
                if effect not in ("NoSchedule", "PreferNoSchedule"):
                    raise ValueError(
                        f"invalid taint effect {effect!r}"
                    )
                key, _, value = body.partition("=")
                cur = [x for x in cur if not (
                    x.get("key") == key and x.get("effect") == effect
                )]
                cur.append({"key": key, "value": value, "effect": effect})
            if n.spec.taints is not None:
                n.spec.taints = [
                    t.Taint(key=x["key"], value=x["value"],
                            effect=x["effect"])
                    for x in cur
                ]
            elif cur:
                n.metadata.annotations[t.TAINTS_ANNOTATION] = (
                    jsonlib.dumps(cur)
                )
            else:
                n.metadata.annotations.pop(t.TAINTS_ANNOTATION, None)

        self._edit_meta("nodes", node, mutate)
        return f"node/{node} tainted"

    def api_versions(self) -> str:
        """kubectl api-versions (cmd/apiversions.go): every groupVersion
        from /apis discovery plus the core versions from /api."""
        core = self.client.do_raw("GET", "/api")
        groups = self.client.do_raw("GET", "/apis")
        out = [v for v in core.get("versions", [])]
        for g in groups.get("groups", []):
            out += [v["groupVersion"] for v in g.get("versions", [])]
        return "\n".join(sorted(out))

    def cluster_info(self) -> str:
        """kubectl cluster-info (cmd/clusterinfo.go): master address +
        well-known system services."""
        base = getattr(self.client.transport, "base_url",
                       "<in-process>")
        lines = [f"Kubernetes master is running at {base}"]
        try:
            svcs, _ = self.client.resource(
                "services", "kube-system"
            ).list()
            for s in svcs:
                lines.append(
                    f"{s.metadata.name} is running at "
                    f"{base}/api/v1/namespaces/kube-system/services/"
                    f"{s.metadata.name}"
                )
        except APIStatusError:
            pass
        return "\n".join(lines)

    def delete(
        self, resource: str = "", name: str = "", filename: str = "",
        selector: str = "",
    ) -> str:
        out = []
        if filename:
            for obj in self._load_manifests(filename):
                r = self._resource_for(obj)
                ns = obj.metadata.namespace or self.namespace
                self.client.resource(r, ns).delete(obj.metadata.name)
                out.append(f"{r}/{obj.metadata.name} deleted")
            return "\n".join(out)
        resource = resolve(resource)
        rc = self._rc(resource)
        names = (
            [name]
            if name
            else [o.metadata.name for o in rc.list(label_selector=selector)[0]]
        )
        for n in names:
            rc.delete(n)
            out.append(f"{resource}/{n} deleted")
        return "\n".join(out)

    def scale(self, resource: str, name: str, replicas: int) -> str:
        resource = resolve(resource)
        if resource not in SCALABLE:
            raise ValueError(f"{resource} is not scalable")
        rc = self._rc(resource)
        # the /scale subresource (registry ScaleREST): one round-trip,
        # no full-object read-modify-write race (the server maps a
        # Job's scale onto parallelism)
        self.client.do_raw(
            "PUT", rc._path(name, "scale"),
            body={"kind": "Scale",
                  "metadata": {"name": name},
                  "spec": {"replicas": replicas}},
        )
        return f"{resource}/{name} scaled"

    # -- set (pkg/kubectl/cmd/set: the update-one-field family) --------------

    def set_image(self, target: str, assignments) -> str:
        """kubectl set image TYPE/NAME container=image...: update
        container images on a pod template (or pod) in place."""
        resource, name = target.split("/", 1)
        resource = resolve(resource)
        want = dict(a.split("=", 1) for a in assignments)

        def mutate(obj):
            spec = (obj.spec if resource == "pods"
                    else obj.spec.template.spec)
            changed = 0
            for c in list(spec.containers) + list(
                getattr(spec, "init_containers", ())
            ):
                img = want.get(c.name) or want.get("*")
                if img:
                    c.image = img
                    changed += 1
            if not changed:
                raise ValueError(
                    f"no container of {target} matches "
                    f"{sorted(want)} (use '*' for all)"
                )

        self._edit_meta(resource, name, mutate)
        return f"{resource}/{name} image updated"

    def set_resources(self, target: str, requests: str = "",
                      limits: str = "", containers: str = "*") -> str:
        """kubectl set resources TYPE/NAME [--containers=...]
        --requests/--limits cpu=..,memory=.."""
        resource, name = target.split("/", 1)
        resource = resolve(resource)

        def parse_kv(text):
            out = {}
            for part in (text or "").split(","):
                part = part.strip()
                if part:
                    key, _, v = part.partition("=")
                    out[key] = v
            return out

        req, lim = parse_kv(requests), parse_kv(limits)
        names = {c.strip() for c in containers.split(",") if c.strip()}

        def mutate(obj):
            spec = (obj.spec if resource == "pods"
                    else obj.spec.template.spec)
            changed = 0
            for c in spec.containers:
                if "*" not in names and c.name not in names:
                    continue
                if req:
                    c.requests = {**(c.requests or {}), **req}
                if lim:
                    c.limits = {**(c.limits or {}), **lim}
                changed += 1
            if not changed:
                raise ValueError(f"no container of {target} matched")

        self._edit_meta(resource, name, mutate)
        return f"{resource}/{name} resource requirements updated"

    # -- typed create generators (pkg/kubectl/cmd/create_*.go) ---------------

    def create_namespace(self, name: str) -> str:
        self.client.resource("namespaces").create(
            t.Namespace(metadata=t.ObjectMeta(name=name, namespace=""))
        )
        return f"namespace/{name} created"

    def create_serviceaccount(self, name: str) -> str:
        self._rc("serviceaccounts").create(
            t.ServiceAccount(metadata=t.ObjectMeta(name=name))
        )
        return f"serviceaccount/{name} created"

    @staticmethod
    def _literals(from_literal, from_file) -> dict:
        data = {}
        for kv in from_literal or ():
            key, _, v = kv.partition("=")
            data[key] = v
        for spec_ in from_file or ():
            path_part = spec_.partition("=")
            if path_part[1]:
                key, path = path_part[0], path_part[2]
            else:
                import os as _os

                key, path = _os.path.basename(spec_), spec_
            with open(path) as f:
                data[key] = f.read()
        return data

    def create_secret(self, subcommand: str, name: str,
                      from_literal=(), from_file=()) -> str:
        """kubectl create secret generic NAME --from-literal=k=v
        (create_secret.go; values land base64'd in .data like the
        real wire form)."""
        if subcommand != "generic":
            raise ValueError(
                f"secret type {subcommand!r} not supported (generic only)"
            )
        import base64

        data = {
            k: base64.b64encode(v.encode()).decode()
            for k, v in self._literals(from_literal, from_file).items()
        }
        self._rc("secrets").create(t.Secret(
            metadata=t.ObjectMeta(name=name), data=data,
        ))
        return f"secret/{name} created"

    def create_configmap(self, name: str, from_literal=(),
                         from_file=()) -> str:
        self._rc("configmaps").create(t.ConfigMap(
            metadata=t.ObjectMeta(name=name),
            data=self._literals(from_literal, from_file),
        ))
        return f"configmap/{name} created"

    def create_service(self, kind: str, name: str, tcp=()) -> str:
        """kubectl create service clusterip|nodeport NAME
        --tcp=port[:targetPort]..."""
        if kind not in ("clusterip", "nodeport"):
            raise ValueError(f"service kind {kind!r} not supported")
        ports = []
        for spec_ in tcp or ("80",):
            p, _, tp = str(spec_).partition(":")
            ports.append(t.ServicePort(
                name=f"{p}-{tp or p}", port=int(p),
                target_port=int(tp) if tp else int(p),
            ))
        self._rc("services").create(t.Service(
            metadata=t.ObjectMeta(name=name, labels={"app": name}),
            spec=t.ServiceSpec(
                selector={"app": name}, ports=ports,
                type="NodePort" if kind == "nodeport" else "ClusterIP",
            ),
        ))
        return f"service/{name} created"

    def _edit_meta(self, resource, name, mutate) -> None:
        rc = self._rc(resolve(resource))
        for _ in range(10):
            obj = rc.get(name)
            mutate(obj)
            try:
                rc.update(obj)
                return
            except APIStatusError as e:
                if e.code != 409:
                    raise
                time.sleep(0.05)
        raise RuntimeError("update kept conflicting")

    def label(self, resource: str, name: str, *pairs: str) -> str:
        def mutate(obj):
            for pair in pairs:
                if pair.endswith("-"):
                    obj.metadata.labels.pop(pair[:-1], None)
                else:
                    k, v = pair.split("=", 1)
                    obj.metadata.labels[k] = v

        self._edit_meta(resource, name, mutate)
        return f"{resolve(resource)}/{name} labeled"

    def annotate(self, resource: str, name: str, *pairs: str) -> str:
        def mutate(obj):
            for pair in pairs:
                if pair.endswith("-"):
                    obj.metadata.annotations.pop(pair[:-1], None)
                else:
                    k, v = pair.split("=", 1)
                    obj.metadata.annotations[k] = v

        self._edit_meta(resource, name, mutate)
        return f"{resolve(resource)}/{name} annotated"

    # -- node ops (cordon.go / drain.go) --------------------------------------

    def cordon(self, node: str) -> str:
        self._edit_meta("nodes", node, lambda n: setattr(n.spec, "unschedulable", True))
        return f"node/{node} cordoned"

    def uncordon(self, node: str) -> str:
        self._edit_meta(
            "nodes", node, lambda n: setattr(n.spec, "unschedulable", False)
        )
        return f"node/{node} uncordoned"

    def drain(self, node: str) -> str:
        """cordon + delete the node's non-daemon pods (drain.go)."""
        self.cordon(node)
        deleted = []
        pods, _ = self.client.resource("pods", "").list(
            field_selector=f"spec.nodeName={node}"
        )
        for p in pods:
            created_by = p.metadata.annotations.get("kubernetes.io/created-by", "")
            if created_by.startswith("DaemonSet/"):
                continue  # daemons are left (they'd be recreated anyway)
            self.client.pods(p.metadata.namespace).delete(p.metadata.name)
            deleted.append(p.metadata.name)
        return "\n".join(
            [f"node/{node} cordoned"]
            + [f"pod/{n} evicted" for n in deleted]
            + [f"node/{node} drained"]
        )

    # -- imperative creators (run.go / expose.go) -----------------------------

    def run(self, name: str, image: str = "", replicas: int = 1,
            labels: str = "") -> str:
        lbls = dict(p.split("=", 1) for p in labels.split(",") if p) or {
            "run": name
        }
        rc = t.ReplicationController(
            metadata=t.ObjectMeta(name=name, namespace=self.namespace),
            spec=t.ReplicationControllerSpec(
                replicas=replicas,
                selector=dict(lbls),
                template=t.PodTemplateSpec(
                    metadata=t.ObjectMeta(labels=dict(lbls)),
                    spec=t.PodSpec(containers=[t.Container(name=name, image=image)]),
                ),
            ),
        )
        self._rc("replicationcontrollers").create(rc)
        return f"replicationcontroller/{name} created"

    def expose(self, resource: str, name: str, port: int,
               target_port: int = 0) -> str:
        resource = resolve(resource)
        obj = self._rc(resource).get(name)
        if resource == "replicationcontrollers":
            selector = dict(obj.spec.selector)
        else:
            selector = dict(obj.spec.selector.match_labels)
        svc = t.Service(
            metadata=t.ObjectMeta(name=name, namespace=self.namespace),
            spec=t.ServiceSpec(
                selector=selector,
                ports=[t.ServicePort(port=port, target_port=target_port or port)],
            ),
        )
        self._rc("services").create(svc)
        return f"service/{name} exposed"

    def rollout_status(self, resource: str, name: str) -> str:
        resource = resolve(resource)
        obj = self._rc(resource).get(name)
        if obj.status.updated_replicas < obj.spec.replicas:
            return (
                f"Waiting for rollout to finish: {obj.status.updated_replicas} "
                f"out of {obj.spec.replicas} new replicas have been updated..."
            )
        return f'{resource} "{name}" successfully rolled out'


    # -- node-backed verbs (kubelet API) -------------------------------------

    def _kubelet_base(self, pod) -> str:
        """Resolve the pod's node -> kubelet API endpoint (the reference
        proxies via the apiserver; here the client dials the address the
        kubelet registered on its Node status)."""
        node = self.client.nodes().get(pod.spec.node_name)
        port = node.status.kubelet_port
        if not port:
            raise RuntimeError(
                f"node {node.metadata.name!r} does not serve the kubelet API"
            )
        host = next(
            (a.address for a in node.status.addresses
             if a.type == "InternalIP"),
            "127.0.0.1",
        )
        scheme = "https" if getattr(
            node.status, "kubelet_https", False
        ) else "http"
        return f"{scheme}://{host}:{port}"

    def _kubelet_open(self, url, timeout: float = 10, data=None,
                      method: str = ""):
        """urlopen with the node-API credentials attached (bearer token
        + the shared client TLS policy, context cached per Kubectl)."""
        import urllib.request

        req = urllib.request.Request(
            url, data=data, method=method or None
        )
        if self.node_token:
            req.add_header("Authorization", f"Bearer {self.node_token}")
        ctx = None
        if url.startswith("https"):
            ctx = self._node_ssl_ctx
            if ctx is None:
                from kubernetes_tpu_torch.client.transport import build_ssl_context

                ctx = self._node_ssl_ctx = build_ssl_context(
                    self.node_tls_ca, self.node_insecure
                )
        return urllib.request.urlopen(req, timeout=timeout, context=ctx)

    def logs(self, name: str, container: str = "", tail: int = 0) -> str:
        """kubectl logs (cmd/logs.go): fetch container logs through the
        kubelet's /containerLogs endpoint."""
        import urllib.request

        pod = self._rc("pods").get(name)
        if not pod.spec.node_name:
            raise RuntimeError(f"pod {name!r} is not scheduled yet")
        container = container or (
            pod.spec.containers[0].name if pod.spec.containers else ""
        )
        url = (
            f"{self._kubelet_base(pod)}/containerLogs/"
            f"{pod.metadata.namespace}/{pod.metadata.name}/{container}"
        )
        if tail:
            url += f"?tailLines={tail}"
        with self._kubelet_open(url, timeout=10) as r:
            return r.read().decode()

    def exec(self, name: str, command: Sequence[str],
             container: str = "") -> str:
        """kubectl exec (cmd/exec.go): run a command through the
        kubelet's /exec endpoint."""
        import urllib.parse
        import urllib.request

        pod = self._rc("pods").get(name)
        if not pod.spec.node_name:
            raise RuntimeError(f"pod {name!r} is not scheduled yet")
        container = container or (
            pod.spec.containers[0].name if pod.spec.containers else ""
        )
        q = urllib.parse.urlencode(
            [("command", c) for c in command], doseq=False
        )
        url = (
            f"{self._kubelet_base(pod)}/exec/"
            f"{pod.metadata.namespace}/{pod.metadata.name}/{container}?{q}"
        )
        with self._kubelet_open(url, timeout=10, data=b"",
                                method="POST") as r:
            return r.read().decode()

    def attach(self, name: str, container: str = "",
               timeout: float = 2.0) -> str:
        """kubectl attach (cmd/attach.go): follow a running container's
        output through the kubelet's /attach stream; returns what the
        container wrote within `timeout` seconds (or until it stopped)."""
        import urllib.request

        pod = self._rc("pods").get(name)
        if not pod.spec.node_name:
            raise RuntimeError(f"pod {name!r} is not scheduled yet")
        container = container or (
            pod.spec.containers[0].name if pod.spec.containers else ""
        )
        url = (
            f"{self._kubelet_base(pod)}/attach/"
            f"{pod.metadata.namespace}/{pod.metadata.name}/{container}"
        )
        out = []
        deadline = time.monotonic() + timeout
        try:
            with self._kubelet_open(url, timeout=timeout) as r:
                while time.monotonic() < deadline:
                    chunk = r.read1(65536)
                    if not chunk:
                        break
                    out.append(chunk.decode(errors="replace"))
        except TimeoutError:
            pass
        except OSError as e:  # stream timeout surfaces as URLError too
            if out or "timed out" in str(e):
                pass
            else:
                raise
        return "".join(out)

    def port_forward(self, name: str, local_port: int, remote_port: int):
        """kubectl port-forward (cmd/portforward.go): listen on
        127.0.0.1:local_port and relay each connection to the pod's
        remote_port through the kubelet's /portForward endpoint. Returns
        a handle with .local_port and .stop()."""
        import socket as socketlib
        import threading

        pod = self._rc("pods").get(name)
        if not pod.spec.node_name:
            raise RuntimeError(f"pod {name!r} is not scheduled yet")
        base = self._kubelet_base(pod)
        host, port = base.replace("http://", "").rsplit(":", 1)
        path = (
            f"/portForward/{pod.metadata.namespace}/{pod.metadata.name}"
            f"?port={remote_port}"
        )

        listener = socketlib.socket()
        listener.setsockopt(socketlib.SOL_SOCKET, socketlib.SO_REUSEADDR, 1)
        listener.bind(("127.0.0.1", local_port))
        listener.listen(8)
        stop = threading.Event()

        def tunnel(conn):
            from kubernetes_tpu_torch.kubelet.server import _relay

            try:
                up = socketlib.create_connection((host, int(port)), timeout=10)
                req = (
                    f"POST {path} HTTP/1.1\r\nHost: {host}\r\n"
                    "Connection: close\r\n\r\n"
                ).encode()
                up.sendall(req)
                # consume the response headers; the raw relay follows
                buf = b""
                while b"\r\n\r\n" not in buf:
                    data = up.recv(4096)
                    if not data:
                        conn.close()
                        return
                    buf += data
                head, rest = buf.split(b"\r\n\r\n", 1)
                if b" 200 " not in head.split(b"\r\n", 1)[0]:
                    conn.close()
                    up.close()
                    return
                if rest:
                    conn.sendall(rest)
                _relay(conn, up)
            except OSError:
                pass
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

        def accept_loop():
            while not stop.is_set():
                try:
                    conn, _ = listener.accept()
                except OSError:
                    return
                threading.Thread(
                    target=tunnel, args=(conn,), daemon=True
                ).start()

        threading.Thread(target=accept_loop, daemon=True).start()

        class Handle:
            local_port = listener.getsockname()[1]

            @staticmethod
            def stop():
                stop.set()
                listener.close()

        return Handle

    # -- mutation verbs (patch.go / edit.go / rollingupdate.go) ---------------

    def patch(self, resource: str, name: str, patch: str,
              subresource: str = "") -> str:
        """kubectl patch (cmd/patch.go): strategic-merge/merge patch from
        a JSON string."""
        resource = resolve(resource)
        body = json.loads(patch)
        self._rc(resource).patch(name, body, subresource=subresource)
        return f"{resource}/{name} patched"

    def edit(self, resource: str, name: str, editor: str = "") -> str:
        """kubectl edit (cmd/edit.go): dump the object to a temp file,
        run $KUBE_EDITOR/$EDITOR on it, and update with the result."""
        import os
        import subprocess
        import tempfile

        import yaml

        resource = resolve(resource)
        rc = self._rc(resource)
        obj = rc.get(name)
        doc = scheme.encode(obj)
        editor = editor or os.environ.get("KUBE_EDITOR") or os.environ.get(
            "EDITOR", "vi"
        )
        with tempfile.NamedTemporaryFile(
            "w+", suffix=".yaml", delete=False
        ) as f:
            yaml.safe_dump(doc, f, sort_keys=True)
            path = f.name
        try:
            subprocess.run(f"{editor} {path}", shell=True, check=True)
            with open(path) as f:
                edited = yaml.safe_load(f)
        finally:
            os.unlink(path)
        if edited == doc:
            return "Edit cancelled, no changes made."
        new = scheme.decode(edited)
        new.metadata.resource_version = obj.metadata.resource_version
        rc.update(new)
        return f"{resource}/{name} edited"

    def rolling_update(self, old_name: str, image: str = "",
                       new_name: str = "", interval: float = 0.1,
                       timeout: float = 30.0) -> str:
        """kubectl rolling-update (cmd/rollingupdate.go +
        pkg/kubectl/rolling_updater.go): create a new RC alongside the
        old one, scale +1/-1 until the new RC owns every replica, then
        delete the old RC."""
        rc_api = self._rc("replicationcontrollers")
        old = rc_api.get(old_name)
        desired = old.spec.replicas
        new_name = new_name or f"{old_name}-next"
        deploy_key = "deployment"
        import copy as copymod

        # Disambiguate ownership before the new RC exists: without a
        # deployment-key dimension the old selector would match the new
        # RC's pods too and fight it for them
        # (rolling_updater.go AddDeploymentKeyToReplicationController).
        old_token = f"{old_name}-orig"
        if old.spec.selector.get(deploy_key) != old_token:
            sel = ",".join(f"{k}={v}" for k, v in old.spec.selector.items())
            for p in self.client.pods(old.metadata.namespace).list(
                label_selector=sel
            )[0]:
                self.label("pods", p.metadata.name,
                           f"{deploy_key}={old_token}")
            def add_key(rc_obj):
                rc_obj.spec.template.metadata.labels[deploy_key] = old_token
                rc_obj.spec.selector[deploy_key] = old_token

            self._edit_meta("replicationcontrollers", old_name, add_key)
            old = rc_api.get(old_name)

        new = copymod.deepcopy(old)
        new.metadata = t.ObjectMeta(
            name=new_name, namespace=old.metadata.namespace,
            labels=dict(old.metadata.labels),
        )
        # a distinct selector dimension so the two RCs never fight over
        # pods (rolling_updater.go AddDeploymentKeyToReplicationController)
        new.spec.selector = dict(old.spec.selector)
        new.spec.selector[deploy_key] = new_name
        tmeta = new.spec.template.metadata
        tmeta.labels = dict(tmeta.labels)
        tmeta.labels[deploy_key] = new_name
        if image:
            for c in new.spec.template.spec.containers:
                c.image = image
        new.spec.replicas = 0
        rc_api.create(new)

        def ready(rc_obj) -> int:
            return rc_obj.status.replicas

        deadline = time.monotonic() + timeout
        lines = [f"Created {new_name}"]
        while True:
            new_obj = rc_api.get(new_name)
            old_obj = rc_api.get(old_name)
            if new_obj.spec.replicas >= desired and old_obj.spec.replicas == 0:
                if ready(new_obj) >= desired:
                    break
            elif ready(new_obj) >= new_obj.spec.replicas:
                # the new RC converged at this size: take one
                # INTERLEAVED +1/-1 step (rolling_updater.go Update) so
                # the peak pod count stays at desired+1, never 2x
                if new_obj.spec.replicas <= desired - old_obj.spec.replicas:
                    new_obj.spec.replicas += 1
                    rc_api.update(new_obj)
                    lines.append(
                        f"Scaling {new_name} up to {new_obj.spec.replicas}"
                    )
                elif old_obj.spec.replicas > 0:
                    old_obj.spec.replicas -= 1
                    rc_api.update(old_obj)
                    lines.append(
                        f"Scaling {old_name} down to {old_obj.spec.replicas}"
                    )
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"rolling update stalled: {new_name} at "
                    f"{ready(new_obj)}/{new_obj.spec.replicas}"
                )
            time.sleep(interval)
        rc_api.delete(old_name)
        lines.append(f"Update succeeded. Deleting {old_name}")
        lines.append(f"replicationcontroller/{new_name} rolling updated")
        return "\n".join(lines)

    # -- observability verbs (top.go / autoscale.go) --------------------------

    def top(self, what: str) -> str:
        """kubectl top node|pod: usage from each node's kubelet
        /stats/summary endpoint (the heapster-lite path)."""
        import urllib.request

        what = resolve(what)
        nodes, _ = self.client.nodes().list()
        stats = {}
        for n in nodes:
            port = n.status.kubelet_port
            if not port:
                continue
            host = next(
                (a.address for a in n.status.addresses
                 if a.type == "InternalIP"), "127.0.0.1",
            )
            scheme_str = "https" if getattr(
                n.status, "kubelet_https", False
            ) else "http"
            try:
                with self._kubelet_open(
                    f"{scheme_str}://{host}:{port}/stats/summary", timeout=5
                ) as r:
                    stats[n.metadata.name] = json.loads(r.read())
            except OSError:
                continue
        if what == "nodes":
            rows = [["NAME", "CPU(s)", "MEMORY(bytes)",
                     "MEMORY(available)", "DEVICES", "PODS"]]
            for name in sorted(stats):
                node = stats[name].get("node", {})
                mem = node.get("memory", {})
                avail = mem.get("availableBytes")
                rows.append([
                    name,
                    _fmt_num(node.get("cpu", {}).get("usageCoreSeconds")),
                    _fmt_num(mem.get("workingSetBytes")),
                    "<unknown>" if avail is None else str(avail),
                    _fmt_num(node.get("devices", {}).get("requested")),
                    str(len(stats[name].get("pods", []))),
                ])
        elif what == "pods":
            rows = [["NAMESPACE", "NAME", "NODE", "CPU(s)",
                     "MEMORY(bytes)", "DEVICES"]]
            for name in sorted(stats):
                for p in stats[name].get("pods", []):
                    ref = p.get("podRef", {})
                    rows.append([
                        ref.get("namespace", ""),
                        ref.get("name", ""),
                        name,
                        _fmt_num(p.get("cpu", {}).get("usageCoreSeconds")),
                        _fmt_num(p.get("memory", {}).get("rssBytes")),
                        _fmt_num(p.get("devices", {}).get("requested")),
                    ])
            rows[1:] = sorted(rows[1:])
        else:
            raise ValueError(f"top supports nodes|pods, not {what!r}")
        return _tabulate(rows)

    def audit_tail(self, limit: int = 20, output: str = "",
                   user: str = "", verb: str = "",
                   resource: str = "") -> str:
        """kubectl audit tail: the newest apiserver audit events from
        /debug/audit — who did what, the response code, and the request
        latency. Filters mirror the endpoint's (?user/?verb/?resource)."""
        query = {"limit": str(max(1, limit))}
        if user:
            query["user"] = user
        if verb:
            query["verb"] = verb
        if resource:
            query["resource"] = resource
        code, payload = self.client.transport.request(
            "GET", "/debug/audit", query, None
        )
        if code != 200:
            raise APIStatusError(
                code, payload if isinstance(payload, dict) else {}
            )
        items = payload.get("items", [])
        if output == "json":
            return json.dumps(items, indent=2, sort_keys=True)
        rows = [["TIME", "LEVEL", "USER", "VERB", "RESOURCE",
                 "NAMESPACE/NAME", "CODE", "LATENCY", "REQUEST-ID"]]
        # the ring is newest-first; a tail reads oldest-first like a log
        for e in reversed(items):
            ts = e.get("timestamp")
            when = (
                time.strftime("%H:%M:%S", time.localtime(ts))
                if isinstance(ts, (int, float)) else ""
            )
            ns, nm = e.get("namespace", ""), e.get("name", "")
            rows.append([
                when,
                e.get("level", ""),
                e.get("user", ""),
                e.get("verb", ""),
                e.get("resource", "") or e.get("path", ""),
                f"{ns}/{nm}" if (ns or nm) else "",
                str(e.get("code", "")),
                f"{e.get('latencySeconds', 0) * 1e3:.1f}ms",
                e.get("requestID", ""),
            ])
        return _tabulate(rows)

    def metrics_query(self, expr: str = "", output: str = "") -> str:
        """kubectl metrics query '<expr>': evaluate a telemetry
        expression — rate(...), sum(...)/sum_by(...), quantile(...),
        or a bare name{label="v"}[window] selector — against the
        apiserver's /debug/telemetry/query. No expression prints the
        store index (series/sample counts, scraped jobs)."""
        query = {"q": expr} if expr else {}
        code, payload = self.client.transport.request(
            "GET", "/debug/telemetry/query", query, None
        )
        if code != 200:
            raise APIStatusError(
                code, payload if isinstance(payload, dict) else {}
            )
        if output == "json":
            return json.dumps(payload, indent=2, sort_keys=True)
        kind = payload.get("kind", "")
        if kind == "TelemetryIndex":
            rows = [["TICKS", "JOBS", "SERIES", "SAMPLES", "DROPPED"]]
            rows.append([
                str(payload.get("ticks", 0)),
                ",".join(payload.get("jobs", [])),
                str(payload.get("series", 0)),
                str(payload.get("samples", 0)),
                str(sum((payload.get("dropped") or {}).values())),
            ])
            return _tabulate(rows)
        result = payload.get("result")
        kind = payload.get("resultType", kind)
        if kind == "scalar":
            return _fmt_num(result)
        if kind == "vector":
            rows = [["LABELS", "VALUE"]]
            for item in result or []:
                labels = item.get("labels", {})
                rows.append([
                    ",".join(f"{k}={v}"
                             for k, v in sorted(labels.items())) or "{}",
                    _fmt_num(item.get("value")),
                ])
            return _tabulate(rows)
        if kind == "matrix":
            rows = [["LABELS", "SAMPLES", "LAST"]]
            for item in result or []:
                labels = item.get("labels", {})
                samples = item.get("samples", [])
                last = samples[-1][1] if samples else None
                rows.append([
                    ",".join(f"{k}={v}"
                             for k, v in sorted(labels.items())) or "{}",
                    str(len(samples)),
                    _fmt_num(last),
                ])
            return _tabulate(rows)
        return json.dumps(payload, indent=2, sort_keys=True)

    def alerts_cmd(self, output: str = "",
                   firing_only: bool = False) -> str:
        """kubectl alerts: the SLO engine's rule states (and the
        fire/resolve timeline) from /debug/telemetry/alerts."""
        query = {"firing": "1"} if firing_only else {}
        code, payload = self.client.transport.request(
            "GET", "/debug/telemetry/alerts", query, None
        )
        if code != 200:
            raise APIStatusError(
                code, payload if isinstance(payload, dict) else {}
            )
        if output == "json":
            return json.dumps(payload, indent=2, sort_keys=True)
        rows = [["ALERT", "STATE", "SINCE", "VALUE", "DESCRIPTION"]]
        for st in payload.get("items", []):
            since = st.get("since")
            when = (
                time.strftime("%H:%M:%S", time.localtime(since))
                if isinstance(since, (int, float)) else ""
            )
            rows.append([
                st.get("alert", ""),
                "FIRING" if st.get("firing") else "ok",
                when,
                _fmt_num(st.get("value")),
                st.get("description", ""),
            ])
        return _tabulate(rows)

    def autoscale(self, resource: str, name: str, min_replicas: int,
                  max_replicas: int, cpu_percent: int = 80) -> str:
        """kubectl autoscale (cmd/autoscale.go): create an HPA targeting
        the scalable resource."""
        resource = resolve(resource)
        if resource not in SCALABLE:
            raise ValueError(f"{resource} is not scalable")
        hpa = t.HorizontalPodAutoscaler(
            metadata=t.ObjectMeta(name=name, namespace=self.namespace),
            spec=t.HorizontalPodAutoscalerSpec(
                scale_target_kind=SCALABLE[resource],
                scale_target_name=name,
                min_replicas=min_replicas,
                max_replicas=max_replicas,
                target_cpu_utilization_percentage=cpu_percent,
            ),
        )
        self._rc("horizontalpodautoscalers").create(hpa)
        return f"horizontalpodautoscaler/{name} autoscaled"

    # -- proxy / explain / config --------------------------------------------

    def proxy(self, port: int = 0):
        """kubectl proxy (cmd/proxy.go): a localhost HTTP server relaying
        every request to the apiserver through this client's transport
        (and therefore its auth). Returns a handle with .port/.stop()."""
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qsl, urlparse

        client = self.client

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _do(self, method):
                parsed = urlparse(self.path)
                query = dict(parse_qsl(parsed.query))
                n = int(self.headers.get("Content-Length", 0) or 0)
                body = json.loads(self.rfile.read(n)) if n else None
                try:
                    code, payload = client.transport.request(
                        method, parsed.path, query or None, body
                    )
                except Exception as e:
                    code, payload = 502, {"message": str(e)}
                data = json.dumps(
                    payload, default=lambda o: scheme.encode(o)
                ).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self._do("GET")

            def do_POST(self):
                self._do("POST")

            def do_PUT(self):
                self._do("PUT")

            def do_PATCH(self):
                self._do("PATCH")

            def do_DELETE(self):
                self._do("DELETE")

        class Server(ThreadingHTTPServer):
            request_queue_size = 64  # default backlog of 5 RSTs bursts
            daemon_threads = True
            allow_reuse_address = True

        srv = Server(("127.0.0.1", port), Handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()

        class Handle:
            port = srv.server_address[1]

            @staticmethod
            def stop():
                srv.shutdown()
                srv.server_close()

        return Handle

    def explain(self, path: str) -> str:
        """kubectl explain (cmd/explain.go): describe a resource's
        fields from the dataclass schema, dotted paths supported
        (e.g. pods.spec.containers)."""
        import dataclasses
        import typing

        segs = path.split(".")
        resource = resolve(segs[0])
        kind = next(
            (k for k, r in _KIND_TO_RESOURCE.items() if r == resource), None
        )
        if kind is None:
            raise ValueError(f"unknown resource {segs[0]!r}")
        cls = scheme.type_for(kind)

        def field_type(tp):
            origin = typing.get_origin(tp)
            if origin in (list, List):
                return f"[]{field_type(typing.get_args(tp)[0])}"
            if origin is dict:
                return "map[string]string"
            if origin is typing.Union:
                args = [a for a in typing.get_args(tp) if a is not type(None)]
                return field_type(args[0]) if args else "Object"
            return getattr(tp, "__name__", str(tp))

        def resolve_path(cls, segs):
            for seg in segs:
                hints = typing.get_type_hints(cls)
                camel = {to_camel_local(f.name): f
                         for f in dataclasses.fields(cls)}
                f = camel.get(seg) or next(
                    (ff for ff in dataclasses.fields(cls)
                     if ff.name == seg), None,
                )
                if f is None:
                    raise ValueError(f"field {seg!r} does not exist in "
                                     f"{cls.__name__}")
                tp = hints[f.name]
                origin = typing.get_origin(tp)
                if origin in (list, List):
                    tp = typing.get_args(tp)[0]
                elif origin is typing.Union:
                    tp = next(a for a in typing.get_args(tp)
                              if a is not type(None))
                cls = tp
            return cls

        from kubernetes_tpu_torch.runtime.scheme import to_camel as to_camel_local

        cls = resolve_path(cls, segs[1:])
        lines = [f"KIND:     {kind}", f"RESOURCE: {'.'.join(segs)}", "",
                 "FIELDS:"]
        if dataclasses.is_dataclass(cls):
            hints = typing.get_type_hints(cls)
            for f in sorted(dataclasses.fields(cls), key=lambda f: f.name):
                lines.append(
                    f"   {to_camel_local(f.name)}\t<{field_type(hints[f.name])}>"
                )
        else:
            lines.append(f"   <{getattr(cls, '__name__', cls)}>")
        return "\n".join(lines)

    def convert(self, filename: str, output_version: str) -> str:
        """kubectl convert (cmd/convert.go): re-express a manifest in a
        different wire version — decode through the SOURCE version's
        codec (each doc's apiVersion), encode through the target's."""
        import json as jsonlib

        from kubernetes_tpu_torch.runtime.scheme import scheme as base_scheme
        from kubernetes_tpu_torch.runtime.versioning import codec_for

        def _codec(ver: str):
            group, _, version = ver.rpartition("/")
            c = codec_for(base_scheme, group, version)
            if c is None:
                raise ValueError(f"no codec for version {ver!r}")
            return c

        target = _codec(output_version)
        if filename == "-":
            raw = sys.stdin.read()
        else:
            with open(filename) as f:
                raw = f.read()
        if raw.lstrip().startswith(("{", "[")):
            docs = jsonlib.loads(raw)
            docs = docs if isinstance(docs, list) else [docs]
        else:
            import yaml

            docs = [d for d in yaml.safe_load_all(raw) if d]
        out = []
        for d in docs:
            for item in (d.get("items", []) if d.get("kind") == "List"
                         else [d]):
                obj = _codec(item.get("apiVersion", "v1")).decode(item)
                out.append(target.encode(obj))
        return jsonlib.dumps(out[0] if len(out) == 1 else
                             {"kind": "List", "items": out},
                             indent=2, sort_keys=True)

    # -- kubeconfig (cmd/config.go) ------------------------------------------

    @staticmethod
    def config(kubeconfig: str, args: Sequence[str]) -> str:
        """kubectl config view|current-context|use-context|set-cluster|
        set-context against a kubeconfig YAML file."""
        import os

        import yaml

        def load():
            if os.path.exists(kubeconfig):
                with open(kubeconfig) as f:
                    return yaml.safe_load(f) or {}
            return {"apiVersion": "v1", "kind": "Config", "clusters": [],
                    "contexts": [], "current-context": ""}

        def save(cfg):
            os.makedirs(os.path.dirname(kubeconfig) or ".", exist_ok=True)
            with open(kubeconfig, "w") as f:
                yaml.safe_dump(cfg, f, sort_keys=True)

        if not args:
            raise ValueError("config requires a subcommand")
        sub, rest = args[0], list(args[1:])
        if sub in ("use-context", "set-cluster", "set-context") and not rest:
            raise ValueError(f"config {sub} requires a name")
        cfg = load()
        if sub == "view":
            return yaml.safe_dump(cfg, sort_keys=True)
        if sub == "current-context":
            return cfg.get("current-context", "")
        if sub == "use-context":
            names = [c["name"] for c in cfg.get("contexts", [])]
            if rest[0] not in names:
                raise ValueError(f"no context exists with the name {rest[0]!r}")
            cfg["current-context"] = rest[0]
            save(cfg)
            return f'Switched to context "{rest[0]}".'
        if sub == "set-cluster":
            name = rest[0]
            server = next(
                (a.split("=", 1)[1] for a in rest[1:]
                 if a.startswith("--server=")), "",
            )
            clusters = [c for c in cfg.get("clusters", [])
                        if c["name"] != name]
            clusters.append({"name": name, "cluster": {"server": server}})
            cfg["clusters"] = clusters
            save(cfg)
            return f'Cluster "{name}" set.'
        if sub == "set-context":
            name = rest[0]
            cluster = next(
                (a.split("=", 1)[1] for a in rest[1:]
                 if a.startswith("--cluster=")), "",
            )
            namespace = next(
                (a.split("=", 1)[1] for a in rest[1:]
                 if a.startswith("--namespace=")), "",
            )
            existed = any(
                c["name"] == name for c in cfg.get("contexts", [])
            )
            contexts = [c for c in cfg.get("contexts", [])
                        if c["name"] != name]
            ctx = {"cluster": cluster}
            if namespace:
                ctx["namespace"] = namespace
            contexts.append({"name": name, "context": ctx})
            cfg["contexts"] = contexts
            save(cfg)
            return f'Context "{name}" {"modified" if existed else "created"}.'
        raise ValueError(f"unknown config subcommand {sub!r}")


def main(argv: Optional[Sequence[str]] = None, client: Optional[RESTClient] = None):
    parser = argparse.ArgumentParser(prog="kubectl")
    parser.add_argument("--server", "-s", default="http://127.0.0.1:8080")
    parser.add_argument("--certificate-authority", default="",
                        help="CA file pinning a TLS apiserver")
    parser.add_argument("--insecure-skip-tls-verify", action="store_true")
    parser.add_argument("--token", default="",
                        help="bearer token (e.g. a service-account JWT)")
    parser.add_argument(
        "--as", dest="as_user", default="system:admin",
        help="flow identity declared to an authenticator-less "
        "apiserver (X-Remote-User; APF classification + audit). The "
        "default is the local-admin idiom — exempt, like kubectl on "
        "the reference's insecure port. Ignored by servers with an "
        "authenticator (the authenticated identity wins).")
    parser.add_argument(
        "--as-group", dest="as_groups", action="append", default=None,
        help="flow-identity group (repeatable; default system:masters)")
    parser.add_argument("--namespace", "-n", default="default")
    # node-API credentials (kubelet TLS + bearer authn — logs/exec/top
    # dial the kubelet directly, so they carry their own trust)
    parser.add_argument("--node-token", default="",
                        help="bearer token for the kubelet node API")
    parser.add_argument("--node-certificate-authority", default="",
                        help="CA file pinning a TLS kubelet node API")
    parser.add_argument("--node-insecure-skip-tls-verify",
                        action="store_true")
    sub = parser.add_subparsers(dest="verb", required=True)

    p = sub.add_parser("get")
    p.add_argument("resource")
    p.add_argument("name", nargs="?", default="")
    p.add_argument("--selector", "-l", default="")
    p.add_argument("--output", "-o", default="")
    p.add_argument("--all-namespaces", action="store_true")
    p.add_argument("--watch", "-w", action="store_true",
                   help="stream rows as watch events arrive")
    p.add_argument("--watch-max", type=int, default=0,
                   help="stop after N streamed rows (0 = until the "
                        "stream closes)")

    p = sub.add_parser("describe")
    p.add_argument("resource")
    p.add_argument("name")

    # create: -f FILE, or a typed generator (create_*.go):
    #   create namespace NAME | serviceaccount NAME
    #   create secret generic NAME --from-literal=k=v --from-file=p
    #   create configmap NAME --from-literal=k=v --from-file=p
    #   create service clusterip|nodeport NAME --tcp=80:8080
    p = sub.add_parser("create")
    p.add_argument("kind", nargs="?", default="")
    p.add_argument("rest", nargs="*", default=[])
    p.add_argument("--filename", "-f", default="")
    p.add_argument("--from-literal", action="append", default=[])
    p.add_argument("--from-file", action="append", default=[])
    p.add_argument("--tcp", action="append", default=[])

    p = sub.add_parser("apply")
    p.add_argument("--filename", "-f", required=True)

    p = sub.add_parser("set")
    p.add_argument("what", choices=["image", "resources"])
    p.add_argument("target")  # TYPE/NAME
    p.add_argument("assignments", nargs="*", default=[])
    p.add_argument("--requests", default="")
    p.add_argument("--limits", default="")
    p.add_argument("--containers", default="*")

    p = sub.add_parser("completion")
    p.add_argument("shell", choices=["bash", "zsh"])

    p = sub.add_parser("delete")
    p.add_argument("resource", nargs="?", default="")
    p.add_argument("name", nargs="?", default="")
    p.add_argument("--filename", "-f", default="")
    p.add_argument("--selector", "-l", default="")

    p = sub.add_parser("scale")
    p.add_argument("target")  # resource/name
    p.add_argument("--replicas", type=int, required=True)

    for verb in ("label", "annotate"):
        p = sub.add_parser(verb)
        p.add_argument("resource")
        p.add_argument("name")
        p.add_argument("pairs", nargs="+")

    for verb in ("cordon", "uncordon", "drain"):
        p = sub.add_parser(verb)
        p.add_argument("node")

    p = sub.add_parser("run")
    p.add_argument("name")
    p.add_argument("--image", default="")
    p.add_argument("--replicas", type=int, default=1)
    p.add_argument("--labels", default="")

    p = sub.add_parser("expose")
    p.add_argument("target")  # resource/name
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--target-port", type=int, default=0)

    p = sub.add_parser("logs")
    p.add_argument("name")
    p.add_argument("--container", "-c", default="")
    p.add_argument("--tail", type=int, default=0)

    p = sub.add_parser("exec")
    p.add_argument("name")
    p.add_argument("command", nargs="+")
    p.add_argument("--container", "-c", default="")

    p = sub.add_parser("rollout")
    p.add_argument("subverb", choices=["status"])
    p.add_argument("target")

    p = sub.add_parser("patch")
    p.add_argument("resource")
    p.add_argument("name")
    p.add_argument("--patch", "-p", required=True)
    p.add_argument("--subresource", default="")

    p = sub.add_parser("edit")
    p.add_argument("resource")
    p.add_argument("name")
    p.add_argument("--editor", default="")

    p = sub.add_parser("rolling-update")
    p.add_argument("old_name")
    p.add_argument("new_name", nargs="?", default="")
    p.add_argument("--image", default="")
    p.add_argument("--update-period", type=float, default=0.1)
    p.add_argument("--timeout", type=float, default=30.0)

    p = sub.add_parser("attach")
    p.add_argument("name")
    p.add_argument("--container", "-c", default="")
    p.add_argument("--timeout", type=float, default=2.0)

    p = sub.add_parser("port-forward")
    p.add_argument("name")
    p.add_argument("ports")  # LOCAL:REMOTE or PORT

    p = sub.add_parser("proxy")
    p.add_argument("--port", "-p", type=int, default=8001)

    p = sub.add_parser("top")
    p.add_argument("what", choices=["node", "nodes", "pod", "pods"])

    p = sub.add_parser("audit")
    p.add_argument("subverb", choices=["tail"])
    p.add_argument("--limit", type=int, default=20)
    p.add_argument("--output", "-o", default="")
    p.add_argument("--user", default="")
    # dest renamed: the subcommand itself already owns args.verb
    p.add_argument("--verb", dest="verb_filter", default="")
    p.add_argument("--resource", default="")

    p = sub.add_parser("metrics")
    p.add_argument("subverb", choices=["query"])
    p.add_argument("expr", nargs="?", default="")
    p.add_argument("--output", "-o", default="")

    p = sub.add_parser("alerts")
    p.add_argument("--output", "-o", default="")
    p.add_argument("--firing", action="store_true")

    p = sub.add_parser("autoscale")
    p.add_argument("target")  # resource/name
    p.add_argument("--min", type=int, required=True)
    p.add_argument("--max", type=int, required=True)
    p.add_argument("--cpu-percent", type=int, default=80)

    p = sub.add_parser("explain")
    p.add_argument("path")

    p = sub.add_parser("convert")
    p.add_argument("--filename", "-f", required=True)
    p.add_argument("--output-version", default="v1")

    p = sub.add_parser("config")
    p.add_argument("--kubeconfig", default="")
    # REMAINDER: --server=/--cluster=/--namespace= tokens belong to the
    # config subcommand's own parser, not argparse
    p.add_argument("config_args", nargs=argparse.REMAINDER)

    sub.add_parser("version")

    p = sub.add_parser("replace")
    p.add_argument("--filename", "-f", required=True)
    p.add_argument("--force", action="store_true")

    p = sub.add_parser("taint")
    p.add_argument("resource")  # must be "nodes"/"node"/"no"
    p.add_argument("node")
    p.add_argument("taints", nargs="+",
                   help="key=value:Effect to add, key:Effect- to remove")

    sub.add_parser("api-versions")
    sub.add_parser("cluster-info")

    args = parser.parse_args(argv)
    if client is None:
        client = RESTClient(HTTPTransport(
            args.server,
            tls_ca=args.certificate_authority,
            insecure=args.insecure_skip_tls_verify,
            bearer_token=args.token,
            user=args.as_user,
            groups=tuple(args.as_groups or ("system:masters",)),
        ))
    k = Kubectl(
        client, args.namespace,
        node_token=getattr(args, "node_token", ""),
        node_tls_ca=getattr(args, "node_certificate_authority", ""),
        node_insecure=getattr(args, "node_insecure_skip_tls_verify", False),
    )

    if args.verb == "get":
        if args.watch:
            if args.output:
                parser.error("--watch supports only the default table output")
            # rows were already streamed to stdout; return them for
            # callers driving main() programmatically
            return k.get_watch(
                args.resource, name=args.name, selector=args.selector,
                all_namespaces=args.all_namespaces,
                max_events=args.watch_max,
            )
        out = k.get(args.resource, args.name, args.selector, args.output,
                    args.all_namespaces)
    elif args.verb == "describe":
        out = k.describe(args.resource, args.name)
    elif args.verb == "create":
        _arity = {"namespace": 1, "serviceaccount": 1, "secret": 2,
                  "configmap": 1, "service": 2}
        if not args.filename and len(args.rest) < _arity.get(
            args.kind, 0
        ):
            parser.error(
                f"create {args.kind} requires "
                f"{_arity[args.kind]} positional argument(s)"
            )
        if args.filename:
            out = k.create(args.filename)
        elif args.kind == "namespace":
            out = k.create_namespace(args.rest[0])
        elif args.kind == "serviceaccount":
            out = k.create_serviceaccount(args.rest[0])
        elif args.kind == "secret":
            out = k.create_secret(
                args.rest[0], args.rest[1],
                from_literal=args.from_literal, from_file=args.from_file,
            )
        elif args.kind == "configmap":
            out = k.create_configmap(
                args.rest[0],
                from_literal=args.from_literal, from_file=args.from_file,
            )
        elif args.kind == "service":
            out = k.create_service(args.rest[0], args.rest[1],
                                   tcp=args.tcp)
        else:
            parser.error(
                "create requires -f FILE or a typed generator "
                "(namespace|serviceaccount|secret|configmap|service)"
            )
    elif args.verb == "set":
        if args.what == "image":
            out = k.set_image(args.target, args.assignments)
        else:
            out = k.set_resources(
                args.target, requests=args.requests, limits=args.limits,
                containers=args.containers,
            )
    elif args.verb == "completion":
        verbs = sorted(sub.choices)
        if args.shell == "bash":
            out = (
                "# bash completion for kubectl (source this file)\n"
                "_kubectl_completions() {\n"
                "  COMPREPLY=($(compgen -W \""
                + " ".join(verbs)
                + "\" -- \"${COMP_WORDS[COMP_CWORD]}\"))\n"
                "}\n"
                "complete -F _kubectl_completions kubectl\n"
            )
        else:
            out = (
                "#compdef kubectl\n_arguments '1： :("
                + " ".join(verbs) + ")'\n"
            ).replace("：", ":")
    elif args.verb == "apply":
        out = k.apply(args.filename)
    elif args.verb == "delete":
        out = k.delete(args.resource, args.name, args.filename, args.selector)
    elif args.verb == "scale":
        resource, name = args.target.split("/", 1)
        out = k.scale(resource, name, args.replicas)
    elif args.verb == "label":
        out = k.label(args.resource, args.name, *args.pairs)
    elif args.verb == "annotate":
        out = k.annotate(args.resource, args.name, *args.pairs)
    elif args.verb == "replace":
        out = k.replace(args.filename, force=args.force)
    elif args.verb == "taint":
        if resolve(args.resource) != "nodes":
            raise SystemExit("taint only applies to nodes")
        out = k.taint(args.node, *args.taints)
    elif args.verb == "api-versions":
        out = k.api_versions()
    elif args.verb == "cluster-info":
        out = k.cluster_info()
    elif args.verb == "cordon":
        out = k.cordon(args.node)
    elif args.verb == "uncordon":
        out = k.uncordon(args.node)
    elif args.verb == "drain":
        out = k.drain(args.node)
    elif args.verb == "run":
        out = k.run(args.name, args.image, args.replicas, args.labels)
    elif args.verb == "expose":
        resource, name = args.target.split("/", 1)
        out = k.expose(resource, name, args.port, args.target_port)
    elif args.verb == "logs":
        out = k.logs(args.name, container=args.container, tail=args.tail)
    elif args.verb == "exec":
        out = k.exec(args.name, args.command, container=args.container)
    elif args.verb == "rollout":
        resource, name = args.target.split("/", 1)
        out = k.rollout_status(resource, name)
    elif args.verb == "patch":
        out = k.patch(args.resource, args.name, args.patch, args.subresource)
    elif args.verb == "edit":
        out = k.edit(args.resource, args.name, editor=args.editor)
    elif args.verb == "rolling-update":
        out = k.rolling_update(args.old_name, image=args.image,
                               new_name=args.new_name,
                               interval=args.update_period,
                               timeout=args.timeout)
    elif args.verb == "attach":
        out = k.attach(args.name, container=args.container,
                       timeout=args.timeout)
    elif args.verb == "port-forward":
        if ":" in args.ports:
            local_s, remote_s = args.ports.split(":", 1)
        else:
            local_s = remote_s = args.ports
        handle = k.port_forward(args.name, int(local_s), int(remote_s))
        out = (f"Forwarding from 127.0.0.1:{handle.local_port} -> "
               f"{remote_s}")
        print(out)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            handle.stop()
        return out
    elif args.verb == "proxy":
        handle = k.proxy(args.port)
        out = f"Starting to serve on 127.0.0.1:{handle.port}"
        print(out)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            handle.stop()
        return out
    elif args.verb == "top":
        out = k.top(args.what)
    elif args.verb == "audit":
        out = k.audit_tail(
            limit=args.limit, output=args.output, user=args.user,
            verb=args.verb_filter, resource=args.resource,
        )
    elif args.verb == "metrics":
        out = k.metrics_query(args.expr, output=args.output)
    elif args.verb == "alerts":
        out = k.alerts_cmd(output=args.output,
                           firing_only=args.firing)
    elif args.verb == "autoscale":
        resource, name = args.target.split("/", 1)
        out = k.autoscale(resource, name, args.min, args.max,
                          args.cpu_percent)
    elif args.verb == "explain":
        out = k.explain(args.path)
    elif args.verb == "convert":
        out = k.convert(args.filename, args.output_version)
    elif args.verb == "config":
        import os

        kubeconfig = args.kubeconfig or os.environ.get(
            "KUBECONFIG", os.path.expanduser("~/.kube/config")
        )
        out = Kubectl.config(kubeconfig, args.config_args)
    elif args.verb == "version":
        out = "kubernetes-tpu v0 (reference parity: kubernetes v1.3-dev)"
    else:  # pragma: no cover
        parser.error(f"unknown verb {args.verb}")
    print(out)
    return out


if __name__ == "__main__":  # pragma: no cover
    main()
