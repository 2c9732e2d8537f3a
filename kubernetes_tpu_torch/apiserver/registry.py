"""Per-resource REST semantics (pkg/registry analogue).

One ResourceInfo per resource: kind, store key prefix (the reference's
etcd layout — pods under /pods/<ns>/<name>, nodes under /minions/<name>,
registry/pod/etcd, registry/node/etcd), namespacing, and the
prepare/validate strategy hooks (strategy.go idiom).

Copy of kubernetes_tpu/apiserver/registry.py: only the import package differs.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass
from datetime import datetime, timezone
from typing import Any, Callable, Dict, Optional

from kubernetes_tpu_torch.api import types as t

_NOW_CACHE = (0, "")

# Buffered fork-safe urandom lives in utils/entropy (the trace layer
# mints span ids from the same buffers); re-exported here because the
# uid/generateName minting is this module's hot path.
from kubernetes_tpu_torch.utils.entropy import rand_hex  # noqa: F401


def now_rfc3339() -> str:
    # second-granularity timestamps repeat within a creation burst;
    # strftime per object was a measurable slice of the create path
    global _NOW_CACHE
    now = int(_time.time())
    if now != _NOW_CACHE[0]:
        _NOW_CACHE = (
            now,
            datetime.fromtimestamp(now, timezone.utc).strftime(
                "%Y-%m-%dT%H:%M:%SZ"
            ),
        )
    return _NOW_CACHE[1]


class ValidationError(Exception):
    pass


def prepare_meta(obj: Any) -> None:
    """Common create-time defaulting (strategy PrepareForCreate +
    BeforeCreate in pkg/api/rest): uid, creationTimestamp, generateName.

    uid + generateName suffixes come from one urandom read instead of
    uuid4 objects: create.go's rand.String(5) needs unpredictable, not
    RFC-4122, and two uuid4 constructions per create were ~10% of the
    whole create path."""
    meta = obj.metadata
    if not meta.name and meta.generate_name:
        # pkg/api/rest/create.go: 5-char random suffix
        meta.name = meta.generate_name + rand_hex(3)[:5]
    if not meta.uid:
        h = rand_hex(16)
        meta.uid = (
            f"{h[:8]}-{h[8:12]}-{h[12:16]}-{h[16:20]}-{h[20:]}"
        )
    if not meta.creation_timestamp:
        meta.creation_timestamp = now_rfc3339()


def validate_meta(obj: Any, namespaced: bool) -> None:
    meta = obj.metadata
    if not meta.name:
        raise ValidationError("metadata.name: required value")
    if namespaced and not meta.namespace:
        raise ValidationError("metadata.namespace: required value")


def prepare_pod(pod: t.Pod) -> None:
    if not pod.status.phase:
        pod.status.phase = "Pending"


def prepare_namespace(ns: t.Namespace) -> None:
    """registry/namespace/strategy.go PrepareForCreate: every namespace
    gets the kubernetes finalizer."""
    if "kubernetes" not in ns.spec.finalizers:
        ns.spec.finalizers = list(ns.spec.finalizers) + ["kubernetes"]
    if not ns.status.phase:
        ns.status.phase = "Active"


def validate_pod(pod: t.Pod) -> None:
    if not pod.spec.containers:
        raise ValidationError("spec.containers: required value")


def validate_ingress(ing: t.Ingress) -> None:
    """extensions/validation: at least one of backend or rules
    (extensions/types.go:455-460)."""
    if ing.spec.backend is None and not ing.spec.rules:
        raise ValidationError(
            "spec: at least one of `backend` or `rules` must be specified"
        )
    for rule in ing.spec.rules:
        for p in rule.http_paths:
            if p.path and not p.path.startswith("/"):
                raise ValidationError(
                    f"spec.rules.http.paths: path {p.path!r} must begin "
                    "with a '/'"
                )


import re as _re

# cron field: numbers/ranges/steps/lists, '*'/'?', or the named
# day/month forms (JAN..DEC, SUN..SAT) robfig/cron accepts
_CRON_FIELD = _re.compile(r"^[0-9*,/\-?LW#A-Za-z]+$")
_CRON_WORD = _re.compile(r"(?i)\b(JAN|FEB|MAR|APR|MAY|JUN|JUL|AUG|SEP|OCT|"
                         r"NOV|DEC|SUN|MON|TUE|WED|THU|FRI|SAT)\b")
_EVERY_DURATION = _re.compile(r"^@every ([0-9]+(\.[0-9]+)?(ns|us|µs|ms|s|m|h))+$")


def validate_podgroup(pg: t.PodGroup) -> None:
    """PodGroup invariants the apiserver rejects with 422: minMember
    must be positive, quota keys must be known, budgets non-negative."""
    if pg.spec.min_member < 1:
        raise ValidationError("spec.minMember: must be >= 1")
    if pg.spec.priority < 0:
        raise ValidationError("spec.priority: must be >= 0")
    for key, v in (pg.spec.quota or {}).items():
        if key not in ("pods", "devices"):
            raise ValidationError(
                f"spec.quota: unknown budget {key!r} (pods, devices)"
            )
        try:
            if int(str(v)) < 0:
                raise ValueError
        except (TypeError, ValueError):
            raise ValidationError(
                f"spec.quota.{key}: {v!r} is not a non-negative integer"
            )


def validate_priorityclass(pc: t.PriorityClass) -> None:
    if pc.value < 0:
        raise ValidationError("value: must be >= 0")


def validate_scheduledjob(sj: t.ScheduledJob) -> None:
    """batch/validation ValidateScheduledJobSpec: the schedule must be
    a cron expression — @-descriptors (robfig/cron's @daily etc.,
    @every with a Go duration) or 5/6 fields of cron syntax."""
    sched = (sj.spec.schedule or "").strip()
    ok = sched in ("@yearly", "@annually", "@monthly", "@weekly",
                   "@daily", "@midnight", "@hourly") or bool(
        _EVERY_DURATION.match(sched)
    )
    if not ok:
        fields = sched.split()
        ok = len(fields) in (5, 6) and all(
            _CRON_FIELD.match(f) and (
                any(ch.isdigit() for ch in f) or "*" in f or "?" in f
                or _CRON_WORD.search(f)
            )
            for f in fields
        )
    if not ok:
        raise ValidationError(
            f"spec.schedule: {sj.spec.schedule!r} is not a valid cron "
            "expression"
        )
    if sj.spec.concurrency_policy not in ("Allow", "Forbid", "Replace"):
        raise ValidationError(
            "spec.concurrencyPolicy: must be Allow, Forbid or Replace"
        )


@dataclass
class ResourceInfo:
    resource: str  # plural REST name, e.g. "pods"
    kind: str
    cls: type
    prefix: str  # store key prefix
    namespaced: bool = True
    group: str = ""  # "" == core /api/v1; else /apis/<group>/v1
    prepare: Optional[Callable[[Any], None]] = None
    validate: Optional[Callable[[Any], None]] = None
    has_status: bool = False

    def key(self, namespace: str, name: str) -> str:
        if self.namespaced:
            return f"{self.prefix}/{namespace}/{name}"
        return f"{self.prefix}/{name}"

    def list_prefix(self, namespace: str = "") -> str:
        if self.namespaced and namespace:
            return f"{self.prefix}/{namespace}/"
        return f"{self.prefix}/"


def default_resources() -> Dict[str, ResourceInfo]:
    """The resource table the master installs (master.go:419
    initV1ResourcesStorage + extensions in master.go InstallAPIs)."""
    infos = [
        ResourceInfo(
            "pods", "Pod", t.Pod, "/pods",
            prepare=prepare_pod, validate=validate_pod, has_status=True,
        ),
        # nodes live under /minions in the reference's etcd layout
        ResourceInfo(
            "nodes", "Node", t.Node, "/minions", namespaced=False, has_status=True
        ),
        ResourceInfo(
            "services", "Service", t.Service, "/services/specs",
            has_status=True,
        ),
        ResourceInfo("endpoints", "Endpoints", t.Endpoints, "/services/endpoints"),
        ResourceInfo("events", "Event", t.Event, "/events"),
        ResourceInfo(
            "namespaces", "Namespace", t.Namespace, "/namespaces",
            namespaced=False, has_status=True, prepare=prepare_namespace,
        ),
        ResourceInfo(
            "replicationcontrollers", "ReplicationController",
            t.ReplicationController, "/controllers", has_status=True,
        ),
        ResourceInfo(
            "persistentvolumes", "PersistentVolume", t.PersistentVolume,
            "/persistentvolumes", namespaced=False,
        ),
        ResourceInfo(
            "persistentvolumeclaims", "PersistentVolumeClaim",
            t.PersistentVolumeClaim, "/persistentvolumeclaims",
        ),
        ResourceInfo(
            "replicasets", "ReplicaSet", t.ReplicaSet, "/replicasets",
            group="extensions", has_status=True,
        ),
        ResourceInfo(
            "deployments", "Deployment", t.Deployment, "/deployments",
            group="extensions", has_status=True,
        ),
        ResourceInfo(
            "daemonsets", "DaemonSet", t.DaemonSet, "/daemonsets",
            group="extensions", has_status=True,
        ),
        ResourceInfo(
            "jobs", "Job", t.Job, "/jobs", group="batch", has_status=True
        ),
        ResourceInfo(
            "horizontalpodautoscalers", "HorizontalPodAutoscaler",
            t.HorizontalPodAutoscaler, "/horizontalpodautoscalers",
            group="autoscaling", has_status=True,
        ),
        ResourceInfo(
            "petsets", "PetSet", t.PetSet, "/petsets", group="apps",
            has_status=True,
        ),
        ResourceInfo(
            "resourcequotas", "ResourceQuota", t.ResourceQuota,
            "/resourcequotas", has_status=True,
        ),
        ResourceInfo("limitranges", "LimitRange", t.LimitRange, "/limitranges"),
        ResourceInfo(
            "serviceaccounts", "ServiceAccount", t.ServiceAccount,
            "/serviceaccounts",
        ),
        ResourceInfo("secrets", "Secret", t.Secret, "/secrets"),
        ResourceInfo("configmaps", "ConfigMap", t.ConfigMap, "/configmaps"),
        ResourceInfo(
            "thirdpartyresources", "ThirdPartyResource",
            t.ThirdPartyResource, "/thirdpartyresources",
            namespaced=False, group="extensions",
        ),
        # -- the 1.3-era additions (registry/<resource>/etcd/etcd.go) --------
        ResourceInfo(
            "ingresses", "Ingress", t.Ingress, "/ingress",
            group="extensions", has_status=True,
            validate=validate_ingress,
        ),
        ResourceInfo(
            "networkpolicies", "NetworkPolicy", t.NetworkPolicy,
            "/networkpolicies", group="extensions",
        ),
        ResourceInfo(
            "poddisruptionbudgets", "PodDisruptionBudget",
            t.PodDisruptionBudget, "/poddisruptionbudgets",
            group="policy", has_status=True,
        ),
        ResourceInfo(
            "podsecuritypolicies", "PodSecurityPolicy",
            t.PodSecurityPolicy, "/podsecuritypolicy",
            namespaced=False, group="extensions",
        ),
        ResourceInfo(
            "scheduledjobs", "ScheduledJob", t.ScheduledJob,
            "/scheduledjobs", group="batch", has_status=True,
            validate=validate_scheduledjob,
        ),
        ResourceInfo(
            "podtemplates", "PodTemplate", t.PodTemplate, "/podtemplates",
        ),
        # -- RBAC (pkg/apis/rbac; registry/role etc. land post-window,
        # the API group itself is in this tree) ------------------------------
        ResourceInfo(
            "roles", "Role", t.Role, "/roles", group="rbac",
        ),
        ResourceInfo(
            "rolebindings", "RoleBinding", t.RoleBinding,
            "/rolebindings", group="rbac",
        ),
        ResourceInfo(
            "clusterroles", "ClusterRole", t.ClusterRole,
            "/clusterroles", namespaced=False, group="rbac",
        ),
        ResourceInfo(
            "clusterrolebindings", "ClusterRoleBinding",
            t.ClusterRoleBinding, "/clusterrolebindings",
            namespaced=False, group="rbac",
        ),
        # -- AI-cluster workload API (scheduling group) -----------------------
        ResourceInfo(
            "podgroups", "PodGroup", t.PodGroup, "/podgroups",
            group="scheduling", has_status=True,
            validate=validate_podgroup,
        ),
        ResourceInfo(
            "priorityclasses", "PriorityClass", t.PriorityClass,
            "/priorityclasses", namespaced=False, group="scheduling",
            validate=validate_priorityclass,
        ),
        # virtual: GET/LIST probe live component health, nothing stored
        # (registry/componentstatus/rest.go)
        ResourceInfo(
            "componentstatuses", "ComponentStatus", t.ComponentStatus,
            "/componentstatuses", namespaced=False,
        ),
        # virtual review resources: the SERVER side of the webhook wire
        # (pkg/apis/authentication.k8s.io TokenReview, authorization
        # SubjectAccessReview) — POST-only, nothing stored; answered by
        # this server's own authenticator/authorizer
        ResourceInfo(
            "tokenreviews", "TokenReview", dict, "/tokenreviews",
            namespaced=False, group="authentication.k8s.io",
        ),
        ResourceInfo(
            "subjectaccessreviews", "SubjectAccessReview", dict,
            "/subjectaccessreviews", namespaced=False,
            group="authorization.k8s.io",
        ),
    ]
    return {info.resource: info for info in infos}
