"""Admission control (pkg/admission + plugin/pkg/admission).

A chain of plugins runs on every write before storage (chain.go). Each
plugin sees (operation, resource, namespace, object) and may mutate the
object or reject the request by raising AdmissionDenied.

Copy of kubernetes_tpu/apiserver/admission.py: only the import package differs.
"""

from __future__ import annotations

from typing import Any, List, Optional

CREATE = "CREATE"
UPDATE = "UPDATE"
DELETE = "DELETE"


class AdmissionDenied(Exception):
    pass


class AdmissionPlugin:
    def admit(
        self, operation: str, resource: str, namespace: str, obj: Optional[Any]
    ) -> None:
        raise NotImplementedError


class AdmissionChain(AdmissionPlugin):
    """chain.go: run plugins in order; first rejection wins."""

    def __init__(self, plugins: Optional[List[AdmissionPlugin]] = None):
        self.plugins = plugins or []

    def admit(self, operation, resource, namespace, obj) -> None:
        for p in self.plugins:
            p.admit(operation, resource, namespace, obj)


class NamespaceLifecycle(AdmissionPlugin):
    """plugin/pkg/admission/namespace/lifecycle: reject writes into a
    terminating namespace. (Missing namespaces are auto-provisioned by
    the server itself, the test-master convenience.)"""

    def __init__(self, server):
        self._server = server

    def admit(self, operation, resource, namespace, obj) -> None:
        if operation != CREATE or not namespace or resource == "namespaces":
            return
        if self._server.namespace_active(namespace):
            return  # memoized exists-and-not-terminating fast path
        ns = self._server.get_namespace(namespace)
        if ns is not None and ns.status.phase == "Terminating":
            raise AdmissionDenied(
                f"unable to create new content in namespace {namespace} "
                "because it is being terminated"
            )


class AlwaysAdmit(AdmissionPlugin):
    def admit(self, operation, resource, namespace, obj) -> None:
        return


class LimitRanger(AdmissionPlugin):
    """plugin/pkg/admission/limitranger: apply container request defaults
    from LimitRange objects and enforce min/max bounds on pod CREATE."""

    def __init__(self, server):
        self._server = server

    def _limit_ranges(self, namespace: str):
        out = []
        try:
            from kubernetes_tpu_torch.storage.store import KeyNotFound  # noqa: F401

            objs, _rv = self._server.store.list(f"/limitranges/{namespace}/")
            out = objs
        except Exception:
            pass
        return out

    def admit(self, operation, resource, namespace, obj) -> None:
        if operation != CREATE or resource != "pods" or obj is None:
            return
        from kubernetes_tpu_torch.api.resource import (
            parse_quantity,
            resource_list_cpu_milli,
            resource_list_memory,
        )

        for lr in self._limit_ranges(namespace):
            for item in lr.spec.limits:
                if item.type != "Container":
                    continue
                for c in obj.spec.containers:
                    # defaulting (limitranger.go mergePodResourceRequirements):
                    # requests get defaultRequest (falling back to default),
                    # limits get default
                    for k, v in (item.default_request or item.default).items():
                        c.requests.setdefault(k, v)
                    for k, v in item.default.items():
                        c.limits.setdefault(k, v)
                    # bounds apply to requests AND limits; a bound parsing
                    # to 0 is still a bound ('is not None', not truthiness)
                    max_cpu = resource_list_cpu_milli(item.max) if item.max else None
                    max_mem = resource_list_memory(item.max) if item.max else None
                    min_cpu = resource_list_cpu_milli(item.min) if item.min else None
                    min_mem = resource_list_memory(item.min) if item.min else None
                    for which, rl, observed_only in (
                        ("request", c.requests, False),
                        ("limit", c.limits, True),
                    ):
                        # requests are always bounded (absent == 0, as the
                        # reference sums them); limits only when present
                        if observed_only and not rl:
                            continue
                        cpu = resource_list_cpu_milli(rl)
                        mem = resource_list_memory(rl)
                        if max_cpu is not None and (not observed_only or "cpu" in rl) and cpu > max_cpu:
                            raise AdmissionDenied(
                                f"maximum cpu usage per Container is "
                                f"{item.max['cpu']}, but {which} is {rl.get('cpu')}"
                            )
                        if max_mem is not None and (not observed_only or "memory" in rl) and mem > max_mem:
                            raise AdmissionDenied(
                                "maximum memory usage per Container exceeded"
                            )
                        if min_cpu is not None and (not observed_only or "cpu" in rl) and cpu < min_cpu:
                            raise AdmissionDenied(
                                "minimum cpu usage per Container not met"
                            )
                        if min_mem is not None and (not observed_only or "memory" in rl) and mem < min_mem:
                            raise AdmissionDenied(
                                "minimum memory usage per Container not met"
                            )


class ResourceQuotaAdmission(AdmissionPlugin):
    """plugin/pkg/admission/resourcequota: reject pod CREATEs that would
    exceed any hard limit in the namespace's quotas."""

    def __init__(self, server):
        self._server = server

    def admit(self, operation, resource, namespace, obj) -> None:
        if operation != CREATE or resource != "pods" or obj is None:
            return
        try:
            quotas, _rv = self._server.store.list(f"/resourcequotas/{namespace}/")
        except Exception:
            return
        if not quotas:
            return
        from kubernetes_tpu_torch.api.resource import parse_quantity
        from kubernetes_tpu_torch.api.types import pod_resource_request

        from kubernetes_tpu_torch.metrics import apiserver_quota_denials_total

        pods, _rv = self._server.store.list(f"/pods/{namespace}/")
        active = [p for p in pods if p.status.phase not in ("Succeeded", "Failed")]
        new_cpu, new_mem, new_dev = pod_resource_request(obj)
        used_cpu = sum(pod_resource_request(p)[0] for p in active)
        used_mem = sum(pod_resource_request(p)[1] for p in active)
        used_dev = sum(pod_resource_request(p)[2] for p in active)
        for q in quotas:
            hard = q.spec.hard
            if "pods" in hard and len(active) + 1 > int(parse_quantity(hard["pods"]).value()):
                apiserver_quota_denials_total.inc(budget="pods")
                raise AdmissionDenied(
                    f"exceeded quota: pods={hard['pods']}"
                )
            for key in ("cpu", "requests.cpu"):
                if key in hard:
                    limit = parse_quantity(hard[key]).milli_value()
                    if used_cpu + new_cpu > limit:
                        apiserver_quota_denials_total.inc(budget="cpu")
                        raise AdmissionDenied(f"exceeded quota: {key}={hard[key]}")
            for key in ("memory", "requests.memory"):
                if key in hard:
                    limit = parse_quantity(hard[key]).value()
                    if used_mem + new_mem > limit:
                        apiserver_quota_denials_total.inc(budget="memory")
                        raise AdmissionDenied(f"exceeded quota: {key}={hard[key]}")
            # per-tenant accelerator budget (the AI-cluster workload
            # dimension: a namespace's summed device requests)
            for key in ("devices", "requests.devices"):
                if key in hard:
                    limit = int(parse_quantity(str(hard[key])).value())
                    if used_dev + new_dev > limit:
                        apiserver_quota_denials_total.inc(budget="devices")
                        raise AdmissionDenied(f"exceeded quota: {key}={hard[key]}")


class PodGroupAdmission(AdmissionPlugin):
    """Gang workload admission (the Kant-style unified quota/priority
    door, PAPERS.md):

    * PodGroup CREATE/UPDATE: resolve ``spec.priorityClassName`` into
      ``spec.priority`` from the PriorityClass table (unknown class is
      denied — a gang whose tier cannot be resolved must not race the
      scheduler with priority 0), default ``spec.queue`` to the
      namespace (the tenant scope).
    * Pod CREATE carrying the ``scheduler.k8s.io/pod-group`` label: the
      named PodGroup must exist, and the group's pod/device budgets
      must hold AFTER this pod: active member count <= quota.pods and
      summed accelerator requests <= quota.devices. Exceeding either is
      an AdmissionDenied (HTTP 403) counted in
      ``apiserver_quota_denials_total``. Usage is computed from live
      store state, so pod DELETEs release budget with no ledger to
      drift.
    """

    def __init__(self, server):
        self._server = server

    def _group(self, namespace: str, name: str):
        try:
            from kubernetes_tpu_torch.storage.store import KeyNotFound

            return self._server.store.get(
                f"/podgroups/{namespace}/{name}")[0]
        except Exception:
            return None

    def _resolve_priority(self, pg) -> None:
        cls_name = pg.spec.priority_class_name
        if not cls_name:
            return
        try:
            pc = self._server.store.get(f"/priorityclasses/{cls_name}")[0]
        except Exception:
            raise AdmissionDenied(
                f"podgroup {pg.metadata.name!r} names unknown priority "
                f"class {cls_name!r}"
            )
        pg.spec.priority = int(pc.value)

    def admit(self, operation, resource, namespace, obj) -> None:
        from kubernetes_tpu_torch.api.types import POD_GROUP_LABEL

        if resource == "podgroups" and operation in (CREATE, UPDATE) \
                and obj is not None:
            self._resolve_priority(obj)
            if not obj.spec.queue:
                obj.spec.queue = namespace or obj.metadata.namespace
            return
        if operation != CREATE or resource != "pods" or obj is None:
            return
        group_name = (obj.metadata.labels or {}).get(POD_GROUP_LABEL, "")
        if not group_name:
            return
        pg = self._group(namespace, group_name)
        if pg is None:
            raise AdmissionDenied(
                f"pod {obj.metadata.name!r} joins pod group "
                f"{group_name!r}, which does not exist in namespace "
                f"{namespace!r}; create the PodGroup first"
            )
        quota = pg.spec.quota or {}
        if not quota:
            return
        from kubernetes_tpu_torch.api.types import pod_resource_request
        from kubernetes_tpu_torch.metrics import apiserver_quota_denials_total

        pods, _rv = self._server.store.list(f"/pods/{namespace}/")
        members = [
            p for p in pods
            if p.status.phase not in ("Succeeded", "Failed")
            and (p.metadata.labels or {}).get(POD_GROUP_LABEL) == group_name
        ]
        if "pods" in quota:
            budget = int(str(quota["pods"]))
            if len(members) + 1 > budget:
                apiserver_quota_denials_total.inc(budget="pods")
                raise AdmissionDenied(
                    f"pod group {group_name!r} (tenant "
                    f"{pg.spec.queue!r}) exceeded quota: pods="
                    f"{budget} (in use: {len(members)}, requested: 1)"
                )
        if "devices" in quota:
            budget = int(str(quota["devices"]))
            new_dev = pod_resource_request(obj)[2]
            used_dev = sum(pod_resource_request(p)[2] for p in members)
            if used_dev + new_dev > budget:
                apiserver_quota_denials_total.inc(budget="devices")
                raise AdmissionDenied(
                    f"pod group {group_name!r} (tenant "
                    f"{pg.spec.queue!r}) exceeded quota: devices="
                    f"{budget} (in use: {used_dev}, requested: "
                    f"{new_dev})"
                )


class ServiceAccountAdmission(AdmissionPlugin):
    """plugin/pkg/admission/serviceaccount: default the pod's service
    account to "default"."""

    def admit(self, operation, resource, namespace, obj) -> None:
        if operation == CREATE and resource == "pods" and obj is not None:
            if not obj.spec.service_account_name:
                obj.spec.service_account_name = "default"


class LimitPodHardAntiAffinityTopology(AdmissionPlugin):
    """plugin/pkg/admission/antiaffinity: hard pod anti-affinity is only
    allowed with the hostname topology key (admission.go:58-76)."""

    HOSTNAME = "kubernetes.io/hostname"

    def admit(self, operation, resource, namespace, obj) -> None:
        if operation != CREATE or resource != "pods" or obj is None:
            return
        from kubernetes_tpu_torch.api.types import get_affinity

        try:
            affinity = get_affinity(obj)
        except Exception:
            return  # unparseable annotations fail scheduling, not admission
        if affinity is None or affinity.pod_anti_affinity is None:
            return
        for term in affinity.pod_anti_affinity.required_during_scheduling_ignored_during_execution:
            if term.topology_key != self.HOSTNAME:
                raise AdmissionDenied(
                    "affinity.PodAntiAffinity.RequiredDuringScheduling has "
                    f"TopologyKey {term.topology_key!r}; only "
                    f"{self.HOSTNAME!r} is allowed"
                )


class AlwaysPullImages(AdmissionPlugin):
    """plugin/pkg/admission/alwayspullimages/admission.go: force every
    container's imagePullPolicy to Always on pod CREATE/UPDATE, so a
    privately pulled image can't be reused by name alone by tenants
    without registry credentials."""

    def admit(self, operation, resource, namespace, obj) -> None:
        if resource != "pods" or operation not in (CREATE, UPDATE):
            return
        spec = getattr(obj, "spec", None)
        if spec is None:
            return
        for c in list(spec.init_containers) + list(spec.containers):
            c.image_pull_policy = "Always"


class SecurityContextDeny(AdmissionPlugin):
    """plugin/pkg/admission/securitycontext/scdeny/admission.go: deny
    any pod that sets SELinuxOptions, RunAsUser, or pod-level
    SupplementalGroups — the multitenant hardening plugin for clusters
    without PodSecurityPolicy."""

    def admit(self, operation, resource, namespace, obj) -> None:
        if resource != "pods" or operation not in (CREATE, UPDATE):
            return
        spec = getattr(obj, "spec", None)
        if spec is None:
            return
        psc = spec.security_context
        if psc is not None:
            if psc.supplemental_groups is not None:
                raise AdmissionDenied(
                    "SecurityContext.SupplementalGroups is forbidden"
                )
            if psc.se_linux_options is not None:
                raise AdmissionDenied(
                    "pod.Spec.SecurityContext.SELinuxOptions is forbidden"
                )
            if psc.run_as_user is not None:
                raise AdmissionDenied(
                    "pod.Spec.SecurityContext.RunAsUser is forbidden"
                )
        for c in list(spec.init_containers) + list(spec.containers):
            sc = c.security_context
            if sc is None:
                continue
            if sc.se_linux_options is not None:
                raise AdmissionDenied(
                    "SecurityContext.SELinuxOptions is forbidden"
                )
            if sc.run_as_user is not None:
                raise AdmissionDenied(
                    "SecurityContext.RunAsUser is forbidden"
                )


class InitialResources(AdmissionPlugin):
    """plugin/pkg/admission/initialresources/admission.go: estimate
    resource REQUESTS for containers that specify none, from observed
    history of the same image. The reference queries an influxdb/GCM
    usage store; the in-process data source here samples the requests
    of existing containers running the same image across the cluster
    (60th percentile like the reference's default), falling back to a
    configured table. Estimated values are annotated on the pod the way
    the reference logs them, so users can see what was inferred."""

    PERCENTILE = 0.6
    ANNOTATION = "initial-resources.alpha.kubernetes.io/estimated"

    def __init__(self, server, table: Optional[dict] = None):
        """table: {image: {"cpu": "100m", "memory": "64Mi"}} fallback
        estimates when the cluster holds no sample for the image."""
        self._server = server
        self.table = dict(table or {})

    def _history(self, images: set) -> dict:
        """{(image, res): sorted quantity strings} in ONE store scan —
        a per-(container, resource) scan would make a density fill
        O(pods^2) under the store lock."""
        from kubernetes_tpu_torch.api.resource import parse_quantity

        out: dict = {}
        objs, _ = self._server.store.list("/pods/")
        for pod in objs:
            for c in pod.spec.containers:
                if c.image not in images:
                    continue
                for res in ("cpu", "memory"):
                    if res in (c.requests or {}):
                        try:
                            q = c.requests[res]
                            out.setdefault((c.image, res), []).append(
                                (parse_quantity(str(q)).value_frac,
                                 str(q))
                            )
                        except Exception:
                            pass
        return {k: [s for _v, s in sorted(v)] for k, v in out.items()}

    def _estimate(self, history: dict, image: str, res: str):
        samples = history.get((image, res), ())
        if samples:
            idx = min(int(len(samples) * self.PERCENTILE),
                      len(samples) - 1)
            return samples[idx]  # the original quantity STRING
        fallback = self.table.get(image, {}).get(res)
        return fallback

    def admit(self, operation, resource, namespace, obj) -> None:
        if resource != "pods" or operation != CREATE:
            return
        spec = getattr(obj, "spec", None)
        if spec is None:
            return
        need = {
            c.image for c in spec.containers
            if "cpu" not in (c.requests or {})
            or "memory" not in (c.requests or {})
        }
        if not need:
            return
        history = self._history(need)
        estimated = []
        for c in spec.containers:
            for res in ("cpu", "memory"):
                if res in (c.requests or {}):
                    continue
                got = self._estimate(history, c.image, res)
                if got is None:
                    continue
                if not c.requests:
                    c.requests = {}
                c.requests[res] = str(got)
                estimated.append(f"{c.name or c.image}/{res}={got}")
        if estimated:
            obj.metadata.annotations = dict(
                obj.metadata.annotations or {}
            )
            obj.metadata.annotations[self.ANNOTATION] = ",".join(
                estimated
            )


#: --admission-control name -> factory(server) (the reference's
#: admission.RegisterPlugin registry; kubeadmission defaults order)
PLUGIN_FACTORIES = {
    "NamespaceLifecycle": NamespaceLifecycle,
    "AlwaysAdmit": lambda server: AlwaysAdmit(),
    "AlwaysPullImages": lambda server: AlwaysPullImages(),
    "SecurityContextDeny": lambda server: SecurityContextDeny(),
    "LimitRanger": LimitRanger,
    "ResourceQuota": ResourceQuotaAdmission,
    "PodGroup": PodGroupAdmission,
    "ServiceAccount": ServiceAccountAdmission,
    "InitialResources": InitialResources,
    "LimitPodHardAntiAffinityTopology":
        lambda server: LimitPodHardAntiAffinityTopology(),
}


def make_plugin(name: str, server) -> AdmissionPlugin:
    factory = PLUGIN_FACTORIES.get(name)
    if factory is None:
        raise ValueError(f"unknown admission plugin {name!r}")
    return factory(server)
