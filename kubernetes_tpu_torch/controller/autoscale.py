"""Horizontal pod autoscaler (pkg/controller/podautoscaler/horizontal.go)
and resource quota recalculation (pkg/controller/resourcequota/
resource_quota_controller.go).

The HPA loop reads a CPU-utilization metric for the target workload's
pods from a MetricsClient (the heapster seam, metrics_client.go — here an
injectable callable), computes
    desired = ceil(current_replicas * current_util / target_util)
(horizontal.go:computeReplicasForCPUUtilization), clamps to
[min, max], applies the scale through the workload's spec.replicas, and
records status. The quota controller recomputes status.used from live
objects (quota usage: pods/services/RCs counts + cpu/mem request sums).

Copy of kubernetes_tpu/controller/autoscale.py: only the import package differs.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Optional

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.api.resource import parse_quantity
from kubernetes_tpu_torch.api.types import pod_resource_request
from kubernetes_tpu_torch.client.rest import APIStatusError, RESTClient
from kubernetes_tpu_torch.controller.framework import (
    PeriodicRunner,
    SharedInformerFactory,
    label_selector_matches,
    selector_matches,
)

_SCALE_RESOURCE = {
    "ReplicationController": "replicationcontrollers",
    "ReplicaSet": "replicasets",
    "Deployment": "deployments",
}

# metrics seam: (namespace, pod_names) -> avg CPU utilization percent (or
# None when metrics are missing, horizontal.go tolerance path)
MetricsClient = Callable[[str, list], Optional[float]]

# horizontal.go:47 tolerance = 0.1
TOLERANCE = 0.1


class HorizontalController(PeriodicRunner):
    SYNC_PERIOD = 30.0
    THREAD_NAME = "horizontal-pod-autoscaler"
    def __init__(
        self,
        client: RESTClient,
        informers: SharedInformerFactory,
        metrics_client: MetricsClient,
        recorder=None,
    ):
        self.client = client
        self.metrics = metrics_client
        self.recorder = recorder
        self.pod_informer = informers.pods()
        self.hpa_informer = informers.informer("horizontalpodautoscalers")

    def reconcile_once(self) -> None:
        for hpa in self.hpa_informer.store.list():
            try:
                self._reconcile(hpa)
            except APIStatusError:
                pass

    def _target_pods(self, ns: str, workload) -> list:
        spec = workload.spec
        if isinstance(spec.selector, t.LabelSelector) or spec.selector is None:
            match = lambda p: label_selector_matches(spec.selector, p)
        else:
            match = lambda p: selector_matches(spec.selector, p)
        return [
            p
            for p in self.pod_informer.store.list()
            if p.metadata.namespace == ns and match(p)
            and p.metadata.deletion_timestamp is None
        ]

    def _reconcile(self, hpa: t.HorizontalPodAutoscaler) -> None:
        ns = hpa.metadata.namespace
        resource = _SCALE_RESOURCE.get(hpa.spec.scale_target_kind)
        if resource is None:
            return
        wl_client = self.client.resource(resource, ns)
        workload = wl_client.get(hpa.spec.scale_target_name)
        current = workload.spec.replicas
        pods = self._target_pods(ns, workload)
        util = self.metrics(ns, [p.metadata.name for p in pods])
        target = hpa.spec.target_cpu_utilization_percentage or 80
        desired = current
        if util is not None and current > 0:
            ratio = util / float(target)
            if abs(ratio - 1.0) > TOLERANCE:
                desired = int(math.ceil(ratio * current))
        desired = max(hpa.spec.min_replicas, min(hpa.spec.max_replicas, desired))
        if desired != current:
            workload.spec.replicas = desired
            wl_client.update(workload)
            if self.recorder is not None:
                self.recorder.eventf(
                    hpa, "Normal", "SuccessfulRescale",
                    f"New size: {desired}; reason: cpu utilization {util}",
                )
        hpa.status.current_replicas = current
        hpa.status.desired_replicas = desired
        hpa.status.current_cpu_utilization_percentage = (
            int(util) if util is not None else None
        )
        self.client.resource("horizontalpodautoscalers", ns).update_status(hpa)

    def sync_once(self) -> None:
        self.reconcile_once()


class ResourceQuotaController(PeriodicRunner):
    """resource_quota_controller.go: recompute status.used per quota."""

    SYNC_PERIOD = 10.0
    THREAD_NAME = "resourcequota-controller"

    def __init__(self, client: RESTClient, informers: SharedInformerFactory):
        self.client = client
        self.pod_informer = informers.pods()
        self.quota_informer = informers.informer("resourcequotas")
        self.svc_informer = informers.informer("services")
        self.rc_informer = informers.informer("replicationcontrollers")

    def sync_once(self) -> None:
        for quota in self.quota_informer.store.list():
            self._sync(quota)

    def _sync(self, quota: t.ResourceQuota) -> None:
        ns = quota.metadata.namespace
        pods = [
            p
            for p in self.pod_informer.store.list()
            if p.metadata.namespace == ns
            and p.status.phase not in ("Succeeded", "Failed")
        ]
        used = {}
        for key in quota.spec.hard:
            if key == "pods":
                used[key] = str(len(pods))
            elif key == "services":
                used[key] = str(
                    sum(
                        1
                        for s in self.svc_informer.store.list()
                        if s.metadata.namespace == ns
                    )
                )
            elif key == "replicationcontrollers":
                used[key] = str(
                    sum(
                        1
                        for rc in self.rc_informer.store.list()
                        if rc.metadata.namespace == ns
                    )
                )
            elif key in ("cpu", "requests.cpu"):
                total = sum(pod_resource_request(p)[0] for p in pods)
                used[key] = f"{total}m"
            elif key in ("memory", "requests.memory"):
                total = sum(pod_resource_request(p)[1] for p in pods)
                used[key] = str(total)
        quota.status.hard = dict(quota.spec.hard)
        quota.status.used = used
        try:
            self.client.resource("resourcequotas", ns).update_status(quota)
        except APIStatusError:
            pass

