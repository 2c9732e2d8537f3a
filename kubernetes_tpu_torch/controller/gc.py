"""Pod garbage collection (pkg/controller/podgc/gc_controller.go) and the
namespace lifecycle controller (pkg/controller/namespace/
namespace_controller.go).

PodGC: when terminated (Succeeded/Failed) pods exceed a threshold, delete
the oldest beyond it (gc_controller.go:leastRecentlyCreated order); also
delete pods bound to nodes that no longer exist (orphans).

NamespaceController: a namespace with a deletionTimestamp moves to
Terminating, its contents are deleted resource-by-resource, the
"kubernetes" finalizer is removed, and the namespace object disappears
once empty (namespace_controller.go syncNamespace).

Copy of kubernetes_tpu/controller/gc.py: only the import package differs.
"""

from __future__ import annotations

import threading
from typing import List

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.client.informer import ResourceEventHandler
from kubernetes_tpu_torch.client.rest import APIStatusError, RESTClient
from kubernetes_tpu_torch.controller.framework import PeriodicRunner, QueueWorker, SharedInformerFactory


class PodGCController(PeriodicRunner):
    SYNC_PERIOD = 20.0
    THREAD_NAME = "podgc"
    """gc_controller.go:45 New — threshold <= 0 disables collection of
    terminated pods (orphan cleanup still runs)."""

    def __init__(
        self,
        client: RESTClient,
        informers: SharedInformerFactory,
        terminated_pod_threshold: int = 12500,
    ):
        self.client = client
        self.threshold = terminated_pod_threshold
        self.pod_informer = informers.pods()
        self.node_informer = informers.nodes()

    def gc_once(self) -> int:
        """One collection pass; returns number of pods deleted."""
        deleted = 0
        pods = self.pod_informer.store.list()
        if self.threshold > 0:
            terminated = [
                p for p in pods if p.status.phase in ("Succeeded", "Failed")
            ]
            excess = len(terminated) - self.threshold
            if excess > 0:
                terminated.sort(key=lambda p: p.metadata.creation_timestamp or "")
                for pod in terminated[:excess]:
                    deleted += self._delete(pod)
        # orphan pods: bound to a node that no longer exists
        node_names = {n.metadata.name for n in self.node_informer.store.list()}
        for pod in pods:
            if pod.spec.node_name and pod.spec.node_name not in node_names:
                deleted += self._delete(pod)
        return deleted

    def _delete(self, pod: t.Pod) -> int:
        try:
            self.client.pods(pod.metadata.namespace).delete(pod.metadata.name)
            return 1
        except APIStatusError:
            return 0

    def sync_once(self) -> int:
        return self.gc_once()


# namespaced resources swept during namespace deletion
# (namespace_controller_utils.go deleteAllContent)
_NAMESPACED_RESOURCES = (
    "pods",
    "services",
    "endpoints",
    "replicationcontrollers",
    "replicasets",
    "deployments",
    "daemonsets",
    "jobs",
    "events",
    "persistentvolumeclaims",
)


class NamespaceController:
    def __init__(self, client: RESTClient, informers: SharedInformerFactory):
        self.client = client
        self.ns_informer = informers.informer("namespaces")
        self.worker = QueueWorker("namespace-controller", self._sync)
        self.ns_informer.add_event_handler(
            ResourceEventHandler(
                on_add=lambda ns: self.worker.enqueue(ns.metadata.name),
                on_update=lambda old, new: self.worker.enqueue(new.metadata.name),
            )
        )

    def _sync(self, name: str) -> None:
        nsc = self.client.resource("namespaces")
        # fetch live (namespace_controller.go syncNamespaceFromKey re-GETs)
        # so status/finalize updates never race a stale informer copy
        try:
            ns = nsc.get(name)
        except APIStatusError as e:
            if e.code == 404:
                return
            raise
        if ns.metadata.deletion_timestamp is None:
            return
        # phase -> Terminating (syncNamespace step 1)
        if ns.status.phase != "Terminating":
            ns.status.phase = "Terminating"
            ns = nsc.update_status(ns)
        # delete all content (step 2)
        remaining = 0
        for resource in _NAMESPACED_RESOURCES:
            rc = self.client.resource(resource, name)
            objs, _rv = rc.list()
            for obj in objs:
                try:
                    rc.delete(obj.metadata.name)
                except APIStatusError:
                    pass
                remaining += 1
        if remaining:
            # content was present this pass; re-check before finalizing
            self.worker.enqueue_after(name, 0.05)
            return
        # remove the kubernetes finalizer (step 3) and delete (step 4)
        if "kubernetes" in ns.spec.finalizers:
            ns.spec.finalizers = [f for f in ns.spec.finalizers if f != "kubernetes"]
            ns = nsc.update(ns, subresource="finalize")
        if not ns.spec.finalizers:
            try:
                nsc.delete(name)
            except APIStatusError:
                pass

    def run(self) -> "NamespaceController":
        self.worker.run()
        return self

    def stop(self) -> None:
        self.worker.stop()
