"""ReplicationController manager (pkg/controller/replication/
replication_controller.go) and its extensions/ReplicaSet twin
(pkg/controller/replicaset/replica_set.go) — same loop, different
selector flavor.

Loop shape (replication_controller.go:75-120, 404-478):
  rc informer + pod informer -> workqueue of rc keys -> syncReplicationController:
    filtered = active pods in rc.namespace matching rc selector
    if expectations satisfied: manageReplicas(filtered, rc)
    update rc.status.replicas
manageReplicas (:404): diff = len(filtered) - spec.replicas;
  < 0 -> ExpectCreations + burst create (capped at burstReplicas=500);
  > 0 -> ExpectDeletions + delete ActivePods-sorted victims.

Copy of kubernetes_tpu/controller/replication.py: only the import package differs.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.client.informer import ResourceEventHandler
from kubernetes_tpu_torch.client.rest import RESTClient
from kubernetes_tpu_torch.controller.framework import (
    ControllerExpectations,
    PodControl,
    QueueWorker,
    SharedInformerFactory,
    active_pods,
    filter_active_pods,
    label_selector_matches,
    selector_matches,
)

BURST_REPLICAS = 500  # replication_controller.go:64


class _ReplicaWorkload:
    """Adapter unifying RC (map selector) and ReplicaSet (LabelSelector)."""

    resource = "replicationcontrollers"
    kind = "ReplicationController"

    def selector_matches(self, obj, pod: t.Pod) -> bool:
        return selector_matches(obj.spec.selector, pod)

    def update_status(self, client: RESTClient, obj, n_active: int) -> None:
        if (
            obj.status.replicas != n_active
            or obj.status.observed_generation != obj.metadata.generation
        ):
            # live fetch: the informer copy's resourceVersion may be stale
            # (updateReplicaCount in the reference retries on conflict)
            rc = client.resource(self.resource, obj.metadata.namespace)
            live = rc.get(obj.metadata.name)
            live.status.replicas = n_active
            live.status.observed_generation = live.metadata.generation
            rc.update_status(live)


class _ReplicaSetWorkload(_ReplicaWorkload):
    resource = "replicasets"
    kind = "ReplicaSet"

    def selector_matches(self, obj, pod: t.Pod) -> bool:
        return label_selector_matches(obj.spec.selector, pod)


class ReplicationManager:
    """replication_controller.go:68 ReplicationManager (also serves as the
    ReplicaSet controller with workload=_ReplicaSetWorkload())."""

    def __init__(
        self,
        client: RESTClient,
        informers: SharedInformerFactory,
        recorder=None,
        workload: Optional[_ReplicaWorkload] = None,
        burst_replicas: int = BURST_REPLICAS,
    ):
        self.client = client
        self.workload = workload or _ReplicaWorkload()
        self.pod_control = PodControl(client, recorder)
        self.expectations = ControllerExpectations()
        self.burst_replicas = burst_replicas
        self.pod_informer = informers.pods()
        self.rc_informer = informers.informer(self.workload.resource)
        self.worker = QueueWorker(f"{self.workload.resource}-manager", self._sync)

        self.rc_informer.add_event_handler(
            ResourceEventHandler(
                on_add=lambda obj: self._enqueue(obj),
                on_update=lambda old, new: self._enqueue(new),
                on_delete=self._on_rc_delete,
            )
        )
        self.pod_informer.add_event_handler(
            ResourceEventHandler(
                on_add=self._on_pod_add,
                on_update=lambda old, new: self._on_pod_update(old, new),
                on_delete=self._on_pod_delete,
            )
        )

    # -- event plumbing ------------------------------------------------------

    @staticmethod
    def _key(obj) -> str:
        return f"{obj.metadata.namespace}/{obj.metadata.name}"

    def _enqueue(self, obj) -> None:
        self.worker.enqueue(self._key(obj))

    def _on_rc_delete(self, obj) -> None:
        self.expectations.delete_expectations(self._key(obj))

    def _controllers_for_pod(self, pod: t.Pod):
        return [
            rc
            for rc in self.rc_informer.store.list()
            if rc.metadata.namespace == pod.metadata.namespace
            and self.workload.selector_matches(rc, pod)
        ]

    def _on_pod_add(self, pod: t.Pod) -> None:
        for rc in self._controllers_for_pod(pod):
            self.expectations.creation_observed(self._key(rc))
            self._enqueue(rc)

    def _on_pod_update(self, old: t.Pod, new: t.Pod) -> None:
        # a deletion timestamp appearing counts as a graceful delete
        # (replication_controller.go updatePod comment)
        if (
            old.metadata.deletion_timestamp is None
            and new.metadata.deletion_timestamp is not None
        ):
            self._on_pod_delete(new)
            return
        for rc in self._controllers_for_pod(new):
            self._enqueue(rc)

    def _on_pod_delete(self, pod: t.Pod) -> None:
        for rc in self._controllers_for_pod(pod):
            self.expectations.deletion_observed(self._key(rc))
            self._enqueue(rc)

    # -- sync ----------------------------------------------------------------

    def _sync(self, key: str) -> None:
        ns, name = key.split("/", 1)
        rc = self.rc_informer.store.get_by_key(key)
        if rc is None:
            self.expectations.delete_expectations(key)
            return
        filtered = filter_active_pods(
            p
            for p in self.pod_informer.store.list()
            if p.metadata.namespace == ns and self.workload.selector_matches(rc, p)
        )
        if self.expectations.satisfied(key):
            self._manage_replicas(key, filtered, rc)
        self.workload.update_status(self.client, rc, len(filtered))

    def _manage_replicas(self, key: str, filtered: List[t.Pod], rc) -> None:
        """replication_controller.go:404 manageReplicas."""
        diff = len(filtered) - rc.spec.replicas
        if diff < 0:
            diff = min(-diff, self.burst_replicas)
            self.expectations.expect_creations(key, diff)
            errors = 0
            for _ in range(diff):
                try:
                    self.pod_control.create_pods(
                        rc.metadata.namespace, rc.spec.template, rc,
                        self.workload.kind,
                    )
                except Exception:
                    # decrement so the expectation isn't stuck (:437-447)
                    self.expectations.creation_observed(key)
                    errors += 1
            if errors:
                raise RuntimeError(f"{errors} pod creations failed for {key}")
        elif diff > 0:
            diff = min(diff, self.burst_replicas)
            victims = active_pods(filtered)[:diff]
            self.expectations.expect_deletions(key, diff)
            errors = 0
            for pod in victims:
                try:
                    self.pod_control.delete_pod(
                        rc.metadata.namespace, pod.metadata.name, rc
                    )
                except Exception:
                    self.expectations.deletion_observed(key)
                    errors += 1
            if errors:
                raise RuntimeError(f"{errors} pod deletions failed for {key}")

    # -- lifecycle -----------------------------------------------------------

    def run(self) -> "ReplicationManager":
        self.worker.run()
        return self

    def stop(self) -> None:
        self.worker.stop()


def new_replicaset_manager(
    client: RESTClient, informers: SharedInformerFactory, recorder=None
) -> ReplicationManager:
    return ReplicationManager(
        client, informers, recorder, workload=_ReplicaSetWorkload()
    )
