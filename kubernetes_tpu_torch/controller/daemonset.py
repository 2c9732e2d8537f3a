"""DaemonSet controller (pkg/controller/daemon/controller.go).

syncDaemonSet (:455): for every node, decide shouldRun via the scheduler's
own GeneralPredicates against a simulated placement (:560-600
nodeShouldRunDaemonPod), then create the missing daemon pods (with
spec.nodeName pre-bound — daemons bypass the scheduler) and delete
duplicates/strays.

Copy of kubernetes_tpu/controller/daemonset.py: only the import package differs.
"""

from __future__ import annotations

import copy
from typing import Dict, List

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.client.informer import ResourceEventHandler
from kubernetes_tpu_torch.client.rest import RESTClient
from kubernetes_tpu_torch.controller.framework import (
    ControllerExpectations,
    PodControl,
    QueueWorker,
    SharedInformerFactory,
    label_selector_matches,
)
from kubernetes_tpu_torch.oracle.predicates import general_predicates
from kubernetes_tpu_torch.oracle.state import ClusterState, NodeInfo


class DaemonSetsController:
    def __init__(
        self, client: RESTClient, informers: SharedInformerFactory, recorder=None
    ):
        self.client = client
        self.pod_control = PodControl(client, recorder)
        self.expectations = ControllerExpectations()
        self.pod_informer = informers.pods()
        self.node_informer = informers.nodes()
        self.ds_informer = informers.informer("daemonsets")
        self.worker = QueueWorker("daemonset-controller", self._sync)

        self.ds_informer.add_event_handler(
            ResourceEventHandler(
                on_add=lambda ds: self._enqueue(ds),
                on_update=lambda old, new: self._enqueue(new),
                on_delete=lambda ds: self.expectations.delete_expectations(
                    self._key(ds)
                ),
            )
        )
        self.node_informer.add_event_handler(
            ResourceEventHandler(
                on_add=lambda n: self._enqueue_all(),
                on_update=lambda old, new: self._enqueue_all(),
                on_delete=lambda n: self._enqueue_all(),
            )
        )
        self.pod_informer.add_event_handler(
            ResourceEventHandler(
                on_add=self._on_pod_add,
                on_delete=self._on_pod_delete,
            )
        )

    @staticmethod
    def _key(obj) -> str:
        return f"{obj.metadata.namespace}/{obj.metadata.name}"

    def _enqueue(self, ds) -> None:
        self.worker.enqueue(self._key(ds))

    def _enqueue_all(self) -> None:
        for ds in self.ds_informer.store.list():
            self._enqueue(ds)

    def _sets_for_pod(self, pod: t.Pod):
        return [
            ds
            for ds in self.ds_informer.store.list()
            if ds.metadata.namespace == pod.metadata.namespace
            and label_selector_matches(ds.spec.selector, pod)
        ]

    def _on_pod_add(self, pod: t.Pod) -> None:
        for ds in self._sets_for_pod(pod):
            self.expectations.creation_observed(self._key(ds))
            self._enqueue(ds)

    def _on_pod_delete(self, pod: t.Pod) -> None:
        for ds in self._sets_for_pod(pod):
            self.expectations.deletion_observed(self._key(ds))
            self._enqueue(ds)

    # -- placement simulation ------------------------------------------------

    def _node_should_run(self, ds: t.DaemonSet, node: t.Node) -> bool:
        """controller.go:560 nodeShouldRunDaemonPod: unschedulable nodes
        excluded, then GeneralPredicates with the daemon pod placed on the
        node's current pods."""
        if node.spec.unschedulable:
            return False
        pod = t.Pod(
            metadata=t.ObjectMeta(
                namespace=ds.metadata.namespace,
                labels=dict(ds.spec.template.metadata.labels),
            ),
            spec=copy.deepcopy(ds.spec.template.spec),
        )
        pod.spec.node_name = node.metadata.name
        info = NodeInfo(node=node)
        for p in self.pod_informer.store.list():
            if p.spec.node_name == node.metadata.name and p.status.phase not in (
                "Succeeded",
                "Failed",
            ):
                info.add_pod(p)
        state = ClusterState()
        state.node_infos[node.metadata.name] = info
        fit, _reason = general_predicates(pod, info, state)
        return fit

    # -- sync ----------------------------------------------------------------

    def _sync(self, key: str) -> None:
        ns, _name = key.split("/", 1)
        ds = self.ds_informer.store.get_by_key(key)
        if ds is None:
            self.expectations.delete_expectations(key)
            return
        if not self.expectations.satisfied(key):
            return
        by_node: Dict[str, List[t.Pod]] = {}
        for p in self.pod_informer.store.list():
            if p.metadata.namespace == ns and label_selector_matches(
                ds.spec.selector, p
            ):
                if p.metadata.deletion_timestamp is None:
                    by_node.setdefault(p.spec.node_name, []).append(p)

        to_create: List[str] = []
        to_delete: List[t.Pod] = []
        desired = current = misscheduled = 0
        for node in self.node_informer.store.list():
            name = node.metadata.name
            should = self._node_should_run(ds, node)
            running = by_node.pop(name, [])
            if should:
                desired += 1
                if not running:
                    to_create.append(name)
                else:
                    current += 1
                    # duplicates: keep the oldest (controller.go:520-527)
                    running.sort(
                        key=lambda p: p.metadata.creation_timestamp or ""
                    )
                    to_delete.extend(running[1:])
            elif running:
                misscheduled += 1
                to_delete.extend(running)
        # pods on unknown nodes are strays
        for strays in by_node.values():
            to_delete.extend(s for s in strays if s.spec.node_name)

        if to_create or to_delete:
            # one joint expectation per sync (controller.go:285-300): a
            # create-and-delete sync must track both sides
            self.expectations.set_expectations(
                key, len(to_create), len(to_delete)
            )
        for node_name in to_create:
            try:
                template = copy.deepcopy(ds.spec.template)
                template.spec.node_name = node_name
                self.pod_control.create_pods(ns, template, ds, "DaemonSet")
            except Exception:
                self.expectations.creation_observed(key)
        for pod in to_delete:
            try:
                self.pod_control.delete_pod(ns, pod.metadata.name, ds)
            except Exception:
                self.expectations.deletion_observed(key)

        ds.status.desired_number_scheduled = desired
        ds.status.current_number_scheduled = current
        ds.status.number_misscheduled = misscheduled
        self.client.resource("daemonsets", ns).update_status(ds)

    def run(self) -> "DaemonSetsController":
        self.worker.run()
        return self

    def stop(self) -> None:
        self.worker.stop()
