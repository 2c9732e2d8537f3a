"""Endpoints controller (pkg/controller/endpoint/endpoints_controller.go).

For every service with a selector: collect assigned, running pods whose
labels match, resolve each service port's targetPort (int or named
container port, :320-345), and write an Endpoints object mirroring the
service name. Pods that are not ready land in notReadyAddresses
(:361-371).

Copy of kubernetes_tpu/controller/endpoints.py: only the import package differs.
"""

from __future__ import annotations

from typing import List, Optional

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.client.informer import ResourceEventHandler
from kubernetes_tpu_torch.client.rest import APIStatusError, RESTClient
from kubernetes_tpu_torch.controller.framework import (
    QueueWorker,
    SharedInformerFactory,
    selector_matches,
)


def _resolve_target_port(port: t.ServicePort, pod: t.Pod) -> Optional[int]:
    """endpoints_controller.go findPort: int targetPort used directly; a
    string resolves against the pod's named container ports; 0/"" falls
    back to the service port."""
    tp = port.target_port
    if isinstance(tp, int):
        return tp if tp != 0 else port.port
    if isinstance(tp, str) and tp:
        for c in pod.spec.containers:
            for cp in c.ports:
                if cp.name == tp and cp.protocol == port.protocol:
                    return cp.container_port
        return None  # named port missing => pod skipped for this port
    return port.port


def _pod_ready(pod: t.Pod) -> bool:
    return any(
        c.type == "Ready" and c.status == "True" for c in pod.status.conditions
    )


class EndpointsController:
    def __init__(
        self, client: RESTClient, informers: SharedInformerFactory, recorder=None
    ):
        self.client = client
        self.pod_informer = informers.pods()
        self.service_informer = informers.informer("services")
        self.worker = QueueWorker("endpoints-controller", self._sync)

        self.service_informer.add_event_handler(
            ResourceEventHandler(
                on_add=lambda s: self._enqueue(s),
                on_update=lambda old, new: self._enqueue(new),
                on_delete=lambda s: self._enqueue(s),
            )
        )
        self.pod_informer.add_event_handler(
            ResourceEventHandler(
                on_add=self._on_pod_change,
                on_update=lambda old, new: self._on_pod_change(new),
                on_delete=self._on_pod_change,
            )
        )

    @staticmethod
    def _key(obj) -> str:
        return f"{obj.metadata.namespace}/{obj.metadata.name}"

    def _enqueue(self, svc) -> None:
        self.worker.enqueue(self._key(svc))

    def _on_pod_change(self, pod: t.Pod) -> None:
        for svc in self.service_informer.store.list():
            if svc.metadata.namespace == pod.metadata.namespace and selector_matches(
                svc.spec.selector, pod
            ):
                self._enqueue(svc)

    def _sync(self, key: str) -> None:
        ns, name = key.split("/", 1)
        svc = self.service_informer.store.get_by_key(key)
        eps_client = self.client.resource("endpoints", ns)
        if svc is None:
            try:
                eps_client.delete(name)
            except APIStatusError:
                pass
            return
        if not svc.spec.selector:
            # headless/selector-less services manage their own endpoints
            return
        pods = [
            p
            for p in self.pod_informer.store.list()
            if p.metadata.namespace == ns
            and selector_matches(svc.spec.selector, p)
            and p.spec.node_name
            and p.status.pod_ip
            and p.status.phase not in ("Succeeded", "Failed")
        ]
        ports = svc.spec.ports or [t.ServicePort(port=0)]
        subsets: List[t.EndpointSubset] = []
        for port in ports:
            # group by RESOLVED port: pods mid-migration of a named
            # container port must land in separate subsets, each carrying
            # its own port number (endpoints_controller.go subsets are
            # repacked per unique port set)
            by_port = {}
            for pod in pods:
                target = _resolve_target_port(port, pod)
                if target is None:
                    continue
                addr = t.EndpointAddress(
                    ip=pod.status.pod_ip,
                    target_ref=f"{pod.metadata.namespace}/{pod.metadata.name}",
                )
                ready, not_ready = by_port.setdefault(target, ([], []))
                (ready if _pod_ready(pod) else not_ready).append(addr)
            for resolved_port in sorted(by_port):
                ready, not_ready = by_port[resolved_port]
                subsets.append(
                    t.EndpointSubset(
                        addresses=sorted(ready, key=lambda a: a.ip),
                        not_ready_addresses=sorted(not_ready, key=lambda a: a.ip),
                        ports=[
                            t.EndpointPort(
                                name=port.name,
                                port=resolved_port,
                                protocol=port.protocol,
                            )
                        ],
                    )
                )
        eps = t.Endpoints(
            metadata=t.ObjectMeta(name=name, namespace=ns), subsets=subsets
        )
        try:
            existing = eps_client.get(name)
            eps.metadata = existing.metadata
            eps.metadata.namespace = ns
            existing.subsets = subsets
            eps_client.update(existing)
        except APIStatusError as e:
            if e.code == 404:
                eps_client.create(eps)
            else:
                raise

    def run(self) -> "EndpointsController":
        self.worker.run()
        return self

    def stop(self) -> None:
        self.worker.stop()
