"""PetSet controller (pkg/controller/petset/pet_set.go, the 1.3 alpha
StatefulSet): stable identities <name>-0..<name>-N-1, created in ordinal
order (the next pet only after its predecessor exists and is active),
deleted from the highest ordinal down.

Copy of kubernetes_tpu/controller/petset.py: only the import package differs."""

from __future__ import annotations

import copy
import re

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.client.informer import ResourceEventHandler
from kubernetes_tpu_torch.client.rest import APIStatusError, RESTClient
from kubernetes_tpu_torch.controller.framework import QueueWorker, SharedInformerFactory


class PetSetController:
    def __init__(
        self, client: RESTClient, informers: SharedInformerFactory, recorder=None
    ):
        self.client = client
        self.recorder = recorder
        self.pod_informer = informers.pods()
        self.ps_informer = informers.informer("petsets")
        self.worker = QueueWorker("petset-controller", self._sync)
        self.ps_informer.add_event_handler(
            ResourceEventHandler(
                on_add=lambda ps: self._enqueue(ps),
                on_update=lambda old, new: self._enqueue(new),
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

    def _enqueue(self, ps) -> None:
        self.worker.enqueue(self._key(ps))

    @staticmethod
    def _pet_ordinal(ps, pod_name: str):
        """Ordinal if pod_name is EXACTLY <set>-<int>, else None — a name
        prefix is not ownership (sibling set \"web-db\" must not be
        claimed by set \"web\")."""
        m = re.fullmatch(re.escape(ps.metadata.name) + r"-(\d+)", pod_name)
        return int(m.group(1)) if m else None

    def _on_pod_change(self, pod: t.Pod) -> None:
        for ps in self.ps_informer.store.list():
            if ps.metadata.namespace == pod.metadata.namespace and (
                self._pet_ordinal(ps, pod.metadata.name) is not None
            ):
                self._enqueue(ps)

    def _pet_name(self, ps, ordinal: int) -> str:
        return f"{ps.metadata.name}-{ordinal}"

    def _sync(self, key: str) -> None:
        ns, _name = key.split("/", 1)
        ps = self.ps_informer.store.get_by_key(key)
        if ps is None or ps.spec.template is None:
            return
        pods_client = self.client.pods(ns)
        existing = {
            p.metadata.name: p
            for p in self.pod_informer.store.list()
            if p.metadata.namespace == ns
            and self._pet_ordinal(ps, p.metadata.name) is not None
            and p.metadata.deletion_timestamp is None
        }
        n_active = 0
        # create in ordinal order; stop at the first hole (pet_set.go
        # syncPetSet: pets are brought up one at a time)
        for ordinal in range(ps.spec.replicas):
            name = self._pet_name(ps, ordinal)
            pod = existing.get(name)
            if pod is None:
                pet = t.Pod(
                    metadata=t.ObjectMeta(
                        name=name,
                        namespace=ns,
                        labels=dict(ps.spec.template.metadata.labels),
                        annotations={"pod.alpha.kubernetes.io/initialized": "true"},
                    ),
                    spec=copy.deepcopy(ps.spec.template.spec),
                )
                pet.spec.hostname = name
                pet.spec.subdomain = ps.spec.service_name
                try:
                    pods_client.create(pet)
                except APIStatusError:
                    pass
                break  # one pet per pass; wait for it to appear
            n_active += 1
        # scale down: delete highest ordinals beyond replicas
        for name, pod in sorted(existing.items(), reverse=True):
            ordinal = self._pet_ordinal(ps, name)
            if ordinal is not None and ordinal >= ps.spec.replicas:
                try:
                    pods_client.delete(name)
                except APIStatusError:
                    pass
        ps.status.replicas = n_active
        ps.status.observed_generation = ps.metadata.generation
        self.client.resource("petsets", ns).update_status(ps)

    def run(self) -> "PetSetController":
        self.worker.run()
        return self

    def stop(self) -> None:
        self.worker.stop()
