"""Typed listers over stores (pkg/client/cache/listers.go +
plugin/pkg/scheduler/algorithm/listers.go).

Each wraps a Store/Indexer and exposes the read patterns control loops
use. Fake* variants take static lists — the unit-test seam
(algorithm/listers.go:33-77).

Copy of kubernetes_tpu/client/cache/listers.py: only the import package differs.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from kubernetes_tpu_torch.api import labels as labelpkg
from kubernetes_tpu_torch.api.types import Node, Pod, Service


def _selector_of(map_selector) -> labelpkg.Selector:
    return labelpkg.selector_from_set(map_selector or {})


class StoreToPodLister:
    def __init__(self, store):
        self.store = store

    def list(self, selector: Optional[labelpkg.Selector] = None) -> List[Pod]:
        pods = self.store.list()
        if selector is None:
            return pods
        return [p for p in pods if selector.matches(p.metadata.labels)]


class StoreToNodeLister:
    def __init__(self, store, predicate: Optional[Callable[[Node], bool]] = None):
        self.store = store
        self.predicate = predicate

    def list(self) -> List[Node]:
        nodes = self.store.list()
        if self.predicate is not None:
            nodes = [n for n in nodes if self.predicate(n)]
        return nodes


class StoreToServiceLister:
    def __init__(self, store):
        self.store = store

    def list(self) -> List[Service]:
        return self.store.list()

    def get_pod_services(self, pod: Pod) -> List[Service]:
        """Services whose selector matches the pod, same namespace
        (listers.go GetPodServices; empty selector matches nothing)."""
        out = []
        for svc in self.store.list():
            if svc.metadata.namespace != pod.metadata.namespace:
                continue
            sel = (svc.spec.selector or {}) if svc.spec else {}
            if not sel:
                continue
            if _selector_of(sel).matches(pod.metadata.labels):
                out.append(svc)
        return out


class StoreToControllerLister:
    def __init__(self, store):
        self.store = store

    def list(self):
        return self.store.list()

    def get_pod_controllers(self, pod: Pod):
        out = []
        for rc in self.store.list():
            if rc.metadata.namespace != pod.metadata.namespace:
                continue
            sel = (rc.spec.selector or {}) if rc.spec else {}
            if not sel:
                continue
            if _selector_of(sel).matches(pod.metadata.labels):
                out.append(rc)
        return out


class StoreToReplicaSetLister:
    def __init__(self, store):
        self.store = store

    def list(self):
        return self.store.list()

    def get_pod_replica_sets(self, pod: Pod):
        from kubernetes_tpu_torch.oracle.predicates import label_selector_as_selector

        out = []
        for rs in self.store.list():
            if rs.metadata.namespace != pod.metadata.namespace:
                continue
            sel = rs.spec.selector if rs.spec else None
            if sel is None:
                continue
            if label_selector_as_selector(sel).matches(pod.metadata.labels):
                out.append(rs)
        return out


# -- fakes (test seam) -------------------------------------------------------


class _StaticStore:
    def __init__(self, items: Sequence):
        self._items = list(items)

    def list(self):
        return list(self._items)


def fake_pod_lister(pods: Sequence[Pod]) -> StoreToPodLister:
    return StoreToPodLister(_StaticStore(pods))


def fake_node_lister(nodes: Sequence[Node]) -> StoreToNodeLister:
    return StoreToNodeLister(_StaticStore(nodes))


def fake_service_lister(services: Sequence[Service]) -> StoreToServiceLister:
    return StoreToServiceLister(_StaticStore(services))


def fake_controller_lister(rcs) -> StoreToControllerLister:
    return StoreToControllerLister(_StaticStore(rcs))


def fake_replica_set_lister(rss) -> StoreToReplicaSetLister:
    return StoreToReplicaSetLister(_StaticStore(rss))
