"""Cluster state as the oracle sees it.

Mirrors plugin/pkg/scheduler/schedulercache/node_info.go: per-node pod list
plus incrementally-maintained requested/nonzero resource sums. The oracle's
ClusterState is the Python analogue of the `GetNodeNameToInfoMap` snapshot
(cache.go:77) plus the auxiliary listers (services/RCs/RSs/PVs/PVCs).

Copy of kubernetes_tpu/oracle/state.py: only the import package differs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import (
    Node,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    ReplicaSet,
    ReplicationController,
    Service,
    pod_nonzero_request,
    pod_resource_request,
)


@dataclass
class NodeInfo:
    """node_info.go:32 NodeInfo — node + aggregated pod demand.

    requested_* excludes init containers (calculateResource, node_info.go:158);
    nonzero_* applies the 100m/200Mi per-container defaults.
    """

    node: Optional[Node] = None
    pods: List[Pod] = field(default_factory=list)
    requested_milli_cpu: int = 0
    requested_memory: int = 0
    requested_gpu: int = 0
    nonzero_milli_cpu: int = 0
    nonzero_memory: int = 0

    def add_pod(self, pod: Pod) -> None:
        cpu, mem, gpu = _calculate_resource(pod)
        n0cpu, n0mem = pod_nonzero_request(pod)
        self.requested_milli_cpu += cpu
        self.requested_memory += mem
        self.requested_gpu += gpu
        self.nonzero_milli_cpu += n0cpu
        self.nonzero_memory += n0mem
        self.pods.append(pod)

    def remove_pod(self, pod: Pod) -> None:
        key = (pod.namespace, pod.name)
        for i, p in enumerate(self.pods):
            if (p.namespace, p.name) == key:
                self.pods[i] = self.pods[-1]
                self.pods.pop()
                cpu, mem, gpu = _calculate_resource(pod)
                n0cpu, n0mem = pod_nonzero_request(pod)
                self.requested_milli_cpu -= cpu
                self.requested_memory -= mem
                self.requested_gpu -= gpu
                self.nonzero_milli_cpu -= n0cpu
                self.nonzero_memory -= n0mem
                return
        raise KeyError(f"no pod {key} on node")

    def clone(self) -> "NodeInfo":
        return NodeInfo(
            node=self.node,
            pods=list(self.pods),
            requested_milli_cpu=self.requested_milli_cpu,
            requested_memory=self.requested_memory,
            requested_gpu=self.requested_gpu,
            nonzero_milli_cpu=self.nonzero_milli_cpu,
            nonzero_memory=self.nonzero_memory,
        )


def _calculate_resource(pod: Pod) -> Tuple[int, int, int]:
    """node_info.go:158 calculateResource: containers only, no init max."""
    from kubernetes_tpu_torch.api.resource import (
        resource_list_cpu_milli,
        resource_list_gpu,
        resource_list_memory,
    )

    cpu = sum(resource_list_cpu_milli(c.requests) for c in pod.spec.containers)
    mem = sum(resource_list_memory(c.requests) for c in pod.spec.containers)
    gpu = sum(resource_list_gpu(c.requests) for c in pod.spec.containers)
    return cpu, mem, gpu


@dataclass
class ClusterState:
    """The full decision input: node infos + auxiliary object listers."""

    node_infos: Dict[str, NodeInfo] = field(default_factory=dict)
    services: List[Service] = field(default_factory=list)
    controllers: List[ReplicationController] = field(default_factory=list)
    replica_sets: List[ReplicaSet] = field(default_factory=list)
    pvs: Dict[str, PersistentVolume] = field(default_factory=dict)
    pvcs: Dict[Tuple[str, str], PersistentVolumeClaim] = field(default_factory=dict)
    # When this state is a filtered view (priorities see only nodes that
    # passed predicates, generic_scheduler.go:109), `full` points at the
    # complete state so pod listers / GetNodeInfo still resolve everything,
    # matching the reference where nodeNameToInfo and podLister are global.
    full: Optional["ClusterState"] = None

    @classmethod
    def build(
        cls,
        nodes: List[Node],
        assigned_pods: List[Pod] = (),
        services: List[Service] = (),
        controllers: List[ReplicationController] = (),
        replica_sets: List[ReplicaSet] = (),
        pvs: List[PersistentVolume] = (),
        pvcs: List[PersistentVolumeClaim] = (),
    ) -> "ClusterState":
        st = cls(
            services=list(services),
            controllers=list(controllers),
            replica_sets=list(replica_sets),
            pvs={pv.metadata.name: pv for pv in pvs},
            pvcs={(p.metadata.namespace, p.metadata.name): p for p in pvcs},
        )
        for n in nodes:
            st.node_infos[n.name] = NodeInfo(node=n)
        for p in assigned_pods:
            st.assign(p)
        return st

    def assign(self, pod: Pod) -> None:
        """Add a pod with spec.node_name set (cache AddPod / AssumePod)."""
        name = pod.spec.node_name
        if not name:
            raise ValueError(f"pod {pod.name} has no node_name")
        self.node_infos.setdefault(name, NodeInfo()).add_pod(pod)

    def all_assigned_pods(self) -> List[Pod]:
        src = self.full if self.full is not None else self
        out: List[Pod] = []
        for info in src.node_infos.values():
            out.extend(info.pods)
        return out

    def get_node_info_any(self, name: str) -> Optional[NodeInfo]:
        """Resolve a node by name, looking through a filtered view if needed
        (the reference's schedulercache GetNodeInfo is always global)."""
        info = self.node_infos.get(name)
        if info is None and self.full is not None:
            info = self.full.node_infos.get(name)
        return info

    def nodes(self) -> List[Node]:
        return [i.node for i in self.node_infos.values() if i.node is not None]

    def get_node(self, name: str) -> Node:
        info = self.node_infos.get(name)
        if info is None or info.node is None:
            raise KeyError(f"node {name!r} not in cache")
        return info.node

    def clone(self) -> "ClusterState":
        st = ClusterState(
            services=list(self.services),
            controllers=list(self.controllers),
            replica_sets=list(self.replica_sets),
            pvs=dict(self.pvs),
            pvcs=dict(self.pvcs),
        )
        st.node_infos = {k: v.clone() for k, v in self.node_infos.items()}
        return st
