"""Federated apiserver + controllers (federation/cmd/federated-apiserver,
federation/pkg/federation-controller).

- `Cluster` (federation/apis/federation/types.go): a member cluster's
  endpoint + health conditions.
- `FederatedAPIServer`: the regular apiserver machinery hosting the
  federation object universe (clusters + federated workloads).
- `ClusterController` (cluster_controller.go): probes member /healthz,
  flips the Ready condition.
- `FederatedReplicationManager`: spreads a federated RC's replicas over
  Ready clusters (even split, remainder to the first clusters — the
  ubernetes scheduler's default weight distribution) and reconciles each
  member's RC through its own API.

Copy of kubernetes_tpu/federation/federation.py: only the import package differs."""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.apiserver.registry import ResourceInfo
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.controller.framework import PeriodicRunner
from kubernetes_tpu_torch.client.rest import APIStatusError, RESTClient
from kubernetes_tpu_torch.runtime.scheme import scheme

log = logging.getLogger(__name__)


@dataclass
class ClusterSpec:
    server_address: str = ""  # federation/types.go serverAddressByClientCIDRs


@dataclass
class ClusterCondition:
    type: str = "Ready"
    status: str = "Unknown"
    reason: str = ""


@dataclass
class ClusterStatus:
    conditions: List[ClusterCondition] = field(default_factory=list)


@dataclass
class Cluster:
    metadata: t.ObjectMeta = field(default_factory=t.ObjectMeta)
    spec: ClusterSpec = field(default_factory=ClusterSpec)
    status: ClusterStatus = field(default_factory=ClusterStatus)


scheme.register("Cluster", Cluster)


class FederatedAPIServer(APIServer):
    """federated-apiserver: the generic machinery + the federation
    resource universe (clusters, plus federated workload kinds)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.resources["clusters"] = ResourceInfo(
            "clusters", "Cluster", Cluster, "/clusters",
            namespaced=False, group="federation", has_status=True,
        )
        # the federated universe only carries multi-cluster kinds; the
        # reference's federated apiserver serves a reduced resource set,
        # but reusing the full table costs nothing and keeps clients uniform


class ClusterController(PeriodicRunner):
    """cluster_controller.go: periodic member health checks."""

    SYNC_PERIOD = 5.0
    THREAD_NAME = "federation-cluster-controller"

    def __init__(
        self,
        fed_client: RESTClient,
        member_client_factory: Callable[[Cluster], Optional[RESTClient]],
    ):
        self.fed_client = fed_client
        self.member_client_factory = member_client_factory

    def sync_once(self) -> None:
        clusters, _rv = self.fed_client.resource("clusters").list()
        for cluster in clusters:
            status = "False"
            reason = "ClusterNotReachable"
            try:
                member = self.member_client_factory(cluster)
                if member is not None and member.healthz():
                    status, reason = "True", "ClusterReady"
            except Exception:
                pass
            cluster.status.conditions = [
                ClusterCondition(type="Ready", status=status, reason=reason)
            ]
            try:
                self.fed_client.resource("clusters").update_status(cluster)
            except APIStatusError:
                pass


def spread_replicas(total: int, n_clusters: int) -> List[int]:
    """Even split, remainder to the earliest clusters."""
    if n_clusters <= 0:
        return []
    base, rem = divmod(total, n_clusters)
    return [base + (1 if i < rem else 0) for i in range(n_clusters)]


class FederatedServiceController(PeriodicRunner):
    """federation-controller/service: propagate federated Services to
    every Ready member cluster (servicecontroller.go reconciliation,
    create-or-converge per member)."""

    SYNC_PERIOD = 5.0
    THREAD_NAME = "federation-service"

    def __init__(self, fed_client, member_client_factory):
        self.fed_client = fed_client
        self.member_client_factory = member_client_factory

    def sync_once(self) -> None:
        services, _rv = self.fed_client.resource("services", "").list()
        clusters, _rv = self.fed_client.resource("clusters").list()
        ready = [
            c for c in clusters
            if any(cond.type == "Ready" and cond.status == "True"
                   for cond in c.status.conditions)
        ]
        for svc in services:
            for cluster in ready:
                member = self.member_client_factory(cluster)
                if member is None:
                    continue
                mc = member.resource("services", svc.metadata.namespace)
                want = t.Service(
                    metadata=t.ObjectMeta(
                        name=svc.metadata.name,
                        namespace=svc.metadata.namespace,
                        labels=dict(svc.metadata.labels),
                    ),
                    spec=t.ServiceSpec(
                        selector=dict(svc.spec.selector),
                        ports=list(svc.spec.ports),
                    ),
                )
                try:
                    existing = mc.get(svc.metadata.name)
                    # converge drift: federated spec changes propagate
                    if (existing.spec.selector != want.spec.selector
                            or existing.spec.ports != want.spec.ports):
                        existing.spec.selector = dict(want.spec.selector)
                        existing.spec.ports = list(want.spec.ports)
                        mc.update(existing)
                except APIStatusError as e:
                    if e.code == 404:
                        try:
                            mc.create(want)
                        except APIStatusError as ce:
                            if ce.code != 409:  # lost create race only
                                raise


class FederatedReplicationManager(PeriodicRunner):
    """Distribute federated RCs over Ready member clusters."""

    SYNC_PERIOD = 5.0
    THREAD_NAME = "federation-replication"

    def __init__(
        self,
        fed_client: RESTClient,
        member_client_factory: Callable[[Cluster], Optional[RESTClient]],
    ):
        self.fed_client = fed_client
        self.member_client_factory = member_client_factory

    def _ready_clusters(self) -> List[Cluster]:
        clusters, _rv = self.fed_client.resource("clusters").list()
        return sorted(
            (
                c
                for c in clusters
                if any(
                    cond.type == "Ready" and cond.status == "True"
                    for cond in c.status.conditions
                )
            ),
            key=lambda c: c.metadata.name,
        )

    def sync_once(self) -> None:
        rcs, _rv = self.fed_client.resource("replicationcontrollers", "").list()
        clusters = self._ready_clusters()
        for rc in rcs:
            shares = spread_replicas(rc.spec.replicas, len(clusters))
            for cluster, share in zip(clusters, shares):
                member = self.member_client_factory(cluster)
                if member is None:
                    continue
                mc = member.resource(
                    "replicationcontrollers", rc.metadata.namespace
                )
                want = t.ReplicationController(
                    metadata=t.ObjectMeta(
                        name=rc.metadata.name,
                        namespace=rc.metadata.namespace,
                        labels=dict(rc.metadata.labels),
                    ),
                    spec=t.ReplicationControllerSpec(
                        replicas=share,
                        selector=dict(rc.spec.selector),
                        template=rc.spec.template,
                    ),
                )
                try:
                    existing = mc.get(rc.metadata.name)
                    if existing.spec.replicas != share:
                        existing.spec.replicas = share
                        existing.spec.template = rc.spec.template
                        mc.update(existing)
                except APIStatusError as e:
                    if e.code == 404:
                        mc.create(want)


def default_member_client_factory(cluster: Cluster) -> Optional[RESTClient]:
    """Dial the member by its registered endpoint (the reference reads
    a kubeconfig secret named by the Cluster; the endpoint is the
    flattened equivalent here)."""
    from kubernetes_tpu_torch.client.transport import HTTPTransport

    addr = cluster.spec.server_address
    if not addr:
        return None
    # the federation control plane is system traffic to its member
    # clusters: exempt under APF, attributed in their audit logs
    return RESTClient(HTTPTransport(
        addr, user="system:federation-controller-manager",
        groups=("system:masters",)))


def join_cluster(fed_client: RESTClient, name: str,
                 server_address: str) -> Cluster:
    """The kubefed-join flow (federation/cluster/clustercontroller.go
    registration): record the member's endpoint as a Cluster object; the
    cluster controller then probes it and flips Ready."""
    cluster = Cluster(
        metadata=t.ObjectMeta(name=name, namespace=""),
        spec=ClusterSpec(server_address=server_address),
    )
    return fed_client.resource("clusters").create(cluster)


def unjoin_cluster(fed_client: RESTClient, name: str,
                   member_client_factory=None) -> None:
    """kubefed unjoin: capture the departing member's endpoint, delete
    the Cluster object FIRST (so propagation loops stop targeting it),
    then remove the federation's workloads from the member — retrying
    until a verification pass finds the member clean, because a
    propagation pass that listed clusters BEFORE the deletion can still
    re-create workloads AFTER a single cleanup sweep (the TOCTOU the
    reference closes with cluster finalizers in later versions).
    Without the cleanup the member keeps running its share forever and
    federated totals are silently exceeded."""
    factory = member_client_factory or default_member_client_factory
    try:
        cluster = fed_client.resource("clusters").get(name)
        member = factory(cluster)
    except Exception:
        member = None
    fed_client.resource("clusters").delete(name)
    if member is None:
        return

    def fed_workloads():
        out = []
        for resource in ("replicationcontrollers", "services"):
            try:
                fed_objs, _rv = fed_client.resource(resource, "").list()
            except APIStatusError:
                continue
            out.extend(
                (resource, o.metadata.namespace, o.metadata.name)
                for o in fed_objs
            )
        return out

    def sweep(targets):
        """-> (removed, failed): deletes that succeeded vs RAISED for a
        reason other than not-found. A pass where everything fails must
        never read as 'clean' — that is exactly the transient-blip case
        where a concurrent propagation pass can resurrect workloads."""
        removed = failed = 0
        for resource, ns, nm in targets:
            try:
                member.resource(resource, ns).delete(nm)
                removed += 1
            except APIStatusError as e:
                if e.code != 404:
                    failed += 1
            except Exception:
                failed += 1  # member unreachable: NOT proof of clean
        return removed, failed

    targets = fed_workloads()
    sweep(targets)
    # verify-until-stable: an in-flight propagation pass (which listed
    # clusters before our deletion) may re-create workloads after the
    # first sweep. Clean = one full pass that finds nothing present and
    # nothing unreachable. The budget covers multi-second propagation
    # passes; exhaustion is LOGGED — the member would otherwise run its
    # stale share silently forever.
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        time.sleep(0.1)
        removed, failed = sweep(targets)
        if removed == 0 and failed == 0:
            return
    log.error(
        "kubefed unjoin %s: member cleanup never stabilized within 30s; "
        "federation workloads may survive on the departed cluster", name,
    )


class FederationControllerManager:
    """federation/cmd/federation-controller-manager: one process running
    the federation loops (cluster health, service propagation, replica
    spreading) over the federated apiserver."""

    def __init__(self, fed_client: RESTClient,
                 member_client_factory=None,
                 cluster_sync_period: float = 5.0,
                 workload_sync_period: float = 5.0):
        factory = member_client_factory or default_member_client_factory
        self._memo: Dict[str, Optional[RESTClient]] = {}
        self._memo_lock = threading.Lock()

        def memoized(cluster: Cluster) -> Optional[RESTClient]:
            key = f"{cluster.metadata.name}|{cluster.spec.server_address}"
            with self._memo_lock:
                if key not in self._memo:
                    self._memo[key] = factory(cluster)
                return self._memo[key]

        manager = self

        class _MemoPruner(PeriodicRunner):
            """Evict member clients for unjoined/re-addressed clusters
            so long-lived managers don't leak one transport per
            historical (name, address) pair."""

            THREAD_NAME = "federation-memo-pruner"

            def sync_once(self) -> int:
                clusters, _rv = fed_client.resource("clusters").list()
                live = {
                    f"{c.metadata.name}|{c.spec.server_address}"
                    for c in clusters
                }
                with manager._memo_lock:
                    stale = [k for k in manager._memo if k not in live]
                    for k in stale:
                        del manager._memo[k]
                return len(stale)

        self.controllers = [
            ClusterController(fed_client, memoized),
            FederatedServiceController(fed_client, memoized),
            FederatedReplicationManager(fed_client, memoized),
            _MemoPruner(),
        ]
        self._periods = [cluster_sync_period, workload_sync_period,
                         workload_sync_period, cluster_sync_period]

    def start(self) -> "FederationControllerManager":
        for ctrl, period in zip(self.controllers, self._periods):
            ctrl.run(period)
        return self

    def stop(self) -> None:
        for ctrl in self.controllers:
            ctrl.stop()
