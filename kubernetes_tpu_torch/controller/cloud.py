"""Cloud-facing controllers (pkg/controller/service/servicecontroller.go
and pkg/controller/route/routecontroller.go).

ServiceController: services of type LoadBalancer get a cloud TCP load
balancer spanning the cluster's nodes; deleting the service (or flipping
its type) tears the balancer down. RouteController: every node gets a
cloud route for its pod CIDR; routes for vanished nodes are removed.

Copy of kubernetes_tpu/controller/cloud.py: only the import package differs."""

from __future__ import annotations

from typing import Dict, Optional

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.cloudprovider import CloudProvider, Route
from kubernetes_tpu_torch.client.rest import RESTClient
from kubernetes_tpu_torch.controller.framework import PeriodicRunner, SharedInformerFactory


class ServiceController(PeriodicRunner):
    """servicecontroller.go: reconcile cloud load balancers."""

    SYNC_PERIOD = 10.0
    THREAD_NAME = "service-controller"

    def __init__(
        self,
        client: RESTClient,
        informers: SharedInformerFactory,
        cloud: CloudProvider,
        cluster_name: str = "kubernetes",
    ):
        self.client = client
        self.cloud = cloud
        self.cluster_name = cluster_name
        self.svc_informer = informers.informer("services")
        self.node_informer = informers.nodes()
        self._owned: Dict[str, str] = {}  # "ns/name" -> region

    def _lb_name(self, svc: t.Service) -> str:
        # servicecontroller.go cloudprovider.GetLoadBalancerName (uid-based
        # in the reference; ns/name is equally unique here)
        return f"a{svc.metadata.uid[:8]}" if svc.metadata.uid else (
            f"{svc.metadata.namespace}-{svc.metadata.name}"
        )

    def sync_once(self) -> None:
        region = self.cloud.get_zone().region
        hosts = tuple(
            sorted(n.metadata.name for n in self.node_informer.store.list())
        )
        seen = set()
        for svc in self.svc_informer.store.list():
            key = f"{svc.metadata.namespace}/{svc.metadata.name}"
            if svc.spec.type != "LoadBalancer":
                continue
            seen.add(key)
            port_nums = tuple(p.port for p in svc.spec.ports)
            existing = self.cloud.get_tcp_load_balancer(self._lb_name(svc), region)
            if (
                existing is None
                or existing.ports != port_nums
                or existing.hosts != hosts
            ):
                # the reference's CreateTCPLoadBalancer takes the
                # []*api.ServicePort themselves (node ports included)
                lb = self.cloud.ensure_tcp_load_balancer(
                    self._lb_name(svc), region, tuple(svc.spec.ports), hosts
                )
            else:
                lb = existing
            # persist the balancer's address in service status
            # (servicecontroller.go persistUpdate of
            # status.loadBalancer.ingress) — re-checked EVERY sync so a
            # lost write (Conflict) or wiped status self-repairs
            have = [i.ip for i in svc.status.load_balancer.ingress]
            if have != [lb.external_ip]:
                try:
                    cur = self.client.resource(
                        "services", svc.metadata.namespace
                    ).get(svc.metadata.name)
                    cur.status.load_balancer = t.LoadBalancerStatus(
                        ingress=[t.LoadBalancerIngress(ip=lb.external_ip)]
                    )
                    self.client.resource(
                        "services", svc.metadata.namespace
                    ).update_status(cur)
                except Exception:
                    pass  # retried next sync (the have-check re-fires)
            self._owned[key] = self._lb_name(svc)
        # tear down balancers for deleted / retyped services
        for key, name in list(self._owned.items()):
            if key not in seen:
                self.cloud.ensure_tcp_load_balancer_deleted(name, region)
                del self._owned[key]


class RouteController(PeriodicRunner):
    """routecontroller.go: one cloud route per node's pod CIDR."""

    SYNC_PERIOD = 10.0
    THREAD_NAME = "route-controller"

    def __init__(
        self,
        client: RESTClient,
        informers: SharedInformerFactory,
        cloud: CloudProvider,
        cluster_name: str = "kubernetes",
        cluster_cidr: str = "10.42.0.0/16",
    ):
        self.client = client
        self.cloud = cloud
        self.cluster_name = cluster_name
        self.cluster_cidr = cluster_cidr
        self.node_informer = informers.nodes()

    @staticmethod
    def _pod_cidr(node: t.Node, index: int) -> str:
        # the reference reads node.spec.podCIDR (assigned by the CIDR
        # allocator); our kubelet derives per-node ranges, so the route
        # uses a deterministic per-node /24
        return f"10.42.{index % 256}.0/24"

    def sync_once(self) -> None:
        nodes = sorted(
            self.node_informer.store.list(), key=lambda n: n.metadata.name
        )
        want = {
            n.metadata.name: self._pod_cidr(n, i) for i, n in enumerate(nodes)
        }
        have = {
            r.target_instance: r
            for r in self.cloud.list_routes(self.cluster_name)
        }
        for name, cidr in want.items():
            r = have.get(name)
            if r is None or r.destination_cidr != cidr:
                self.cloud.create_route(
                    self.cluster_name,
                    Route(name=name, target_instance=name, destination_cidr=cidr),
                )
        for name, r in have.items():
            if name not in want:
                self.cloud.delete_route(self.cluster_name, r)
