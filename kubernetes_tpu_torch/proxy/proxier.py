"""kube-proxy (pkg/proxy).

`Proxier` mirrors iptables/proxier.go's shape: service/endpoints watches
feed `on_service_update` / `on_endpoints_update` (pkg/proxy/config
ServiceConfigHandler/EndpointsConfigHandler), each update triggers
`sync_rules()` which rebuilds an idempotent rule table:

    (cluster_ip, port) -> [(endpoint_ip, endpoint_port), ...]

The reference's iptables chains (KUBE-SERVICES -> KUBE-SVC-* ->
KUBE-SEP-* with random load balancing) become this table plus a
per-service balancer. `route()` resolves one flow like a packet would:
service VIP -> endpoint, round-robin with optional ClientIP session
affinity (userspace/roundrobin.go).

Copy of kubernetes_tpu/proxy/proxier.py: only the import package differs."""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.client.informer import Informer, ResourceEventHandler
from kubernetes_tpu_torch.client.rest import RESTClient


@dataclass(frozen=True)
class ServicePortName:
    namespace: str
    name: str
    port: str  # port name ("" for unnamed)

    def __str__(self):
        return f"{self.namespace}/{self.name}:{self.port}"


@dataclass
class Rule:
    """One VIP:port -> endpoints mapping (a KUBE-SVC chain)."""

    cluster_ip: str
    port: int
    protocol: str
    endpoints: Tuple[Tuple[str, int], ...]  # (ip, port)
    session_affinity: str = "None"
    # cluster-unique port for NodePort/LoadBalancer services (the
    # KUBE-NODEPORTS chain key; how a cloud LB addresses one service)
    node_port: int = 0


class RoundRobinLoadBalancer:
    """userspace/roundrobin.go LoadBalancerRR."""

    def __init__(self):
        self._lock = threading.Lock()
        self._index: Dict[ServicePortName, int] = {}
        self._affinity: Dict[Tuple[ServicePortName, str], Tuple[str, int]] = {}

    def next_endpoint(
        self,
        svc: ServicePortName,
        endpoints: Tuple[Tuple[str, int], ...],
        client_ip: str = "",
        session_affinity: str = "None",
    ) -> Tuple[str, int]:
        if not endpoints:
            raise LookupError(f"no endpoints for {svc}")
        with self._lock:
            if session_affinity == "ClientIP" and client_ip:
                prior = self._affinity.get((svc, client_ip))
                if prior is not None and prior in endpoints:
                    return prior
            i = self._index.get(svc, 0) % len(endpoints)
            self._index[svc] = i + 1
            chosen = endpoints[i]
            if session_affinity == "ClientIP" and client_ip:
                self._affinity[(svc, client_ip)] = chosen
            return chosen


class Proxier:
    def __init__(self, client: RESTClient, node_name: str = ""):
        self.client = client
        self.node_name = node_name
        self.balancer = RoundRobinLoadBalancer()
        self._lock = threading.Lock()
        self._services: Dict[str, t.Service] = {}  # ns/name
        self._endpoints: Dict[str, t.Endpoints] = {}
        self.rules: Dict[ServicePortName, Rule] = {}
        self.syncs = 0  # observability: how many times rules rebuilt
        self._svc_informer = Informer(
            client.resource("services"),
            ResourceEventHandler(
                on_add=self._on_service,
                on_update=lambda old, new: self._on_service(new),
                on_delete=self._on_service_delete,
            ),
            name=f"proxy-services-{node_name}",
        )
        self._eps_informer = Informer(
            client.resource("endpoints"),
            ResourceEventHandler(
                on_add=self._on_endpoints,
                on_update=lambda old, new: self._on_endpoints(new),
                on_delete=self._on_endpoints_delete,
            ),
            name=f"proxy-endpoints-{node_name}",
        )

    @staticmethod
    def _key(obj) -> str:
        return f"{obj.metadata.namespace}/{obj.metadata.name}"

    def _on_service(self, svc: t.Service) -> None:
        with self._lock:
            self._services[self._key(svc)] = svc
        self.sync_rules()

    def _on_service_delete(self, svc: t.Service) -> None:
        with self._lock:
            self._services.pop(self._key(svc), None)
        self.sync_rules()

    def _on_endpoints(self, eps: t.Endpoints) -> None:
        with self._lock:
            self._endpoints[self._key(eps)] = eps
        self.sync_rules()

    def _on_endpoints_delete(self, eps: t.Endpoints) -> None:
        with self._lock:
            self._endpoints.pop(self._key(eps), None)
        self.sync_rules()

    # -- rule compilation (iptables/proxier.go syncProxyRules) ----------------

    def sync_rules(self) -> None:
        with self._lock:
            new_rules: Dict[ServicePortName, Rule] = {}
            for key, svc in self._services.items():
                eps = self._endpoints.get(key)
                ports = svc.spec.ports or []
                for sp in ports:
                    spn = ServicePortName(
                        svc.metadata.namespace, svc.metadata.name, sp.name
                    )
                    endpoints: List[Tuple[str, int]] = []
                    if eps is not None:
                        for subset in eps.subsets:
                            port_match = None
                            for ep_port in subset.ports:
                                if ep_port.name == sp.name:
                                    port_match = ep_port.port
                            if port_match is None:
                                continue
                            for addr in subset.addresses:
                                endpoints.append((addr.ip, port_match))
                    new_rules[spn] = Rule(
                        cluster_ip=svc.spec.cluster_ip,
                        port=sp.port,
                        protocol=sp.protocol,
                        endpoints=tuple(sorted(endpoints)),
                        session_affinity=svc.spec.session_affinity,
                        node_port=sp.node_port,
                    )
            self.rules = new_rules
            self.syncs += 1

    # -- the dataplane --------------------------------------------------------

    def route(
        self,
        namespace: str,
        service: str,
        port_name: str = "",
        client_ip: str = "",
    ) -> Tuple[str, int]:
        """Resolve one connection to a service like the NAT table would."""
        spn = ServicePortName(namespace, service, port_name)
        rule = self.rules.get(spn)
        if rule is None:
            raise LookupError(f"no rule for {spn}")
        return self.balancer.next_endpoint(
            spn, rule.endpoints, client_ip, rule.session_affinity
        )

    def run(self) -> "Proxier":
        self._svc_informer.run()
        self._eps_informer.run()
        return self

    def stop(self) -> None:
        self._svc_informer.stop()
        self._eps_informer.stop()
