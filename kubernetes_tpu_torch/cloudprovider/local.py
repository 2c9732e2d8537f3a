"""The "local" cloud provider: a working in-process cloud.

Reference analogue: pkg/cloudprovider/providers/gce/gce.go (the provider
whose TCPLoadBalancer actually forwards traffic). The reference's
provider breadth is what makes ServiceController and RouteController
meaningful; the fake provider only records calls. This provider closes
the loop on one machine: `ensure_tcp_load_balancer` opens REAL listening
sockets and forwards accepted connections round-robin across the
cluster's nodes, dialing each node's userspace proxy (proxy/userspace.py
— the REDIRECT seam) for the service port. ServiceController →
LoadBalancer → kube-proxy → pod backend becomes a live byte path,
end-to-end in-process.

Instances/Zones are the one local machine; Routes are kept in memory
(one machine needs no routing, but RouteController still reconciles).

Copy of kubernetes_tpu/cloudprovider/local.py: only the import package differs.
"""

from __future__ import annotations

import logging
import socket
import threading
from typing import Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.cloudprovider.cloud import (
    CloudProvider,
    DiskAttachmentTable,
    InstanceNotFound,
    LoadBalancer,
    Route,
    Zone,
    register_cloud_provider,
)

log = logging.getLogger(__name__)

# resolver: (host, service_port) -> (ip, port) of that node's proxy
# listener, or None when the node has no listener for the port
ProxyResolver = Callable[[str, int], Optional[Tuple[str, int]]]


class _LBListener:
    """One real listening port of a local load balancer."""

    def __init__(self, lb: "_LocalLB", port: int, node_port: int):
        self.lb = lb
        self.port = port
        self.node_port = node_port
        self.stopped = threading.Event()
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # the balancer answers on its own loopback IP at the SERVICE
        # port, so status.loadBalancer.ingress.ip + spec.ports[].port is
        # a genuinely dialable pair (127.0.0.0/8 is all local on linux —
        # each LB gets its own "external IP" the way a cloud grants one)
        try:
            self.sock.bind((lb.external_ip, port))
        except OSError:
            self.sock.bind((lb.external_ip, 0))
        self.addr = self.sock.getsockname()
        self.sock.listen(64)
        threading.Thread(
            target=self._loop, daemon=True,
            name=f"local-lb-{lb.name}:{port}",
        ).start()

    def close(self) -> None:
        self.stopped.set()
        try:
            self.sock.close()
        except OSError:
            pass

    def _loop(self) -> None:
        from kubernetes_tpu_torch.proxy.userspace import _splice

        while not self.stopped.is_set():
            try:
                conn, _client = self.sock.accept()
            except OSError:
                return

            def serve(conn=conn):
                backend = self.lb.dial(self.node_port or self.port)
                if backend is None:
                    conn.close()
                    return
                try:
                    _splice(conn, backend, self.stopped)
                finally:
                    for s in (conn, backend):
                        try:
                            s.close()
                        except OSError:
                            pass

            threading.Thread(target=serve, daemon=True).start()


def _port_pair(p) -> Tuple[int, int]:
    """(service port, node port) from an int or a ServicePort-shaped
    object (the reference's CreateTCPLoadBalancer takes
    []*api.ServicePort; plain ints keep the fake-provider idiom)."""
    if isinstance(p, int):
        return p, 0
    return int(getattr(p, "port", 0)), int(getattr(p, "node_port", 0) or 0)


class _LocalLB:
    """The balancer: round-robin over member hosts' proxies."""

    def __init__(self, cloud: "LocalCloud", name: str,
                 ports, hosts: Tuple[str, ...], external_ip: str):
        self.cloud = cloud
        self.name = name
        self.hosts = tuple(hosts)
        self.external_ip = external_ip
        self._rr = 0
        self._lock = threading.Lock()
        self.port_pairs = tuple(_port_pair(p) for p in ports)
        self.listeners: Dict[int, _LBListener] = {
            port: _LBListener(self, port, node_port)
            for port, node_port in self.port_pairs
        }

    def dial(self, port: int) -> Optional[socket.socket]:
        """Pick hosts round-robin; first dialable proxy wins (the cloud
        LB's health-check-and-forward, condensed)."""
        with self._lock:
            order = [
                self.hosts[(self._rr + i) % len(self.hosts)]
                for i in range(len(self.hosts))
            ] if self.hosts else []
            self._rr += 1
        for host in order:
            addr = self.cloud.resolve_proxy(host, port)
            if addr is None:
                continue
            try:
                return socket.create_connection(addr, timeout=2.0)
            except OSError:
                continue
        return None

    def close(self) -> None:
        for l in self.listeners.values():
            l.close()

    def describe(self, region: str) -> LoadBalancer:
        return LoadBalancer(
            name=self.name, region=region,
            external_ip=self.external_ip,
            ports=tuple(self.listeners),
            hosts=self.hosts,
        )


class LocalCloud(DiskAttachmentTable, CloudProvider):
    """One-machine cloud: instances are registered node names, the LB
    actually forwards bytes."""

    provider_name = "local"

    def __init__(self, host: str = "127.0.0.1",
                 proxy_resolver: Optional[ProxyResolver] = None):
        self.host = host
        self.zone = Zone("local-a", "local")
        self.instances: List[str] = []
        self.routes: Dict[str, Route] = {}
        self._proxies: Dict[str, object] = {}  # node -> UserspaceProxier
        self._resolver = proxy_resolver
        self._lbs: Dict[Tuple[str, str], _LocalLB] = {}
        self._lock = threading.Lock()
        # per-LB "external IP" allocator over a private loopback slice
        self._next_ip = 1

    def _alloc_ip(self) -> str:
        """Grant the balancer its own address, the way a cloud does
        (127.0.0.0/8 is entirely local, so 127.200.x.y binds without
        any interface setup)."""
        n = self._next_ip
        self._next_ip += 1
        return f"127.200.{(n >> 8) & 0xFF}.{n & 0xFF}"

    # -- wiring ---------------------------------------------------------------

    def register_node(self, name: str, proxier=None) -> None:
        """Attach a node (and its userspace proxier) to the cloud — the
        local-up analogue of VMs existing in the provider's inventory."""
        with self._lock:
            if name not in self.instances:
                self.instances.append(name)
            if proxier is not None:
                self._proxies[name] = proxier

    def resolve_proxy(self, host: str, port: int) -> Optional[Tuple[str, int]]:
        if self._resolver is not None:
            return self._resolver(host, port)
        proxier = self._proxies.get(host)
        if proxier is None:
            return None
        addr_for_port = getattr(proxier, "addr_for_port", None)
        return addr_for_port(port) if addr_for_port else None

    # -- Instances ------------------------------------------------------------

    def node_addresses(self, name):
        if name not in self.instances:
            raise InstanceNotFound(name)
        return [("InternalIP", self.host), ("Hostname", name)]

    def external_id(self, name):
        if name not in self.instances:
            raise InstanceNotFound(name)
        return f"local://{name}"

    def list_instances(self, name_filter=""):
        return [i for i in self.instances if name_filter in i]

    # -- Zones ----------------------------------------------------------------

    def get_zone(self):
        return self.zone

    # -- Routes (in-memory; one machine routes to itself) ---------------------

    def list_routes(self, cluster_name):
        prefix = f"{cluster_name}-"
        return [r for k, r in self.routes.items() if k.startswith(prefix)]

    def create_route(self, cluster_name, route):
        self.routes[f"{cluster_name}-{route.name}"] = route

    def delete_route(self, cluster_name, route):
        self.routes.pop(f"{cluster_name}-{route.name}", None)

    # -- TCP load balancers ---------------------------------------------------

    def get_tcp_load_balancer(self, name, region):
        with self._lock:
            lb = self._lbs.get((name, region))
            return lb.describe(region) if lb else None

    def ensure_tcp_load_balancer(self, name, region, ports, hosts):
        want_pairs = tuple(_port_pair(p) for p in ports)
        with self._lock:
            lb = self._lbs.get((name, region))
            if lb is not None and (
                lb.port_pairs != want_pairs or lb.hosts != tuple(hosts)
            ):
                lb.close()
                ip = lb.external_ip  # keep the granted address stable
                lb = _LocalLB(self, name, ports, tuple(hosts), ip)
                self._lbs[(name, region)] = lb
            elif lb is None:
                lb = _LocalLB(self, name, ports, tuple(hosts),
                              self._alloc_ip())
                self._lbs[(name, region)] = lb
            return lb.describe(region)

    def ensure_tcp_load_balancer_deleted(self, name, region):
        with self._lock:
            lb = self._lbs.pop((name, region), None)
        if lb is not None:
            lb.close()

    def lb_addr(self, name: str, region: str,
                port: int) -> Optional[Tuple[str, int]]:
        """Where the balancer answers for a service port (tests +
        kubectl describe discovery)."""
        with self._lock:
            lb = self._lbs.get((name, region))
            if lb is None:
                return None
            listener = lb.listeners.get(port)
            return listener.addr if listener else None


register_cloud_provider("local", LocalCloud)
