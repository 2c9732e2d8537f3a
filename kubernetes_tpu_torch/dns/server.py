"""In-memory DNS record table fed by service/endpoints informers
(pkg/dns/dns.go newTreeCache shape, minus the skydns etcd detour).

Copy of kubernetes_tpu/dns/server.py: only the import package differs."""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.client.informer import Informer, ResourceEventHandler
from kubernetes_tpu_torch.client.rest import RESTClient


@dataclass(frozen=True)
class SRVRecord:
    target: str
    port: int


class DNSRecords:
    def __init__(self, client: RESTClient, cluster_domain: str = "cluster.local"):
        self.domain = cluster_domain
        self._lock = threading.Lock()
        self._services: Dict[str, t.Service] = {}
        self._endpoints: Dict[str, t.Endpoints] = {}
        self._svc_informer = Informer(
            client.resource("services"),
            ResourceEventHandler(
                on_add=self._on_svc,
                on_update=lambda old, new: self._on_svc(new),
                on_delete=self._on_svc_delete,
            ),
            name="dns-services",
        )
        self._eps_informer = Informer(
            client.resource("endpoints"),
            ResourceEventHandler(
                on_add=self._on_eps,
                on_update=lambda old, new: self._on_eps(new),
                on_delete=self._on_eps_delete,
            ),
            name="dns-endpoints",
        )

    @staticmethod
    def _key(obj) -> str:
        return f"{obj.metadata.namespace}/{obj.metadata.name}"

    def _on_svc(self, svc) -> None:
        with self._lock:
            self._services[self._key(svc)] = svc

    def _on_svc_delete(self, svc) -> None:
        with self._lock:
            self._services.pop(self._key(svc), None)

    def _on_eps(self, eps) -> None:
        with self._lock:
            self._endpoints[self._key(eps)] = eps

    def _on_eps_delete(self, eps) -> None:
        with self._lock:
            self._endpoints.pop(self._key(eps), None)

    # -- lookups -------------------------------------------------------------

    def _parse(self, name: str) -> Optional[List[str]]:
        suffix = f".svc.{self.domain}"
        name = name.rstrip(".")
        if not name.endswith(suffix):
            return None
        return name[: -len(suffix)].split(".")

    def resolve(self, name: str) -> List[str]:
        """A-record lookup -> IPs (dns.go ReceiveGetPath analogue)."""
        parts = self._parse(name)
        if not parts:
            return []
        with self._lock:
            if len(parts) == 2:
                svc_name, ns = parts
                svc = self._services.get(f"{ns}/{svc_name}")
                if svc is None:
                    return []
                if svc.spec.cluster_ip and svc.spec.cluster_ip != "None":
                    return [svc.spec.cluster_ip]
                # headless: ready endpoint IPs
                eps = self._endpoints.get(f"{ns}/{svc_name}")
                if eps is None:
                    return []
                return sorted(
                    {a.ip for s in eps.subsets for a in s.addresses}
                )
            if len(parts) == 3:
                # <pod-hostname>.<svc>.<ns> — petset stable identities
                host, svc_name, ns = parts
                eps = self._endpoints.get(f"{ns}/{svc_name}")
                if eps is None:
                    return []
                out = []
                for s in eps.subsets:
                    for a in s.addresses:
                        if a.target_ref.endswith(f"/{host}"):
                            out.append(a.ip)
                return sorted(set(out))
        return []

    def resolve_srv(self, name: str) -> List[SRVRecord]:
        """_<port>._<proto>.<svc>.<ns>.svc.<domain> -> SRV records."""
        parts = self._parse(name)
        if not parts or len(parts) != 4:
            return []
        port_label, proto_label, svc_name, ns = parts
        if not (port_label.startswith("_") and proto_label.startswith("_")):
            return []
        port_name, proto = port_label[1:], proto_label[1:].upper()
        with self._lock:
            svc = self._services.get(f"{ns}/{svc_name}")
            if svc is None:
                return []
            out = []
            for sp in svc.spec.ports:
                if sp.name == port_name and sp.protocol == proto:
                    out.append(
                        SRVRecord(
                            target=f"{svc_name}.{ns}.svc.{self.domain}",
                            port=sp.port,
                        )
                    )
            return out

    def run(self) -> "DNSRecords":
        self._svc_informer.run()
        self._eps_informer.run()
        return self

    def stop(self) -> None:
        self._svc_informer.stop()
        self._eps_informer.stop()
