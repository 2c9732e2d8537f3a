"""cloud.go Interface + providers.go registry + providers/fake.

Copy of kubernetes_tpu/cloudprovider/cloud.py: only the import package differs."""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


@dataclass
class Zone:
    failure_domain: str = ""
    region: str = ""


@dataclass
class Route:
    name: str = ""
    target_instance: str = ""
    destination_cidr: str = ""


@dataclass
class LoadBalancer:
    name: str = ""
    region: str = ""
    external_ip: str = ""
    ports: Tuple[int, ...] = ()
    hosts: Tuple[str, ...] = ()


class CloudProvider:
    """cloud.go Interface. Capability getters return None when the
    provider lacks the capability (the Interface() bool idiom)."""

    provider_name = ""

    # Instances
    def node_addresses(self, name: str) -> List[Tuple[str, str]]:
        """[(type, address)] per cloud.go NodeAddresses."""
        raise NotImplementedError

    def external_id(self, name: str) -> str:
        raise NotImplementedError

    def list_instances(self, name_filter: str = "") -> List[str]:
        raise NotImplementedError

    # Zones
    def get_zone(self) -> Zone:
        raise NotImplementedError

    # Routes
    def list_routes(self, cluster_name: str) -> List[Route]:
        raise NotImplementedError

    def create_route(self, cluster_name: str, route: Route) -> None:
        raise NotImplementedError

    def delete_route(self, cluster_name: str, route: Route) -> None:
        raise NotImplementedError

    # Block-device attach/detach (the gce.AttachDisk/DetachDisk +
    # aws.AttachDisk surface the volume attachers drive;
    # providers/gce/gce.go, providers/aws/aws.go)
    def attach_disk(self, device_id: str, node: str,
                    read_only: bool = False) -> str:
        """Attach the disk to the node; returns the device path.
        Idempotent when already attached to the same node."""
        raise NotImplementedError

    def detach_disk(self, device_id: str, node: str) -> None:
        raise NotImplementedError

    def disk_is_attached(self, device_id: str, node: str) -> bool:
        raise NotImplementedError

    # TCP load balancers (cloud.go TCPLoadBalancer, the 1.3 surface)
    def get_tcp_load_balancer(self, name: str, region: str) -> Optional[LoadBalancer]:
        raise NotImplementedError

    def ensure_tcp_load_balancer(
        self, name: str, region: str, ports: Tuple[int, ...], hosts: Tuple[str, ...]
    ) -> LoadBalancer:
        raise NotImplementedError

    def ensure_tcp_load_balancer_deleted(self, name: str, region: str) -> None:
        raise NotImplementedError


class InstanceNotFound(Exception):
    pass


class DiskConflict(Exception):
    """A read-write disk attachment already exists elsewhere (the
    gce.AttachDisk 'disk is already being used' error family)."""


class DiskAttachmentTable:
    """Shared in-memory disk attach/detach semantics (GCE PD rules:
    read-only to many XOR read-write to one). FakeCloud and LocalCloud
    both carry this table; a real provider would call its API."""

    def _disk_table(self) -> Dict[str, Dict[str, bool]]:
        tbl = getattr(self, "disk_attachments", None)
        if tbl is None:
            tbl = self.disk_attachments = {}
        return tbl

    def attach_disk(self, device_id, node, read_only=False):
        holders = self._disk_table().setdefault(device_id, {})
        if holders.get(node) is read_only:
            return f"/dev/disk/by-id/{device_id}"  # idempotent re-attach
        others = {n: ro for n, ro in holders.items() if n != node}
        writer = next((n for n, ro in others.items() if not ro), None)
        if writer is not None:
            raise DiskConflict(
                f"disk {device_id!r} is attached read-write to {writer!r}"
            )
        if not read_only and others:
            raise DiskConflict(
                f"disk {device_id!r} has readers "
                f"{sorted(others)}; cannot attach read-write"
            )
        holders[node] = read_only
        return f"/dev/disk/by-id/{device_id}"

    def detach_disk(self, device_id, node):
        tbl = self._disk_table()
        holders = tbl.get(device_id, {})
        holders.pop(node, None)
        if not holders:
            tbl.pop(device_id, None)

    def disk_is_attached(self, device_id, node):
        return node in self._disk_table().get(device_id, {})

    def disks_attached_to(self, node):
        return sorted(
            d for d, holders in self._disk_table().items()
            if node in holders
        )

    def all_disk_attachments(self):
        """{device_id: [nodes]} — the startup actual-state listing
        (gce ListDisks/aws DescribeVolumes role) the controller sweeps
        so holds of nodes deleted while it was down don't leak."""
        return {
            d: sorted(holders)
            for d, holders in self._disk_table().items()
        }


class FakeCloud(DiskAttachmentTable, CloudProvider):
    """providers/fake/fake.go: scripted instances + recorded calls."""

    provider_name = "fake"

    def __init__(self, instances: Optional[List[str]] = None,
                 zone: Optional[Zone] = None):
        self.instances = list(instances or [])
        self.zone = zone or Zone("us-central1-a", "us-central1")
        self.routes: Dict[str, Route] = {}
        self.balancers: Dict[Tuple[str, str], LoadBalancer] = {}
        # device_id -> {node: read_only} (the cloud's attachment table)
        self.disk_attachments: Dict[str, Dict[str, bool]] = {}
        self.calls: List[str] = []
        self.addresses: Dict[str, List[Tuple[str, str]]] = {}
        self.err: Optional[Exception] = None  # injectable failure

    def _call(self, name: str) -> None:
        self.calls.append(name)
        if self.err is not None:
            raise self.err

    def node_addresses(self, name):
        self._call("node-addresses")
        return self.addresses.get(
            name, [("InternalIP", "10.0.0.1"), ("Hostname", name)]
        )

    def external_id(self, name):
        self._call("external-id")
        if name not in self.instances:
            raise InstanceNotFound(name)
        return f"ext-{name}"

    def list_instances(self, name_filter=""):
        self._call("list")
        return [i for i in self.instances if name_filter in i]

    def get_zone(self):
        self._call("get-zone")
        return self.zone

    def list_routes(self, cluster_name):
        self._call("list-routes")
        prefix = f"{cluster_name}-"
        return [r for k, r in self.routes.items() if k.startswith(prefix)]

    def create_route(self, cluster_name, route):
        self._call("create-route")
        self.routes[f"{cluster_name}-{route.name}"] = route

    def delete_route(self, cluster_name, route):
        self._call("delete-route")
        self.routes.pop(f"{cluster_name}-{route.name}", None)

    def attach_disk(self, device_id, node, read_only=False):
        self._call("attach-disk")
        return super().attach_disk(device_id, node, read_only)

    def detach_disk(self, device_id, node):
        self._call("detach-disk")
        super().detach_disk(device_id, node)

    def disk_is_attached(self, device_id, node):
        self._call("disk-is-attached")
        return super().disk_is_attached(device_id, node)

    def disks_attached_to(self, node):
        self._call("disks-attached-to")
        return super().disks_attached_to(node)

    def get_tcp_load_balancer(self, name, region):
        self._call("get-lb")
        return self.balancers.get((name, region))

    def ensure_tcp_load_balancer(self, name, region, ports, hosts):
        self._call("ensure-lb")
        lb = LoadBalancer(
            name=name, region=region, external_ip="1.2.3.4",
            # ports arrive as ints or ServicePort-shaped objects (the
            # reference's CreateTCPLoadBalancer takes []*api.ServicePort)
            ports=tuple(
                p if isinstance(p, int) else p.port for p in ports
            ),
            hosts=tuple(hosts),
        )
        self.balancers[(name, region)] = lb
        return lb

    def ensure_tcp_load_balancer_deleted(self, name, region):
        self._call("delete-lb")
        self.balancers.pop((name, region), None)


_registry_lock = threading.Lock()
_registry: Dict[str, Callable[[], CloudProvider]] = {}


def register_cloud_provider(name: str, factory: Callable[[], CloudProvider]) -> None:
    """providers.go RegisterCloudProvider."""
    with _registry_lock:
        _registry[name] = factory


def get_cloud_provider(name: str) -> Optional[CloudProvider]:
    with _registry_lock:
        factory = _registry.get(name)
    return factory() if factory else None


register_cloud_provider("fake", FakeCloud)
