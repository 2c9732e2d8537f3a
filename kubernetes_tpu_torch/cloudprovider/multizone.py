"""The "multizone" cloud provider: a simulated REGIONAL cloud.

Reference analogue: pkg/cloudprovider/providers/aws/aws.go +
providers/gce/gce.go — providers whose value in the registry is that
zones, disk placement, and load balancers behave DIFFERENTLY from a
single-machine cloud behind the same interface:

  * instances live in zones; `instance_zone(name)` answers per node
    (the kubelet-side GetZone seen from each zone's metadata service);
  * block devices are ZONAL: a disk created in us-sim1-a can only
    attach to instances in us-sim1-a (the GCE PD / EBS placement rule
    that makes NoVolumeZoneConflict meaningful), and attach/detach
    complete ASYNCHRONOUSLY after a configurable latency — the state
    machine passes through "attaching"/"detaching" the way the
    attach/detach controller sees real clouds behave;
  * load balancers are provisioned per region with per-zone frontends
    (one simulated external IP per zone that has backend hosts).

Everything is in-memory and deterministic; inject `attach_latency` /
`detach_latency` (seconds) to harden controllers against slow clouds.

Copy of kubernetes_tpu/cloudprovider/multizone.py: only the import package differs.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.cloudprovider.cloud import (
    CloudProvider,
    DiskConflict,
    InstanceNotFound,
    LoadBalancer,
    Route,
    Zone,
    register_cloud_provider,
)

DEFAULT_REGION = "us-sim1"
DEFAULT_ZONES = ("us-sim1-a", "us-sim1-b", "us-sim1-c")


class MultiZoneCloud(CloudProvider):
    provider_name = "multizone"

    def __init__(self, region: str = DEFAULT_REGION,
                 zones: Tuple[str, ...] = DEFAULT_ZONES,
                 instances: Optional[Dict[str, str]] = None,
                 attach_latency: float = 0.0,
                 detach_latency: float = 0.0):
        """instances: {name: zone}; add_instance() places round-robin
        when no zone is given."""
        self.region = region
        self.zones = tuple(zones)
        self._rr = itertools.cycle(self.zones)
        self._lock = threading.RLock()
        self.instances: Dict[str, str] = dict(instances or {})
        self.attach_latency = attach_latency
        self.detach_latency = detach_latency
        # device_id -> zone (zonal disks); created on first reference
        # against the referencing instance's zone unless pre-created
        self.disk_zones: Dict[str, str] = {}
        # device_id -> {node: (state, read_only)};
        # state in {"attaching", "attached", "detaching"}
        self._attachments: Dict[str, Dict[str, Tuple[str, bool]]] = {}
        self.routes: Dict[str, Route] = {}
        self.balancers: Dict[Tuple[str, str], LoadBalancer] = {}
        self._ip_seq = itertools.count(1)
        self.calls: List[str] = []

    # -- instances / zones ---------------------------------------------------

    def add_instance(self, name: str, zone: str = "") -> str:
        with self._lock:
            z = zone or next(self._rr)
            if z not in self.zones:
                raise ValueError(f"unknown zone {z!r}")
            self.instances[name] = z
            return z

    def node_addresses(self, name):
        self._zone_of(name)
        return [("InternalIP", "10.0.0.1"), ("Hostname", name)]

    def external_id(self, name):
        return f"mz-{self._zone_of(name)}-{name}"

    def list_instances(self, name_filter=""):
        with self._lock:
            return sorted(i for i in self.instances if name_filter in i)

    def get_zone(self):
        # the region-level answer (a real kubelet asks its own zone's
        # metadata service; controllers use instance_zone per node)
        return Zone(self.zones[0], self.region)

    def instance_zone(self, name: str) -> Zone:
        return Zone(self._zone_of(name), self.region)

    def _zone_of(self, name: str) -> str:
        with self._lock:
            z = self.instances.get(name)
        if z is None:
            raise InstanceNotFound(name)
        return z

    # -- zonal disks with async attach ---------------------------------------

    def create_disk(self, device_id: str, zone: str) -> None:
        with self._lock:
            if zone not in self.zones:
                raise ValueError(f"unknown zone {zone!r}")
            self.disk_zones[device_id] = zone

    def attach_disk(self, device_id, node, read_only=False):
        self.calls.append("attach-disk")
        node_zone = self._zone_of(node)
        with self._lock:
            disk_zone = self.disk_zones.setdefault(device_id, node_zone)
            if disk_zone != node_zone:
                # the zonal placement rule (gce.go AttachDisk resolves
                # the disk IN the instance's zone and 404s otherwise)
                raise DiskConflict(
                    f"disk {device_id!r} is in zone {disk_zone!r}; "
                    f"instance {node!r} is in {node_zone!r}"
                )
            holders = self._attachments.setdefault(device_id, {})
            cur = holders.get(node)
            if cur is not None and cur[0] == "attached" \
                    and cur[1] is read_only:
                return f"/dev/disk/by-id/mz-{device_id}"
            others = {
                n: ro for n, (st, ro) in holders.items()
                if n != node and st != "detaching"
            }
            writer = next(
                (n for n, ro in others.items() if not ro), None
            )
            if writer is not None:
                raise DiskConflict(
                    f"disk {device_id!r} is attached read-write to "
                    f"{writer!r}"
                )
            if not read_only and others:
                raise DiskConflict(
                    f"disk {device_id!r} has readers {sorted(others)}; "
                    "cannot attach read-write"
                )
            holders[node] = ("attaching", read_only)
        if self.attach_latency:
            time.sleep(self.attach_latency)
        with self._lock:
            holders = self._attachments.get(device_id, {})
            if holders.get(node, ("", False))[0] == "attaching":
                holders[node] = ("attached", read_only)
        return f"/dev/disk/by-id/mz-{device_id}"

    def detach_disk(self, device_id, node):
        self.calls.append("detach-disk")
        with self._lock:
            holders = self._attachments.get(device_id, {})
            if node not in holders:
                return  # idempotent
            holders[node] = ("detaching", holders[node][1])
        if self.detach_latency:
            time.sleep(self.detach_latency)
        with self._lock:
            holders = self._attachments.get(device_id, {})
            holders.pop(node, None)
            if not holders:
                self._attachments.pop(device_id, None)

    def disk_is_attached(self, device_id, node):
        with self._lock:
            st = self._attachments.get(device_id, {}).get(node)
            return st is not None and st[0] == "attached"

    def disks_attached_to(self, node):
        with self._lock:
            return sorted(
                d for d, holders in self._attachments.items()
                if holders.get(node, ("", False))[0] != "detaching"
                and node in holders
            )

    def all_disk_attachments(self):
        with self._lock:
            return {
                d: sorted(holders)
                for d, holders in self._attachments.items()
            }

    # -- routes --------------------------------------------------------------

    def list_routes(self, cluster_name):
        prefix = f"{cluster_name}-"
        with self._lock:
            return [r for k, r in self.routes.items()
                    if k.startswith(prefix)]

    def create_route(self, cluster_name, route):
        # a regional cloud validates the target instance exists
        self._zone_of(route.target_instance)
        with self._lock:
            self.routes[f"{cluster_name}-{route.name}"] = route

    def delete_route(self, cluster_name, route):
        with self._lock:
            self.routes.pop(f"{cluster_name}-{route.name}", None)

    # -- regional load balancers with per-zone frontends ---------------------

    def get_tcp_load_balancer(self, name, region):
        with self._lock:
            return self.balancers.get((name, region))

    def ensure_tcp_load_balancer(self, name, region, ports, hosts):
        if region != self.region:
            raise ValueError(
                f"region {region!r} is not served (this is {self.region!r})"
            )
        hosts = tuple(h for h in hosts if h in self.instances)
        # one frontend IP per zone that actually has backends — the
        # regional-LB shape (a zone outage keeps the others serving)
        zones_used = sorted({self._zone_of(h) for h in hosts})
        with self._lock:
            cur = self.balancers.get((name, region))
            if cur is not None and cur.hosts == hosts and tuple(
                p if isinstance(p, int) else p.port for p in ports
            ) == cur.ports:
                return cur
            if cur is not None:
                # backend churn must not flap the frontend: real clouds
                # keep the external IP stable across host/port updates
                ip = cur.external_ip
            else:
                zone_idx = {z: i for i, z in enumerate(self.zones)}
                n = next(self._ip_seq)
                ip = (
                    f"203.0.{zone_idx.get(zones_used[0], 0)}.{n}"
                    if zones_used else f"203.0.255.{n}"
                )
            lb = LoadBalancer(
                name=name, region=region, external_ip=ip,
                ports=tuple(
                    p if isinstance(p, int) else p.port for p in ports
                ),
                hosts=hosts,
            )
            self.balancers[(name, region)] = lb
            return lb

    def ensure_tcp_load_balancer_deleted(self, name, region):
        with self._lock:
            self.balancers.pop((name, region), None)


register_cloud_provider("multizone", MultiZoneCloud)
