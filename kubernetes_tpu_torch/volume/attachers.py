"""Cloud-disk attachers (pkg/volume/gce_pd/attacher.go,
pkg/volume/aws_ebs/attacher.go).

The reference's attachable plugins each carry a real attach state
machine: Attach calls the cloud (gce.AttachDisk / aws.AttachDisk) and is
idempotent for re-attach to the same node; a read-write disk attaches to
at most one instance, so a second RW attach FAILS and the controller
retries until the holder lets go; WaitForAttach polls until the cloud
reports the device; Detach calls the cloud and tolerates
already-detached. The round-3 plugins were device-string mappers with
none of this — the state machine is what makes the attach/detach
controller meaningful.

Copy of kubernetes_tpu/volume/attachers.py: only the import package differs.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

from kubernetes_tpu_torch.cloudprovider.cloud import CloudProvider, DiskConflict
from kubernetes_tpu_torch.volume.plugins import (
    VolumePlugin,
    VolumeSpec,
    _source,
)


def spec_read_only(spec: VolumeSpec) -> bool:
    """The source's readOnly bit (gce_pd.readOnly / awsElasticBlockStore
    .readOnly), PV or inline form (source routing shared with the
    plugin registry's _source)."""
    for field_name in ("gce_persistent_disk", "aws_elastic_block_store",
                       "cinder", "fc"):
        src = _source(spec, field_name)
        if src is not None:
            return bool(getattr(src, "read_only", False))
    return False


class CloudDiskAttacher:
    """One plugin's attacher bound to a cloud (attacher.go Attacher)."""

    def __init__(self, plugin: VolumePlugin, cloud: CloudProvider):
        self.plugin = plugin
        self.cloud = cloud

    def attach(self, spec: VolumeSpec, node: str) -> str:
        """-> device path. Raises DiskConflict when the disk is held
        read-write elsewhere (attacher.go Attach surfaces the cloud's
        'already in use' error; the controller retries)."""
        device_id = self.plugin.device_of(spec)
        return self.cloud.attach_disk(
            device_id, node, read_only=spec_read_only(spec)
        )

    def wait_for_attach(self, spec: VolumeSpec, node: str,
                        timeout: float = 10.0) -> Optional[str]:
        """Poll the cloud until it reports the device on the node
        (attacher.go WaitForAttach's device-path poll)."""
        device_id = self.plugin.device_of(spec)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.cloud.disk_is_attached(device_id, node):
                return f"/dev/disk/by-id/{device_id}"
            time.sleep(0.05)
        return None

    def detach(self, device_id: str, node: str) -> None:
        """Idempotent: already-detached is success (attacher.go Detach
        tolerates 'not found')."""
        if not tolerant_detach(self.cloud, device_id, node):
            raise RuntimeError(
                f"detach of {device_id!r} from {node!r} failed and the "
                "cloud still reports the hold"
            )


def tolerant_detach(cloud: CloudProvider, device_id: str,
                    node: str) -> bool:
    """The one copy of the already-detached tolerance rule (attacher.go
    Detach): returns True when the hold is gone — including when the
    cloud raised because it was never there — and False only when the
    cloud still reports (or cannot deny) the attachment."""
    try:
        cloud.detach_disk(device_id, node)
        return True
    except Exception:
        try:
            return not cloud.disk_is_attached(device_id, node)
        except Exception:
            return False


def attacher_for(plugin: VolumePlugin,
                 cloud: Optional[CloudProvider]) -> Optional[CloudDiskAttacher]:
    """The plugin's attacher against this cloud, or None when the plugin
    is not attachable / no cloud is configured (volume host wiring,
    plugins.go NewAttacher)."""
    if cloud is None or not getattr(plugin, "attachable", False):
        return None
    return CloudDiskAttacher(plugin, cloud)


__all__ = [
    "CloudDiskAttacher",
    "DiskConflict",
    "attacher_for",
    "spec_read_only",
]
