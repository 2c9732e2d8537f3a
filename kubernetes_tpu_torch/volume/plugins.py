"""Volume plugin registry + plugins (pkg/volume/plugins.go + per-plugin
dirs: empty_dir, host_path, gce_pd, aws_ebs, nfs, rbd, secret,
configmap, persistent_claim).

Copy of kubernetes_tpu/volume/plugins.py: only the import package differs."""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api import types as t


class FakeMounter:
    """pkg/util/mount FakeMounter: records mount/unmount calls."""

    def __init__(self):
        self._lock = threading.Lock()
        self.mounts: Dict[str, Tuple[str, str]] = {}  # path -> (device, fstype)
        self.log: List[Tuple[str, str]] = []

    def mount(self, device: str, path: str, fstype: str = "ext4") -> None:
        with self._lock:
            self.mounts[path] = (device, fstype)
            self.log.append(("mount", path))

    def unmount(self, path: str) -> None:
        with self._lock:
            self.mounts.pop(path, None)
            self.log.append(("unmount", path))

    def is_mounted(self, path: str) -> bool:
        with self._lock:
            return path in self.mounts


@dataclass
class VolumeSpec:
    """pkg/volume Spec: either a pod-inline Volume or a PersistentVolume."""

    volume: Optional[t.Volume] = None
    pv: Optional[t.PersistentVolume] = None

    @property
    def name(self) -> str:
        if self.volume is not None:
            return self.volume.name
        return self.pv.metadata.name if self.pv else ""


class VolumePlugin:
    """plugins.go VolumePlugin: name + support check + setup/teardown."""

    name = ""
    # attachable plugins need a node attach step before mount
    # (pkg/volume/util/operationexecutor; gce_pd/aws_ebs are attachable)
    attachable = False

    def can_support(self, spec: VolumeSpec) -> bool:
        raise NotImplementedError

    def device_of(self, spec: VolumeSpec) -> str:
        return spec.name

    def setup(self, mounter: FakeMounter, spec: VolumeSpec, pod_uid: str) -> str:
        """Mount; returns the volume path inside the pod dir (SetUpAt)."""
        path = f"/var/lib/kubelet/pods/{pod_uid}/volumes/{self.name}/{spec.name}"
        mounter.mount(self.device_of(spec), path)
        return path

    def teardown(self, mounter: FakeMounter, spec: VolumeSpec, pod_uid: str) -> None:
        path = f"/var/lib/kubelet/pods/{pod_uid}/volumes/{self.name}/{spec.name}"
        mounter.unmount(path)


def _source(spec: VolumeSpec, field_name: str):
    """The named volume source from an inline volume or a PV (the
    plugins below route on exactly one source field each)."""
    if spec.volume is not None:
        return getattr(spec.volume, field_name, None)
    if spec.pv is not None:
        return getattr(spec.pv, field_name, None)
    return None


def _any_source(v) -> bool:
    import dataclasses as _dc

    return any(
        getattr(v, f.name) is not None
        for f in _dc.fields(v)
        if f.name != "name"
    )


class _SourcePlugin(VolumePlugin):
    """A plugin keyed on one volume-source field; device_fn renders the
    stable device id the attach/detach controller and mount paths use."""

    field_name = ""

    def can_support(self, spec):
        return _source(spec, self.field_name) is not None

    def device_of(self, spec):
        return self.render(_source(spec, self.field_name))

    def render(self, src) -> str:  # pragma: no cover - overridden
        return self.name


class EmptyDirPlugin(VolumePlugin):
    name = "kubernetes.io/empty-dir"

    def can_support(self, spec):
        # the fallback medium: an inline volume with NO source field
        # set (any new Volume source automatically excludes emptyDir)
        v = spec.volume
        return v is not None and not _any_source(v)

    def device_of(self, spec):
        return "tmpfs"


class HostPathPlugin(_SourcePlugin):
    name = "kubernetes.io/host-path"
    field_name = "host_path"

    def render(self, s):
        return s.path


class GCEPDPlugin(VolumePlugin):
    name = "kubernetes.io/gce-pd"
    attachable = True

    def can_support(self, spec):
        if spec.volume is not None:
            return spec.volume.gce_persistent_disk is not None
        return spec.pv is not None and spec.pv.gce_persistent_disk is not None

    def device_of(self, spec):
        src = (
            spec.volume.gce_persistent_disk
            if spec.volume is not None
            else spec.pv.gce_persistent_disk
        )
        return f"gce-pd/{src.pd_name}"


class AWSEBSPlugin(VolumePlugin):
    name = "kubernetes.io/aws-ebs"
    attachable = True

    def can_support(self, spec):
        if spec.volume is not None:
            return spec.volume.aws_elastic_block_store is not None
        return spec.pv is not None and spec.pv.aws_elastic_block_store is not None

    def device_of(self, spec):
        src = (
            spec.volume.aws_elastic_block_store
            if spec.volume is not None
            else spec.pv.aws_elastic_block_store
        )
        return f"aws-ebs/{src.volume_id}"


class RBDPlugin(_SourcePlugin):
    name = "kubernetes.io/rbd"
    field_name = "rbd"

    def render(self, r):
        return f"rbd/{r.pool}/{r.image}"


class NFSPlugin(_SourcePlugin):
    name = "kubernetes.io/nfs"
    field_name = "nfs"

    def render(self, s):
        return f"nfs/{s.server}{s.path}"


class ISCSIPlugin(_SourcePlugin):
    name = "kubernetes.io/iscsi"
    field_name = "iscsi"

    def render(self, s):
        return f"iscsi/{s.target_portal}/{s.iqn}/lun-{s.lun}"


class GlusterfsPlugin(_SourcePlugin):
    name = "kubernetes.io/glusterfs"
    field_name = "glusterfs"

    def render(self, s):
        return f"glusterfs/{s.endpoints_name}/{s.path}"


class CephFSPlugin(_SourcePlugin):
    name = "kubernetes.io/cephfs"
    field_name = "cephfs"

    def render(self, s):
        return f"cephfs/{','.join(s.monitors)}{s.path}"


class CinderPlugin(_SourcePlugin):
    name = "kubernetes.io/cinder"
    field_name = "cinder"
    attachable = True

    def render(self, s):
        return f"cinder/{s.volume_id}"


class FCPlugin(_SourcePlugin):
    name = "kubernetes.io/fc"
    field_name = "fc"
    attachable = True

    def render(self, s):
        return f"fc/{','.join(s.target_wwns)}/lun-{s.lun}"


class AzureFilePlugin(_SourcePlugin):
    name = "kubernetes.io/azure-file"
    field_name = "azure_file"

    def render(self, s):
        return f"azure-file/{s.share_name}"


class FlockerPlugin(_SourcePlugin):
    name = "kubernetes.io/flocker"
    field_name = "flocker"

    def render(self, s):
        return f"flocker/{s.dataset_name}"


class VspherePlugin(_SourcePlugin):
    name = "kubernetes.io/vsphere-volume"
    field_name = "vsphere_volume"
    attachable = True

    def render(self, s):
        return f"vsphere/{s.volume_path}"


class SecretPlugin(_SourcePlugin):
    """pkg/volume/secret: API-object-backed (inline-only in practice —
    PersistentVolume has no secret source, so the base routing holds)."""

    name = "kubernetes.io/secret"
    field_name = "secret"

    def render(self, s):
        return f"secret/{s.secret_name}"


class ConfigMapPlugin(_SourcePlugin):
    name = "kubernetes.io/configmap"
    field_name = "config_map"

    def render(self, s):
        return f"configmap/{s.name}"


class DownwardAPIPlugin(_SourcePlugin):
    name = "kubernetes.io/downward-api"
    field_name = "downward_api"

    def render(self, s):
        return "downward-api"


class GitRepoPlugin(_SourcePlugin):
    name = "kubernetes.io/git-repo"
    field_name = "git_repo"

    def render(self, s):
        return f"git/{s.repository}@{s.revision or 'HEAD'}"


class VolumePluginMgr:
    """plugins.go VolumePluginMgr."""

    def __init__(self, plugins: Optional[List[VolumePlugin]] = None):
        self.plugins: List[VolumePlugin] = plugins or []

    def register(self, plugin: VolumePlugin) -> None:
        self.plugins.append(plugin)

    def find_plugin_by_spec(self, spec: VolumeSpec) -> VolumePlugin:
        matches = [p for p in self.plugins if p.can_support(spec)]
        if not matches:
            raise LookupError(f"no volume plugin matched spec {spec.name!r}")
        if len(matches) > 1:
            names = ", ".join(p.name for p in matches)
            raise LookupError(f"multiple plugins matched: {names}")
        return matches[0]

    def find_plugin_by_name(self, name: str) -> VolumePlugin:
        for p in self.plugins:
            if p.name == name:
                return p
        raise LookupError(f"no volume plugin named {name!r}")


def default_plugin_mgr() -> VolumePluginMgr:
    """ProbeVolumePlugins (cmd/kubelet app plugins.go)."""
    return VolumePluginMgr(
        [
            GCEPDPlugin(),
            AWSEBSPlugin(),
            RBDPlugin(),
            HostPathPlugin(),
            EmptyDirPlugin(),
            NFSPlugin(),
            ISCSIPlugin(),
            GlusterfsPlugin(),
            CephFSPlugin(),
            CinderPlugin(),
            FCPlugin(),
            AzureFilePlugin(),
            FlockerPlugin(),
            VspherePlugin(),
            SecretPlugin(),
            ConfigMapPlugin(),
            DownwardAPIPlugin(),
            GitRepoPlugin(),
        ]
    )
