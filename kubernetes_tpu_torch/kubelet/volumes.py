"""Kubelet volume manager (pkg/kubelet/volume_manager.go +
volumemanager reconciler).

Mount lifecycle over the volume plugin registry (volume/plugins.py):
syncPod mounts every pod volume through its plugin before the runtime
starts containers (attachable plugins get the attach step first), and
the reconciler tears down mounts whose pod is gone — the
desired-state/actual-state loop, collapsed to the hollow-node scale
where the mounter is fake but the plugin routing and refcounts are
real.

Copy of kubernetes_tpu/kubelet/volumes.py: only the import package differs.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Set, Tuple

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.volume.plugins import (
    FakeMounter,
    VolumePluginMgr,
    VolumeSpec,
    default_plugin_mgr,
)

log = logging.getLogger(__name__)


class VolumeManager:
    def __init__(self, plugins: VolumePluginMgr = None,
                 mounter: FakeMounter = None, node_name: str = ""):
        self.plugins = plugins or default_plugin_mgr()
        self.mounter = mounter or FakeMounter()
        self.node_name = node_name
        self._lock = threading.Lock()
        # (pod_uid, volume name) -> (plugin, spec, mounted path)
        self._mounted: Dict[Tuple[str, str], Tuple[object, VolumeSpec, str]] = {}

    def mount_pod_volumes(self, pod: t.Pod) -> Dict[str, str]:
        """WaitForAttachAndMount: every spec.volumes entry mounted via
        its plugin; -> {volume name: path}. Unsupported volume types
        raise (the pod must not start half-mounted)."""
        out: Dict[str, str] = {}
        for vol in pod.spec.volumes or []:
            key = (pod.metadata.uid, vol.name)
            with self._lock:
                ent = self._mounted.get(key)
                if ent is not None:
                    out[vol.name] = ent[2]
                    continue
            spec = VolumeSpec(volume=vol)
            plugin = self.plugins.find_plugin_by_spec(spec)
            if getattr(plugin, "attachable", False):
                attach = getattr(plugin, "attach", None)
                if attach is not None:
                    attach(spec, self.node_name)
            path = plugin.setup(self.mounter, spec, pod.metadata.uid)
            with self._lock:
                self._mounted[key] = (plugin, spec, path)
            out[vol.name] = path
        return out

    def unmount_pod_volumes(self, pod_uid: str) -> int:
        """TearDown every mount belonging to the pod; -> count."""
        with self._lock:
            keys = [k for k in self._mounted if k[0] == pod_uid]
            ents = [(k, self._mounted.pop(k)) for k in keys]
        n = 0
        for (uid, _name), (plugin, spec, _path) in ents:
            try:
                plugin.teardown(self.mounter, spec, uid)
                detach = getattr(plugin, "detach", None)
                if getattr(plugin, "attachable", False) and detach is not None:
                    detach(spec, self.node_name)
                n += 1
            except Exception:
                log.debug("teardown failed for %s/%s", uid, spec.name,
                          exc_info=True)
        return n

    def reconcile(self, active_uids: Set[str]) -> int:
        """The reconciler's orphan sweep: unmount volumes whose pod is
        no longer on the node; -> mounts torn down."""
        with self._lock:
            orphans = {uid for (uid, _n) in self._mounted
                       if uid not in active_uids}
        n = 0
        for uid in orphans:
            n += self.unmount_pod_volumes(uid)
        return n

    def in_use_devices(self) -> List[str]:
        """Device ids of mounted ATTACHABLE volumes — what the kubelet
        reports as node.status.volumesInUse so the attach/detach
        controller defers detaching devices still mounted here."""
        with self._lock:
            return sorted({
                plugin.device_of(spec)
                for (plugin, spec, _path) in self._mounted.values()
                if getattr(plugin, "attachable", False)
            })

    def mounted_for(self, pod_uid: str) -> List[str]:
        with self._lock:
            return sorted(
                name for (uid, name) in self._mounted if uid == pod_uid
            )
