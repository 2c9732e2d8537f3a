"""Attach/detach controller
(cmd/kube-controller-manager/app/controllermanager.go:394,
pkg/controller/volume/attach_detach_controller.go).

Reconciles which attachable volumes are attached to which nodes:

- desired state: every scheduled, non-terminal pod's attachable volume
  specs (inline sources, or PVC -> bound PV resolution), keyed by the
  plugin's stable device id;
- actual state: node.status.volumesAttached;
- attach what is desired and absent, detach what is attached and no
  longer desired — each step committed through the node status so the
  kubelet (WaitForAttachAndMount) and any observer see the same truth.

The reference performs the actual attach through the cloud provider;
here the plugin's attach/detach hooks are the (fake-able) actuation
seam and the API status is the system of record.

Copy of kubernetes_tpu/controller/attach_detach.py: only the import package differs.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.client.rest import APIStatusError, RESTClient
from kubernetes_tpu_torch.controller.framework import PeriodicRunner
from kubernetes_tpu_torch.volume.plugins import (
    VolumePluginMgr,
    VolumeSpec,
    default_plugin_mgr,
)


class AttachDetachController(PeriodicRunner):
    SYNC_PERIOD = 1.0
    THREAD_NAME = "attachdetach"

    def __init__(self, client: RESTClient, informers,
                 plugins: VolumePluginMgr = None, cloud=None):
        self.client = client
        self.plugins = plugins or default_plugin_mgr()
        # with a cloud configured, attach/detach go through the REAL
        # attacher state machines (volume/attachers.py) — the cloud's
        # attachment table is authoritative and RW multi-attach is
        # refused the way gce.AttachDisk refuses it. Without one, node
        # status is the only state (the round-3 behavior, still what
        # hollow/kubemark tests want).
        self.cloud = cloud
        self.conflicts = 0  # observability: RW multi-attach refusals
        self.pod_informer = informers.pods()
        self.node_informer = informers.nodes()
        self.pv_informer = informers.informer("persistentvolumes")
        self.pvc_informer = informers.informer("persistentvolumeclaims")

    # -- state derivation ----------------------------------------------------

    def _resolve_specs(self, pod: t.Pod, pvs, pvcs) -> List[VolumeSpec]:
        out = []
        for vol in pod.spec.volumes or []:
            if vol.persistent_volume_claim is not None:
                claim = pvcs.get(
                    f"{pod.metadata.namespace}/"
                    f"{vol.persistent_volume_claim.claim_name}"
                )
                pv = pvs.get(claim.volume_name) if claim is not None else None
                if pv is not None:
                    out.append(VolumeSpec(pv=pv))
                continue
            out.append(VolumeSpec(volume=vol))
        return out

    def desired_state(self) -> Dict[str, Set[str]]:
        """node name -> device ids that must be attached."""
        want: Dict[str, Set[str]] = {}
        self._want_specs: Dict[Tuple[str, str], tuple] = {}
        # one snapshot of the PV/PVC universe per pass, not per pod
        pvs = {
            pv.metadata.name: pv for pv in self.pv_informer.store.list()
        }
        pvcs = {
            f"{c.metadata.namespace}/{c.metadata.name}": c
            for c in self.pvc_informer.store.list()
        }
        for pod in self.pod_informer.store.list():
            if not pod.spec.node_name:
                continue
            if pod.status.phase in ("Succeeded", "Failed"):
                continue
            if pod.metadata.deletion_timestamp is not None:
                continue
            for spec in self._resolve_specs(pod, pvs, pvcs):
                try:
                    plugin = self.plugins.find_plugin_by_spec(spec)
                except LookupError:
                    continue
                if not getattr(plugin, "attachable", False):
                    continue
                device = plugin.device_of(spec)
                want.setdefault(pod.spec.node_name, set()).add(device)
                # remember (plugin, spec) so the cloud attacher can
                # carry the source's readOnly bit; when multiple pods
                # on the node share the device, ANY read-write consumer
                # makes the attachment read-write (iteration order must
                # not decide the mode)
                key = (pod.spec.node_name, device)
                prior = self._want_specs.get(key)
                if prior is not None:
                    from kubernetes_tpu_torch.volume.attachers import (
                        spec_read_only,
                    )

                    if not spec_read_only(prior[1]):
                        continue  # already RW: strongest mode wins
                self._want_specs[key] = (plugin, spec)
        return want

    # -- reconcile -----------------------------------------------------------

    def _sweep_gone_nodes(self, current: Set[str]) -> int:
        """Detach cloud holds of nodes that no longer exist. Steady
        state compares against the nodes seen last sync; the FIRST sync
        of a process instead lists the cloud's whole attachment table
        (gce ListDisks role), so a node deleted while the controller
        was down doesn't leak its holds forever."""
        gone_nodes: Set[str] = set()
        known = getattr(self, "_known_nodes", None)
        if known is None:
            list_all = getattr(self.cloud, "all_disk_attachments", None)
            if list_all is not None:
                try:
                    for _d, holders in list_all().items():
                        gone_nodes |= set(holders) - current
                except Exception:
                    pass
        else:
            gone_nodes = known - current
        enum = getattr(self.cloud, "disks_attached_to", None)
        detached = 0
        failed_gone: Set[str] = set()
        for gone in gone_nodes:
            if enum is None:
                break
            try:
                for device in enum(gone):
                    self.cloud.detach_disk(device, gone)
                    detached += 1
            except Exception:
                failed_gone.add(gone)  # sweep again next sync
        self._known_nodes = current | failed_gone
        return detached

    def sync_once(self) -> Tuple[int, int]:
        want = self.desired_state()
        attached = detached = 0
        nodes = self.node_informer.store.list()
        # a node deleted while holding cloud attachments would leak its
        # holds forever (nothing iterates it again): sweep the holds of
        # nodes that vanished since the last sync
        if self.cloud is not None:
            synced = getattr(self.node_informer, "has_synced",
                             lambda: True)
            if synced():
                detached += self._sweep_gone_nodes(
                    {n.metadata.name for n in nodes}
                )
            # else: an unsynced (empty) node list must not read as
            # "every node is gone" — the sweep waits for the informer
        for node in nodes:
            name = node.metadata.name
            have = {v.name for v in node.status.volumes_attached}
            if self.cloud is not None:
                # the cloud's attachment table is the ACTUAL state: a
                # sync that attached in the cloud but crashed before
                # recording it in node status must not leak the hold
                # forever (reconciler.go actual-state-of-world)
                enum = getattr(self.cloud, "disks_attached_to", None)
                if enum is not None:
                    try:
                        have = have | set(enum(name))
                    except Exception:
                        pass
            need = want.get(name, set())
            if have == need:
                continue
            try:
                fresh = self.client.nodes().get(name)
            except APIStatusError:
                continue
            # the volumesInUse handshake (reconciler.go): never detach a
            # device the kubelet still reports mounted — defer until its
            # heartbeat drops it from volumesInUse
            in_use = set(fresh.status.volumes_in_use)
            keep = need | (have & in_use)
            # detach through the cloud FIRST: node status must never
            # claim a device the cloud still holds elsewhere
            for device in sorted(have - keep):
                if self.cloud is not None:
                    from kubernetes_tpu_torch.volume.attachers import (
                        tolerant_detach,
                    )

                    if not tolerant_detach(self.cloud, device, name):
                        keep = keep | {device}  # still held: next sync
                        continue
                detached += 1
            fresh.status.volumes_attached = [
                v for v in fresh.status.volumes_attached if v.name in keep
            ]
            present = {v.name for v in fresh.status.volumes_attached}
            for device in sorted(need - present):
                device_path = f"/dev/disk/by-id/{device}"
                if self.cloud is not None:
                    from kubernetes_tpu_torch.cloudprovider.cloud import (
                        DiskConflict,
                    )
                    from kubernetes_tpu_torch.volume.attachers import (
                        attacher_for,
                    )

                    plugin, spec = self._want_specs.get(
                        (name, device), (None, None)
                    )
                    att = attacher_for(plugin, self.cloud) if plugin else None
                    if att is not None:
                        try:
                            device_path = att.attach(spec, name)
                        except DiskConflict:
                            # held read-write elsewhere: refused, like
                            # gce.AttachDisk; retried next sync once the
                            # holder detaches
                            self.conflicts += 1
                            continue
                        except Exception:
                            continue  # cloud hiccup: retried next sync
                fresh.status.volumes_attached.append(
                    t.AttachedVolume(name=device, device_path=device_path)
                )
                attached += 1
            try:
                self.client.nodes().update_status(fresh)
            except APIStatusError:
                continue
        return attached, detached
