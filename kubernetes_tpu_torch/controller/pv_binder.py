"""PersistentVolume claim binder (pkg/controller/persistentvolume/
persistentvolume_claim_binder_controller.go).

Matches unbound PVCs to available PVs (smallest PV whose capacity covers
the request, volume.Spec matching reduced to capacity + access) and
writes the two-way binding: pvc.spec.volumeName <- pv,
pv.claimRef <- pvc; released PVs whose claim is gone become Available
again (Recycle-lite).

Copy of kubernetes_tpu/controller/pv_binder.py: only the import package differs."""

from __future__ import annotations

import threading
from typing import List, Optional

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.api.resource import parse_quantity
from kubernetes_tpu_torch.client.rest import APIStatusError, RESTClient
from kubernetes_tpu_torch.controller.framework import PeriodicRunner, SharedInformerFactory


def _capacity(obj) -> int:
    cap = getattr(obj, "capacity", None) or {}
    return int(parse_quantity(cap.get("storage", 0)).value())


def _request(pvc: t.PersistentVolumeClaim) -> int:
    req = getattr(pvc, "requests", None) or {}
    return int(parse_quantity(req.get("storage", 0)).value())


class PersistentVolumeClaimBinder(PeriodicRunner):
    SYNC_PERIOD = 2.0
    THREAD_NAME = "pv-binder"
    def __init__(self, client: RESTClient, informers: SharedInformerFactory):
        self.client = client
        self.pv_informer = informers.informer("persistentvolumes")
        self.pvc_informer = informers.informer("persistentvolumeclaims")

    def sync_once(self) -> int:
        """One binding pass; returns bindings made."""
        pvs = self.pv_informer.store.list()
        # PVs already used — by live claimRef or by a bind made THIS pass
        # (the informer copy is stale until the watch catches up)
        used_pvs = {
            pv.metadata.name for pv in pvs if getattr(pv, "claim_ref", "")
        }
        bound = 0
        for pvc in self.pvc_informer.store.list():
            if pvc.volume_name:
                continue
            key = f"{pvc.metadata.namespace}/{pvc.metadata.name}"
            # candidates: unclaimed PVs with enough capacity, smallest fit
            # first (the reference's matchVolume order)
            candidates = sorted(
                (
                    pv
                    for pv in pvs
                    if pv.metadata.name not in used_pvs
                    and _capacity(pv) >= _request(pvc)
                ),
                key=_capacity,
            )
            if not candidates:
                continue
            pv = candidates[0]
            try:
                live_pv = self.client.resource("persistentvolumes").get(
                    pv.metadata.name
                )
                if live_pv.claim_ref:
                    used_pvs.add(pv.metadata.name)
                    continue
                live_pv.claim_ref = key
                self.client.resource("persistentvolumes").update(live_pv)
                pvc_client = self.client.resource(
                    "persistentvolumeclaims", pvc.metadata.namespace
                )
                live_pvc = pvc_client.get(pvc.metadata.name)
                live_pvc.volume_name = pv.metadata.name
                pvc_client.update(live_pvc)
                used_pvs.add(pv.metadata.name)
                bound += 1
            except APIStatusError:
                continue
        # release PVs whose claim disappeared
        pvc_keys = {
            f"{c.metadata.namespace}/{c.metadata.name}"
            for c in self.pvc_informer.store.list()
        }
        for pv in pvs:
            ref = getattr(pv, "claim_ref", "")
            if ref and ref not in pvc_keys:
                try:
                    live = self.client.resource("persistentvolumes").get(
                        pv.metadata.name
                    )
                    live.claim_ref = ""
                    self.client.resource("persistentvolumes").update(live)
                except APIStatusError:
                    pass
        return bound

