"""Volume predicate compilation: volumes -> bitset programs.

Three reference predicates read pod/PV volume structure
(plugin/pkg/scheduler/algorithm/predicates/predicates.go):

- **NoDiskConflict** (:105, isVolumeConflict :64-95): a pending pod's
  GCE-PD / AWS-EBS / RBD volumes may not clash with volumes of pods on
  the node. Compiled to "conflict units": EBS volume ids and RBD
  (pool, image, monitor) triples conflict on any shared use; GCE PDs
  conflict unless BOTH uses are read-only. Each node carries two u32
  bitsets — `vol_any` (every use) and `vol_rw` (writable uses) — and a
  pod conflicts iff `(pod_rw & any) | (pod_ro & rw)` is non-zero, where
  pod_ro holds only its read-only GCE mounts. RBD monitor-set overlap
  with equal pool+image is exactly "shares a (pool, image, monitor)
  triple", so set intersection is exact, not approximate.

- **MaxEBSVolumeCount / MaxGCEPDVolumeCount** (:137-259): count DISTINCT
  attachable volumes per node (direct + resolved through PVC->PV). Node
  bitset per kind; fits iff popcount(node) + popcount(pod & ~node) <= max.
  PVC/PV resolution failures mark the pod (fails everywhere, like the
  reference's error return) or the node (existing-pod resolution error).

- **NoVolumeZoneConflict** (:271-347): every zone/region label on a
  PV bound to the pod must equal the node's corresponding label value
  (missing node key compares as ""). Values are dictionary-encoded; a
  pod with conflicting/unresolvable requirements fails exactly on nodes
  that carry at least one zone/region label, like the reference.

Copy of kubernetes_tpu/snapshot/volumes.py: only the import package differs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.oracle.predicates import (
    LABEL_ZONE_FAILURE_DOMAIN,
    LABEL_ZONE_REGION,
)
from kubernetes_tpu_torch.oracle.state import ClusterState


def _words(n: int) -> int:
    return max(1, (n + 31) // 32)


def _pack(ids, words) -> np.ndarray:
    out = np.zeros((words,), np.uint32)
    for i in ids:
        out[i // 32] |= np.uint32(1) << np.uint32(i % 32)
    return out


@dataclass
class VolumeProgram:
    # node-side (initial carry unless noted static)
    vol_any: np.ndarray  # u32 (N, VW)
    vol_rw: np.ndarray  # u32 (N, VW)
    ebs_mask: np.ndarray  # u32 (N, EW)
    gce_mask: np.ndarray  # u32 (N, GW)
    ebs_bad: np.ndarray  # bool (N,) static
    gce_bad: np.ndarray  # bool (N,) static
    vz_zone: np.ndarray  # i32 (N,) static — value id ('' when missing)
    vz_region: np.ndarray  # i32 (N,) static
    vz_has: np.ndarray  # bool (N,) static — any zone/region label present
    # pod-side
    p_vol_rw: np.ndarray  # u32 (P, VW)
    p_vol_ro: np.ndarray  # u32 (P, VW) — read-only GCE mounts
    p_ebs: np.ndarray  # u32 (P, EW)
    p_gce: np.ndarray  # u32 (P, GW)
    p_ebs_bad: np.ndarray  # bool (P,)
    p_gce_bad: np.ndarray  # bool (P,)
    p_has_ebs: np.ndarray  # bool (P,)
    p_has_gce: np.ndarray  # bool (P,)
    p_vz_zone: np.ndarray  # i32 (P,), -1 unconstrained
    p_vz_region: np.ndarray  # i32 (P,)
    p_vz_fail: np.ndarray  # bool (P,) — unresolvable/conflicting reqs


class _Vocab:
    def __init__(self):
        self.ids: Dict[object, int] = {}

    def get(self, key) -> int:
        i = self.ids.get(key)
        if i is None:
            i = len(self.ids)
            self.ids[key] = i
        return i

    def __len__(self):
        return len(self.ids)


class VolumeCompiler:
    """Compiles the volume predicates' node and pod programs.

    Deviation from kubernetes_tpu/snapshot/volumes.py VolumeCompiler:
    compile builds the node side column by column, packing each field once
    in place of four bit packs and nine numpy writes a node, and skips an
    assigned pod with no volumes, whose conflict units and filtered ids are
    empty; volume_pods counts the assigned pods it visited. The same arrays
    and vocabulary ids."""

    def __init__(self, state: ClusterState, pods: Sequence[Pod], node_names):
        self.state = state
        self.pods = list(pods)
        self.node_names = list(node_names)
        self.conflict = _Vocab()  # ('gce', pd) | ('ebs', id) | ('rbd', pool, image, mon)
        self.ebs = _Vocab()
        self.gce = _Vocab()
        self.vzval = _Vocab()
        self.vzval.get("")  # id 0 == missing/empty

    # -- per-pod extraction ---------------------------------------------------

    def _conflict_units(self, pod: Pod) -> Tuple[List[int], List[int]]:
        """(rw_ids, ro_ids) — ro is read-only GCE only (predicates.go:72)."""
        rw, ro = [], []
        for v in pod.spec.volumes:
            if v.gce_persistent_disk is not None:
                u = self.conflict.get(("gce", v.gce_persistent_disk.pd_name))
                (ro if v.gce_persistent_disk.read_only else rw).append(u)
            if v.aws_elastic_block_store is not None:
                rw.append(self.conflict.get(("ebs", v.aws_elastic_block_store.volume_id)))
            if v.rbd is not None:
                for mon in v.rbd.monitors:
                    rw.append(
                        self.conflict.get(("rbd", v.rbd.pool, v.rbd.image, mon))
                    )
        return rw, ro

    def _filter_ids(self, pod: Pod, kind: str, vocab: _Vocab) -> List[int]:
        """predicates.go:148-179 filterVolumes; raises ValueError exactly
        where the reference errors (the oracle mirrors this too)."""
        out = []
        for v in pod.spec.volumes:
            if kind == "ebs" and v.aws_elastic_block_store is not None:
                out.append(vocab.get(("d", v.aws_elastic_block_store.volume_id)))
            elif kind == "gce-pd" and v.gce_persistent_disk is not None:
                out.append(vocab.get(("d", v.gce_persistent_disk.pd_name)))
            elif v.persistent_volume_claim is not None:
                pvc_name = v.persistent_volume_claim.claim_name
                if not pvc_name:
                    raise ValueError("PersistentVolumeClaim had no name")
                pvc = self.state.pvcs.get((pod.namespace, pvc_name))
                if pvc is None:
                    raise ValueError(f"PVC not found: {pvc_name}")
                if not pvc.volume_name:
                    raise ValueError(f"PVC is not bound: {pvc_name}")
                pv = self.state.pvs.get(pvc.volume_name)
                if pv is None:
                    raise ValueError(f"PV not found: {pvc.volume_name}")
                if kind == "ebs" and pv.aws_elastic_block_store is not None:
                    out.append(vocab.get(("d", pv.aws_elastic_block_store.volume_id)))
                elif kind == "gce-pd" and pv.gce_persistent_disk is not None:
                    out.append(vocab.get(("d", pv.gce_persistent_disk.pd_name)))
        return out

    def _vz_reqs(self, pod: Pod):
        """(zone_vid, region_vid, fail) from PV labels (predicates.go:302-344).
        -1 == unconstrained."""
        zone = region = -1
        for v in pod.spec.volumes:
            if v.persistent_volume_claim is None:
                continue
            pvc_name = v.persistent_volume_claim.claim_name
            if not pvc_name:
                return -1, -1, True
            pvc = self.state.pvcs.get((pod.namespace, pvc_name))
            if pvc is None or not pvc.volume_name:
                return -1, -1, True
            pv = self.state.pvs.get(pvc.volume_name)
            if pv is None:
                return -1, -1, True
            for k, val in pv.metadata.labels.items():
                vid = self.vzval.get(val)
                if k == LABEL_ZONE_FAILURE_DOMAIN:
                    if zone >= 0 and zone != vid:
                        return -1, -1, True  # conflicting reqs never match
                    zone = vid
                elif k == LABEL_ZONE_REGION:
                    if region >= 0 and region != vid:
                        return -1, -1, True
                    region = vid
        return zone, region, False

    # -- compilation ----------------------------------------------------------

    def compile(self) -> VolumeProgram:
        """The volume program. The node pass appends (row, id) pairs and
        the zone/region columns to plain lists, then packs each field once;
        self.volume_pods counts the assigned pods with volumes it visited."""
        state, pods = self.state, self.pods
        N, P = len(self.node_names), len(pods)
        # pass 1: visit everything so vocab widths are final
        per_pod = []
        for pod in pods:
            rw, ro = self._conflict_units(pod)
            try:
                ebs_ids, ebs_bad = self._filter_ids(pod, "ebs", self.ebs), False
            except ValueError:
                ebs_ids, ebs_bad = [], True
            try:
                gce_ids, gce_bad = self._filter_ids(pod, "gce-pd", self.gce), False
            except ValueError:
                gce_ids, gce_bad = [], True
            vz = self._vz_reqs(pod)
            per_pod.append((rw, ro, ebs_ids, ebs_bad, gce_ids, gce_bad, vz))
        # the node side as (row, id) pairs and one (zone, region, has)
        # triple a node
        rw_at, any_at, ebs_at, gce_at = [], [], [], []
        ebs_bad_rows, gce_bad_rows = [], []
        node_vz = []
        vz_ids = self.vzval.ids
        self.volume_pods = 0
        for n, name in enumerate(self.node_names):
            info = state.node_infos[name]
            for ep in info.pods:
                if not ep.spec.volumes:
                    continue
                self.volume_pods += 1
                rw, ro = self._conflict_units(ep)
                rw_at.extend((n, u) for u in rw)
                any_at.extend((n, u) for u in rw + ro)
                try:
                    ebs_at.extend(
                        (n, u) for u in self._filter_ids(ep, "ebs", self.ebs))
                except ValueError:
                    ebs_bad_rows.append(n)
                try:
                    gce_at.extend(
                        (n, u) for u in self._filter_ids(ep, "gce-pd", self.gce))
                except ValueError:
                    gce_bad_rows.append(n)
            zl = info.node.metadata.labels
            zone = zl.get(LABEL_ZONE_FAILURE_DOMAIN, "")
            z = vz_ids.get(zone)
            if z is None:
                z = self.vzval.get(zone)
            region = zl.get(LABEL_ZONE_REGION, "")
            r = vz_ids.get(region)
            if r is None:
                r = self.vzval.get(region)
            node_vz.append((
                z, r, LABEL_ZONE_FAILURE_DOMAIN in zl or LABEL_ZONE_REGION in zl
            ))

        def bits(pairs, words) -> np.ndarray:
            out = np.zeros((N, words), np.uint32)
            if pairs:
                a = np.array(pairs, np.intp)
                np.bitwise_or.at(
                    out, (a[:, 0], a[:, 1] >> 5),
                    np.left_shift(np.uint32(1), (a[:, 1] & 31).astype(np.uint32)),
                )
            return out

        VW, EW, GW = _words(len(self.conflict)), _words(len(self.ebs)), _words(len(self.gce))
        vz = np.array(node_vz, np.int64).reshape(N, 3)
        ebs_bad = np.zeros(N, bool)
        ebs_bad[ebs_bad_rows] = True
        gce_bad = np.zeros(N, bool)
        gce_bad[gce_bad_rows] = True
        prog = VolumeProgram(
            vol_any=bits(any_at, VW),
            vol_rw=bits(rw_at, VW),
            ebs_mask=bits(ebs_at, EW),
            gce_mask=bits(gce_at, GW),
            ebs_bad=ebs_bad,
            gce_bad=gce_bad,
            vz_zone=vz[:, 0].astype(np.int32),
            vz_region=vz[:, 1].astype(np.int32),
            vz_has=vz[:, 2].astype(bool),
            p_vol_rw=np.zeros((P, VW), np.uint32),
            p_vol_ro=np.zeros((P, VW), np.uint32),
            p_ebs=np.zeros((P, EW), np.uint32),
            p_gce=np.zeros((P, GW), np.uint32),
            p_ebs_bad=np.zeros(P, bool),
            p_gce_bad=np.zeros(P, bool),
            p_has_ebs=np.zeros(P, bool),
            p_has_gce=np.zeros(P, bool),
            p_vz_zone=np.full(P, -1, np.int32),
            p_vz_region=np.full(P, -1, np.int32),
            p_vz_fail=np.zeros(P, bool),
        )
        for i, (rw, ro, ebs_ids, eb, gce_ids, gb, (vzz, vzr, vzf)) in enumerate(
            per_pod
        ):
            prog.p_vol_rw[i] = _pack(rw, VW)
            prog.p_vol_ro[i] = _pack(ro, VW)
            prog.p_ebs[i] = _pack(ebs_ids, EW)
            prog.p_gce[i] = _pack(gce_ids, GW)
            prog.p_ebs_bad[i], prog.p_gce_bad[i] = eb, gb
            # "has new volumes": gates the existing-filter stage; the
            # reference's early return (predicates.go:316) fires before the
            # node's pods are ever filtered
            prog.p_has_ebs[i] = bool(ebs_ids)
            prog.p_has_gce[i] = bool(gce_ids)
            prog.p_vz_zone[i], prog.p_vz_region[i], prog.p_vz_fail[i] = vzz, vzr, vzf
        return prog
