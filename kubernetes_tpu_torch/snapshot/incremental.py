"""Incremental snapshot maintenance: O(event) columnar updates.

The reference never re-derives cluster state per scheduling cycle — the
scheduler cache applies O(1) NodeInfo deltas per watch event
(schedulercache/node_info.go:118-156) and the per-cycle snapshot is a
clone, not a rebuild (cache.go:77). Round 1 of this framework re-encoded
the whole cluster into columnar arrays every wave (O(cluster)); this
module restores the reference's cost model at the array level:

  * `IncrementalEncoder` subscribes to SchedulerCache mutations
    (cache.add_listener) and patches the node-axis arrays in place —
    O(changed rows) per event, never O(cluster) per wave.
  * Vocabularies live in a persistent `VocabBundle`, append-only, so ids
    agree across waves; per-wave pending pods are encoded by a plain
    SnapshotEncoder sharing the bundle with `visit_state=False`
    (O(backlog), not O(cluster)).
  * Bitset widths / class columns grow by column-padding when a vocab
    crosses a word boundary (O(N) once, amortized nil).
  * Node slots are stable: removed nodes free their slot (zeroed
    allocatable => never fit, exactly like pad.py's dummy nodes) and new
    nodes reuse free slots. Decisions depend on the name-desc order, not
    slot order, so slot assignment is invisible to scheduling.

Scope gates (wave_view returns ok=False and the caller falls back to the
from-scratch SnapshotEncoder — correctness is never at stake, only
cost): any pod-affinity/anti-affinity in the cluster or wave (the
inter-pod program's topology tables are global), volumes on wave pods,
a Policy using ServiceAffinity/AntiAffinity, or a config without
GeneralPredicates (free slots are masked via zeroed allocatable, which
needs the resource predicate active).

tests/test_incremental.py drives randomized event streams and proves
snapshot-after-deltas == snapshot-from-scratch, both semantically
(decoded per-node views) and end-to-end (identical decisions).

Copy of kubernetes_tpu/snapshot/incremental.py: only the import package differs.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kubernetes_tpu_torch.api.types import (
    AFFINITY_ANNOTATION,
    Node,
    Pod,
    get_affinity,
    get_taints,
    pod_nonzero_request,
)
from kubernetes_tpu_torch.oracle.priorities import get_zone_key
from kubernetes_tpu_torch.oracle.state import ClusterState, _calculate_resource
from kubernetes_tpu_torch.snapshot.encode import (
    ClusterSnapshot,
    PodBatch,
    SnapshotEncoder,
    VocabBundle,
    _pack_bits,
    _words,
    build_set_table,
    service_config_labels,
)
from kubernetes_tpu_torch.api.resource import (
    parse_quantity,
    resource_list_cpu_milli,
    resource_list_memory,
)


def _has_pod_affinity(pod: Pod) -> bool:
    """True when this pod contributes to (or poisons) the inter-pod
    affinity program — the global-coupling gate."""
    if pod.spec.affinity is None and AFFINITY_ANNOTATION not in pod.metadata.annotations:
        return False
    try:
        aff = get_affinity(pod)
    except Exception:
        return True  # malformed annotation == poison (encoder marks it)
    return aff is not None and (
        aff.pod_affinity is not None or aff.pod_anti_affinity is not None
    )


class _PodContribution:
    """Exactly what one assigned pod added to its node's row — recorded
    at add time so removal is a perfect inverse (no re-parse drift)."""

    __slots__ = ("slot", "cpu", "mem", "gpu", "nzcpu", "nzmem", "ports",
                 "class_id", "affinity")

    def __init__(self, slot, cpu, mem, gpu, nzcpu, nzmem, ports, class_id,
                 affinity):
        self.slot = slot
        self.cpu = cpu
        self.mem = mem
        self.gpu = gpu
        self.nzcpu = nzcpu
        self.nzmem = nzmem
        self.ports = ports  # list of port ids
        self.class_id = class_id
        self.affinity = affinity


def _grow_cols(a: np.ndarray, cols: int) -> np.ndarray:
    if a.shape[1] >= cols:
        return a
    out = np.zeros((a.shape[0], cols), a.dtype)
    out[:, : a.shape[1]] = a
    return out


_SOURCE_COUNTER = itertools.count()


class IncrementalEncoder:
    """Maintains node-axis snapshot arrays from cache events."""

    def __init__(self, config=None, initial_slots: int = 64):
        self.config = config
        # unique device-cache provenance token: vocab bit/slot
        # assignments are encoder-local, so a consumer's cached device
        # arrays must never outlive the encoder that produced them
        # (a monotonic counter — id() reuses freed addresses)
        self.source_token = f"inc:{next(_SOURCE_COUNTER)}"
        self.vocabs = VocabBundle()
        self._lock = threading.Lock()
        self._events: List[Tuple[str, object]] = []
        # slot map
        self._cap = 0
        self.slot_of: Dict[str, int] = {}
        self._free: List[int] = []
        self.node_names: List[str] = []  # per slot; "" == free
        self._node_labels: List[Optional[Dict[str, str]]] = []
        self._node_images: List[Optional[Dict[str, int]]] = []
        self._schedulable = np.zeros(0, bool)
        self._node_gone = np.zeros(0, bool)  # node deleted, pods linger
        self._pod_count_slot = np.zeros(0, np.int64)
        # per-pod contributions
        self._contribs: Dict[Tuple[str, str], _PodContribution] = {}
        self._affinity_pods = 0  # cluster-wide gate counter
        # per-(slot) port id multiset
        self._port_counts: List[Optional[Dict[int, int]]] = []
        self._order_dirty = True
        self._name_desc: Optional[np.ndarray] = None
        self._alloc_raw = None  # (4, cap): mcpu, mem, gpu, pods
        # coarse dirty groups for device-residency (models/wave.py reuses
        # device arrays for clean groups between waves)
        self._dirty_node_side = True
        self._dirty_pod_side = True
        self._last_sets_len = -1
        self._last_img_vocab: Optional[tuple] = None
        self._grow(initial_slots)
        # column-capacity trackers
        self._lw = 1
        self._kw = 1
        self._pw = 1
        self._tw = 1
        self._tv = 1
        self._kg = 1
        self._c = 1

    # -- capacity ------------------------------------------------------------

    def _grow(self, cap: int) -> None:
        cap = max(cap, 1)
        if cap <= self._cap:
            return
        old = self._cap

        def g1(a, dtype, fill=0):
            out = np.full(cap, fill, dtype)
            if old:
                out[:old] = a
            return out

        def g2(a, w, dtype):
            out = np.zeros((cap, w), dtype)
            if old and a is not None:
                out[:old, : a.shape[1]] = a
            return out

        if old == 0:
            self.alloc_mcpu = np.zeros(cap, np.int64)
            self.alloc_mem = np.zeros(cap, np.int64)
            self.alloc_gpu = np.zeros(cap, np.int64)
            self.alloc_pods = np.zeros(cap, np.int64)
            self.req_mcpu = np.zeros(cap, np.int64)
            self.req_mem = np.zeros(cap, np.int64)
            self.req_gpu = np.zeros(cap, np.int64)
            self.nz_mcpu = np.zeros(cap, np.int64)
            self.nz_mem = np.zeros(cap, np.int64)
            self.pod_count = np.zeros(cap, np.int64)
            self.port_mask = np.zeros((cap, 1), np.uint32)
            self.label_kv = np.zeros((cap, 1), np.uint32)
            self.label_key = np.zeros((cap, 1), np.uint32)
            self.numval = np.full((cap, 1), np.nan, np.float64)
            self.taint_mask = np.zeros((cap, 1), np.uint32)
            self.taint_count = np.zeros((cap, 1), np.int32)
            self.has_taints = np.zeros(cap, bool)
            self.taint_bad = np.zeros(cap, bool)
            self.mem_pressure = np.zeros(cap, bool)
            self.zone_id = np.zeros(cap, np.int32)
            self.class_count = np.zeros((cap, 1), np.int64)
        else:
            for f in ("alloc_mcpu", "alloc_mem", "alloc_gpu", "alloc_pods",
                      "req_mcpu", "req_mem", "req_gpu", "nz_mcpu", "nz_mem",
                      "pod_count"):
                setattr(self, f, g1(getattr(self, f), np.int64))
            for f, dt in (("port_mask", np.uint32), ("label_kv", np.uint32),
                          ("label_key", np.uint32), ("taint_mask", np.uint32),
                          ("taint_count", np.int32),
                          ("class_count", np.int64)):
                a = getattr(self, f)
                setattr(self, f, g2(a, a.shape[1], dt))
            nv = np.full((cap, self.numval.shape[1]), np.nan, np.float64)
            nv[:old] = self.numval
            self.numval = nv
            for f in ("has_taints", "taint_bad", "mem_pressure"):
                setattr(self, f, g1(getattr(self, f), bool))
            self.zone_id = g1(self.zone_id, np.int32)
        self._schedulable = g1(self._schedulable, bool, False)
        self._node_gone = g1(self._node_gone, bool, False)
        self._pod_count_slot = g1(self._pod_count_slot, np.int64)
        self.node_names += [""] * (cap - old)
        self._node_labels += [None] * (cap - old)
        self._node_images += [None] * (cap - old)
        self._port_counts += [None] * (cap - old)
        self._free += list(range(cap - 1, old - 1, -1))
        self._cap = cap
        self._order_dirty = True
        self._dirty_node_side = True
        self._dirty_pod_side = True

    def _widths_sync(self) -> None:
        """Grow column capacity to match vocab sizes (amortized O(1))."""
        before = (
            self.label_kv.shape, self.label_key.shape, self.port_mask.shape,
            self.taint_mask.shape, self.taint_count.shape,
            self.class_count.shape, self.numval.shape,
        )
        self._widths_sync_inner()
        after = (
            self.label_kv.shape, self.label_key.shape, self.port_mask.shape,
            self.taint_mask.shape, self.taint_count.shape,
            self.class_count.shape, self.numval.shape,
        )
        if before != after:
            self._dirty_node_side = True
            self._dirty_pod_side = True

    def _widths_sync_inner(self) -> None:
        v = self.vocabs
        lw, kw, pw = _words(len(v.kv)), _words(len(v.keys)), _words(len(v.ports))
        tw, tv = _words(len(v.taints)), max(1, len(v.taints))
        kg, c = max(1, len(v.numkeys)), max(1, len(v.classes))
        if lw > self.label_kv.shape[1]:
            self.label_kv = _grow_cols(self.label_kv, lw)
        if kw > self.label_key.shape[1]:
            self.label_key = _grow_cols(self.label_key, kw)
        if pw > self.port_mask.shape[1]:
            self.port_mask = _grow_cols(self.port_mask, pw)
        if tw > self.taint_mask.shape[1]:
            self.taint_mask = _grow_cols(self.taint_mask, tw)
        if tv > self.taint_count.shape[1]:
            self.taint_count = _grow_cols(self.taint_count, tv)
        if c > self.class_count.shape[1]:
            self.class_count = _grow_cols(self.class_count, max(c, 2 * self.class_count.shape[1]))
        if kg > self.numval.shape[1]:
            # new Gt/Lt key: backfill the column from retained node labels
            old_cols = self.numval.shape[1]
            nv = np.full((self._cap, kg), np.nan, np.float64)
            nv[:, :old_cols] = self.numval
            self.numval = nv
            for k, col in self.vocabs.numkeys.ids.items():
                if col < old_cols:
                    continue
                for slot, labels in enumerate(self._node_labels):
                    if labels and k in labels:
                        try:
                            self.numval[slot, col] = float(labels[k])
                        except ValueError:
                            pass

    # -- cache listener ------------------------------------------------------

    def on_cache_event(self, kind: str, obj) -> None:
        """Called under the cache lock; just queue (apply at wave time)."""
        with self._lock:
            self._events.append((kind, obj))

    def _drain(self) -> List[Tuple[str, object]]:
        with self._lock:
            ev, self._events = self._events, []
            return ev

    # -- event application ---------------------------------------------------

    def _apply_node_set(self, node: Node) -> None:
        name = node.metadata.name
        slot = self.slot_of.get(name)
        if slot is None:
            if not self._free:
                self._grow(max(2 * self._cap, 64))
            slot = self._free.pop()
            self.slot_of[name] = slot
            self.node_names[slot] = name
            self._order_dirty = True
        v = self.vocabs
        labels = dict(node.metadata.labels)
        self._node_labels[slot] = labels
        for k, val in labels.items():
            v.keys.get(k)
            v.kv.get((k, val))
        try:
            taints = get_taints(node)
            self.taint_bad[slot] = False
        except Exception:
            taints = []
            self.taint_bad[slot] = True
        for t in taints:
            v.taints.get((t.key, t.value, t.effect))
        zone = get_zone_key(node)
        zid = v.zones.get(zone) if zone else 0
        self._widths_sync()
        # row refresh (node-owned fields only; pod aggregates untouched)
        alloc = node.status.allocatable
        self.alloc_mcpu[slot] = resource_list_cpu_milli(alloc)
        self.alloc_mem[slot] = resource_list_memory(alloc)
        self.alloc_gpu[slot] = parse_quantity(
            alloc.get("alpha.kubernetes.io/nvidia-gpu", 0)
        ).value()
        self.alloc_pods[slot] = parse_quantity(alloc.get("pods", 0)).value()
        lw, kw = self.label_kv.shape[1], self.label_key.shape[1]
        self.label_kv[slot] = _pack_bits(
            [v.kv.ids[(k, val)] for k, val in labels.items()], lw
        )
        self.label_key[slot] = _pack_bits(
            [v.keys.ids[k] for k in labels], kw
        )
        self.numval[slot, :] = np.nan
        for k, col in v.numkeys.ids.items():
            val = labels.get(k)
            if val is not None:
                try:
                    self.numval[slot, col] = float(val)
                except ValueError:
                    pass
        tw = self.taint_mask.shape[1]
        tids = [v.taints.ids[(t.key, t.value, t.effect)] for t in taints]
        self.taint_mask[slot] = _pack_bits(tids, tw)
        self.taint_count[slot, :] = 0
        for tid in tids:
            self.taint_count[slot, tid] += 1
        self.has_taints[slot] = bool(taints)
        self.mem_pressure[slot] = any(
            c.type == "MemoryPressure" and c.status == "True"
            for c in node.status.conditions
        )
        self.zone_id[slot] = zid
        imgs: Dict[str, int] = {}
        for img in node.status.images:
            for nm in img.names:
                if nm not in imgs:
                    imgs[nm] = img.size_bytes
        self._node_images[slot] = imgs
        from kubernetes_tpu_torch.scheduler.factory import node_schedulable

        self._schedulable[slot] = node_schedulable(node)
        self._node_gone[slot] = False

    def _free_slot(self, slot: int) -> None:
        name = self.node_names[slot]
        if name:
            del self.slot_of[name]
        self.node_names[slot] = ""
        self._node_labels[slot] = None
        self._node_images[slot] = None
        self._port_counts[slot] = None
        self._schedulable[slot] = False
        self._node_gone[slot] = False
        # zero the whole row: a freed slot behaves exactly like a pad.py
        # dummy node (zero allocatable => the resource predicate fails)
        for f in ("alloc_mcpu", "alloc_mem", "alloc_gpu", "alloc_pods",
                  "req_mcpu", "req_mem", "req_gpu", "nz_mcpu", "nz_mem",
                  "pod_count"):
            getattr(self, f)[slot] = 0
        self.port_mask[slot, :] = 0
        self.label_kv[slot, :] = 0
        self.label_key[slot, :] = 0
        self.numval[slot, :] = np.nan
        self.taint_mask[slot, :] = 0
        self.taint_count[slot, :] = 0
        self.has_taints[slot] = False
        self.taint_bad[slot] = False
        self.mem_pressure[slot] = False
        self.zone_id[slot] = 0
        self.class_count[slot, :] = 0
        self._free.append(slot)
        self._order_dirty = True
        self._dirty_node_side = True
        self._dirty_pod_side = True

    def _apply_node_remove(self, node: Node) -> None:
        slot = self.slot_of.get(node.metadata.name)
        if slot is None:
            return
        if self._pod_count_slot[slot] > 0:
            # pods still reference the node (cache.go:272): keep the row
            # but never schedule onto it (the reference's snapshot drops
            # node-less NodeInfos)
            self._node_gone[slot] = True
            self._schedulable[slot] = False
        else:
            self._free_slot(slot)

    def _slot_for_pod(self, name: str) -> int:
        slot = self.slot_of.get(name)
        if slot is None:
            # pod on an unknown node (cache tolerates it); materialize a
            # gone-node slot to hold the aggregates
            if not self._free:
                self._grow(max(2 * self._cap, 64))
            slot = self._free.pop()
            self.slot_of[name] = slot
            self.node_names[slot] = name
            self._node_labels[slot] = {}
            self._node_images[slot] = {}
            self._node_gone[slot] = True
            self._schedulable[slot] = False
            self._order_dirty = True
            # the slot's name changed, so name_desc_order (device-resident
            # between waves) must be re-shipped even though no node event
            # fired -- wave_view's keep is driven by this flag
            self._dirty_node_side = True
        return slot

    def _apply_pod_add(self, pod: Pod) -> None:
        key = (pod.namespace, pod.metadata.name)
        if key in self._contribs:
            self._apply_pod_remove(pod)  # defensive: treat as update
        v = self.vocabs
        slot = self._slot_for_pod(pod.spec.node_name)
        cpu, mem, gpu = _calculate_resource(pod)
        nzcpu, nzmem = pod_nonzero_request(pod)
        ports = []
        for c in pod.spec.containers:
            for p in c.ports:
                if p.host_port != 0:
                    ports.append(v.ports.get(p.host_port))
        class_key = (
            pod.namespace,
            frozenset(pod.metadata.labels.items()),
            pod.metadata.deletion_timestamp is not None,
        )
        class_id = v.classes.get(class_key)
        affinity = _has_pod_affinity(pod)
        self._widths_sync()
        contrib = _PodContribution(
            slot, cpu, mem, gpu, nzcpu, nzmem, ports, class_id, affinity
        )
        self._contribs[key] = contrib
        self.req_mcpu[slot] += cpu
        self.req_mem[slot] += mem
        self.req_gpu[slot] += gpu
        self.nz_mcpu[slot] += nzcpu
        self.nz_mem[slot] += nzmem
        self.pod_count[slot] += 1
        self._pod_count_slot[slot] += 1
        self.class_count[slot, class_id] += 1
        if ports:
            pc = self._port_counts[slot]
            if pc is None:
                pc = self._port_counts[slot] = {}
            for pid in ports:
                pc[pid] = pc.get(pid, 0) + 1
            self.port_mask[slot] = _pack_bits(
                list(pc), self.port_mask.shape[1]
            )
        if affinity:
            self._affinity_pods += 1

    def _apply_pod_remove(self, pod: Pod) -> None:
        key = (pod.namespace, pod.metadata.name)
        contrib = self._contribs.pop(key, None)
        if contrib is None:
            return
        slot = contrib.slot
        self.req_mcpu[slot] -= contrib.cpu
        self.req_mem[slot] -= contrib.mem
        self.req_gpu[slot] -= contrib.gpu
        self.nz_mcpu[slot] -= contrib.nzcpu
        self.nz_mem[slot] -= contrib.nzmem
        self.pod_count[slot] -= 1
        self._pod_count_slot[slot] -= 1
        self.class_count[slot, contrib.class_id] -= 1
        if contrib.ports:
            pc = self._port_counts[slot] or {}
            for pid in contrib.ports:
                n = pc.get(pid, 0) - 1
                if n <= 0:
                    pc.pop(pid, None)
                else:
                    pc[pid] = n
            self.port_mask[slot] = _pack_bits(
                list(pc), self.port_mask.shape[1]
            )
        if contrib.affinity:
            self._affinity_pods -= 1
        if self._node_gone[slot] and self._pod_count_slot[slot] == 0:
            self._free_slot(slot)

    def apply_pending(self) -> None:
        for kind, obj in self._drain():
            if kind == "pod_add":
                self._apply_pod_add(obj)
                self._dirty_pod_side = True
            elif kind == "pod_remove":
                self._apply_pod_remove(obj)
                self._dirty_pod_side = True
            elif kind == "node_set":
                self._apply_node_set(obj)
                self._dirty_node_side = True
            elif kind == "node_remove":
                self._apply_node_remove(obj)
                self._dirty_node_side = True
                self._dirty_pod_side = True

    # -- wave view -----------------------------------------------------------

    def _config_ok(self) -> bool:
        from kubernetes_tpu_torch.models.batch import wants_resources

        cfg = self.config
        if cfg is None:
            return True
        if not wants_resources(cfg):
            return False  # free slots are masked via zeroed allocatable
        if service_config_labels(cfg):
            return False  # SA/SAA programs need the full compiler
        return True

    # snapshot fields per dirty group, for device-array reuse between
    # waves (models/wave.py `keep` protocol)
    NODE_SIDE_FIELDS = frozenset({
        "alloc_mcpu", "alloc_mem", "alloc_gpu", "alloc_pods",
        "label_kv", "label_key", "numval", "taint_mask", "taint_count",
        "has_taints", "taint_bad", "mem_pressure", "zone_id",
        "name_desc_order", "noschedule_taints", "prefer_taints",
    })
    POD_SIDE_FIELDS = frozenset({
        "req_mcpu", "req_mem", "req_gpu", "nz_mcpu", "nz_mem",
        "pod_count", "port_mask", "class_count",
    })
    # deterministically empty under the wave gates: reusable by shape
    WAVE_CONST_FIELDS = frozenset({
        "ip_topo_dom", "ip_u_topo", "ip_u_spec", "ip_lt_spec", "ip_lt_u",
        "ip_lt_sign", "ip_term_count", "ip_own_anti", "ip_rev_hard",
        "ip_rev_pref", "ip_rev_anti", "ip_spec_total",
        "vol_any", "vol_rw", "ebs_mask", "gce_mask", "ebs_bad", "gce_bad",
        "vz_zone", "vz_region", "vz_has",
        "svc_lbl_val", "svc_node_ord", "svc_ord_node", "svc_first_peer",
        "svc_peer_node_count", "svc_peer_total",
    })

    def wave_view(
        self,
        pending: Sequence[Pod],
        services=(),
        controllers=(),
        replica_sets=(),
    ) -> Tuple[Optional[ClusterSnapshot], Optional[PodBatch], frozenset]:
        """Apply queued deltas and emit (snapshot, batch, keep) for this
        wave — `keep` names snapshot fields whose device copies from the
        previous wave are still valid — or (None, None, ø) when a scope
        gate forces the full encoder."""
        self.apply_pending()
        if self._affinity_pods > 0 or not self._config_ok():
            return None, None, frozenset()
        for p in pending:
            if p.spec.volumes or _has_pod_affinity(p):
                return None, None, frozenset()
        # encode pending pods against the shared vocabs; the light state
        # carries only the spread listers (no node scan)
        light = ClusterState(
            services=list(services),
            controllers=list(controllers),
            replica_sets=list(replica_sets),
        )
        enc = SnapshotEncoder(
            light, list(pending), config=self.config, vocabs=self.vocabs,
            visit_state=False, node_id=dict(self.slot_of),
        )
        batch = enc.encode_pods()
        self._widths_sync()
        keep = set(self.WAVE_CONST_FIELDS)
        if not self._dirty_node_side:
            keep |= self.NODE_SIDE_FIELDS
        if not self._dirty_pod_side:
            keep |= self.POD_SIDE_FIELDS
        if len(self.vocabs.set_members) == self._last_sets_len:
            keep.add("set_table")
        img_vocab = tuple(enc.images.ids)
        if img_vocab == self._last_img_vocab and not self._dirty_node_side:
            keep.add("img_size")
        self._dirty_node_side = False
        self._dirty_pod_side = False
        self._last_sets_len = len(self.vocabs.set_members)
        self._last_img_vocab = img_vocab
        snap = self._snapshot_arrays(enc)
        return snap, batch, frozenset(keep)

    def _snapshot_arrays(self, enc: SnapshotEncoder) -> ClusterSnapshot:
        v = self.vocabs
        w = enc.widths
        N = self._cap
        if self._order_dirty:
            self._name_desc = np.argsort(
                np.array(self.node_names, dtype=object), kind="stable"
            )[::-1].astype(np.int32)
            self._order_dirty = False
        # unschedulable/gone slots: zero allocatable == never fit, and
        # (being unfit) excluded from every normalizer — identical to the
        # reference's restricted snapshot dropping them
        live = self._schedulable
        alloc_mcpu = np.where(live, self.alloc_mcpu, 0)
        alloc_mem = np.where(live, self.alloc_mem, 0)
        alloc_gpu = np.where(live, self.alloc_gpu, 0)
        alloc_pods = np.where(live, self.alloc_pods, 0)

        def cut(a, cols):
            return a[:, :cols] if a.shape[1] != cols else a

        img_names = list(enc.images.ids)
        img_size = np.zeros((N, len(img_names)), np.int64)
        for j, nm in enumerate(img_names):
            for slot, imgs in enumerate(self._node_images):
                if imgs:
                    sz = imgs.get(nm)
                    if sz:
                        img_size[slot, j] = sz
        empty_i32 = np.zeros(0, np.int32)
        return ClusterSnapshot(
            node_names=list(self.node_names),
            alloc_mcpu=alloc_mcpu,
            alloc_mem=alloc_mem,
            alloc_gpu=alloc_gpu,
            alloc_pods=alloc_pods,
            req_mcpu=self.req_mcpu.copy(),
            req_mem=self.req_mem.copy(),
            req_gpu=self.req_gpu.copy(),
            nz_mcpu=self.nz_mcpu.copy(),
            nz_mem=self.nz_mem.copy(),
            pod_count=self.pod_count.copy(),
            port_mask=cut(self.port_mask, w["PW"]).copy(),
            label_kv=cut(self.label_kv, w["LW"]),
            label_key=cut(self.label_key, w["KW"]),
            numval=cut(self.numval, w["KG"]),
            taint_mask=cut(self.taint_mask, w["TW"]),
            taint_count=cut(self.taint_count, w["TV"]),
            has_taints=self.has_taints,
            taint_bad=self.taint_bad,
            mem_pressure=self.mem_pressure,
            zone_id=self.zone_id,
            class_count=cut(self.class_count, w["C"]).copy(),
            name_desc_order=self._name_desc,
            set_table=build_set_table(
                v.set_members, v.kv.ids, w["LW"]
            ),
            noschedule_taints=self._taint_effect_mask("NoSchedule", w["TW"]),
            prefer_taints=self._taint_effect_mask("PreferNoSchedule", w["TW"]),
            ip_topo_dom=enc.interpod.topo_dom,
            ip_u_topo=enc.interpod.u_topo,
            ip_u_spec=enc.interpod.u_spec,
            ip_lt_spec=enc.interpod.lt_spec,
            ip_lt_u=enc.interpod.lt_u,
            ip_lt_sign=enc.interpod.lt_sign,
            ip_term_count=enc.interpod.term_count,
            ip_own_anti=enc.interpod.own_anti,
            ip_rev_hard=enc.interpod.rev_hard,
            ip_rev_pref=enc.interpod.rev_pref,
            ip_rev_anti=enc.interpod.rev_anti,
            ip_spec_total=enc.interpod.spec_total,
            # wave pods carry no volumes (gate), so the node-side volume
            # state is vacuous — but the arrays must still be node-axis
            # shaped for the predicate ops (the light compiler saw zero
            # nodes). Widths follow the pod-side masks.
            vol_any=np.zeros((N, enc.volumes.p_vol_rw.shape[1]), np.uint32),
            vol_rw=np.zeros((N, enc.volumes.p_vol_rw.shape[1]), np.uint32),
            ebs_mask=np.zeros((N, enc.volumes.p_ebs.shape[1]), np.uint32),
            gce_mask=np.zeros((N, enc.volumes.p_gce.shape[1]), np.uint32),
            ebs_bad=np.zeros(N, bool),
            gce_bad=np.zeros(N, bool),
            vz_zone=np.zeros(N, np.int32),
            vz_region=np.zeros(N, np.int32),
            vz_has=np.zeros(N, bool),
            img_size=img_size,
            key_ids=dict(v.keys.ids),
            svc_lbl_val=enc.services_program.lbl_val,
            svc_node_ord=enc.services_program.node_ord,
            svc_ord_node=enc.services_program.ord_node,
            svc_first_peer=enc.services_program.first_peer,
            svc_peer_node_count=enc.services_program.peer_node_count,
            svc_peer_total=enc.services_program.peer_total,
            svc_labels=enc.services_program.labels,
            svc_num_values=0,
        )

    def _taint_effect_mask(self, effect: str, tw: int) -> np.ndarray:
        return _pack_bits(
            [
                tid
                for (k, val, eff), tid in self.vocabs.taints.ids.items()
                if eff == effect
            ],
            tw,
        )
