"""Host-side snapshot encoder: objects -> columnar device arrays.

This is the analogue of the reference's snapshot step
(schedulercache/cache.go:77 GetNodeNameToInfoMap) plus a compilation pass
that turns every string-typed construct (labels, selectors, taints, host
ports, node names) into dictionary ids and uint32 bitsets, so the entire
predicate/priority computation can run as masked integer tensor ops.

Selector compilation (SURVEY.md §7 hard-part 3): a label requirement
(key, op, values) becomes (op_code, key_id, value_set_id, numeric operand);
the node side carries `label_kv` / `label_key` bitsets and a float64
sidecar for Gt/Lt keys. Matching a requirement is then 2-4 bitwise ops per
(pod, node) pair, with k8s's exact key-absence semantics preserved
(pkg/labels/selector.go:163-203).

Copy of kubernetes_tpu/snapshot/encode.py: only the import package differs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kubernetes_tpu_torch.api import labels as labelpkg
from kubernetes_tpu_torch.api.types import (
    Affinity,
    Container,
    Node,
    NodeSelectorRequirement,
    Pod,
    get_affinity,
    get_taints,
    get_tolerations,
    pod_nonzero_request,
    pod_resource_request,
)
from kubernetes_tpu_torch.api.resource import parse_quantity, resource_list_cpu_milli, resource_list_memory
from kubernetes_tpu_torch.api.types import Taint
from kubernetes_tpu_torch.oracle.predicates import (
    _requirement_valid,
    get_pod_controllers,
    get_pod_replica_sets,
    get_pod_services,
    is_pod_best_effort,
    label_selector_as_selector,
    taint_tolerated_by_tolerations,
)
from kubernetes_tpu_torch.oracle.priorities import get_zone_key
from kubernetes_tpu_torch.oracle.state import ClusterState, _calculate_resource

# requirement op codes (device-side)
OP_PAD = 0  # always passes (padding inside a term)
OP_IN = 1
OP_NOT_IN = 2
OP_EXISTS = 3
OP_NOT_EXISTS = 4
OP_GT = 5
OP_LT = 6
OP_FAIL = 7  # always fails (parse error / empty term)

_OP_BY_NAME = {
    "In": OP_IN,
    "NotIn": OP_NOT_IN,
    "Exists": OP_EXISTS,
    "DoesNotExist": OP_NOT_EXISTS,
    "Gt": OP_GT,
    "Lt": OP_LT,
}


def service_config_labels(config) -> Tuple[str, ...]:
    """The node-label set a SchedulerConfig's ServiceAffinity /
    ServiceAntiAffinity entries need, in deterministic order (the scan
    body recomputes this mapping from the config alone)."""
    labels = []
    for e in getattr(config, "predicates", ()):
        if isinstance(e, tuple) and e[0] == "ServiceAffinity":
            labels.extend(e[1])
    for name, _w in getattr(config, "priorities", ()):
        if isinstance(name, tuple) and name[0] == "ServiceAntiAffinity":
            labels.append(name[1])
    return tuple(dict.fromkeys(labels))


def pod_feature_key(pod: Pod) -> tuple:
    """Structural scheduling identity: two pods with equal keys encode to
    identical PodBatch rows (property fuzzed in tests/test_wave.py), so a
    backlog run of equal-key pods — the shape every RC/RS/Job template
    produces — can take the wave fast path (models/wave.py).

    Covers every pod field the encoder (and the interpod/volume/service
    compilers) read. The name is deliberately absent: predicates,
    priorities and selectHost never consult it for the pending pod."""

    # This runs once per backlog pod (50k+ at the north-star config), so
    # the implementation avoids generator/sort overhead for the common
    # shapes: 0-2 entry dicts, string-valued resource requests.

    def _d(d: dict) -> tuple:
        if not d:
            return ()
        items = list(d.items())
        if len(items) > 1:
            items.sort()
        return tuple(items)

    def _rq(d: dict) -> tuple:
        if not d:
            return ()
        items = [(k, v if type(v) is str else str(v)) for k, v in d.items()]
        if len(items) > 1:
            items.sort()
        return tuple(items)

    def _cont(c: Container) -> tuple:
        return (
            c.image,
            _rq(c.requests),
            _rq(c.limits) if c.limits else (),
            tuple((p.host_port, p.container_port, p.protocol) for p in c.ports)
            if c.ports else (),
        )

    m = pod.metadata
    spec = pod.spec
    conts = spec.containers
    return (
        pod.namespace,
        _d(m.labels) if m.labels else (),
        _d(m.annotations) if m.annotations else (),
        m.deletion_timestamp is not None,
        spec.node_name,
        _d(spec.node_selector) if spec.node_selector else (),
        (_cont(conts[0]),) if len(conts) == 1
        else tuple(_cont(c) for c in conts),
        tuple(_cont(c) for c in spec.init_containers)
        if spec.init_containers else (),
        repr(spec.affinity) if spec.affinity is not None else None,
        repr(spec.tolerations) if spec.tolerations is not None else None,
        repr(spec.volumes) if spec.volumes else None,
    )


def _pack_bits(ids: Sequence[int], words: int) -> np.ndarray:
    out = np.zeros((words,), dtype=np.uint32)
    for i in ids:
        out[i // 32] |= np.uint32(1) << np.uint32(i % 32)
    return out


def _words(n: int) -> int:
    return max(1, (n + 31) // 32)


class _Dict:
    """Monotone string->id dictionary."""

    def __init__(self):
        self.ids: Dict[object, int] = {}

    def get(self, key, add=True) -> int:
        i = self.ids.get(key)
        if i is None:
            if not add:
                return -1
            i = len(self.ids)
            self.ids[key] = i
        return i

    def __len__(self):
        return len(self.ids)


class VocabBundle:
    """The append-only vocabularies a SnapshotEncoder interns into.

    Normally private to one encoder; the incremental snapshot
    (snapshot/incremental.py) owns a persistent bundle so per-wave
    pod encodes and the long-lived node arrays agree on ids."""

    def __init__(self):
        self.ports = _Dict()
        self.kv = _Dict()  # (key, value) pairs
        self.keys = _Dict()  # label keys
        self.numkeys = _Dict()  # keys used by Gt/Lt
        self.taints = _Dict()  # (key, value, effect)
        self.zones = _Dict()
        self.zones.get("")  # id 0 == no zone
        self.classes = _Dict()  # (ns, frozenset(labels.items()), deleted)
        self.sets: Dict[frozenset, int] = {}
        self.set_members: List[frozenset] = []


def build_set_table(set_members, kv_ids, lw: int) -> np.ndarray:
    """Requirement value-sets as kv-bitmask rows (shared by the full
    encoder and the incremental per-wave view)."""
    out = np.zeros((max(1, len(set_members)), lw), np.uint32)
    for idx, fs in enumerate(set_members):
        out[idx] = _pack_bits([kv_ids[kv] for kv in fs], lw)
    return out


#: snapshot fields that seed the scheduler carry's stacked resource
#: block, in initial_carry row order (models/batch stacks them; the
#: mesh resident state mirrors them host-side across waves)
RES_CARRY_FIELDS = ("req_mcpu", "req_mem", "req_gpu", "nz_mcpu",
                    "nz_mem", "pod_count")


@dataclass
class ClusterSnapshot:
    """Node-axis arrays + vocabulary tables (numpy, host-resident; the
    batch scheduler ships them to device once per wave)."""

    node_names: List[str]
    # resources
    alloc_mcpu: np.ndarray  # i64[N]
    alloc_mem: np.ndarray  # i64[N]
    alloc_gpu: np.ndarray  # i64[N]
    alloc_pods: np.ndarray  # i64[N]
    req_mcpu: np.ndarray  # i64[N]
    req_mem: np.ndarray
    req_gpu: np.ndarray
    nz_mcpu: np.ndarray
    nz_mem: np.ndarray
    pod_count: np.ndarray  # i64[N]
    # ports / labels / taints
    port_mask: np.ndarray  # u32[N, PW]
    label_kv: np.ndarray  # u32[N, LW]
    label_key: np.ndarray  # u32[N, KW]
    numval: np.ndarray  # f64[N, KG]
    taint_mask: np.ndarray  # u32[N, TW]
    # per-(node, taint-id) multiplicity: nodes can carry duplicate taints
    # and the taint-toleration priority counts per-list, not per-set
    taint_count: np.ndarray  # i32[N, TV]
    has_taints: np.ndarray  # bool[N]
    taint_bad: np.ndarray  # bool[N]: malformed taints annotation => unfit
    mem_pressure: np.ndarray  # bool[N]
    zone_id: np.ndarray  # i32[N], 0 == no zone
    # per-(node, pod-class) counts
    class_count: np.ndarray  # i64[N, C]
    # tie-break order: node indices sorted by name DESCENDING
    name_desc_order: np.ndarray  # i32[N]
    # vocab tables
    set_table: np.ndarray  # u32[S, LW]
    noschedule_taints: np.ndarray  # u32[TW]
    prefer_taints: np.ndarray  # u32[TW]
    # inter-pod affinity program (snapshot/interpod.py). topo_dom is
    # node-axis; the *_count/*_w tables are the INITIAL CARRY for the scan.
    ip_topo_dom: Optional[np.ndarray] = None  # i32[Q, N]
    ip_u_topo: Optional[np.ndarray] = None  # i32[U]
    ip_u_spec: Optional[np.ndarray] = None  # i32[U]
    ip_lt_spec: Optional[np.ndarray] = None  # i32[LT]
    ip_lt_u: Optional[np.ndarray] = None  # i32[LT, E]
    ip_lt_sign: Optional[np.ndarray] = None  # i8[LT, E]
    ip_term_count: Optional[np.ndarray] = None  # i32[U, D]
    ip_own_anti: Optional[np.ndarray] = None  # i32[LT, E, D]
    ip_rev_hard: Optional[np.ndarray] = None  # i32[LT, E, D]
    ip_rev_pref: Optional[np.ndarray] = None  # i64[LT, E, D]
    ip_rev_anti: Optional[np.ndarray] = None  # i64[LT, E, D]
    ip_spec_total: Optional[np.ndarray] = None  # i32[S]
    # volume predicate program (snapshot/volumes.py). The four masks are
    # initial carry; bad/zone arrays are static.
    vol_any: Optional[np.ndarray] = None  # u32[N, VW] carry
    vol_rw: Optional[np.ndarray] = None  # u32[N, VW] carry
    ebs_mask: Optional[np.ndarray] = None  # u32[N, EW] carry
    gce_mask: Optional[np.ndarray] = None  # u32[N, GW] carry
    ebs_bad: Optional[np.ndarray] = None  # bool[N]
    gce_bad: Optional[np.ndarray] = None  # bool[N]
    vz_zone: Optional[np.ndarray] = None  # i32[N]
    vz_region: Optional[np.ndarray] = None  # i32[N]
    vz_has: Optional[np.ndarray] = None  # bool[N]
    # ImageLocalityPriority (priorities.go:149): per-node byte size of each
    # pending-pod container image (first status.images entry whose names
    # contain it, priorities.go:155-160)
    img_size: Optional[np.ndarray] = None  # i64[N, CI]
    # ServiceAffinity/ServiceAntiAffinity program (snapshot/services.py;
    # zero-width unless the encoder was given a config that uses them).
    # first_peer/peer_* are initial carry.
    svc_lbl_val: Optional[np.ndarray] = None  # i32[L, N]
    svc_node_ord: Optional[np.ndarray] = None  # i32[N]
    svc_ord_node: Optional[np.ndarray] = None  # i32[ORD]
    svc_first_peer: Optional[np.ndarray] = None  # i32[G]
    svc_peer_node_count: Optional[np.ndarray] = None  # i32[G, N]
    svc_peer_total: Optional[np.ndarray] = None  # i32[G]
    # host-only metadata (NOT shipped to device): vocab maps used to
    # resolve config-parameterized predicates (NodeLabel…) at schedule time
    key_ids: Optional[Dict[str, int]] = None
    svc_labels: Tuple[str, ...] = ()
    svc_num_values: int = 0

    @property
    def num_nodes(self) -> int:
        return len(self.node_names)

    def node_has_key(self, label: str) -> np.ndarray:
        """bool[N]: node carries the label key (from the key bitset)."""
        kid = (self.key_ids or {}).get(label, -1)
        if kid < 0:
            return np.zeros(len(self.node_names), bool)
        return (self.label_key[:, kid // 32] >> np.uint32(kid % 32)) & 1 == 1


@dataclass
class PodBatch:
    """Pending-pod-axis arrays."""

    pod_keys: List[Tuple[str, str]]  # (namespace, name)
    # fit-check request: container sums maxed with init containers
    # (predicates.go:355-374)
    req_mcpu: np.ndarray  # i64[P]
    req_mem: np.ndarray
    req_gpu: np.ndarray
    zero_req: np.ndarray  # bool[P]
    # commit request: container sums ONLY — NodeInfo.addPod accounting
    # (node_info.go:158 calculateResource has no init-container rule)
    commit_mcpu: np.ndarray  # i64[P]
    commit_mem: np.ndarray
    commit_gpu: np.ndarray
    nz_mcpu: np.ndarray
    nz_mem: np.ndarray
    host_req: np.ndarray  # i32[P], -1 == unconstrained
    port_mask: np.ndarray  # u32[P, PW]
    # nodeSelector program: single AND term
    ns_ops: np.ndarray  # i8[P, R1]
    ns_key: np.ndarray  # i32[P, R1]
    ns_set: np.ndarray  # i32[P, R1]
    ns_numkey: np.ndarray  # i32[P, R1]
    ns_num: np.ndarray  # f64[P, R1]
    # required node affinity: ORed terms, each an AND program
    aff_has_req: np.ndarray  # bool[P]
    aff_term_valid: np.ndarray  # bool[P, T]
    aff_ops: np.ndarray  # i8[P, T, R]
    aff_key: np.ndarray  # i32[P, T, R]
    aff_set: np.ndarray  # i32[P, T, R]
    aff_numkey: np.ndarray  # i32[P, T, R]
    aff_num: np.ndarray  # f64[P, T, R]
    # preferred node affinity terms (priority)
    pref_valid: np.ndarray  # bool[P, TP]
    pref_weight: np.ndarray  # i64[P, TP]
    pref_ops: np.ndarray  # i8[P, TP, R]
    pref_key: np.ndarray  # i32[P, TP, R]
    pref_set: np.ndarray  # i32[P, TP, R]
    pref_numkey: np.ndarray  # i32[P, TP, R]
    pref_num: np.ndarray  # f64[P, TP, R]
    # taints / tolerations
    tol_mask: np.ndarray  # u32[P, TW]
    # 0/1 per taint id: PreferNoSchedule AND not tolerated by the pod's
    # PreferNoSchedule-filtered tolerations (taint_toleration.go:39-47)
    intolerable_prefer: np.ndarray  # i32[P, TV]
    has_tolerations: np.ndarray  # bool[P]
    best_effort: np.ndarray  # bool[P]
    # spread
    has_selectors: np.ndarray  # bool[P]
    spread_match: np.ndarray  # i64[P, C] 0/1
    class_id: np.ndarray  # i32[P]
    unschedulable: np.ndarray  # bool[P]
    # inter-pod affinity per-pod program (snapshot/interpod.py)
    ip_match_spec: Optional[np.ndarray] = None  # i8[P, S]
    ip_ha_lt: Optional[np.ndarray] = None  # i32[P, TA]
    ip_ha_self: Optional[np.ndarray] = None  # bool[P, TA]
    ip_hq_lt: Optional[np.ndarray] = None  # i32[P, TQ]
    ip_fwd_lt: Optional[np.ndarray] = None  # i32[P, TF]
    ip_fwd_w: Optional[np.ndarray] = None  # i64[P, TF]
    ip_own_hard: Optional[np.ndarray] = None  # i32[P, LT]
    ip_own_pref: Optional[np.ndarray] = None  # i64[P, LT]
    ip_own_anti_hard: Optional[np.ndarray] = None  # i32[P, LT]
    ip_own_anti_pref: Optional[np.ndarray] = None  # i64[P, LT]
    ip_has_affinity: Optional[np.ndarray] = None  # bool[P]
    ip_has_anti: Optional[np.ndarray] = None  # bool[P]
    ip_sym_reject: Optional[np.ndarray] = None  # bool[P]
    # InterPodAffinityPriority aborts the cycle for EVERY pod when any
    # assigned pod's affinity annotation fails to parse
    ip_poison: Optional[np.ndarray] = None  # bool[P]
    # volume predicate per-pod program (snapshot/volumes.py)
    vp_vol_rw: Optional[np.ndarray] = None  # u32[P, VW]
    vp_vol_ro: Optional[np.ndarray] = None  # u32[P, VW]
    vp_ebs: Optional[np.ndarray] = None  # u32[P, EW]
    vp_gce: Optional[np.ndarray] = None  # u32[P, GW]
    vp_ebs_bad: Optional[np.ndarray] = None  # bool[P]
    vp_gce_bad: Optional[np.ndarray] = None  # bool[P]
    vp_has_ebs: Optional[np.ndarray] = None  # bool[P]
    vp_has_gce: Optional[np.ndarray] = None  # bool[P]
    vp_vz_zone: Optional[np.ndarray] = None  # i32[P]
    vp_vz_region: Optional[np.ndarray] = None  # i32[P]
    vp_vz_fail: Optional[np.ndarray] = None  # bool[P]
    # container-image name usage counts (ImageLocalityPriority)
    img_count: Optional[np.ndarray] = None  # i64[P, CI]
    # service-group program (ServiceAffinity/ServiceAntiAffinity)
    svc_group: Optional[np.ndarray] = None  # i32[P]
    svc_member: Optional[np.ndarray] = None  # i8[P, G]
    svc_fixed: Optional[np.ndarray] = None  # i32[P, L]

    @property
    def num_pods(self) -> int:
        return len(self.pod_keys)


class SnapshotEncoder:
    """Builds all vocabularies over (cluster state, pending pods) and emits
    the columnar snapshot + pod batch. Vocabularies are derived jointly so
    pod-side and node-side ids agree.

    Deviation from kubernetes_tpu/snapshot/encode.py SnapshotEncoder:
    encode_nodes builds the node axis column by column, in one pass, in
    place of ~25 numpy scalar writes and four bit packs a node;
    _build_vocabs' node visit interns a label or zone only on a miss; the
    volumes property keeps the volume compiler's volume_pods;
    encode_pods builds the Services' and RCs' selectors once a call and
    finds each pod's spread classes through an index of the classes'
    label pairs (_SpreadClasses), in place of building every selector
    once a pod and testing it against every class. The same arrays,
    dtypes and vocabulary ids."""

    def __init__(self, state: ClusterState, pods: Sequence[Pod], config=None,
                 vocabs: Optional[VocabBundle] = None, visit_state: bool = True,
                 node_id: Optional[Dict[str, int]] = None):
        self.state = state
        self.pods = list(pods)
        # config-parameterized compilation (ServiceAffinity labels etc.);
        # None keeps those programs zero-width
        self.config = config
        self.node_names = [
            name for name, info in state.node_infos.items() if info.node is not None
        ]
        # node ids may be injected (incremental slot map) so host_req and
        # compilers agree with externally-maintained node arrays
        self.node_id = (
            node_id if node_id is not None
            else {n: i for i, n in enumerate(self.node_names)}
        )
        # --- vocabularies (shared, append-only, when a bundle is given)
        self.vocabs = vocabs or VocabBundle()
        self.ports = self.vocabs.ports
        self.kv = self.vocabs.kv
        self.keys = self.vocabs.keys
        self.numkeys = self.vocabs.numkeys
        self.taints = self.vocabs.taints
        self.zones = self.vocabs.zones
        self.classes = self.vocabs.classes
        self.sets = self.vocabs.sets
        self.set_members = self.vocabs.set_members
        # visit_state=False: the caller maintains node/assigned-pod vocab
        # entries itself (snapshot/incremental.py); only the pending pods
        # are visited here
        self._visit_state = visit_state
        self._interpod = None
        self._volumes = None
        self._services = None
        self._build_vocabs()

    @property
    def interpod(self):
        """Lazily compiled inter-pod affinity program (shared between
        encode_nodes and encode_pods so ids agree)."""
        if self._interpod is None:
            from kubernetes_tpu_torch.snapshot.interpod import InterPodCompiler

            self._interpod = InterPodCompiler(
                self.state, self.pods, self.node_names
            ).compile()
        return self._interpod

    @property
    def volumes(self):
        """Lazily compiled volume predicate program; volume_pods is the
        number of assigned pods that took its per-pod path."""
        if self._volumes is None:
            from kubernetes_tpu_torch.snapshot.volumes import VolumeCompiler

            compiler = VolumeCompiler(self.state, self.pods, self.node_names)
            self._volumes = compiler.compile()
            self.volume_pods = compiler.volume_pods
        return self._volumes

    @property
    def services_program(self):
        if self._services is None:
            from kubernetes_tpu_torch.snapshot.services import ServiceCompiler

            labels = ()
            if self.config is not None:
                labels = service_config_labels(self.config)
            self._services = ServiceCompiler(
                self.state, self.pods, self.node_names, labels
            ).compile()
        return self._services

    # -- vocab construction --------------------------------------------------

    def _class_key(self, pod: Pod):
        deleted = pod.metadata.deletion_timestamp is not None
        return (
            pod.namespace,
            frozenset(pod.metadata.labels.items()),
            deleted,
        )

    def _set_selectors(self) -> List[Tuple[str, frozenset]]:
        """(namespace, frozenset of (key, value) pairs) of each Service's
        and then each RC's selector. Such a selector
        (labels.SelectorFromSet) matches exactly the labels that hold
        every pair, an empty one every labels: a subset test of the pairs
        against the labels' items."""
        return [(o.metadata.namespace,
                 frozenset((o.spec.selector or {}).items()))
                for o in (*self.state.services, *self.state.controllers)]

    class _SpreadClasses:
        """The live (not deleted) spread classes of each namespace, and
        an index from each (namespace, label pair) to the live classes
        holding it, so that a label-set selector finds its classes from
        its rarest pair instead of testing every class."""

        def __init__(self, class_list):
            self.class_list = class_list
            self.by_ns: Dict[str, List[int]] = {}
            self.by_pair: Dict[tuple, List[int]] = {}
            for c_idx, (ns, labels_fs, deleted) in enumerate(class_list):
                if deleted:
                    continue
                self.by_ns.setdefault(ns, []).append(c_idx)
                for pair in labels_fs:
                    self.by_pair.setdefault((ns, pair), []).append(c_idx)

        def classes(self, ns: str, sets, selectors) -> List[int]:
            """Ids of the live classes of namespace ns whose labels one of
            the label sets (frozensets of pairs) or one of the selectors
            matches."""
            hit = set()
            for s in sets:
                if not s:
                    return list(self.by_ns.get(ns, ()))
                rarest = min(s, key=lambda p: len(self.by_pair.get((ns, p),
                                                                   ())))
                hit.update(c for c in self.by_pair.get((ns, rarest), ())
                           if s <= self.class_list[c][1])
            if selectors:
                for c_idx in self.by_ns.get(ns, ()):
                    if c_idx not in hit:
                        lbls = dict(self.class_list[c_idx][1])
                        if any(sel.matches(lbls) for sel in selectors):
                            hit.add(c_idx)
            return list(hit)

    def _intern_set(self, key: str, values) -> int:
        """Intern a requirement value set as a bitmask over kv ids."""
        fs = frozenset((key, v) for v in values)
        idx = self.sets.get(fs)
        if idx is None:
            idx = len(self.set_members)
            self.sets[fs] = idx
            self.set_members.append(fs)
        for kv in fs:
            self.kv.get(kv)
        return idx

    def _visit_requirement(self, r: NodeSelectorRequirement):
        self.keys.get(r.key)
        if r.operator in ("In", "NotIn"):
            self._intern_set(r.key, r.values)
        elif r.operator in ("Gt", "Lt"):
            self.numkeys.get(r.key)

    def _visit_pod_vocab(self, pod: Pod):
        for c in pod.spec.containers:
            for p in c.ports:
                if p.host_port != 0:
                    self.ports.get(p.host_port)
        for k, v in pod.spec.node_selector.items():
            self.keys.get(k)
            self._intern_set(k, [v])
        aff = self._affinity_or_none(pod)
        if aff is not None and aff.node_affinity is not None:
            na = aff.node_affinity
            if na.required_during_scheduling_ignored_during_execution is not None:
                for t in na.required_during_scheduling_ignored_during_execution.node_selector_terms:
                    for r in t.match_expressions:
                        self._visit_requirement(r)
            for wt in na.preferred_during_scheduling_ignored_during_execution:
                for r in wt.preference.match_expressions:
                    self._visit_requirement(r)
        self.classes.get(self._class_key(pod))

    def _affinity_or_none(self, pod: Pod) -> Optional[Affinity]:
        try:
            return get_affinity(pod)
        except Exception:
            return None

    def _build_vocabs(self):
        # images are deliberately per-encoder (not in the shared bundle):
        # ImageLocality only needs pod-ids and node sizes to agree within
        # one wave, and a per-wave vocab keeps the image axis small
        self.images = _Dict()
        for pod in self.pods:
            for c in pod.spec.containers:
                self.images.get(c.image)
        if self._visit_state:
            # interned on a miss only, in the same order as ever
            key_ids, kv_ids, zone_ids = (self.keys.ids, self.kv.ids,
                                         self.zones.ids)
            for name in self.node_names:
                node = self.state.node_infos[name].node
                for kv in node.metadata.labels.items():
                    if kv[0] not in key_ids:
                        self.keys.get(kv[0])
                    if kv not in kv_ids:
                        self.kv.get(kv)
                try:
                    for t in get_taints(node):
                        self.taints.get((t.key, t.value, t.effect))
                except Exception:
                    pass  # malformed annotation; encode_nodes marks taint_bad
                zone = get_zone_key(node)
                if zone and zone not in zone_ids:
                    self.zones.get(zone)
            for info in self.state.node_infos.values():
                for pod in info.pods:
                    self._visit_pod_vocab(pod)
        for pod in self.pods:
            self._visit_pod_vocab(pod)

    # -- emission ------------------------------------------------------------

    @property
    def widths(self):
        return dict(
            PW=_words(len(self.ports)),
            LW=_words(len(self.kv)),
            KW=_words(len(self.keys)),
            TW=_words(len(self.taints)),
            TV=max(1, len(self.taints)),
            KG=max(1, len(self.numkeys)),
            C=max(1, len(self.classes)),
        )

    def encode_nodes(self) -> ClusterSnapshot:
        """The node axis, built column by column: one pass over the nodes
        appends each field's values to a plain list, as (row, id) pairs for
        the bitsets and counts, and each field is then made by one array
        build or one scatter. An allocatable is parsed once per distinct
        content in the call."""
        from itertools import chain

        GPU = "alpha.kubernetes.io/nvidia-gpu"
        w = self.widths
        N = len(self.node_names)
        C = w["C"]
        node_infos = self.state.node_infos
        kv_ids, key_ids, port_ids = self.kv.ids, self.keys.ids, self.ports.ids
        image_ids = self.images.ids
        numkeys = list(self.numkeys.ids.items())
        # (mcpu, mem, gpu, pods) of each distinct allocatable content, and
        # its row by the four values they are parsed from
        alloc_table: List[Tuple[int, int, int, int]] = []
        alloc_rows: Dict[tuple, int] = {}
        # per node: its allocatable's row, the six requested columns,
        # zone_id, has_taints, taint_bad, mem_pressure
        scalars = []
        # (row, id) pairs; the values of the (row, column) pairs nums, imgs
        ports, kvs, keys, taints_at, classes = [], [], [], [], []
        nums, num_vals, imgs, img_vals = [], [], [], []
        # interned ids read straight from the dictionaries; the method
        # only for a miss, which interns as it always did
        class_ids, class_key = self.classes.ids, self._class_key
        zone_ids, taint_id = self.zones.ids, self.taints.get
        for i, name in enumerate(self.node_names):
            info = node_infos[name]
            node = info.node
            labels = node.metadata.labels
            alloc = node.status.allocatable
            gpu, n_pods = alloc.get(GPU, 0), alloc.get("pods", 0)
            a_key = (alloc.get("cpu"), alloc.get("memory"), gpu, n_pods)
            a = alloc_rows.get(a_key)
            if a is None:
                a = alloc_rows[a_key] = len(alloc_table)
                alloc_table.append((
                    resource_list_cpu_milli(alloc),
                    resource_list_memory(alloc),
                    parse_quantity(gpu).value(),
                    parse_quantity(n_pods).value(),
                ))
            pods = info.pods
            for pod in pods:
                # ports in use on this node
                for c in pod.spec.containers:
                    for p in c.ports:
                        if p.host_port != 0:
                            x = port_ids.get(p.host_port)
                            if x is not None:
                                ports.append((i, x))
                ck = class_key(pod)
                x = class_ids.get(ck)
                classes.append((i, self.classes.get(ck) if x is None else x))
            # labels
            for kv in labels.items():
                x = kv_ids.get(kv)
                if x is not None:
                    kvs.append((i, x))
                x = key_ids.get(kv[0])
                if x is not None:
                    keys.append((i, x))
            for k, col in numkeys:
                v = labels.get(k)
                if v is not None:
                    try:
                        num_vals.append(float(v))
                    except ValueError:
                        continue  # stays NaN -> Gt/Lt never match
                    nums.append((i, col))
            # taints
            try:
                taints = get_taints(node)
                bad = False
            except Exception:
                taints = []
                bad = True
            for t in taints:
                taints_at.append((i, taint_id((t.key, t.value, t.effect))))
            pressure = False
            for cond in node.status.conditions:
                if cond.type == "MemoryPressure" and cond.status == "True":
                    pressure = True
            zone = get_zone_key(node)
            if zone:
                z = zone_ids.get(zone)
                if z is None:
                    z = self.zones.get(zone)
            else:
                z = 0
            scalars.append((
                a, info.requested_milli_cpu, info.requested_memory,
                info.requested_gpu, info.nonzero_milli_cpu,
                info.nonzero_memory, len(pods),
                z, bool(taints), bad, pressure,
            ))
            # image sizes: first status.images entry containing the name
            # wins (priorities.go:155-160 breaks at the first match)
            if node.status.images:
                seen_img = set()
                for img in node.status.images:
                    for nm in img.names:
                        iid = image_ids.get(nm)
                        if iid is not None and iid not in seen_img:
                            imgs.append((i, iid))
                            img_vals.append(img.size_bytes)
                            seen_img.add(iid)

        def at(pairs):
            """(rows, ids) index arrays of a list of (row, id) pairs."""
            a = np.fromiter(chain.from_iterable(pairs), np.intp,
                            2 * len(pairs)).reshape(-1, 2)
            return a[:, 0], a[:, 1]

        def bits(pairs, words) -> np.ndarray:
            out = np.zeros((N, words), np.uint32)
            if pairs:
                rows, ids = at(pairs)
                np.bitwise_or.at(
                    out, (rows, ids >> 5),
                    np.left_shift(np.uint32(1), (ids & 31).astype(np.uint32)),
                )
            return out

        def counts(pairs, width, dtype) -> np.ndarray:
            out = np.zeros((N, width), dtype)
            if pairs:
                np.add.at(out, at(pairs), 1)
            return out

        cols = np.fromiter(chain.from_iterable(scalars), np.int64,
                           11 * N).reshape(N, 11).T.copy()
        alloc = np.array(alloc_table, np.int64).reshape(-1, 4)[cols[0]].T.copy()
        numval = np.full((N, w["KG"]), np.nan, np.float64)
        if nums:
            numval[at(nums)] = num_vals
        img_size = np.zeros((N, max(0, len(self.images))), np.int64)
        if imgs:
            img_size[at(imgs)] = img_vals
        return ClusterSnapshot(
            node_names=list(self.node_names),
            alloc_mcpu=alloc[0],
            alloc_mem=alloc[1],
            alloc_gpu=alloc[2],
            alloc_pods=alloc[3],
            req_mcpu=cols[1],
            req_mem=cols[2],
            req_gpu=cols[3],
            nz_mcpu=cols[4],
            nz_mem=cols[5],
            pod_count=cols[6],
            port_mask=bits(ports, w["PW"]),
            label_kv=bits(kvs, w["LW"]),
            label_key=bits(keys, w["KW"]),
            numval=numval,
            taint_mask=bits(taints_at, w["TW"]),
            taint_count=counts(taints_at, w["TV"], np.int32),
            has_taints=cols[8].astype(bool),
            taint_bad=cols[9].astype(bool),
            mem_pressure=cols[10].astype(bool),
            zone_id=cols[7].astype(np.int32),
            class_count=counts(classes, C, np.int64),
            name_desc_order=np.argsort(
                np.array(self.node_names, dtype=object), kind="stable"
            )[::-1].astype(np.int32),
            set_table=self._set_table(),
            noschedule_taints=self._taint_effect_mask("NoSchedule"),
            prefer_taints=self._taint_effect_mask("PreferNoSchedule"),
            ip_topo_dom=self.interpod.topo_dom,
            ip_u_topo=self.interpod.u_topo,
            ip_u_spec=self.interpod.u_spec,
            ip_lt_spec=self.interpod.lt_spec,
            ip_lt_u=self.interpod.lt_u,
            ip_lt_sign=self.interpod.lt_sign,
            ip_term_count=self.interpod.term_count,
            ip_own_anti=self.interpod.own_anti,
            ip_rev_hard=self.interpod.rev_hard,
            ip_rev_pref=self.interpod.rev_pref,
            ip_rev_anti=self.interpod.rev_anti,
            ip_spec_total=self.interpod.spec_total,
            vol_any=self.volumes.vol_any,
            vol_rw=self.volumes.vol_rw,
            ebs_mask=self.volumes.ebs_mask,
            gce_mask=self.volumes.gce_mask,
            ebs_bad=self.volumes.ebs_bad,
            gce_bad=self.volumes.gce_bad,
            vz_zone=self.volumes.vz_zone,
            vz_region=self.volumes.vz_region,
            vz_has=self.volumes.vz_has,
            img_size=img_size,
            key_ids=dict(self.keys.ids),
            svc_lbl_val=self.services_program.lbl_val,
            svc_node_ord=self.services_program.node_ord,
            svc_ord_node=self.services_program.ord_node,
            svc_first_peer=self.services_program.first_peer,
            svc_peer_node_count=self.services_program.peer_node_count,
            svc_peer_total=self.services_program.peer_total,
            svc_labels=self.services_program.labels,
            svc_num_values=int(
                max(
                    self.services_program.lbl_val.max(initial=-1),
                    self.services_program.fixed.max(initial=-1),
                )
                + 1
            ),
        )

    def _set_table(self) -> np.ndarray:
        return build_set_table(self.set_members, self.kv.ids, self.widths["LW"])

    def _taint_effect_mask(self, effect: str) -> np.ndarray:
        w = self.widths
        ids = [i for (k, v, e), i in self.taints.ids.items() if e == effect]
        return _pack_bits(ids, w["TW"])

    # -- pod batch -----------------------------------------------------------

    def _compile_requirements(self, reqs, ops, key, set_, numkey, num, row):
        """Fill one AND-program row from a requirement list. Returns False
        (with the whole row forced to OP_FAIL) when labels.NewRequirement
        would reject any requirement — the caller must then treat the term
        list exactly as the reference does on parse error."""
        for j, r in enumerate(reqs):
            if not _requirement_valid(r):
                ops[row][:] = OP_PAD
                ops[row][0] = OP_FAIL
                return False
            code = _OP_BY_NAME[r.operator]
            ops[row][j] = code
            key[row][j] = self.keys.get(r.key, add=False)
            if code in (OP_IN, OP_NOT_IN):
                set_[row][j] = self._intern_set_ro(r.key, r.values)
            elif code in (OP_GT, OP_LT):
                numkey[row][j] = self.numkeys.get(r.key, add=False)
                num[row][j] = float(next(iter(r.values)))
        return True

    def _intern_set_ro(self, key, values) -> int:
        fs = frozenset((key, v) for v in values)
        idx = self.sets.get(fs)
        if idx is None:
            raise KeyError(
                f"value set for key {key!r} was not interned during vocab "
                "construction — encoder bug"
            )
        return idx

    def encode_pods(self, max_terms=None, max_reqs=None) -> PodBatch:
        w = self.widths
        P = len(self.pods)
        # one annotation parse per pod: failures become (None, True)
        affs = []
        parse_failed = []
        for p in self.pods:
            try:
                affs.append(get_affinity(p))
                parse_failed.append(False)
            except Exception:
                affs.append(None)
                parse_failed.append(True)

        def na(a):
            return a.node_affinity if a is not None else None

        R1 = max(
            [1] + [len(p.spec.node_selector) for p in self.pods]
        )
        req_terms = []
        pref_terms = []
        for a in affs:
            n = na(a)
            if n is not None and n.required_during_scheduling_ignored_during_execution is not None:
                req_terms.append(
                    list(n.required_during_scheduling_ignored_during_execution.node_selector_terms)
                )
            else:
                req_terms.append(None)
            pref_terms.append(
                list(n.preferred_during_scheduling_ignored_during_execution)
                if n is not None
                else []
            )
        T = max_terms or max([1] + [len(t) for t in req_terms if t is not None])
        TP = max([1] + [len(t) for t in pref_terms])
        R = max_reqs or max(
            [1]
            + [
                len(term.match_expressions)
                for terms in req_terms
                if terms
                for term in terms
            ]
            + [
                len(wt.preference.match_expressions)
                for terms in pref_terms
                for wt in terms
            ]
        )

        b = PodBatch(
            pod_keys=[(p.namespace, p.name) for p in self.pods],
            req_mcpu=np.zeros(P, np.int64),
            req_mem=np.zeros(P, np.int64),
            req_gpu=np.zeros(P, np.int64),
            zero_req=np.zeros(P, bool),
            commit_mcpu=np.zeros(P, np.int64),
            commit_mem=np.zeros(P, np.int64),
            commit_gpu=np.zeros(P, np.int64),
            nz_mcpu=np.zeros(P, np.int64),
            nz_mem=np.zeros(P, np.int64),
            host_req=np.full(P, -1, np.int32),
            port_mask=np.zeros((P, w["PW"]), np.uint32),
            ns_ops=np.zeros((P, R1), np.int8),
            ns_key=np.zeros((P, R1), np.int32),
            ns_set=np.zeros((P, R1), np.int32),
            ns_numkey=np.zeros((P, R1), np.int32),
            ns_num=np.zeros((P, R1), np.float64),
            aff_has_req=np.zeros(P, bool),
            aff_term_valid=np.zeros((P, T), bool),
            aff_ops=np.zeros((P, T, R), np.int8),
            aff_key=np.zeros((P, T, R), np.int32),
            aff_set=np.zeros((P, T, R), np.int32),
            aff_numkey=np.zeros((P, T, R), np.int32),
            aff_num=np.zeros((P, T, R), np.float64),
            pref_valid=np.zeros((P, TP), bool),
            pref_weight=np.zeros((P, TP), np.int64),
            pref_ops=np.zeros((P, TP, R), np.int8),
            pref_key=np.zeros((P, TP, R), np.int32),
            pref_set=np.zeros((P, TP, R), np.int32),
            pref_numkey=np.zeros((P, TP, R), np.int32),
            pref_num=np.zeros((P, TP, R), np.float64),
            tol_mask=np.zeros((P, w["TW"]), np.uint32),
            intolerable_prefer=np.zeros((P, w["TV"]), np.int32),
            has_tolerations=np.zeros(P, bool),
            best_effort=np.zeros(P, bool),
            has_selectors=np.zeros(P, bool),
            spread_match=np.zeros((P, w["C"]), np.int64),
            class_id=np.zeros(P, np.int32),
            unschedulable=np.zeros(P, bool),
            ip_match_spec=self.interpod.match_spec,
            ip_ha_lt=self.interpod.ha_lt,
            ip_ha_self=self.interpod.ha_self,
            ip_hq_lt=self.interpod.hq_lt,
            ip_fwd_lt=self.interpod.fwd_lt,
            ip_fwd_w=self.interpod.fwd_w,
            ip_own_hard=self.interpod.own_hard,
            ip_own_pref=self.interpod.own_pref,
            ip_own_anti_hard=self.interpod.own_anti_hard,
            ip_own_anti_pref=self.interpod.own_anti_pref,
            ip_has_affinity=self.interpod.has_affinity,
            ip_has_anti=self.interpod.has_anti,
            ip_sym_reject=self.interpod.sym_reject,
            ip_poison=np.full(P, self.interpod.poison, bool),
            vp_vol_rw=self.volumes.p_vol_rw,
            vp_vol_ro=self.volumes.p_vol_ro,
            vp_ebs=self.volumes.p_ebs,
            vp_gce=self.volumes.p_gce,
            vp_ebs_bad=self.volumes.p_ebs_bad,
            vp_gce_bad=self.volumes.p_gce_bad,
            vp_has_ebs=self.volumes.p_has_ebs,
            vp_has_gce=self.volumes.p_has_gce,
            vp_vz_zone=self.volumes.p_vz_zone,
            vp_vz_region=self.volumes.p_vz_region,
            vp_vz_fail=self.volumes.p_vz_fail,
            img_count=np.zeros((P, max(0, len(self.images))), np.int64),
            svc_group=self.services_program.group,
            svc_member=self.services_program.member,
            svc_fixed=self.services_program.fixed,
        )
        set_selectors = self._set_selectors()
        spread = self._SpreadClasses(list(self.classes.ids.keys()))
        for i, pod in enumerate(self.pods):
            cpu, mem, gpu = pod_resource_request(pod)
            b.req_mcpu[i], b.req_mem[i], b.req_gpu[i] = cpu, mem, gpu
            b.zero_req[i] = cpu == 0 and mem == 0 and gpu == 0
            b.commit_mcpu[i], b.commit_mem[i], b.commit_gpu[i] = _calculate_resource(pod)
            b.nz_mcpu[i], b.nz_mem[i] = pod_nonzero_request(pod)
            if pod.spec.node_name:
                b.host_req[i] = self.node_id.get(pod.spec.node_name, -2)
            b.port_mask[i] = _pack_bits(
                [
                    self.ports.get(p.host_port, add=False)
                    for c in pod.spec.containers
                    for p in c.ports
                    if p.host_port != 0
                ],
                w["PW"],
            )
            # nodeSelector -> equality (In) requirements
            for j, (k, v) in enumerate(sorted(pod.spec.node_selector.items())):
                b.ns_ops[i, j] = OP_IN
                b.ns_key[i, j] = self.keys.get(k, add=False)
                b.ns_set[i, j] = self._intern_set_ro(k, [v])
            if parse_failed[i]:
                b.unschedulable[i] = True
                continue
            aff = affs[i]
            n = na(aff)
            if n is not None and n.required_during_scheduling_ignored_during_execution is not None:
                b.aff_has_req[i] = True
                terms = n.required_during_scheduling_ignored_during_execution.node_selector_terms
                for t_idx, term in enumerate(terms):
                    b.aff_term_valid[i, t_idx] = True
                    if not term.match_expressions:
                        # empty req list == labels.Nothing (helpers.go:374),
                        # no error — later terms still evaluated
                        b.aff_ops[i, t_idx, 0] = OP_FAIL
                        continue
                    ok = self._compile_requirements(
                        term.match_expressions,
                        b.aff_ops[i],
                        b.aff_key[i],
                        b.aff_set[i],
                        b.aff_numkey[i],
                        b.aff_num[i],
                        t_idx,
                    )
                    if not ok:
                        # parse error: predicates.go:457-459 returns false
                        # for the WHOLE term list the moment the bad term is
                        # reached — terms before it were already tried, so
                        # "any earlier term matched" wins; later terms never
                        # run. Leaving them term_valid=False models that.
                        break
            for t_idx, wt in enumerate(pref_terms[i]):
                if wt.weight == 0:
                    continue
                b.pref_valid[i, t_idx] = True
                b.pref_weight[i, t_idx] = wt.weight
                if not wt.preference.match_expressions:
                    b.pref_ops[i, t_idx, 0] = OP_FAIL
                    continue
                ok = self._compile_requirements(
                    wt.preference.match_expressions,
                    b.pref_ops[i],
                    b.pref_key[i],
                    b.pref_set[i],
                    b.pref_numkey[i],
                    b.pref_num[i],
                    t_idx,
                )
                if not ok:
                    # node_affinity.go:68: a bad preferred term errors the
                    # whole scheduling cycle — the pod is not scheduled.
                    b.unschedulable[i] = True
                    break
            if b.unschedulable[i]:
                continue
            # tolerations
            try:
                tols = get_tolerations(pod)
            except Exception:
                # malformed annotation => every node's taint predicate errors
                b.unschedulable[i] = True
                continue
            b.has_tolerations[i] = bool(tols)
            prefer_tols = [
                t for t in tols if not t.effect or t.effect == "PreferNoSchedule"
            ]
            tolerated_ids = []
            for (tk, tv, te), tid in self.taints.ids.items():
                taint = Taint(key=tk, value=tv, effect=te)
                if taint_tolerated_by_tolerations(taint, tols):
                    tolerated_ids.append(tid)
                if te == "PreferNoSchedule" and not taint_tolerated_by_tolerations(
                    taint, prefer_tols
                ):
                    b.intolerable_prefer[i, tid] = 1
            b.tol_mask[i] = _pack_bits(tolerated_ids, w["TW"])
            b.best_effort[i] = is_pod_best_effort(pod)
            # spread selectors: the Services' and RCs' label sets that
            # the pod's labels hold, then its ReplicaSets' selectors
            ns, items = pod.namespace, pod.metadata.labels.items()
            sets = [s for s_ns, s in set_selectors if s_ns == ns and s <= items]
            selectors = [label_selector_as_selector(rs.spec.selector)
                         for rs in get_pod_replica_sets(self.state, pod)]
            b.has_selectors[i] = bool(sets or selectors)
            b.spread_match[i, spread.classes(ns, sets, selectors)] = 1
            b.class_id[i] = self.classes.get(self._class_key(pod))
            for c in pod.spec.containers:
                iid = self.images.get(c.image, add=False)
                if iid >= 0:
                    b.img_count[i, iid] += 1
        return b

    def encode(self) -> Tuple[ClusterSnapshot, PodBatch]:
        return self.encode_nodes(), self.encode_pods()


