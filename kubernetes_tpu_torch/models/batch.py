"""The serial scan: a backlog scheduled pod by pod on the device.

PyTorch counterpart of kubernetes_tpu/models/batch.py. The carry is the
mutable slice of the cluster state (requested/nonzero resources, pod
counts, port masks, per-class pod counts, lastNodeIndex, the inter-pod
and volume tables) as a dict of device tensors, and each step is:

    fit[N]    = AND of predicate masks          (ops.predicates)
    score[N]  = sum_i weight_i * priority_i[N]  (ops.priorities)
    chosen    = deterministic argmax w/ name-desc round-robin (ops.select)
    carry    += commit(pod, chosen)             (AssumePod analogue)

which is bit-identical to the serial loop (scheduler.go:93 scheduleOne).
The JAX package compiles the loop into one lax.scan; here it is a
Python loop of plain torch ops that updates the carry in place and
keeps `chosen` on the device, so a backlog costs no host sync until its
end. A hand kernel for the step waits for a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.ops import interpod as IP
from kubernetes_tpu_torch.ops import predicates as P
from kubernetes_tpu_torch.ops import priorities as R
from kubernetes_tpu_torch.ops import select as S
from kubernetes_tpu_torch.ops import services as SV
from kubernetes_tpu_torch.ops import volumes as V
from kubernetes_tpu_torch.snapshot.carry import place, to_device
from kubernetes_tpu_torch.snapshot.encode import (
    RES_CARRY_FIELDS,
    ClusterSnapshot,
    PodBatch,
    service_config_labels,
)

I64 = torch.int64

# predicate keys (factory/plugins.go registry names)
GENERAL_PREDICATES = "GeneralPredicates"
POD_TOLERATES_NODE_TAINTS = "PodToleratesNodeTaints"
CHECK_NODE_MEMORY_PRESSURE = "CheckNodeMemoryPressure"
MATCH_INTER_POD_AFFINITY = "MatchInterPodAffinity"
NO_DISK_CONFLICT = "NoDiskConflict"
NO_VOLUME_ZONE_CONFLICT = "NoVolumeZoneConflict"
MAX_EBS_VOLUME_COUNT = "MaxEBSVolumeCount"
MAX_GCE_PD_VOLUME_COUNT = "MaxGCEPDVolumeCount"
# GeneralPredicates components, individually addressable (plugins.go)
POD_FITS_RESOURCES = "PodFitsResources"
POD_FITS_HOST_PORTS = "PodFitsHostPorts"
POD_FITS_PORTS = "PodFitsPorts"  # legacy alias (defaults.go:77)
HOST_NAME = "HostName"
MATCH_NODE_SELECTOR = "MatchNodeSelector"

LEAST_REQUESTED = "LeastRequestedPriority"
BALANCED_ALLOCATION = "BalancedResourceAllocation"
SELECTOR_SPREAD = "SelectorSpreadPriority"
NODE_AFFINITY = "NodeAffinityPriority"
TAINT_TOLERATION = "TaintTolerationPriority"
INTER_POD_AFFINITY = "InterPodAffinityPriority"
EQUAL = "EqualPriority"
IMAGE_LOCALITY = "ImageLocalityPriority"
# config-parameterized entries (Policy args, api/types.go:60-94) are
# tuples: ("CheckNodeLabelPresence", (labels...), presence) as a predicate,
# (("NodeLabelPriority", label, presence), weight) as a priority
NODE_LABEL_PREDICATE = "CheckNodeLabelPresence"
NODE_LABEL_PRIORITY = "NodeLabelPriority"
SERVICE_AFFINITY = "ServiceAffinity"
SERVICE_ANTI_AFFINITY = "ServiceAntiAffinity"

#: the carry dict's keys, in the order of the JAX package's carry tuple
CARRY_FIELDS = (
    "res", "port_mask", "class_count", "last_idx",
    "ip_term_count", "ip_own_anti", "ip_rev_hard", "ip_rev_pref",
    "ip_rev_anti", "ip_spec_total",
    "vol_any", "vol_rw", "ebs_mask", "gce_mask",
    "svc_first_peer", "svc_peer_node_count", "svc_peer_total",
)


def wants_resources(config: "SchedulerConfig") -> bool:
    return (GENERAL_PREDICATES in config.predicates
            or POD_FITS_RESOURCES in config.predicates)


def wants_host(config: "SchedulerConfig") -> bool:
    return (GENERAL_PREDICATES in config.predicates
            or HOST_NAME in config.predicates)


def wants_ports(config: "SchedulerConfig") -> bool:
    return (GENERAL_PREDICATES in config.predicates
            or POD_FITS_HOST_PORTS in config.predicates
            or POD_FITS_PORTS in config.predicates)


def wants_selector(config: "SchedulerConfig") -> bool:
    return (GENERAL_PREDICATES in config.predicates
            or MATCH_NODE_SELECTOR in config.predicates)


def wants_interpod(config: "SchedulerConfig") -> bool:
    return (MATCH_INTER_POD_AFFINITY in config.predicates
            or any(n == INTER_POD_AFFINITY for n, _ in config.priorities))


@dataclass(frozen=True)
class SchedulerConfig:
    """Static algorithm configuration — the analogue of a resolved
    algorithm provider (defaults.go:55 init)."""

    # defaults.go:116 defaultPredicates (order is irrelevant for
    # fit/no-fit — the masks AND together)
    predicates: Tuple[str, ...] = (
        NO_DISK_CONFLICT,
        NO_VOLUME_ZONE_CONFLICT,
        MAX_EBS_VOLUME_COUNT,
        MAX_GCE_PD_VOLUME_COUNT,
        GENERAL_PREDICATES,
        POD_TOLERATES_NODE_TAINTS,
        CHECK_NODE_MEMORY_PRESSURE,
        MATCH_INTER_POD_AFFINITY,
    )
    priorities: Tuple[Tuple[str, int], ...] = (
        (LEAST_REQUESTED, 1),
        (BALANCED_ALLOCATION, 1),
        (SELECTOR_SPREAD, 1),
        (NODE_AFFINITY, 1),
        (TAINT_TOLERATION, 1),
        (INTER_POD_AFFINITY, 1),
    )
    # --hard-pod-affinity-symmetric-weight (options.go:52)
    hard_pod_affinity_weight: int = 1
    # defaults.go:37-53
    max_ebs_volumes: int = 39
    max_gce_pd_volumes: int = 16


def interpod_carry_tables(static, ip_term_count, num_nodes):
    """cnt_lt — the per-node expansion of the inter-pod term counts
    carried between steps. Shared by the scan and the wave probe."""
    cnt_u = IP.gather_counts(
        ip_term_count, static["ip_u_topo"], static["ip_topo_dom"]
    )
    return IP.expand_lt(
        cnt_u, static["ip_lt_u"], static["ip_lt_sign"], num_nodes
    )


def fit_mask(
    config: SchedulerConfig,
    static,
    carry,
    pod,
    cnt_lt,
    include_resources: bool = True,
):
    """The full predicate AND for one pod against one carry state.

    `include_resources=False` drops the carry-dependent PodFitsResources
    term (the wave probe tabulates it separately over the commit count);
    everything else is evaluated against the given carry exactly as the
    serial scan does."""
    res = carry["res"]
    num_nodes = res.shape[1]
    svc_labels = service_config_labels(config)

    fit = ~pod["unschedulable"]
    if any(n == INTER_POD_AFFINITY for n, _ in config.priorities):
        # a bad assigned-pod annotation errors the priority for every pod
        fit = fit & ~pod["ip_poison"]
    if NO_DISK_CONFLICT in config.predicates:
        fit = fit & V.no_disk_conflict(
            pod["vp_vol_rw"], pod["vp_vol_ro"], carry["vol_any"],
            carry["vol_rw"],
        )
    if NO_VOLUME_ZONE_CONFLICT in config.predicates:
        fit = fit & V.volume_zone(
            pod["vp_vz_zone"], pod["vp_vz_region"], pod["vp_vz_fail"],
            static["vz_zone"], static["vz_region"], static["vz_has"],
        )
    if MAX_EBS_VOLUME_COUNT in config.predicates:
        fit = fit & V.max_pd_count(
            pod["vp_ebs"], pod["vp_ebs_bad"], pod["vp_has_ebs"],
            carry["ebs_mask"], static["ebs_bad"], config.max_ebs_volumes,
        )
    if MAX_GCE_PD_VOLUME_COUNT in config.predicates:
        fit = fit & V.max_pd_count(
            pod["vp_gce"], pod["vp_gce_bad"], pod["vp_has_gce"],
            carry["gce_mask"], static["gce_bad"], config.max_gce_pd_volumes,
        )
    if wants_resources(config) and include_resources:
        fit = fit & P.pod_fits_resources(
            pod["req_mcpu"], pod["req_mem"], pod["req_gpu"], pod["zero_req"],
            static["alloc_mcpu"], static["alloc_mem"], static["alloc_gpu"],
            static["alloc_pods"],
            res[0], res[1], res[2], res[5],
        )
    if wants_host(config):
        fit = fit & P.pod_fits_host(pod["host_req"], num_nodes)
    if wants_ports(config):
        fit = fit & P.pod_fits_host_ports(pod["port_mask"],
                                          carry["port_mask"])
    if wants_selector(config):
        fit = fit & P.match_node_selector(
            pod["ns_ops"], pod["ns_key"], pod["ns_set"], pod["ns_numkey"],
            pod["ns_num"], pod["aff_has_req"], pod["aff_term_valid"],
            pod["aff_ops"], pod["aff_key"], pod["aff_set"],
            pod["aff_numkey"], pod["aff_num"],
            static["label_kv"], static["label_key"], static["numval"],
            static["set_table"],
        )
    if POD_TOLERATES_NODE_TAINTS in config.predicates:
        fit = fit & P.pod_tolerates_node_taints(
            pod["tol_mask"], pod["has_tolerations"], static["taint_mask"],
            static["has_taints"], static["taint_bad"],
            static["noschedule_taints"],
        )
    if CHECK_NODE_MEMORY_PRESSURE in config.predicates:
        fit = fit & P.check_node_memory_pressure(
            pod["best_effort"], static["mem_pressure"]
        )
    for entry in config.predicates:
        if isinstance(entry, tuple) and entry[0] == NODE_LABEL_PREDICATE:
            # per-node static mask resolved host-side (predicates.go:552)
            for lbl in entry[1]:
                has = static[f"nl_pred_{lbl}"]
                fit = fit & (has if entry[2] else ~has)
        elif isinstance(entry, tuple) and entry[0] == SERVICE_AFFINITY:
            fit = fit & SV.service_affinity(
                carry["svc_first_peer"], static["svc_lbl_val"],
                static["svc_ord_node"], pod["svc_group"], pod["svc_fixed"],
                tuple(svc_labels.index(l) for l in entry[1]), num_nodes,
            )
    if MATCH_INTER_POD_AFFINITY in config.predicates:
        own_lt = IP.gather_lt(
            carry["ip_own_anti"], static["ip_u_topo"], static["ip_topo_dom"],
            static["ip_lt_u"], static["ip_lt_sign"],
        )
        fit = fit & IP.match_interpod(
            cnt_lt, own_lt, carry["ip_spec_total"], static["ip_lt_spec"],
            pod["ip_match_spec"], pod["ip_ha_lt"], pod["ip_ha_self"],
            pod["ip_hq_lt"], pod["ip_has_affinity"], pod["ip_has_anti"],
            pod["ip_sym_reject"], num_nodes,
        )
    return fit


def _gather_lt(static, table):
    return IP.gather_lt(table, static["ip_u_topo"], static["ip_topo_dom"],
                        static["ip_lt_u"], static["ip_lt_sign"])


def evaluate_pod(config: SchedulerConfig, num_zones: int, num_values: int,
                 static, carry, pod):
    """Fit mask + weighted priority total for one pod against a frozen
    carry — Schedule() up to selectHost (generic_scheduler.go:72-115)."""
    res = carry["res"]
    nz_mcpu, nz_mem = res[3], res[4]
    num_nodes = res.shape[1]
    svc_labels = service_config_labels(config)
    cnt_lt = None
    if wants_interpod(config):
        cnt_lt = interpod_carry_tables(static, carry["ip_term_count"],
                                       num_nodes)

    fit = fit_mask(config, static, carry, pod, cnt_lt, include_resources=True)

    score = torch.zeros((num_nodes,), dtype=I64, device=res.device)
    for name, weight in config.priorities:
        if name == LEAST_REQUESTED:
            s = R.least_requested(
                pod["nz_mcpu"], pod["nz_mem"], nz_mcpu, nz_mem,
                static["alloc_mcpu"], static["alloc_mem"],
            )
        elif name == BALANCED_ALLOCATION:
            s = R.balanced_resource_allocation(
                pod["nz_mcpu"], pod["nz_mem"], nz_mcpu, nz_mem,
                static["alloc_mcpu"], static["alloc_mem"],
            )
        elif name == SELECTOR_SPREAD:
            s = R.selector_spread(
                pod["has_selectors"], pod["spread_match"],
                carry["class_count"], static["zone_id"], num_zones, fit,
            )
        elif name == NODE_AFFINITY:
            s = R.node_affinity_preferred(
                pod["pref_valid"], pod["pref_weight"], pod["pref_ops"],
                pod["pref_key"], pod["pref_set"], pod["pref_numkey"],
                pod["pref_num"], static["label_kv"], static["label_key"],
                static["numval"], static["set_table"], fit,
            )
        elif name == TAINT_TOLERATION:
            s = R.taint_toleration(
                pod["intolerable_prefer"], static["taint_count"], fit,
            )
        elif name == INTER_POD_AFFINITY:
            s = IP.interpod_priority(
                cnt_lt,
                _gather_lt(static, carry["ip_rev_hard"]),
                _gather_lt(static, carry["ip_rev_pref"]),
                _gather_lt(static, carry["ip_rev_anti"]),
                static["ip_lt_spec"], pod["ip_match_spec"],
                pod["ip_fwd_lt"], pod["ip_fwd_w"],
                config.hard_pod_affinity_weight, fit, num_nodes,
            )
        elif name == EQUAL:
            s = R.equal(num_nodes, device=res.device)
        elif name == IMAGE_LOCALITY:
            s = R.image_locality(static["img_size"], pod["img_count"])
        elif isinstance(name, tuple) and name[0] == NODE_LABEL_PRIORITY:
            s = R.node_label(static[f"nl_prio_{name[1]}"], name[2])
        elif isinstance(name, tuple) and name[0] == SERVICE_ANTI_AFFINITY:
            s = SV.service_anti_affinity(
                carry["svc_peer_node_count"], carry["svc_peer_total"],
                static["svc_lbl_val"][svc_labels.index(name[1])],
                pod["svc_group"], fit, num_values, num_nodes,
            )
        else:
            raise ValueError(f"unknown priority {name!r}")
        score = score + int(weight) * s

    return fit, score


def _scan_fn(config: SchedulerConfig, num_zones: int, num_values: int,
             static, carry, pod):
    """One scan step: evaluate, select, and commit into `carry` in place.
    -> (carry, chosen 0-d tensor, -1 == unschedulable)."""
    fit, score = evaluate_pod(config, num_zones, num_values, static, carry,
                              pod)
    chosen, scheduled = S.select_host(score, fit, carry["last_idx"],
                                      static["name_desc_order"])

    # commit (AssumePod): fold the pod into the carry where scheduled.
    # NodeInfo accounting uses container sums WITHOUT the init-container
    # max rule (node_info.go:158), hence commit_* not req_*. Every
    # scatter below writes one index, so it is deterministic on CUDA.
    safe = chosen.clamp(min=0).view(1)
    inc = scheduled.to(I64)
    commit = torch.stack([
        pod["commit_mcpu"], pod["commit_mem"], pod["commit_gpu"],
        pod["nz_mcpu"], pod["nz_mem"], torch.ones_like(inc),
    ]) * inc
    carry["res"].index_add_(1, safe, commit[:, None])
    pm = carry["port_mask"]
    pm.index_copy_(0, safe, pm.index_select(0, safe)
                   | (pod["port_mask"] * inc)[None, :])
    carry["class_count"].index_put_(
        (safe, pod["class_id"].view(1)), inc.view(1), accumulate=True)
    carry["last_idx"] += inc
    if wants_interpod(config):
        IP.interpod_commit(
            carry["ip_term_count"], carry["ip_own_anti"],
            carry["ip_rev_hard"], carry["ip_rev_pref"],
            carry["ip_rev_anti"], carry["ip_spec_total"],
            static["ip_topo_dom"], static["ip_u_topo"], static["ip_u_spec"],
            static["ip_lt_u"], pod["ip_match_spec"], pod["ip_own_hard"],
            pod["ip_own_pref"], pod["ip_own_anti_hard"],
            pod["ip_own_anti_pref"], chosen, scheduled,
        )
    if any(k in config.predicates for k in (
            NO_DISK_CONFLICT, MAX_EBS_VOLUME_COUNT, MAX_GCE_PD_VOLUME_COUNT)):
        sel = inc * 0xFFFFFFFF
        for key, bits in (
            ("vol_any", pod["vp_vol_rw"] | pod["vp_vol_ro"]),
            ("vol_rw", pod["vp_vol_rw"]),
            ("ebs_mask", pod["vp_ebs"]),
            ("gce_mask", pod["vp_gce"]),
        ):
            t = carry[key]
            t.index_copy_(0, safe, t.index_select(0, safe)
                          | (bits & sel)[None, :])
    if service_config_labels(config):
        SV.service_commit(
            carry["svc_first_peer"], carry["svc_peer_node_count"],
            carry["svc_peer_total"], static["svc_node_ord"],
            pod["svc_member"], chosen, scheduled,
        )
    return carry, chosen


def num_zones_of(snap: ClusterSnapshot) -> int:
    """Zone vocabulary size (ids are dense from encoding; 0 == none)."""
    return max(int(snap.zone_id.max()) + 1 if snap.zone_id.size else 1, 1)


class BatchScheduler:
    """Schedule a pending-pod backlog against a snapshot, bit-identically
    to the serial reference loop, on `device`."""

    POD_FIELDS = [
        "req_mcpu", "req_mem", "req_gpu", "zero_req",
        "commit_mcpu", "commit_mem", "commit_gpu", "nz_mcpu", "nz_mem",
        "host_req", "port_mask",
        "ns_ops", "ns_key", "ns_set", "ns_numkey", "ns_num",
        "aff_has_req", "aff_term_valid", "aff_ops", "aff_key", "aff_set",
        "aff_numkey", "aff_num",
        "pref_valid", "pref_weight", "pref_ops", "pref_key", "pref_set",
        "pref_numkey", "pref_num",
        "tol_mask", "intolerable_prefer", "has_tolerations", "best_effort",
        "has_selectors", "spread_match", "class_id", "unschedulable",
        "ip_match_spec", "ip_ha_lt", "ip_ha_self", "ip_hq_lt", "ip_fwd_lt",
        "ip_fwd_w", "ip_own_hard", "ip_own_pref", "ip_own_anti_hard",
        "ip_own_anti_pref", "ip_has_affinity", "ip_has_anti",
        "ip_sym_reject", "ip_poison",
        "vp_vol_rw", "vp_vol_ro", "vp_ebs", "vp_gce", "vp_ebs_bad",
        "vp_gce_bad", "vp_has_ebs", "vp_has_gce", "vp_vz_zone",
        "vp_vz_region", "vp_vz_fail",
        "img_count", "svc_group", "svc_member", "svc_fixed",
    ]
    STATIC_FIELDS = [
        "alloc_mcpu", "alloc_mem", "alloc_gpu", "alloc_pods",
        "label_kv", "label_key", "numval",
        "taint_mask", "taint_count", "has_taints", "taint_bad",
        "mem_pressure", "zone_id", "name_desc_order", "set_table",
        "noschedule_taints", "prefer_taints",
        "ip_topo_dom", "ip_u_topo", "ip_u_spec", "ip_lt_spec", "ip_lt_u",
        "ip_lt_sign",
        "ebs_bad", "gce_bad", "vz_zone", "vz_region", "vz_has",
        "img_size", "svc_lbl_val", "svc_node_ord", "svc_ord_node",
    ]

    @classmethod
    def config_static(cls, config: SchedulerConfig, snap: ClusterSnapshot):
        """Per-node static HOST arrays for config-parameterized entries
        (NodeLabel predicates/priorities), resolved from the snapshot's
        host-side key vocab."""
        out = {}
        for entry in config.predicates:
            if isinstance(entry, tuple) and entry[0] == NODE_LABEL_PREDICATE:
                for lbl in entry[1]:
                    out[f"nl_pred_{lbl}"] = np.asarray(snap.node_has_key(lbl))
        for name, _w in config.priorities:
            if isinstance(name, tuple) and name[0] == NODE_LABEL_PRIORITY:
                out[f"nl_prio_{name[1]}"] = np.asarray(
                    snap.node_has_key(name[1]))
        return out

    def __init__(self, config: Optional[SchedulerConfig] = None,
                 device="cuda"):
        self.config = config or SchedulerConfig()
        self.device = torch.device(device)

    def place_static(self, snap: ClusterSnapshot):
        """The snapshot's static node tables on the device."""
        static = to_device(snap, self.device, self.STATIC_FIELDS)
        static.update({k: place(v, self.device) for k, v in
                       self.config_static(self.config, snap).items()})
        return static

    def initial_carry(self, snap: ClusterSnapshot, last_node_index: int = 0):
        carry = to_device(snap, self.device, CARRY_FIELDS[1:3]
                          + CARRY_FIELDS[4:])
        carry["res"] = place(
            np.stack([np.asarray(getattr(snap, f))
                      for f in RES_CARRY_FIELDS]), self.device)
        # selectHost's persistent round-robin counter
        # (generic_scheduler.go:127 lastNodeIndex)
        carry["last_idx"] = torch.tensor(int(last_node_index), dtype=I64,
                                         device=self.device)
        return {k: carry[k] for k in CARRY_FIELDS}

    def run(self, static, carry, pods, num_zones: int, num_values: int):
        """Scan the placed pods (name -> [P, ...] tensors) through
        `carry`, in place. -> chosen i64[P] on the device."""
        P_ = pods["req_mcpu"].shape[0]
        chosen = torch.empty((P_,), dtype=I64, device=self.device)
        for i in range(P_):
            pod = {f: pods[f][i] for f in self.POD_FIELDS}
            _carry, chosen[i] = _scan_fn(self.config, num_zones, num_values,
                                         static, carry, pod)
        return chosen

    def schedule(self, snap: ClusterSnapshot, batch: PodBatch,
                 last_node_index: int = 0):
        """Returns (chosen_node_index[P] int32 with -1 == unschedulable,
        final carry dict). carry["last_idx"] is the post-wave
        lastNodeIndex."""
        carry = self.initial_carry(snap, last_node_index)
        if snap.num_nodes == 0:
            # empty cluster: every pod fails with FitError in the reference
            return np.full(batch.num_pods, -1, np.int32), carry
        static = self.place_static(snap)
        pods = to_device(batch, self.device, self.POD_FIELDS)
        chosen = self.run(static, carry, pods, num_zones_of(snap),
                          int(snap.svc_num_values))
        return chosen.cpu().numpy().astype(np.int32), carry

    def schedule_names(self, snap: ClusterSnapshot, batch: PodBatch):
        """Like schedule() but returns node names (None == unschedulable)."""
        chosen, _ = self.schedule(snap, batch)
        return [snap.node_names[i] if i >= 0 else None for i in chosen]

    def debug_evaluate(self, snap: ClusterSnapshot, batch: PodBatch):
        """Per-(pod, node) fit and weighted score against the initial
        carry, with no commits between pods: how the reference unit
        tables (predicates_test.go / priorities_test.go) exercise each
        function, and what the extender service's filter and prioritize
        answer. Returns (fit[P, N] bool, score[P, N] int64) as numpy."""
        static = self.place_static(snap)
        pods = to_device(batch, self.device, self.POD_FIELDS)
        carry = self.initial_carry(snap)
        num_zones, num_values = num_zones_of(snap), int(snap.svc_num_values)
        fits, scores = [], []
        for i in range(batch.num_pods):
            fit, score = evaluate_pod(
                self.config, num_zones, num_values, static, carry,
                {f: pods[f][i] for f in self.POD_FIELDS})
            fits.append(fit)
            scores.append(score)
        N = snap.num_nodes
        if not fits:
            return np.zeros((0, N), bool), np.zeros((0, N), np.int64)
        return (torch.stack(fits).cpu().numpy(),
                torch.stack(scores).cpu().numpy())
