"""Fit predicates — exact reference semantics.

Reference: plugin/pkg/scheduler/algorithm/predicates/predicates.go and
error.go. Each predicate returns (fit: bool, reason: str|None); the reason
strings reproduce error.go:31-44 / InsufficientResourceError formatting so
the user-facing "explain" output matches.

Copy of kubernetes_tpu/oracle/predicates.py: only the import package differs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from kubernetes_tpu_torch.api import labels as labelpkg
from kubernetes_tpu_torch.api.resource import (
    parse_quantity,
    resource_list_cpu_milli,
    resource_list_memory,
)
from kubernetes_tpu_torch.api.types import (
    LabelSelector,
    Node,
    NodeSelectorTerm,
    Pod,
    PodAffinityTerm,
    get_affinity,
    get_taints,
    get_tolerations,
    pod_resource_request,
)
from kubernetes_tpu_torch.oracle.state import ClusterState, NodeInfo

# unversioned.LabelZone* constants.
LABEL_ZONE_FAILURE_DOMAIN = "failure-domain.beta.kubernetes.io/zone"
LABEL_ZONE_REGION = "failure-domain.beta.kubernetes.io/region"
LABEL_HOSTNAME = "kubernetes.io/hostname"

# api.DefaultFailureDomains (used for empty topologyKey in anti-affinity).
DEFAULT_FAILURE_DOMAINS = (
    LABEL_HOSTNAME,
    LABEL_ZONE_FAILURE_DOMAIN,
    LABEL_ZONE_REGION,
)

# defaults.go:37 + cloudprovider aws defaults.
DEFAULT_MAX_GCE_PD_VOLUMES = 16
DEFAULT_MAX_EBS_VOLUMES = 39

# error.go:31-44 — stable failure reasons.
ERR_DISK_CONFLICT = "NoDiskConflict"
ERR_VOLUME_ZONE_CONFLICT = "NoVolumeZoneConflict"
ERR_NODE_SELECTOR_NOT_MATCH = "MatchNodeSelector"
ERR_POD_NOT_MATCH_HOST_NAME = "HostName"
ERR_POD_NOT_FITS_HOST_PORTS = "PodFitsHostPorts"
ERR_NODE_LABEL_PRESENCE_VIOLATED = "CheckNodeLabelPresence"
ERR_SERVICE_AFFINITY_VIOLATED = "CheckServiceAffinity"
ERR_MAX_VOLUME_COUNT_EXCEEDED = "MaxVolumeCount"
ERR_POD_AFFINITY_NOT_MATCH = "MatchInterPodAffinity"
ERR_TAINTS_TOLERATIONS_NOT_MATCH = "PodToleratesNodeTaints"
ERR_NODE_UNDER_MEMORY_PRESSURE = "NodeUnderMemoryPressure"


def insufficient_resource_error(resource: str, requested: int, used: int, capacity: int) -> str:
    """error.go:49-69 InsufficientResourceError.Error()."""
    return (
        f"Node didn't have enough resource: {resource}, "
        f"requested: {requested}, used: {used}, capacity: {capacity}"
    )


# --- selector compilation helpers ------------------------------------------


def node_selector_requirements_as_selector(reqs) -> Optional[labelpkg.Selector]:
    """pkg/api/helpers.go:373 — empty list => Nothing; any requirement that
    labels.NewRequirement (selector.go:116-144) would reject => None
    (parse error => caller regards the whole term list as no-match)."""
    if not reqs:
        return labelpkg.nothing()
    out = []
    for r in reqs:
        if not _requirement_valid(r):
            return None
        out.append(labelpkg.new_requirement(r.key, r.operator, r.values))
    return labelpkg.Selector(tuple(out))


def _requirement_valid(r) -> bool:
    """labels.NewRequirement validation (selector.go:116-144)."""
    if not r.key:
        return False
    if r.operator in (labelpkg.IN, labelpkg.NOT_IN):
        return len(r.values) > 0
    if r.operator in (labelpkg.EXISTS, labelpkg.DOES_NOT_EXIST):
        return len(r.values) == 0
    if r.operator in (labelpkg.GT, labelpkg.LT):
        if len(r.values) != 1:
            return False
        try:
            float(next(iter(r.values)))
            return True
        except (TypeError, ValueError):
            return False
    return False  # unrecognized operator


def label_selector_as_selector(sel: Optional[LabelSelector]) -> labelpkg.Selector:
    """pkg/apis/unversioned/helpers.go LabelSelectorAsSelector:
    nil => Nothing, empty => Everything, else matchLabels AND matchExpressions."""
    if sel is None:
        return labelpkg.nothing()
    if not sel.match_labels and not sel.match_expressions:
        return labelpkg.everything()
    reqs = []
    for k in sorted(sel.match_labels):
        reqs.append(labelpkg.new_requirement(k, labelpkg.IN, [sel.match_labels[k]]))
    for e in sel.match_expressions:
        op = {
            "In": labelpkg.IN,
            "NotIn": labelpkg.NOT_IN,
            "Exists": labelpkg.EXISTS,
            "DoesNotExist": labelpkg.DOES_NOT_EXIST,
        }.get(e.operator)
        if op is None:
            return labelpkg.nothing()
        reqs.append(labelpkg.new_requirement(e.key, op, e.values))
    return labelpkg.Selector(tuple(reqs))


# --- GeneralPredicates members ---------------------------------------------


def pod_fits_resources(pod: Pod, info: NodeInfo, state: ClusterState):
    """predicates.go:416 PodFitsResources."""
    node = info.node
    if node is None:
        return False, "node not found"
    allowed_pods = parse_quantity(node.status.allocatable.get("pods", 0)).value()
    if len(info.pods) + 1 > allowed_pods:
        return False, insufficient_resource_error("PodCount", 1, len(info.pods), allowed_pods)
    req_cpu, req_mem, req_gpu = pod_resource_request(pod)
    if req_cpu == 0 and req_mem == 0 and req_gpu == 0:
        return True, None
    total_cpu = resource_list_cpu_milli(node.status.allocatable)
    total_mem = resource_list_memory(node.status.allocatable)
    total_gpu = parse_quantity(
        node.status.allocatable.get("alpha.kubernetes.io/nvidia-gpu", 0)
    ).value()
    if total_cpu < req_cpu + info.requested_milli_cpu:
        return False, insufficient_resource_error("CPU", req_cpu, info.requested_milli_cpu, total_cpu)
    if total_mem < req_mem + info.requested_memory:
        return False, insufficient_resource_error("Memory", req_mem, info.requested_memory, total_mem)
    if total_gpu < req_gpu + info.requested_gpu:
        return False, insufficient_resource_error("NvidiaGpu", req_gpu, info.requested_gpu, total_gpu)
    return True, None


def node_matches_node_selector_terms(node: Node, terms: Sequence[NodeSelectorTerm]) -> bool:
    """predicates.go:455 — terms ORed; empty term list matches nothing."""
    for term in terms:
        sel = node_selector_requirements_as_selector(term.match_expressions)
        if sel is None:
            return False  # parse failure => regard as not match
        if sel.matches(node.metadata.labels):
            return True
    return False


def pod_matches_node_labels(pod: Pod, node: Node) -> bool:
    """predicates.go:470 PodMatchesNodeLabels: nodeSelector AND required
    NodeAffinity; NodeAffinity with nil Required short-circuits to true."""
    if pod.spec.node_selector:
        sel = labelpkg.selector_from_set(pod.spec.node_selector)
        if not sel.matches(node.metadata.labels):
            return False
    affinity = get_affinity(pod)
    if affinity is not None and affinity.node_affinity is not None:
        na = affinity.node_affinity
        if na.required_during_scheduling_ignored_during_execution is None:
            return True
        return node_matches_node_selector_terms(
            node, na.required_during_scheduling_ignored_during_execution.node_selector_terms
        )
    return True


def pod_selector_matches(pod: Pod, info: NodeInfo, state: ClusterState):
    if info.node is None:
        return False, "node not found"
    if pod_matches_node_labels(pod, info.node):
        return True, None
    return False, ERR_NODE_SELECTOR_NOT_MATCH


def pod_fits_host(pod: Pod, info: NodeInfo, state: ClusterState):
    """predicates.go:533 PodFitsHost."""
    if not pod.spec.node_name:
        return True, None
    if info.node is None:
        return False, "node not found"
    if pod.spec.node_name == info.node.name:
        return True, None
    return False, ERR_POD_NOT_MATCH_HOST_NAME


def get_used_ports(*pods: Pod) -> Set[int]:
    """predicates.go:704 getUsedPorts (0 excluded by the caller)."""
    ports: Set[int] = set()
    for pod in pods:
        for c in pod.spec.containers:
            for p in c.ports:
                if p.host_port != 0:
                    ports.add(p.host_port)
    return ports


def pod_fits_host_ports(pod: Pod, info: NodeInfo, state: ClusterState):
    """predicates.go:687 PodFitsHostPorts."""
    want = get_used_ports(pod)
    if not want:
        return True, None
    existing = get_used_ports(*info.pods)
    for port in want:
        if port == 0:
            continue
        if port in existing:
            return False, ERR_POD_NOT_FITS_HOST_PORTS
    return True, None


def general_predicates(pod: Pod, info: NodeInfo, state: ClusterState):
    """predicates.go:733 — resources, host, ports, selector, in order."""
    for fn in (pod_fits_resources, pod_fits_host, pod_fits_host_ports, pod_selector_matches):
        fit, reason = fn(pod, info, state)
        if not fit:
            return fit, reason
    return True, None


# --- volume predicates ------------------------------------------------------


def _is_volume_conflict(volume, pod: Pod) -> bool:
    """predicates.go:64-95 isVolumeConflict."""
    if (
        volume.gce_persistent_disk is None
        and volume.aws_elastic_block_store is None
        and volume.rbd is None
    ):
        return False
    for ev in pod.spec.volumes:
        if volume.gce_persistent_disk is not None and ev.gce_persistent_disk is not None:
            d, ed = volume.gce_persistent_disk, ev.gce_persistent_disk
            if d.pd_name == ed.pd_name and not (d.read_only and ed.read_only):
                return True
        if (
            volume.aws_elastic_block_store is not None
            and ev.aws_elastic_block_store is not None
        ):
            if volume.aws_elastic_block_store.volume_id == ev.aws_elastic_block_store.volume_id:
                return True
        if volume.rbd is not None and ev.rbd is not None:
            a, b = volume.rbd, ev.rbd
            if (
                any(m in b.monitors for m in a.monitors)
                and a.pool == b.pool
                and a.image == b.image
            ):
                return True
    return False


def no_disk_conflict(pod: Pod, info: NodeInfo, state: ClusterState):
    """predicates.go:105 NoDiskConflict."""
    for v in pod.spec.volumes:
        for existing_pod in info.pods:
            if _is_volume_conflict(v, existing_pod):
                return False, ERR_DISK_CONFLICT
    return True, None


def _filter_volumes(volumes, namespace: str, filter_kind: str, state: ClusterState, out: Dict[str, bool]):
    """predicates.go:148-179 MaxPDVolumeCountChecker.filterVolumes.
    filter_kind is 'ebs' or 'gce-pd'. Raises KeyError style errors -> caller
    maps to predicate error (reference propagates err => pod marked unfit)."""
    for vol in volumes:
        if filter_kind == "ebs" and vol.aws_elastic_block_store is not None:
            out[vol.aws_elastic_block_store.volume_id] = True
        elif filter_kind == "gce-pd" and vol.gce_persistent_disk is not None:
            out[vol.gce_persistent_disk.pd_name] = True
        elif vol.persistent_volume_claim is not None:
            pvc_name = vol.persistent_volume_claim.claim_name
            if not pvc_name:
                raise ValueError("PersistentVolumeClaim had no name")
            pvc = state.pvcs.get((namespace, pvc_name))
            if pvc is None:
                raise ValueError(f"PVC not found: {pvc_name}")
            pv_name = pvc.volume_name
            if not pv_name:
                raise ValueError(f"PVC is not bound: {pvc_name}")
            pv = state.pvs.get(pv_name)
            if pv is None:
                raise ValueError(f"PV not found: {pv_name}")
            if filter_kind == "ebs" and pv.aws_elastic_block_store is not None:
                out[pv.aws_elastic_block_store.volume_id] = True
            elif filter_kind == "gce-pd" and pv.gce_persistent_disk is not None:
                out[pv.gce_persistent_disk.pd_name] = True


def max_pd_volume_count(filter_kind: str, max_volumes: int):
    """predicates.go:137 NewMaxPDVolumeCountPredicate."""

    def predicate(pod: Pod, info: NodeInfo, state: ClusterState):
        new_volumes: Dict[str, bool] = {}
        try:
            _filter_volumes(pod.spec.volumes, pod.namespace, filter_kind, state, new_volumes)
        except ValueError as e:
            return False, str(e)
        if not new_volumes:
            return True, None
        existing: Dict[str, bool] = {}
        for ep in info.pods:
            try:
                _filter_volumes(ep.spec.volumes, ep.namespace, filter_kind, state, existing)
            except ValueError as e:
                return False, str(e)
        num_existing = len(existing)
        for k in existing:
            new_volumes.pop(k, None)
        if num_existing + len(new_volumes) > max_volumes:
            return False, ERR_MAX_VOLUME_COUNT_EXCEEDED
        return True, None

    return predicate


def volume_zone(pod: Pod, info: NodeInfo, state: ClusterState):
    """predicates.go:271 VolumeZoneChecker.predicate."""
    node = info.node
    if node is None:
        return False, "node not found"
    constraints = {
        k: v
        for k, v in node.metadata.labels.items()
        if k in (LABEL_ZONE_FAILURE_DOMAIN, LABEL_ZONE_REGION)
    }
    if not constraints:
        return True, None
    for vol in pod.spec.volumes:
        if vol.persistent_volume_claim is None:
            continue
        pvc_name = vol.persistent_volume_claim.claim_name
        if not pvc_name:
            return False, "PersistentVolumeClaim had no name"
        pvc = state.pvcs.get((pod.namespace, pvc_name))
        if pvc is None:
            return False, f"PVC not found: {pvc_name}"
        pv_name = pvc.volume_name
        if not pv_name:
            return False, f"PVC is not bound: {pvc_name}"
        pv = state.pvs.get(pv_name)
        if pv is None:
            return False, f"PV not found: {pv_name}"
        for k, v in pv.metadata.labels.items():
            if k not in (LABEL_ZONE_FAILURE_DOMAIN, LABEL_ZONE_REGION):
                continue
            if v != constraints.get(k, ""):
                return False, ERR_VOLUME_ZONE_CONFLICT
    return True, None


# --- taints / memory pressure ----------------------------------------------


def toleration_tolerates_taint(tol, taint) -> bool:
    """pkg/api/helpers.go:459."""
    if tol.effect and tol.effect != taint.effect:
        return False
    if tol.key != taint.key:
        return False
    if (not tol.operator or tol.operator == "Equal") and tol.value == taint.value:
        return True
    return tol.operator == "Exists"


def taint_tolerated_by_tolerations(taint, tolerations) -> bool:
    return any(toleration_tolerates_taint(t, taint) for t in tolerations)


def pod_tolerates_node_taints(pod: Pod, info: NodeInfo, state: ClusterState):
    """predicates.go:960 PodToleratesNodeTaints + :979
    tolerationsToleratesTaints — note: a non-empty taint list with an empty
    toleration list is rejected even if all taints are PreferNoSchedule.
    A malformed taints/tolerations annotation is an error => unfit."""
    try:
        taints = get_taints(info.node)
        tolerations = get_tolerations(pod)
    except Exception:
        return False, ERR_TAINTS_TOLERATIONS_NOT_MATCH
    if not taints:
        return True, None
    if not tolerations:
        return False, ERR_TAINTS_TOLERATIONS_NOT_MATCH
    for taint in taints:
        if taint.effect == "PreferNoSchedule":
            continue
        if not taint_tolerated_by_tolerations(taint, tolerations):
            return False, ERR_TAINTS_TOLERATIONS_NOT_MATCH
    return True, None


def is_pod_best_effort(pod: Pod) -> bool:
    """qos/util/qos.go:54 GetPodQos == BestEffort: no container has any
    request or limit with quantity > 0."""
    for c in pod.spec.containers:
        for q in list(c.requests.values()) + list(c.limits.values()):
            if parse_quantity(q).value_frac > 0:
                return False
    return True


def check_node_memory_pressure(pod: Pod, info: NodeInfo, state: ClusterState):
    """predicates.go:1011 CheckNodeMemoryPressurePredicate."""
    if info.node is None:
        return False, "node not found"
    if not is_pod_best_effort(pod):
        return True, None
    for cond in info.node.status.conditions:
        if cond.type == "MemoryPressure" and cond.status == "True":
            return False, ERR_NODE_UNDER_MEMORY_PRESSURE
    return True, None


# --- node label / service affinity (policy-configured) ----------------------


def node_label_predicate(label_list: Sequence[str], presence: bool):
    """predicates.go:552 NewNodeLabelPredicate (CheckNodeLabelPresence)."""

    def predicate(pod: Pod, info: NodeInfo, state: ClusterState):
        node = info.node
        if node is None:
            return False, "node not found"
        for l in label_list:
            exists = l in node.metadata.labels
            if (exists and not presence) or (not exists and presence):
                return False, ERR_NODE_LABEL_PRESENCE_VIOLATED
        return True, None

    return predicate


def service_affinity_predicate(affinity_labels: Sequence[str]):
    """predicates.go:596 NewServiceAffinityPredicate: pin the pod to nodes
    sharing the given label values with peers of its service(s). The implicit
    selector is built from the pod's nodeSelector for the affinity labels,
    else from the node of some existing peer pod of a matching service."""

    def predicate(pod: Pod, info: NodeInfo, state: ClusterState):
        node = info.node
        if node is None:
            return False, "node not found"
        affinity_selector: Dict[str, str] = {}
        # labels exactly specified on the pod's nodeSelector win
        unresolved = []
        for l in affinity_labels:
            if l in pod.spec.node_selector:
                affinity_selector[l] = pod.spec.node_selector[l]
            else:
                unresolved.append(l)
        if unresolved:
            # find services matching this pod, then their pods (same ns)
            services = get_pod_services(state, pod)
            if services:
                ns_pods = [
                    p
                    for p in state.all_assigned_pods()
                    if p.namespace == pod.namespace
                ]
                sel = labelpkg.selector_from_set(services[0].spec.selector)
                service_pods = [p for p in ns_pods if sel.matches(p.metadata.labels)]
                if service_pods:
                    other = state.node_infos.get(service_pods[0].spec.node_name)
                    if other is None or other.node is None:
                        return False, "node not found"
                    for l in unresolved:
                        if l in other.node.metadata.labels:
                            affinity_selector[l] = other.node.metadata.labels[l]
        if labelpkg.selector_from_set(affinity_selector).matches(node.metadata.labels):
            return True, None
        return False, ERR_SERVICE_AFFINITY_VIOLATED

    return predicate


def get_pod_services(state: ClusterState, pod: Pod):
    """listers.go:77 — same-namespace services whose selector (set-as-selector,
    empty set matches everything) matches the pod labels."""
    out = []
    for svc in state.services:
        if svc.metadata.namespace != pod.namespace:
            continue
        if labelpkg.selector_from_set(svc.spec.selector).matches(pod.metadata.labels):
            out.append(svc)
    return out


def get_pod_controllers(state: ClusterState, pod: Pod):
    out = []
    for rc in state.controllers:
        if rc.metadata.namespace != pod.namespace:
            continue
        if labelpkg.selector_from_set(rc.spec.selector).matches(pod.metadata.labels):
            out.append(rc)
    return out


def get_pod_replica_sets(state: ClusterState, pod: Pod):
    out = []
    for rs in state.replica_sets:
        if rs.metadata.namespace != pod.namespace:
            continue
        if label_selector_as_selector(rs.spec.selector).matches(pod.metadata.labels):
            out.append(rs)
    return out


# --- inter-pod affinity -----------------------------------------------------


def get_namespaces_from_term(pod: Pod, term: PodAffinityTerm) -> Optional[Set[str]]:
    """util/non_zero.go:96 GetNamespacesFromPodAffinityTerm. We model the
    nil-vs-empty distinction with None (=> pod's own ns) vs () (=> all)."""
    if term.namespaces is None:
        return {pod.namespace}
    if len(term.namespaces) == 0:
        return set()  # empty set == all namespaces
    return set(term.namespaces)


def nodes_have_same_topology_key(
    node_a: Optional[Node], node_b: Optional[Node], topology_key: str,
    default_keys: Sequence[str] = DEFAULT_FAILURE_DOMAINS,
) -> bool:
    """util/non_zero.go:97-113 Topologies.NodesHaveSameTopologyKey."""
    if node_a is None or node_b is None:
        return False

    def same(key: str) -> bool:
        va = node_a.metadata.labels.get(key, "")
        vb = node_b.metadata.labels.get(key, "")
        return len(va) > 0 and va == vb

    if not topology_key:
        return any(same(k) for k in default_keys)
    return same(topology_key)


def check_if_pod_match_term(
    pod_a: Pod,
    pod_b: Pod,
    term: PodAffinityTerm,
    node_a: Optional[Node],
    node_b: Optional[Node],
    default_keys: Sequence[str] = DEFAULT_FAILURE_DOMAINS,
) -> bool:
    """util/non_zero.go:114 CheckIfPodMatchPodAffinityTerm: podB's term vs
    podA. node_a None models a GetNodeInfo error => no match."""
    names = get_namespaces_from_term(pod_b, term)
    if len(names) != 0 and pod_a.namespace not in names:
        return False
    sel = label_selector_as_selector(term.label_selector)
    if not sel.matches(pod_a.metadata.labels):
        return False
    return nodes_have_same_topology_key(node_a, node_b, term.topology_key, default_keys)


def _ep_node(state: ClusterState, ep: Pod) -> Optional[Node]:
    info = state.get_node_info_any(ep.spec.node_name)
    return info.node if info is not None else None


def any_pod_matches_term(
    pod: Pod, all_pods: Sequence[Pod], node: Node, term: PodAffinityTerm, state: ClusterState
) -> bool:
    """predicates.go:784 AnyPodMatchesPodAffinityTerm."""
    for ep in all_pods:
        if check_if_pod_match_term(ep, pod, term, _ep_node(state, ep), node):
            return True
    return False


def _node_matches_hard_pod_affinity(pod, all_pods, node, pod_affinity, state) -> bool:
    """predicates.go:800-849, including the first-pod-of-collection escape."""
    terms = list(pod_affinity.required_during_scheduling_ignored_during_execution)
    for term in terms:
        if any_pod_matches_term(pod, all_pods, node, term, state):
            continue
        # escape hatch: the term matches the pod itself and no existing pod
        # in the term's namespaces matches the selector anywhere.
        names = get_namespaces_from_term(pod, term)
        sel = label_selector_as_selector(term.label_selector)
        if pod.namespace not in names or not sel.matches(pod.metadata.labels):
            return False
        filtered = [p for p in all_pods if not names or p.namespace in names]
        for fp in filtered:
            if sel.matches(fp.metadata.labels):
                return False
    return True


def _node_matches_hard_pod_anti_affinity(pod, all_pods, node, pod_anti_affinity, state) -> bool:
    """predicates.go:858-921 incl. the symmetric existing-pod check."""
    for term in pod_anti_affinity.required_during_scheduling_ignored_during_execution:
        if any_pod_matches_term(pod, all_pods, node, term, state):
            return False
    for ep in all_pods:
        try:
            ep_aff = get_affinity(ep)
        except Exception:
            # predicates.go:902: annotation parse error => (false, err) —
            # the node fails for every pod running the symmetric check
            return False
        if ep_aff is None or ep_aff.pod_anti_affinity is None:
            continue
        for term in ep_aff.pod_anti_affinity.required_during_scheduling_ignored_during_execution:
            sel = label_selector_as_selector(term.label_selector)
            names = get_namespaces_from_term(ep, term)
            if (len(names) == 0 or pod.namespace in names) and sel.matches(
                pod.metadata.labels
            ):
                ep_node = _ep_node(state, ep)
                # GetNodeInfo error (unknown node) => reject, matching the
                # reference's `err != nil || sameTopology` disjunction.
                if ep_node is None or nodes_have_same_topology_key(
                    node, ep_node, term.topology_key
                ):
                    return False
    return True


def inter_pod_affinity_matches(pod: Pod, info: NodeInfo, state: ClusterState):
    """predicates.go:769 InterPodAffinityMatches (MatchInterPodAffinity)."""
    node = info.node
    if node is None:
        return False, "node not found"
    all_pods = state.all_assigned_pods()
    try:
        affinity = get_affinity(pod)
    except Exception:
        # predicates.go:775: parse error => (false, err) for every node
        return False, ERR_POD_AFFINITY_NOT_MATCH
    if affinity is not None:
        if affinity.pod_affinity is not None:
            if not _node_matches_hard_pod_affinity(
                pod, all_pods, node, affinity.pod_affinity, state
            ):
                return False, ERR_POD_AFFINITY_NOT_MATCH
        if affinity.pod_anti_affinity is not None:
            if not _node_matches_hard_pod_anti_affinity(
                pod, all_pods, node, affinity.pod_anti_affinity, state
            ):
                return False, ERR_POD_AFFINITY_NOT_MATCH
    else:
        # even with no affinity on the pod, existing pods' anti-affinity can
        # exclude it? No: the reference only runs the symmetric check inside
        # NodeMatchesHardPodAntiAffinity, which is gated on the POD having a
        # PodAntiAffinity. A pod with no affinity annotation gets
        # affinity.PodAffinity == nil and PodAntiAffinity == nil, so both
        # checks are skipped (predicates.go:928-945).
        pass
    return True, None
