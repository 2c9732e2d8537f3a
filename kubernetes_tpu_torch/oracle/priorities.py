"""Priority functions — exact reference semantics (integer/float math
reproduced operation-for-operation).

Reference: plugin/pkg/scheduler/algorithm/priorities/*.go. Every function
maps (pod, state) -> {node_name: int score 0..10}.

Copy of kubernetes_tpu/oracle/priorities.py: only the import package differs.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from kubernetes_tpu_torch.api import labels as labelpkg
from kubernetes_tpu_torch.api.resource import resource_list_cpu_milli, resource_list_memory
from kubernetes_tpu_torch.api.types import (
    Node,
    Pod,
    get_affinity,
    get_taints,
    get_tolerations,
)
from kubernetes_tpu_torch.oracle.predicates import (
    DEFAULT_FAILURE_DOMAINS,
    LABEL_ZONE_FAILURE_DOMAIN,
    LABEL_ZONE_REGION,
    check_if_pod_match_term,
    get_pod_controllers,
    get_pod_replica_sets,
    get_pod_services,
    label_selector_as_selector,
    node_selector_requirements_as_selector,
    taint_tolerated_by_tolerations,
)
from kubernetes_tpu_torch.oracle.state import ClusterState

MAX_PRIORITY = 10
ZONE_WEIGHTING = 2.0 / 3.0  # selector_spreading.go:38


class PriorityError(Exception):
    """A priority function returned an error (aborts the scheduling cycle
    without a FitError, generic_scheduler.go:109-112)."""

MB = 1024 * 1024
MIN_IMG_SIZE = 23 * MB  # priorities.go:138-142
MAX_IMG_SIZE = 1000 * MB

DEFAULT_HARD_POD_AFFINITY_WEIGHT = 1


def _pod_nonzero_sum(pod: Pod):
    """Sum of per-container nonzero requests (priorities.go:55-60 loop)."""
    cpu = 0
    mem = 0
    for c in pod.spec.containers:
        cpu += resource_list_cpu_milli(c.requests) if "cpu" in c.requests else 100
        mem += (
            resource_list_memory(c.requests)
            if "memory" in c.requests
            else 200 * 1024 * 1024
        )
    return cpu, mem


def calculate_score(requested: int, capacity: int) -> int:
    """priorities.go:33 — int64 math, truncating division."""
    if capacity == 0:
        return 0
    if requested > capacity:
        return 0
    # Go's integer division truncates toward zero; operands are >= 0 here.
    return ((capacity - requested) * 10) // capacity


def least_requested_priority(pod: Pod, state: ClusterState) -> Dict[str, int]:
    """priorities.go:81 LeastRequestedPriority."""
    pod_cpu, pod_mem = _pod_nonzero_sum(pod)
    out = {}
    for name, info in state.node_infos.items():
        node = info.node
        total_cpu = info.nonzero_milli_cpu + pod_cpu
        total_mem = info.nonzero_memory + pod_mem
        cap_cpu = resource_list_cpu_milli(node.status.allocatable)
        cap_mem = resource_list_memory(node.status.allocatable)
        cpu_score = calculate_score(total_cpu, cap_cpu)
        mem_score = calculate_score(total_mem, cap_mem)
        out[name] = (cpu_score + mem_score) // 2
    return out


def balanced_resource_allocation(pod: Pod, state: ClusterState) -> Dict[str, int]:
    """priorities.go:215 BalancedResourceAllocation (float64 fraction math)."""
    pod_cpu, pod_mem = _pod_nonzero_sum(pod)
    out = {}
    for name, info in state.node_infos.items():
        node = info.node
        total_cpu = info.nonzero_milli_cpu + pod_cpu
        total_mem = info.nonzero_memory + pod_mem
        cap_cpu = resource_list_cpu_milli(node.status.allocatable)
        cap_mem = resource_list_memory(node.status.allocatable)
        cpu_frac = (total_cpu / cap_cpu) if cap_cpu != 0 else 1.0
        mem_frac = (total_mem / cap_mem) if cap_mem != 0 else 1.0
        if cpu_frac >= 1 or mem_frac >= 1:
            out[name] = 0
        else:
            diff = abs(cpu_frac - mem_frac)
            out[name] = int(10 - diff * 10)
    return out


def equal_priority(pod: Pod, state: ClusterState) -> Dict[str, int]:
    """generic_scheduler.go:310 EqualPriority: 1 for every node."""
    return {name: 1 for name in state.node_infos}


def node_label_priority(label: str, presence: bool):
    """priorities.go:99 NewNodeLabelPriority: 10 if presence matches."""

    def fn(pod: Pod, state: ClusterState) -> Dict[str, int]:
        out = {}
        for name, info in state.node_infos.items():
            exists = label in info.node.metadata.labels
            out[name] = 10 if exists == presence else 0
        return out

    return fn


def image_locality_priority(pod: Pod, state: ClusterState) -> Dict[str, int]:
    """priorities.go:149 ImageLocalityPriority."""
    out = {}
    for name, info in state.node_infos.items():
        node = info.node
        sum_size = 0
        for c in pod.spec.containers:
            for image in node.status.images:
                if c.image in image.names:
                    sum_size += image.size_bytes
                    break
        out[name] = _score_from_size(sum_size)
    return out


def _score_from_size(sum_size: int) -> int:
    """priorities.go:192-207 calculateScoreFromSize."""
    if sum_size == 0 or sum_size < MIN_IMG_SIZE:
        return 0
    if sum_size >= MAX_IMG_SIZE:
        return 10
    return int(10 * (sum_size - MIN_IMG_SIZE) // (MAX_IMG_SIZE - MIN_IMG_SIZE) + 1)


def get_zone_key(node: Node) -> str:
    """selector_spreading.go:59 getZoneKey."""
    labels_ = node.metadata.labels
    region = labels_.get(LABEL_ZONE_REGION, "")
    failure_domain = labels_.get(LABEL_ZONE_FAILURE_DOMAIN, "")
    if region == "" and failure_domain == "":
        return ""
    return region + ":\x00:" + failure_domain


def selector_spread_priority(pod: Pod, state: ClusterState) -> Dict[str, int]:
    """selector_spreading.go:84 CalculateSpreadPriority.

    float32 arithmetic is reproduced with np.float32 so int(fScore)
    truncation matches Go exactly.
    """
    selectors: List[labelpkg.Selector] = []
    for svc in get_pod_services(state, pod):
        selectors.append(labelpkg.selector_from_set(svc.spec.selector))
    for rc in get_pod_controllers(state, pod):
        selectors.append(labelpkg.selector_from_set(rc.spec.selector))
    for rs in get_pod_replica_sets(state, pod):
        selectors.append(label_selector_as_selector(rs.spec.selector))

    counts: Dict[str, int] = {}
    if selectors:
        for name, info in state.node_infos.items():
            count = 0
            for np_ in info.pods:
                if pod.namespace != np_.namespace:
                    continue
                if np_.metadata.deletion_timestamp is not None:
                    # pending-deleted pods are ignored for spreading
                    # (selector_spreading.go:141-148)
                    continue
                if any(s.matches(np_.metadata.labels) for s in selectors):
                    count += 1
            counts[name] = count
    max_count = max(counts.values(), default=0)

    counts_by_zone: Dict[str, int] = {}
    for name, info in state.node_infos.items():
        if name not in counts:
            continue
        zone_id = get_zone_key(info.node)
        if zone_id == "":
            continue
        counts_by_zone[zone_id] = counts_by_zone.get(zone_id, 0) + counts[name]
    have_zones = len(counts_by_zone) != 0
    max_count_by_zone = max(counts_by_zone.values(), default=0)

    out = {}
    for name, info in state.node_infos.items():
        f_score = np.float32(MAX_PRIORITY)
        if max_count > 0:
            f_score = np.float32(MAX_PRIORITY) * (
                np.float32(max_count - counts.get(name, 0)) / np.float32(max_count)
            )
        if have_zones:
            zone_id = get_zone_key(info.node)
            if zone_id != "":
                with np.errstate(invalid="ignore", divide="ignore"):
                    # selector_spreading.go:224 has NO maxCountByZone>0
                    # guard: 0/0 is float32 NaN and Go's int(NaN) on amd64
                    # is minInt64 — reproduced below.
                    zone_score = np.float32(MAX_PRIORITY) * (
                        np.float32(max_count_by_zone - counts_by_zone.get(zone_id, 0))
                        / np.float32(max_count_by_zone)
                    )
                f_score = np.float32(f_score * np.float32(1.0 - ZONE_WEIGHTING)) + (
                    np.float32(ZONE_WEIGHTING) * zone_score
                )
        out[name] = -(2**63) if np.isnan(f_score) else int(f_score)
    return out


def service_anti_affinity_priority(label: str):
    """selector_spreading.go:244 NewServiceAntiAffinityPriority: spread the
    pod's service peers across values of a node label."""

    def fn(pod: Pod, state: ClusterState) -> Dict[str, int]:
        # "just use the first service" (selector_spreading.go:262-274)
        services = get_pod_services(state, pod)
        ns_service_pods: List[Pod] = []
        if services:
            sel = labelpkg.selector_from_set(services[0].spec.selector)
            ns_service_pods = [
                p
                for p in state.all_assigned_pods()
                if p.namespace == pod.namespace and sel.matches(p.metadata.labels)
            ]
        labeled_nodes: Dict[str, str] = {}
        other_nodes: List[str] = []
        for name, info in state.node_infos.items():
            if label in info.node.metadata.labels:
                labeled_nodes[name] = info.node.metadata.labels[label]
            else:
                other_nodes.append(name)
        pod_counts: Dict[str, int] = {}
        for p in ns_service_pods:
            value = labeled_nodes.get(p.spec.node_name)
            if value is None:
                continue
            pod_counts[value] = pod_counts.get(value, 0) + 1
        num_service_pods = len(ns_service_pods)
        out = {}
        for name, value in labeled_nodes.items():
            f = np.float32(MAX_PRIORITY)
            if num_service_pods > 0:
                f = np.float32(MAX_PRIORITY) * (
                    np.float32(num_service_pods - pod_counts.get(value, 0))
                    / np.float32(num_service_pods)
                )
            out[name] = int(f)
        for name in other_nodes:
            out[name] = 0
        return out

    return fn


def node_affinity_priority(pod: Pod, state: ClusterState) -> Dict[str, int]:
    """node_affinity.go:44 CalculateNodeAffinityPriority."""
    counts: Dict[str, int] = {}
    max_count = 0
    affinity = get_affinity(pod)
    if (
        affinity is not None
        and affinity.node_affinity is not None
        and affinity.node_affinity.preferred_during_scheduling_ignored_during_execution
    ):
        for term in affinity.node_affinity.preferred_during_scheduling_ignored_during_execution:
            if term.weight == 0:
                continue
            sel = node_selector_requirements_as_selector(
                term.preference.match_expressions
            )
            if sel is None:
                # node_affinity.go:68 returns the parse error -> the whole
                # scheduling cycle errors out and the pod is not scheduled
                raise PriorityError("invalid preferred scheduling term")
            for name, info in state.node_infos.items():
                if sel.matches(info.node.metadata.labels):
                    counts[name] = counts.get(name, 0) + term.weight
                if counts.get(name, 0) > max_count:
                    max_count = counts[name]
    out = {}
    for name in state.node_infos:
        f = 0.0
        if max_count > 0:
            f = 10 * (counts.get(name, 0) / max_count)
        out[name] = int(f)
    return out


def taint_toleration_priority(pod: Pod, state: ClusterState) -> Dict[str, int]:
    """taint_toleration.go:94 ComputeTaintTolerationPriority."""
    tolerations = [
        t
        for t in get_tolerations(pod)
        if not t.effect or t.effect == "PreferNoSchedule"
    ]
    counts = {}
    max_count = 0
    for name, info in state.node_infos.items():
        taints = get_taints(info.node)
        count = sum(
            1
            for t in taints
            if t.effect == "PreferNoSchedule"
            and not taint_tolerated_by_tolerations(t, tolerations)
        )
        counts[name] = count
        max_count = max(max_count, count)
    out = {}
    for name in state.node_infos:
        f = float(MAX_PRIORITY)
        if max_count > 0:
            f = (1.0 - counts[name] / max_count) * 10
        out[name] = int(f)
    return out


def inter_pod_affinity_priority(
    pod: Pod,
    state: ClusterState,
    hard_pod_affinity_weight: int = DEFAULT_HARD_POD_AFFINITY_WEIGHT,
    failure_domains=None,
) -> Dict[str, int]:
    """interpod_affinity.go:86 CalculateInterPodAffinityPriority.
    failure_domains overrides the default --failure-domains keys used when
    a term has an empty topologyKey (options.go:52; () disables them)."""
    fd = DEFAULT_FAILURE_DOMAINS if failure_domains is None else tuple(failure_domains)
    all_pods = state.all_assigned_pods()
    try:
        affinity = get_affinity(pod)
    except Exception:
        # interpod_affinity.go:89: parse error aborts the whole cycle
        raise PriorityError("invalid affinity annotation on pod")
    counts: Dict[str, int] = {}
    max_count = 0
    min_count = 0

    def ep_node(ep: Pod) -> Optional[Node]:
        info = state.get_node_info_any(ep.spec.node_name)
        return info.node if info is not None else None

    for name, info in state.node_infos.items():
        node = info.node
        total = 0
        if affinity is not None and affinity.pod_affinity is not None:
            for wt in affinity.pod_affinity.preferred_during_scheduling_ignored_during_execution:
                if wt.weight == 0:
                    continue
                matched = sum(
                    1
                    for ep in all_pods
                    if check_if_pod_match_term(
                        ep, pod, wt.pod_affinity_term, ep_node(ep), node, fd
                    )
                )
                total += wt.weight * matched
        if affinity is not None and affinity.pod_anti_affinity is not None:
            for wt in affinity.pod_anti_affinity.preferred_during_scheduling_ignored_during_execution:
                if wt.weight == 0:
                    continue
                matched = sum(
                    1
                    for ep in all_pods
                    if check_if_pod_match_term(
                        ep, pod, wt.pod_affinity_term, ep_node(ep), node, fd
                    )
                )
                total += (0 - wt.weight) * matched
        # reverse direction: terms indicated by existing pods, matched
        # against the pending pod placed hypothetically on `node`.
        for ep in all_pods:
            try:
                ep_aff = get_affinity(ep)
            except Exception:
                # interpod_affinity.go:128: any assigned pod with a bad
                # annotation errors the priority => cycle aborts
                raise PriorityError("invalid affinity annotation on assigned pod")
            if ep_aff is None:
                continue
            if ep_aff.pod_affinity is not None:
                if hard_pod_affinity_weight > 0:
                    for term in ep_aff.pod_affinity.required_during_scheduling_ignored_during_execution:
                        if check_if_pod_match_term(
                            pod, ep, term, node, ep_node(ep), fd
                        ):
                            total += hard_pod_affinity_weight
                for wt in ep_aff.pod_affinity.preferred_during_scheduling_ignored_during_execution:
                    if check_if_pod_match_term(
                        pod, ep, wt.pod_affinity_term, node, ep_node(ep), fd
                    ):
                        total += wt.weight
            if ep_aff.pod_anti_affinity is not None:
                for wt in ep_aff.pod_anti_affinity.preferred_during_scheduling_ignored_during_execution:
                    if check_if_pod_match_term(
                        pod, ep, wt.pod_affinity_term, node, ep_node(ep), fd
                    ):
                        total -= wt.weight
        counts[name] = total
        max_count = max(max_count, total)
        min_count = min(min_count, total)

    out = {}
    for name in state.node_infos:
        f = 0.0
        if (max_count - min_count) > 0:
            f = 10 * ((counts[name] - min_count) / (max_count - min_count))
        out[name] = int(f)
    return out
