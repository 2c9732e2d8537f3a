"""Predicate masks.

PyTorch counterpart of kubernetes_tpu/ops/predicates.py. Each function
maps one pending pod (0-d tensors + small compiled programs) against all
N nodes at once, returning a bool[N] fit mask
(generic_scheduler.go:182 podFitsOnNode).
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch.ops import bitset
from kubernetes_tpu_torch.snapshot.encode import (
    OP_EXISTS,
    OP_FAIL,
    OP_GT,
    OP_IN,
    OP_LT,
    OP_NOT_EXISTS,
    OP_NOT_IN,
)


def pod_fits_resources(
    pod_req_mcpu,
    pod_req_mem,
    pod_req_gpu,
    pod_zero_req,
    alloc_mcpu,
    alloc_mem,
    alloc_gpu,
    alloc_pods,
    req_mcpu,
    req_mem,
    req_gpu,
    pod_count,
):
    """predicates.go:416 PodFitsResources as a mask.

    Order quirks preserved: the pod-count check applies even to
    zero-request pods; a zero-request pod then skips cpu/mem/gpu entirely
    (predicates.go:423-431)."""
    count_ok = pod_count + 1 <= alloc_pods
    cpu_ok = alloc_mcpu >= pod_req_mcpu + req_mcpu
    mem_ok = alloc_mem >= pod_req_mem + req_mem
    gpu_ok = alloc_gpu >= pod_req_gpu + req_gpu
    resources_ok = (cpu_ok & mem_ok & gpu_ok) | pod_zero_req
    return count_ok & resources_ok


def pod_fits_host(pod_host_req, num_nodes):
    """predicates.go:533 PodFitsHost: -1 == unconstrained; -2 == a node
    name not in the snapshot (matches nothing)."""
    node_ids = torch.arange(num_nodes, device=pod_host_req.device)
    return torch.where(pod_host_req < 0, pod_host_req == -1,
                       node_ids == pod_host_req)


def pod_fits_host_ports(pod_port_mask, node_port_mask):
    """predicates.go:687 PodFitsHostPorts: no wanted port already in use.
    An empty want-set intersects nothing, reproducing the early true."""
    return ~bitset.intersects(node_port_mask, pod_port_mask[None, :])


def _requirement_matrix(
    ops, key, set_idx, numkey, num, label_kv, label_key, numval, set_table
):
    """Evaluate an AND-program of R requirements against N nodes.

    ops/key/set_idx/numkey: [R]; num: [R] f64
    label_kv: [N, LW]; label_key: [N, KW]; numval: [N, KG] f64
    Returns match[N] = AND over requirements (exact selector.go:163-203
    semantics per op)."""
    has_key = bitset.test_bit(label_key[:, None, :], key[None, :])  # [N, R]
    set_masks = set_table[set_idx.clamp(min=0)]  # [R, LW]
    in_set = bitset.intersects(label_kv[:, None, :], set_masks[None, :, :])
    node_num = numval[:, numkey.clamp(min=0)]  # [N, R]
    num_valid = ~torch.isnan(node_num)
    gt = has_key & num_valid & (node_num > num[None, :])
    lt = has_key & num_valid & (node_num < num[None, :])

    op = ops[None, :]
    match = torch.ones_like(has_key)
    match = torch.where(op == OP_IN, has_key & in_set, match)
    match = torch.where(op == OP_NOT_IN, (~has_key) | (~in_set), match)
    match = torch.where(op == OP_EXISTS, has_key, match)
    match = torch.where(op == OP_NOT_EXISTS, ~has_key, match)
    match = torch.where(op == OP_GT, gt, match)
    match = torch.where(op == OP_LT, lt, match)
    match = match & (op != OP_FAIL)
    return match.all(dim=1)  # [N]


def match_node_selector(
    ns_ops,
    ns_key,
    ns_set,
    ns_numkey,
    ns_num,
    aff_has_req,
    aff_term_valid,
    aff_ops,
    aff_key,
    aff_set,
    aff_numkey,
    aff_num,
    label_kv,
    label_key,
    numval,
    set_table,
):
    """predicates.go:470 PodMatchesNodeLabels: nodeSelector (AND program)
    AND required NodeAffinity (OR over terms, each an AND program; a pod
    with required affinity but zero valid terms matches nothing)."""
    ns_match = _requirement_matrix(
        ns_ops, ns_key, ns_set, ns_numkey, ns_num, label_kv, label_key,
        numval, set_table,
    )
    any_term = torch.zeros_like(ns_match)
    for t in range(aff_term_valid.shape[0]):
        m = _requirement_matrix(
            aff_ops[t], aff_key[t], aff_set[t], aff_numkey[t], aff_num[t],
            label_kv, label_key, numval, set_table,
        )
        any_term = any_term | (m & aff_term_valid[t])
    aff_ok = any_term | ~aff_has_req
    return ns_match & aff_ok


def pod_tolerates_node_taints(
    pod_tol_mask,
    pod_has_tolerations,
    node_taint_mask,
    node_has_taints,
    node_taint_bad,
    noschedule_taints,
):
    """predicates.go:960-1002 PodToleratesNodeTaints. Quirks preserved:
    empty taints -> fit; non-empty taints + empty tolerations -> unfit
    (even all-PreferNoSchedule); otherwise every NoSchedule taint must be
    tolerated (PreferNoSchedule skipped). A node with a malformed taints
    annotation errors for every pod -> unfit."""
    untolerated = (node_taint_mask & noschedule_taints[None, :]
                   & ~pod_tol_mask[None, :])
    all_tolerated = ~((untolerated != 0).any(dim=-1))
    fit = torch.where(
        ~node_has_taints,
        True,
        torch.where(~pod_has_tolerations, False, all_tolerated),
    )
    return fit & ~node_taint_bad


def check_node_memory_pressure(pod_best_effort, node_mem_pressure):
    """predicates.go:1011 CheckNodeMemoryPressurePredicate."""
    return ~(pod_best_effort & node_mem_pressure)
