"""Priority scores — integer/float arithmetic matched to the reference
operation for operation, so int truncations agree.

PyTorch counterpart of kubernetes_tpu/ops/priorities.py. Every function
returns an int64[N] score vector in 0..10 for one pending pod.
Normalizing functions (spread, node-affinity, taint-toleration) take
the fit mask because the reference normalizes over FILTERED nodes only
(generic_scheduler.go:109).

Promotions are explicit: an int64 quotient is taken in float64 (the
reference runs JAX with x64 on, where int64 / int64 is float64), integer
`//` is a floor division, and the float32 SelectorSpread math runs one
operation per kernel in float32, so nothing fuses or widens it.
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch.ops.predicates import _requirement_matrix
from kubernetes_tpu_torch.parallel.quant import narrow_matvec

MAX_PRIORITY = 10
F64 = torch.float64
F32 = torch.float32
I64 = torch.int64


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _matvec(table, vec):
    """i64 table[N, K] @ vec[K] as a multiply and a sum: CUDA matmul has
    no integer path, and the sum of integer products is exact in any
    order."""
    return (table.to(I64) * vec.to(I64)[None, :]).sum(dim=1)


def taint_intolerable_counts(node_taint_count, pod_intolerable_prefer):
    """i64[N] per-list intolerable-taint counts. The node table may ride
    a narrowed placement dtype (parallel/quant): the 0/1 pod indicator
    casts down to it and the sum accumulates in int64, so the table is
    never widened (quant.narrow_matvec)."""
    return narrow_matvec(node_taint_count, pod_intolerable_prefer, I64)


def _calculate_score(requested, capacity):
    """priorities.go:33 calculateScore — int64, floor division (equal to
    Go's truncation wherever the result is kept); 0 when capacity == 0
    or requested > capacity."""
    safe_cap = torch.where(capacity == 0, 1, capacity)
    score = _floordiv((capacity - requested) * 10, safe_cap)
    return torch.where((capacity == 0) | (requested > capacity), 0, score)


def least_requested(pod_nz_mcpu, pod_nz_mem, nz_mcpu, nz_mem, alloc_mcpu,
                    alloc_mem):
    """priorities.go:81 LeastRequestedPriority: avg of cpu+mem scores,
    over NonZeroRequest + the pod's own nonzero request."""
    cpu_score = _calculate_score(nz_mcpu + pod_nz_mcpu, alloc_mcpu)
    mem_score = _calculate_score(nz_mem + pod_nz_mem, alloc_mem)
    return _floordiv(cpu_score + mem_score, 2)


def balanced_resource_allocation(
    pod_nz_mcpu, pod_nz_mem, nz_mcpu, nz_mem, alloc_mcpu, alloc_mem
):
    """priorities.go:215 BalancedResourceAllocation: float64 fractions,
    10 - |cpuFrac - memFrac| * 10, truncated; 0 if either frac >= 1
    (fractionOfCapacity returns 1 for capacity==0)."""
    total_cpu = (nz_mcpu + pod_nz_mcpu).to(F64)
    total_mem = (nz_mem + pod_nz_mem).to(F64)
    cpu_frac = torch.where(alloc_mcpu == 0, 1.0,
                           total_cpu / alloc_mcpu.to(F64))
    mem_frac = torch.where(alloc_mem == 0, 1.0,
                           total_mem / alloc_mem.to(F64))
    diff = torch.abs(cpu_frac - mem_frac)
    score = (10.0 - diff * 10.0).to(I64)  # truncates toward zero
    return torch.where((cpu_frac >= 1.0) | (mem_frac >= 1.0), 0, score)


def equal(num_nodes, device=None):
    """generic_scheduler.go:310 EqualPriority."""
    return torch.ones((num_nodes,), dtype=I64, device=device)


def selector_spread(
    pod_has_selectors,
    pod_spread_match,  # i64[C] 0/1
    class_count,  # i64[N, C]
    zone_id,  # int[N]: int64, or int8/int16 when narrowed (parallel/quant)
    num_zones,  # static int (vocab size incl. 0 == none)
    fit_mask,  # bool[N]
):
    """selector_spreading.go:84 CalculateSpreadPriority.

    count_n = number of same-namespace, non-deleted pods on node n
    matching ANY selector of the pod = class_count @ spread_match.
    maxCount and the zone aggregation run over FILTERED nodes only.
    float32 math as in Go."""
    dev = class_count.device
    counts = _matvec(class_count, pod_spread_match)
    counts = torch.where(fit_mask, counts, 0)
    max_count = counts.max().clamp(min=0)

    # zone aggregation: zone 0 == "no zone" and never participates.
    # countsByZone exists for every zone seen among filtered nodes, so
    # haveZones == any filtered node is zoned.
    # zone ids index below: torch takes an int64 index (it refuses int8
    # and int16 ones, and reads a uint8 one as a mask), so a narrowed
    # table is widened here, at the index sites only
    zone_idx = zone_id.to(I64)
    zcounts = torch.zeros((num_zones,), dtype=I64, device=dev).index_add_(
        0, zone_idx, counts)
    have_zones = (fit_mask & (zone_id > 0)).any()
    zone_ids = torch.arange(num_zones, device=dev)
    max_zone = torch.where(zone_ids > 0, zcounts, 0).max().clamp(min=0)

    ten = torch.full((), float(MAX_PRIORITY), dtype=F32, device=dev)
    ratio = (max_count - counts).to(F32) / max_count.to(F32)
    f = torch.where(max_count > 0, ten * ratio, ten)
    node_zcount = zcounts[zone_idx]
    # NO maxCountByZone>0 guard in the reference (selector_spreading.go
    # :224): 0/0 in float32 is NaN; Go's int(NaN) on amd64 is minInt64.
    # The NaN rides through the blend and is mapped at the conversion.
    zone_ratio = (max_zone - node_zcount).to(F32) / max_zone.to(F32)
    zone_score = ten * zone_ratio
    # Go evaluates (1.0 - zoneWeighting) as an EXACT untyped-constant
    # expression rounded once to float32 (selector_spreading.go:226)
    third = torch.full((), 1.0 / 3.0, dtype=F32, device=dev)
    two_thirds = torch.full((), 2.0 / 3.0, dtype=F32, device=dev)
    node_part = f * third
    zone_part = two_thirds * zone_score
    blended = node_part + zone_part
    f = torch.where(have_zones & (zone_id > 0), blended, f)
    # no selectors -> counts map empty -> maxCount 0 and zones skipped
    f = torch.where(pod_has_selectors, f, ten)
    nan = torch.isnan(f)
    return torch.where(nan, -(2**63), torch.where(nan, 0.0, f).to(I64))


def node_affinity_counts(
    pref_valid,  # bool[TP]
    pref_weight,  # i64[TP]
    pref_ops,
    pref_key,
    pref_set,
    pref_numkey,
    pref_num,  # [TP, R] programs
    label_kv,
    label_key,
    numval,
    set_table,
):
    """node_affinity.go:44-62: per-node sum of weights of matching
    preferred terms (the un-normalized counts)."""
    counts = torch.zeros(label_kv.shape[:1], dtype=I64,
                         device=label_kv.device)
    for t in range(pref_valid.shape[0]):
        m = _requirement_matrix(
            pref_ops[t], pref_key[t], pref_set[t], pref_numkey[t],
            pref_num[t], label_kv, label_key, numval, set_table,
        )
        counts = counts + torch.where(m & pref_valid[t], pref_weight[t], 0)
    return counts


def normalize_counts_up(counts, max_count):
    """10 * count/max (float64, truncated); all-0 when max == 0
    (node_affinity.go:85-90)."""
    f = torch.where(
        max_count > 0,
        10.0 * (counts.to(F64) / max_count.clamp(min=1).to(F64)),
        0.0,
    )
    return f.to(I64)


def normalize_counts_down(counts, max_count):
    """(1 - count/max) * 10 (float64, truncated); all-10 when max == 0
    (taint_toleration.go:100-106)."""
    f = torch.where(
        max_count > 0,
        (1.0 - counts.to(F64) / max_count.clamp(min=1).to(F64)) * 10.0,
        float(MAX_PRIORITY),
    )
    return f.to(I64)


def _masked_max0(counts, fit_mask):
    """counts.max(where=fit_mask, initial=0)."""
    return torch.where(fit_mask, counts, 0).max().clamp(min=0)


def node_affinity_preferred(
    pref_valid,
    pref_weight,
    pref_ops,
    pref_key,
    pref_set,
    pref_numkey,
    pref_num,
    label_kv,
    label_key,
    numval,
    set_table,
    fit_mask,
):
    """node_affinity.go:44 CalculateNodeAffinityPriority: counts normalized
    by the max over FILTERED nodes."""
    counts = node_affinity_counts(
        pref_valid, pref_weight, pref_ops, pref_key, pref_set, pref_numkey,
        pref_num, label_kv, label_key, numval, set_table,
    )
    return normalize_counts_up(counts, _masked_max0(counts, fit_mask))


def taint_toleration(
    pod_intolerable_prefer,  # i64[TV] 0/1
    node_taint_count,  # i64[N, TV] multiplicities
    fit_mask,
):
    """taint_toleration.go:94: count PreferNoSchedule taints intolerable by
    the pod's PreferNoSchedule-filtered tolerations (per-LIST count);
    normalize over filtered nodes; (1 - count/max) * 10 float64,
    truncated."""
    counts = taint_intolerable_counts(node_taint_count,
                                      pod_intolerable_prefer)
    return normalize_counts_down(counts, _masked_max0(counts, fit_mask))


def image_locality(node_img_size, pod_img_count):
    """priorities.go:149 ImageLocalityPriority -> i64 (N,).

    Per-container sum of the node-local size of its image (0 when absent),
    bucketed into 0..10 over the 23MB..1GB range (calculateScoreFromSize,
    priorities.go:192-207) with Go's integer division."""
    min_img = 23 * 1024 * 1024
    max_img = 1000 * 1024 * 1024
    if node_img_size.shape[1] == 0:
        return torch.zeros((node_img_size.shape[0],), dtype=I64,
                           device=node_img_size.device)
    sum_size = _matvec(node_img_size, pod_img_count)
    mid = _floordiv(10 * (sum_size - min_img), max_img - min_img) + 1
    return torch.where(
        sum_size < min_img, 0, torch.where(sum_size >= max_img, 10, mid)
    )


def node_label(node_has_key, presence):
    """priorities.go:99 NewNodeLabelPriority -> i64 (N,): 10 where the
    key's presence matches the config, else 0 (no normalization)."""
    match = node_has_key if presence else ~node_has_key
    return torch.where(match, 10, 0).to(I64)
