"""Volume predicates on tensors (snapshot/volumes.py compiles them).

PyTorch counterpart of kubernetes_tpu/ops/volumes.py: bitset
intersections over 32-bit words (widened to int64 on the device) and
popcounts for the max-PD distinct-volume counts. Zero-width when the
workload has no volumes.
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch.ops.bitset import popcount
from kubernetes_tpu_torch.parallel.quant import narrow_eq


def _intersects(a, b):
    """Any shared bit between (..., W) masks."""
    if a.shape[-1]:
        return ((a & b) != 0).any(dim=-1)
    return torch.zeros(b.shape[:-1], dtype=torch.bool, device=b.device)


def _popcount(mask):
    """(..., W) words -> (...) i64 bit count."""
    if not mask.shape[-1]:
        return torch.zeros(mask.shape[:-1], dtype=torch.int64,
                           device=mask.device)
    return popcount(mask)


def no_disk_conflict(pod_rw, pod_ro, node_any, node_rw):
    """predicates.go:105 NoDiskConflict -> bool (N,). A writable use
    conflicts with any use; a read-only GCE use conflicts with a
    writable use."""
    return ~(_intersects(pod_rw, node_any) | _intersects(pod_ro, node_rw))


def max_pd_count(pod_mask, pod_bad, pod_has_new, node_mask, node_bad,
                 max_volumes):
    """predicates.go:137 MaxPDVolumeCountChecker -> bool (N,)."""
    if not pod_mask.shape[-1]:
        return torch.ones_like(node_bad) & ~pod_bad
    existing = _popcount(node_mask)
    # the complement is cut back to 32 bits: the words are int64 here
    new = _popcount(pod_mask & (~node_mask & 0xFFFFFFFF))
    ok = (~node_bad) & (existing + new <= max_volumes)
    return ~pod_bad & (~pod_has_new | ok)


def volume_zone(pod_zone, pod_region, pod_fail, node_zone, node_region,
                node_has):
    """predicates.go:271 VolumeZoneChecker -> bool (N,). Nodes without any
    zone/region label always pass (constraints empty). node_zone and
    node_region may ride a narrowed dtype (parallel/quant): the pod's
    value casts down behind a range guard (quant.narrow_eq), as in
    kubernetes_tpu/ops/volumes.py _narrow_eq."""
    match = (
        ~pod_fail
        & ((pod_zone < 0) | narrow_eq(node_zone, pod_zone))
        & ((pod_region < 0) | narrow_eq(node_region, pod_region))
    )
    return ~node_has | match
