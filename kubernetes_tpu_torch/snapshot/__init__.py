"""Columnar ClusterSnapshot: the device-side view of the cluster.

The reference scheduler's per-cycle input is the `GetNodeNameToInfoMap`
clone (schedulercache/cache.go:77) — a map of per-node structs. Here the
same information is a struct-of-arrays over the node axis, plus a pod
batch as a struct-of-arrays over the pending-pod axis, with every string
dictionary-encoded host-side (the device never sees strings):

- resources: int64 milli-CPU / bytes / GPU / pod counts
- host ports: uint32 bitsets over the used-port vocabulary
- labels: uint32 bitsets over (key,value) and key vocabularies; numeric
  label values for Gt/Lt live in a dense float64 sidecar
- selectors (nodeSelector, node affinity): compiled to fixed-width
  requirement programs (op, key_id, value_set_id) over those bitsets
- taints/tolerations: bitsets over the distinct-taint vocabulary
- pods already on nodes: per-(node, pod-class) counts, where a class is a
  distinct (namespace, labels, deleted) triple — selector-spread counts
  and inter-pod affinity matching become (nodes x classes) @ (classes,)
  contractions (MXU-friendly)

Copy of kubernetes_tpu/snapshot/__init__.py: only the import package differs.
"""

from kubernetes_tpu_torch.snapshot.encode import (
    ClusterSnapshot,
    PodBatch,
    SnapshotEncoder,
)

__all__ = ["ClusterSnapshot", "PodBatch", "SnapshotEncoder"]
