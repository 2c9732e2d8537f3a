"""Core API schema: quantities, labels/selectors, object types.

Reference surface: pkg/api/resource (Quantity), pkg/labels (Selector),
pkg/api/types.go (Pod/Node/...). Only the scheduling-relevant subset is
modelled; the types are plain Python dataclasses — the device never sees
them, it sees the columnar encodings produced by `kubernetes_tpu.snapshot`.

Copy of kubernetes_tpu/api/__init__.py: only the import package differs.
"""

from kubernetes_tpu_torch.api.resource import Quantity, parse_quantity
from kubernetes_tpu_torch.api import labels
from kubernetes_tpu_torch.api.types import (
    Container,
    LabelSelector,
    LabelSelectorRequirement,
    Node,
    NodeAffinity,
    NodeCondition,
    NodeSelector,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    PodAntiAffinity,
    PodSpec,
    PodStatus,
    PreferredSchedulingTerm,
    ReplicationController,
    Service,
    Taint,
    Toleration,
    Volume,
    WeightedPodAffinityTerm,
)

__all__ = [
    "Quantity",
    "parse_quantity",
    "labels",
    "Container",
    "LabelSelector",
    "LabelSelectorRequirement",
    "Node",
    "NodeAffinity",
    "NodeCondition",
    "NodeSelector",
    "NodeSelectorRequirement",
    "NodeSelectorTerm",
    "NodeStatus",
    "ObjectMeta",
    "Pod",
    "PodAffinity",
    "PodAffinityTerm",
    "PodAntiAffinity",
    "PodSpec",
    "PodStatus",
    "PreferredSchedulingTerm",
    "ReplicationController",
    "Service",
    "Taint",
    "Toleration",
    "Volume",
    "WeightedPodAffinityTerm",
]
