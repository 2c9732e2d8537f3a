"""Sequential reference oracle.

A pure-Python re-statement of the reference scheduler's exact decision
semantics (plugin/pkg/scheduler/{generic_scheduler.go, algorithm/...}),
used as (a) the conformance oracle that the TPU tensor program must match
bit-for-bit, and (b) a readable specification of the Go behavior.

This is deliberately the *slow, obvious* implementation: per-pod serial
loops over nodes, exactly like the reference. The TPU path under
`kubernetes_tpu.models` must agree with it on fit decisions, scores, and
selected hosts for every scenario in tests/.

Copy of kubernetes_tpu/oracle/__init__.py: only the import package differs.
"""

from kubernetes_tpu_torch.oracle.state import ClusterState, NodeInfo
from kubernetes_tpu_torch.oracle.scheduler import (
    DEFAULT_PREDICATE_ORDER,
    DEFAULT_PRIORITIES,
    FitError,
    GenericScheduler,
    select_host,
)

__all__ = [
    "ClusterState",
    "NodeInfo",
    "DEFAULT_PREDICATE_ORDER",
    "DEFAULT_PRIORITIES",
    "FitError",
    "GenericScheduler",
    "select_host",
]
