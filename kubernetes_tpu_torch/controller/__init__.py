"""Reconciling controllers (pkg/controller analogue).

Every loop follows the reference idiom (pkg/controller/replication/
replication_controller.go and friends): shared informers feed a
rate-limited workqueue of object keys; workers pop keys, read the world
from informer stores, and converge actual -> desired via API writes;
failures re-queue with backoff; "expectations" absorb informer lag so a
burst of creates/deletes is not repeated while watches catch up.

Copy of kubernetes_tpu/controller/__init__.py: only the import package differs.
"""

from kubernetes_tpu_torch.controller.framework import (
    ControllerExpectations,
    PodControl,
    SharedInformerFactory,
    active_pods,
    filter_active_pods,
)
from kubernetes_tpu_torch.controller.manager import ControllerManager

__all__ = [
    "ControllerExpectations",
    "ControllerManager",
    "PodControl",
    "SharedInformerFactory",
    "active_pods",
    "filter_active_pods",
]
