"""Reconciling controllers (pkg/controller analogue).

PyTorch counterpart of kubernetes_tpu/controller/__init__.py. Only the
shared controller machinery (controller/framework.py, a copy) is
ported so far: the defragmentation controller of the optimizing profile
(scheduler/optimizer/controller/defrag.py) imports it.

Deviation from kubernetes_tpu/controller/__init__.py <module>, which
also exports ControllerManager: its controller/manager.py pulls in the
whole controller tree (the replication, node, endpoints, namespace and
PodGroup status controllers and the rest), which comes with ROADMAP.md
queue 1 item 4, the host-only subsystems; until then this package
exports framework's names alone.
"""

from kubernetes_tpu_torch.controller.framework import (
    ControllerExpectations,
    PodControl,
    SharedInformerFactory,
    active_pods,
    filter_active_pods,
)

__all__ = [
    "ControllerExpectations",
    "PodControl",
    "SharedInformerFactory",
    "active_pods",
    "filter_active_pods",
]
