"""Kubemark (pkg/kubemark + cmd/kubemark analogue): hollow nodes.

A HollowNode runs the REAL kubelet and kube-proxy code against fake
runtime/dataplane seams (hollow-node.go:102-120 wires the real kubelet
to FakeDockerClient + fake cadvisor + stub container manager), so a
single process can host hundreds of nodes and exercise the control
plane at scale with ~1% of the hardware. HollowFleet multiplexes
thousands of hollow kubelets onto a few threads + one pooled transport
for the soak-scale load shape; start_kubemark picks the right one.

Copy of kubernetes_tpu/kubemark/__init__.py: only the import package differs."""

from kubernetes_tpu_torch.kubemark.fleet import FleetConfig, HollowFleet
from kubernetes_tpu_torch.kubemark.hollow import (
    HollowCluster,
    HollowNode,
    start_kubemark,
)

__all__ = [
    "FleetConfig",
    "HollowCluster",
    "HollowFleet",
    "HollowNode",
    "start_kubemark",
]
