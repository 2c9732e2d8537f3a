"""Cloud provider interface + registry (pkg/cloudprovider).

The reference's cloud.go Interface split into the capability objects the
tree actually uses (Instances, Zones, Routes, TCPLoadBalancer), a
RegisterCloudProvider/GetCloudProvider registry (providers.go), and the
fake provider every controller test injects (providers/fake).

Copy of kubernetes_tpu/cloudprovider/__init__.py: only the import package differs."""

from kubernetes_tpu_torch.cloudprovider.cloud import (
    CloudProvider,
    FakeCloud,
    LoadBalancer,
    Route,
    Zone,
    get_cloud_provider,
    register_cloud_provider,
)
from kubernetes_tpu_torch.cloudprovider.local import LocalCloud
from kubernetes_tpu_torch.cloudprovider.multizone import MultiZoneCloud

__all__ = [
    "CloudProvider",
    "FakeCloud",
    "LocalCloud",
    "MultiZoneCloud",
    "LoadBalancer",
    "Route",
    "Zone",
    "get_cloud_provider",
    "register_cloud_provider",
]
