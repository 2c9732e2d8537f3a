"""Federation (federation/ analogue): a control plane over clusters.

The 1.3-era federation ("ubernetes") runs a federated apiserver whose
object universe is Clusters + federated workloads, and a federation
controller manager that health-checks member clusters and propagates
services/replicas across the healthy ones. join_cluster/unjoin_cluster
are the kubefed registration flow.

Copy of kubernetes_tpu/federation/__init__.py: only the import package differs."""

from kubernetes_tpu_torch.federation.federation import (
    Cluster,
    ClusterController,
    ClusterSpec,
    ClusterStatus,
    FederatedAPIServer,
    FederatedReplicationManager,
    FederatedServiceController,
    FederationControllerManager,
    default_member_client_factory,
    join_cluster,
    spread_replicas,
    unjoin_cluster,
)

__all__ = [
    "Cluster",
    "ClusterController",
    "ClusterSpec",
    "ClusterStatus",
    "FederatedAPIServer",
    "FederatedReplicationManager",
    "FederatedServiceController",
    "FederationControllerManager",
    "default_member_client_factory",
    "join_cluster",
    "spread_replicas",
    "unjoin_cluster",
]
