"""Hollow nodes (pkg/kubemark/hollow_kubelet.go, hollow_proxy.go) and the
start-kubemark launcher (test/kubemark/start-kubemark.sh reduced to an
in-process API).

Two deployment shapes, one launcher (`start_kubemark`):

* ``faithful`` — HollowNode/HollowCluster: the REAL kubelet (and
  optionally the real proxier) per node on fake runtime seams, exactly
  hollow-node.go:102-120. Highest fidelity, ~6 threads per node;
  hundreds of nodes per process.
* ``fleet`` — kubemark/fleet.HollowFleet: thousands of hollow kubelets
  multiplexed onto a few threads + ONE pooled transport (timer-wheel
  heartbeats, shard watches pinned by ``spec.nodeName in (...)``,
  every ack through /api/v1/batch). The wire surface of a node fleet
  at the cost of a handful of threads — the soak harness's shape.

Copy of kubernetes_tpu/kubemark/hollow.py: only the import package differs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from kubernetes_tpu_torch.client.rest import RESTClient
from kubernetes_tpu_torch.kubelet import FakeRuntime, Kubelet, KubeletConfig
from kubernetes_tpu_torch.proxy import Proxier


@dataclass
class HollowNodeConfig:
    """hollow-node.go flags subset."""

    node_name: str = ""
    # scale-tuned cadences: hollow nodes relist/heartbeat slower than a
    # real node so 1000 of them don't melt the host
    pleg_relist_period: float = 0.5
    status_sync_period: float = 0.5
    node_status_update_frequency: float = 10.0
    run_proxy: bool = False
    max_pods: int = 110


class HollowNode:
    """The real kubelet (+ optionally the real proxier) on fake seams."""

    def __init__(self, client: RESTClient, config: HollowNodeConfig):
        self.config = config
        self.runtime = FakeRuntime()
        self.kubelet = Kubelet(
            client,
            KubeletConfig(
                node_name=config.node_name,
                pleg_relist_period=config.pleg_relist_period,
                status_sync_period=config.status_sync_period,
                node_status_update_frequency=config.node_status_update_frequency,
                max_pods=config.max_pods,
            ),
            self.runtime,
        )
        self.proxier: Optional[Proxier] = (
            Proxier(client, config.node_name) if config.run_proxy else None
        )

    def run(self) -> "HollowNode":
        self.kubelet.run()
        if self.proxier is not None:
            self.proxier.run()
        return self

    def stop(self) -> None:
        self.kubelet.stop()
        if self.proxier is not None:
            self.proxier.stop()


class HollowCluster:
    """N hollow nodes against one control plane."""

    def __init__(
        self,
        client: RESTClient,
        num_nodes: int,
        name_prefix: str = "hollow-node-",
        run_proxy_on_first: bool = False,
    ):
        self.nodes: List[HollowNode] = []
        for i in range(num_nodes):
            self.nodes.append(
                HollowNode(
                    client,
                    HollowNodeConfig(
                        node_name=f"{name_prefix}{i:04d}",
                        run_proxy=run_proxy_on_first and i == 0,
                    ),
                )
            )

    def run(self) -> "HollowCluster":
        for n in self.nodes:
            n.run()
        return self

    def stop(self) -> None:
        for n in self.nodes:
            n.stop()

    def __len__(self) -> int:
        return len(self.nodes)


def start_kubemark(client: RESTClient, num_nodes: int,
                   mode: str = "auto", **kw):
    """start-kubemark.sh as one call: run `num_nodes` hollow nodes in
    the right shape and return the running cluster/fleet (both expose
    run()/stop()/__len__).

    mode: "faithful" (real kubelet per node), "fleet" (multiplexed
    HollowFleet), or "auto" — faithful up to 64 nodes, fleet beyond
    (the real kubelet's thread cost melts a box near a thousand).
    Extra kwargs flow to the chosen constructor."""
    if mode == "auto":
        mode = "faithful" if num_nodes <= 64 else "fleet"
    if mode == "faithful":
        return HollowCluster(client, num_nodes, **kw).run()
    if mode == "fleet":
        from kubernetes_tpu_torch.kubemark.fleet import HollowFleet

        return HollowFleet(client, num_nodes=num_nodes, **kw).run()
    raise ValueError(f"unknown kubemark mode {mode!r}")
