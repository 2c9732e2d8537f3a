"""Kubemark-tier scale: hollow nodes + the real scheduler + controllers in
one process (test/kubemark; SURVEY.md section 4 'multi-node without a
cluster').

The cases of tests/test_kubemark.py, run against the port's copies
(kubernetes_tpu_torch), each with the mark it has there.
The scheduler daemon runs with device="cpu" (the port's entry points take
the card unless asked).
The port's harness/perf.schedule_pods returns its stats, pods_per_sec
among them, where the JAX package's returns that rate."""

import time

import pytest

from kubernetes_tpu_torch.api.types import (
    Container,
    ObjectMeta,
    PodSpec,
    PodTemplateSpec,
    ReplicationController,
    ReplicationControllerSpec,
)
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.rest import RESTClient
from kubernetes_tpu_torch.client.transport import LocalTransport
from kubernetes_tpu_torch.controller.framework import SharedInformerFactory
from kubernetes_tpu_torch.controller.replication import ReplicationManager
from kubernetes_tpu_torch.kubemark import HollowCluster
from kubernetes_tpu_torch.scheduler.server import SchedulerServer, SchedulerServerOptions


from conftest import wait_until  # noqa: E402


def test_hollow_cluster_runs_workload():
    """20 hollow nodes, an RC of 60 pods: everything must reach Running
    via real scheduler bindings and real kubelet status updates."""
    server = APIServer()
    client = RESTClient(LocalTransport(server))
    cluster = HollowCluster(client, 20).run()
    informers = SharedInformerFactory(client)
    rcm = ReplicationManager(client, informers)
    informers.start()
    informers.wait_for_sync()
    rcm.run()
    sched = SchedulerServer(client, SchedulerServerOptions(device="cpu")).start()
    try:
        assert wait_until(lambda: len(client.nodes().list()[0]) == 20, 30)
        client.resource("replicationcontrollers", "default").create(
            ReplicationController(
                metadata=ObjectMeta(name="load"),
                spec=ReplicationControllerSpec(
                    replicas=60,
                    selector={"app": "load"},
                    template=PodTemplateSpec(
                        metadata=ObjectMeta(labels={"app": "load"}),
                        spec=PodSpec(
                            containers=[
                                Container(name="pause", requests={"cpu": "100m"})
                            ]
                        ),
                    ),
                ),
            )
        )
        assert wait_until(
            lambda: sum(
                1
                for p in client.pods().list()[0]
                if p.status.phase == "Running"
            )
            == 60,
            60,
        ), [
            (p.metadata.name, p.status.phase, p.spec.node_name)
            for p in client.pods().list()[0]
        ][:10]
        nodes_used = {p.spec.node_name for p in client.pods().list()[0]}
        assert len(nodes_used) == 20  # spreading across every hollow node
    finally:
        sched.stop()
        rcm.stop()
        informers.stop()
        cluster.stop()


def test_perf_harness_small():
    """The density harness runs end-to-end (tiny config in CI; the real
    configs are 100n/3kp and 1000n/30kp per the reference README)."""
    import io

    from kubernetes_tpu_torch.harness.perf import schedule_pods

    out = io.StringIO()
    throughput = schedule_pods(10, 50, provider="DefaultProvider", out=out,
                               device="cpu")["pods_per_sec"]
    assert throughput > 0
    assert "scheduled 50 pods on 10 nodes" in out.getvalue()


class _CountingTransport:
    """LocalTransport wrapper counting requests (the O(1)-requests
    structural assertions below count wire ops, not wall time)."""

    def __init__(self, inner):
        self._inner = inner
        self.object_protocol = getattr(inner, "object_protocol", False)
        self.requests = 0

    def request(self, method, path, query=None, body=None):
        self.requests += 1
        return self._inner.request(method, path, query, body)

    def watch(self, path, query=None):
        self.requests += 1
        return self._inner.watch(path, query)


def _fleet_env(num_nodes, **cfg_kw):
    from kubernetes_tpu_torch.client.transport import LocalTransport
    from kubernetes_tpu_torch.kubemark.fleet import FleetConfig, HollowFleet

    server = APIServer()
    transport = _CountingTransport(LocalTransport(server))
    client = RESTClient(transport)
    fleet = HollowFleet(client, FleetConfig(num_nodes=num_nodes, **cfg_kw))
    return server, transport, client, fleet


def test_hollow_fleet_acks_lifecycle():
    """Pending->Running acks through the batch door + local
    deletion observation, driven by interest-indexed shard watches."""
    from kubernetes_tpu_torch.api.types import Pod
    from kubernetes_tpu_torch.client.rest import batch_delete_item

    server, transport, client, fleet = _fleet_env(
        40, shard_size=16, heartbeat_interval=30.0, tick=0.05)
    fleet.run()
    try:
        assert len(client.nodes().list()[0]) == 40
        pods = client.pods()
        for i in range(30):
            pods.create(Pod(
                metadata=ObjectMeta(name=f"p-{i:03d}"),
                spec=PodSpec(containers=[Container(requests={"cpu": "100m"})]),
            ))
            pods.bind(f"p-{i:03d}", fleet.node_names[i % 40])
        assert wait_until(lambda: fleet.running_pods() == 30, 30)
        assert wait_until(
            lambda: sum(1 for p in pods.list()[0]
                        if p.status.phase == "Running") == 30, 30)
        # the fleet's shard watches registered in the interest index,
        # not the broadcast list (O(own pods) fan-out)
        cacher = server._cacher_for(server.resources["pods"])
        with cacher._cond:
            assert len(cacher._watchers) == 0
            assert len(cacher._interest) == 40
        # churn's delete half: one batch request, acks observed
        client.commit_batch(
            [batch_delete_item("pods", f"p-{i:03d}") for i in range(10)])
        assert wait_until(lambda: fleet.running_pods() == 20, 30)
        assert fleet.snapshot_stats()["deletions_observed"] >= 10
    finally:
        fleet.stop()
        server.close_cachers()


def test_hollow_fleet_heartbeats_are_batched():
    """N nodes' heartbeats per interval ride O(ticks) batch requests,
    not N PUTs: 120 nodes / 0.6s interval for ~1.5s must commit >=120
    heartbeats in a handful of requests."""
    import time as _t

    server, transport, client, fleet = _fleet_env(
        120, shard_size=64, heartbeat_interval=0.6, tick=0.1)
    fleet.run()
    try:
        t0 = transport.requests
        _t.sleep(1.5)
        stats = fleet.snapshot_stats()
        spent = transport.requests - t0
        assert stats["heartbeats"] >= 120
        # ~15 ticks elapsed; every tick flushes at most
        # ceil(pending/batch_max) = 1 batch here. Generous 3x headroom
        # against scheduler jitter — the per-node shape would be 120+.
        assert spent <= 45, (spent, stats)
        # heartbeats actually landed server-side
        node = client.nodes().get(fleet.node_names[0])
        assert node.status.conditions[0].last_heartbeat_time
    finally:
        fleet.stop()
        server.close_cachers()


def test_start_kubemark_mode_selection():
    from kubernetes_tpu_torch.client.transport import LocalTransport
    from kubernetes_tpu_torch.kubemark import (
        HollowCluster,
        HollowFleet,
        start_kubemark,
    )

    server = APIServer()
    client = RESTClient(LocalTransport(server))
    small = start_kubemark(client, 2)
    try:
        assert isinstance(small, HollowCluster) and len(small) == 2
    finally:
        small.stop()
    big = start_kubemark(client, 80, shard_size=40,
                         heartbeat_interval=30.0)
    try:
        assert isinstance(big, HollowFleet) and len(big) == 80
    finally:
        big.stop()
        server.close_cachers()
