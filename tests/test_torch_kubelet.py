"""Kubelet against the in-process control plane with the fake runtime —
the hollow-node configuration (kubemark, hollow-node.go:102-120): real
kubelet logic, instant containers.

The cases of tests/test_kubelet.py, run against the port's copies
(kubernetes_tpu_torch), each with the mark it has there.
The scheduler daemon runs with device="cpu" (the port's entry points take
the card unless asked)."""

import time

import pytest

from kubernetes_tpu_torch.api.types import (
    Container,
    ObjectMeta,
    Pod,
    PodSpec,
)
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.rest import RESTClient
from kubernetes_tpu_torch.client.transport import LocalTransport
from kubernetes_tpu_torch.kubelet import FakeRuntime, Kubelet, KubeletConfig


from conftest import wait_until  # noqa: E402


@pytest.fixture()
def plane():
    server = APIServer()
    client = RESTClient(LocalTransport(server))
    kubelets = []

    def start_kubelet(node_name, **kw):
        cfg = KubeletConfig(
            node_name=node_name,
            pleg_relist_period=0.05,
            status_sync_period=0.05,
            housekeeping_interval=0.2,
            node_status_update_frequency=0.2,
            **kw,
        )
        runtime = FakeRuntime()
        kl = Kubelet(client, cfg, runtime).run()
        kubelets.append(kl)
        return kl, runtime

    yield server, client, start_kubelet
    for kl in kubelets:
        kl.stop()


def bound_pod(name, node, restart_policy="Always"):
    return Pod(
        metadata=ObjectMeta(name=name),
        spec=PodSpec(
            node_name=node,
            restart_policy=restart_policy,
            containers=[Container(name="main", requests={"cpu": "100m"})],
        ),
    )


def test_kubelet_registers_and_heartbeats(plane):
    server, client, start_kubelet = plane
    start_kubelet("n1")
    assert wait_until(lambda: _node_exists(client, "n1"))
    node = client.nodes().get("n1")
    ready = node.status.conditions[0]
    assert ready.type == "Ready" and ready.status == "True"
    first = ready.last_heartbeat_time
    assert wait_until(
        lambda: client.nodes().get("n1").status.conditions[0].last_heartbeat_time
        is not None
    )


def _node_exists(client, name):
    try:
        client.nodes().get(name)
        return True
    except Exception:
        return False


def test_bound_pod_runs(plane):
    server, client, start_kubelet = plane
    kl, runtime = start_kubelet("n1")
    assert wait_until(lambda: _node_exists(client, "n1"))
    client.pods().create(bound_pod("p1", "n1"))

    def phase():
        return client.pods().get("p1").status.phase

    assert wait_until(lambda: phase() == "Running")
    pod = client.pods().get("p1")
    assert pod.status.pod_ip.startswith("10.")
    assert any(c.type == "Ready" and c.status == "True" for c in pod.status.conditions)
    assert pod.status.container_statuses[0].state == "running"
    # runtime actually holds the pod
    assert any(rp.name == "p1" for rp in runtime.list_pods())


def test_container_death_via_pleg(plane):
    server, client, start_kubelet = plane
    kl, runtime = start_kubelet("n1")
    assert wait_until(lambda: _node_exists(client, "n1"))
    client.pods().create(bound_pod("crasher", "n1", restart_policy="Never"))
    assert wait_until(
        lambda: client.pods().get("crasher").status.phase == "Running"
    )
    uid = client.pods().get("crasher").metadata.uid
    runtime.exits["main"] = 1  # future syncs see the crash
    runtime.exit_container(uid, "main", code=1)
    assert wait_until(
        lambda: client.pods().get("crasher").status.phase == "Failed"
    )


def test_successful_completion(plane):
    server, client, start_kubelet = plane
    kl, runtime = start_kubelet("n1")
    assert wait_until(lambda: _node_exists(client, "n1"))
    client.pods().create(bound_pod("oneshot", "n1", restart_policy="Never"))
    assert wait_until(
        lambda: client.pods().get("oneshot").status.phase == "Running"
    )
    uid = client.pods().get("oneshot").metadata.uid
    runtime.exits["main"] = 0
    runtime.exit_container(uid, "main", code=0)
    assert wait_until(
        lambda: client.pods().get("oneshot").status.phase == "Succeeded"
    )


def test_pod_delete_kills_runtime(plane):
    server, client, start_kubelet = plane
    kl, runtime = start_kubelet("n1")
    assert wait_until(lambda: _node_exists(client, "n1"))
    client.pods().create(bound_pod("doomed", "n1"))
    assert wait_until(lambda: any(rp.name == "doomed" for rp in runtime.list_pods()))
    client.pods().delete("doomed")
    assert wait_until(
        lambda: not any(rp.name == "doomed" for rp in runtime.list_pods())
    )


def test_scheduler_to_kubelet_end_to_end(plane):
    """The full loop the reference demonstrates in its integration tier:
    unbound pod -> scheduler binds -> kubelet (watching its node) runs it."""
    from kubernetes_tpu_torch.scheduler.server import SchedulerServer, SchedulerServerOptions

    server, client, start_kubelet = plane
    for i in range(2):
        start_kubelet(f"n{i}")
    assert wait_until(lambda: _node_exists(client, "n0") and _node_exists(client, "n1"))
    sched = SchedulerServer(client, SchedulerServerOptions(device="cpu")).start()
    try:
        client.pods().create(
            Pod(
                metadata=ObjectMeta(name="workload"),
                spec=PodSpec(containers=[Container(name="main", requests={"cpu": "100m"})]),
            )
        )
        assert wait_until(
            lambda: client.pods().get("workload").status.phase == "Running", 15
        )
        assert client.pods().get("workload").spec.node_name in ("n0", "n1")
    finally:
        sched.stop()


def test_pod_ips_unique_across_nodes(plane):
    """Review regression: each kubelet draws pod IPs from its own range
    (per-node CIDR), so pods on different nodes never share an IP."""
    server, client, start_kubelet = plane
    start_kubelet("node-a")
    start_kubelet("node-b")
    assert wait_until(lambda: _node_exists(client, "node-a") and _node_exists(client, "node-b"))
    client.pods().create(bound_pod("pa", "node-a"))
    client.pods().create(bound_pod("pb", "node-b"))
    assert wait_until(
        lambda: client.pods().get("pa").status.pod_ip
        and client.pods().get("pb").status.pod_ip
    )
    assert client.pods().get("pa").status.pod_ip != client.pods().get("pb").status.pod_ip


def test_status_writes_settle(plane):
    """Review regression: a steady-state running pod must stop generating
    status writes (no start_time churn / self-sustaining update loop)."""
    server, client, start_kubelet = plane
    start_kubelet("n1")
    assert wait_until(lambda: _node_exists(client, "n1"))
    client.pods().create(bound_pod("steady", "n1"))
    assert wait_until(lambda: client.pods().get("steady").status.phase == "Running")
    rv1 = client.pods().get("steady").metadata.resource_version
    time.sleep(1.0)  # many sync periods
    rv2 = client.pods().get("steady").metadata.resource_version
    assert rv1 == rv2, "pod status kept churning at steady state"


# --- probes (pkg/kubelet/prober) --------------------------------------------


def probed_pod(name, node, kind, restart_policy="Always", period=0.05):
    from kubernetes_tpu_torch.api.types import Probe

    probe = Probe(period_seconds=period, failure_threshold=2,
                  success_threshold=1)
    kw = {"liveness_probe" if kind == "liveness" else "readiness_probe": probe}
    return Pod(
        metadata=ObjectMeta(name=name),
        spec=PodSpec(
            node_name=node,
            restart_policy=restart_policy,
            containers=[Container(name="main", requests={"cpu": "100m"},
                                  **kw)],
        ),
    )


def _probe_plane(node_name="n1", **kubelet_kw):
    from kubernetes_tpu_torch.kubelet.prober import FakeProber

    server = APIServer()
    client = RESTClient(LocalTransport(server))
    prober = FakeProber()
    cfg = KubeletConfig(
        node_name=node_name,
        pleg_relist_period=0.05,
        status_sync_period=0.05,
        housekeeping_interval=0.2,
        node_status_update_frequency=0.1,
    )
    runtime = FakeRuntime()
    kl = Kubelet(client, cfg, runtime, prober=prober, **kubelet_kw).run()
    return server, client, kl, runtime, prober


def test_failing_liveness_probe_restarts_container():
    """prober/worker.go: failureThreshold consecutive liveness failures
    kill the container; the pod worker restarts it (restartPolicy Always)
    and restartCount climbs while the pod returns to Running."""
    server, client, kl, runtime, prober = _probe_plane()
    try:
        client.pods().create(probed_pod("sick", "n1", "liveness"))
        assert wait_until(
            lambda: client.pods().get("sick").status.phase == "Running"
        )
        prober.set_result("sick", "main", "liveness", False)

        def restarted():
            st = client.pods().get("sick").status
            return any(cs.restart_count >= 1 for cs in st.container_statuses)

        assert wait_until(restarted)
        # back to Running after the restart (fresh probe history)
        prober.set_result("sick", "main", "liveness", True)
        assert wait_until(
            lambda: client.pods().get("sick").status.phase == "Running"
            and all(cs.state == "running"
                    for cs in client.pods().get("sick").status.container_statuses)
        )
    finally:
        kl.stop()


def test_liveness_failure_with_restart_never_fails_pod():
    server, client, kl, runtime, prober = _probe_plane()
    try:
        client.pods().create(
            probed_pod("doomed", "n1", "liveness", restart_policy="Never")
        )
        assert wait_until(
            lambda: client.pods().get("doomed").status.phase == "Running"
        )
        prober.set_result("doomed", "main", "liveness", False)
        assert wait_until(
            lambda: client.pods().get("doomed").status.phase == "Failed"
        )
        st = client.pods().get("doomed").status
        assert all(cs.restart_count == 0 for cs in st.container_statuses)
    finally:
        kl.stop()


def test_readiness_starts_false_during_initial_delay():
    """A probed container must report unready from the moment the
    worker exists — not default-Ready during initialDelaySeconds
    (worker.go:88,170; ADVICE r2 medium)."""
    import time as _time

    from kubernetes_tpu_torch.api.types import Probe
    from kubernetes_tpu_torch.kubelet.prober import ProbeManager

    mgr = ProbeManager(runner=lambda pod, container, probe: True)
    pod = Pod(
        metadata=ObjectMeta(name="slow", uid="u-slow"),
        spec=PodSpec(containers=[Container(
            name="main",
            readiness_probe=Probe(initial_delay_seconds=1,
                                  period_seconds=1),
        )]),
    )
    mgr.add_pod(pod)
    try:
        assert wait_until(
            lambda: mgr.is_ready("u-slow", "main") is False, timeout=2
        )
        # still within the initial delay: must remain unready
        assert mgr.is_ready("u-slow", "main") is False
        # after the delay, the succeeding probe flips it ready
        assert wait_until(lambda: mgr.is_ready("u-slow", "main"))
    finally:
        mgr.remove_pod("u-slow")


def test_readiness_probe_gates_pod_ready_condition():
    """A failing readiness probe keeps phase Running but flips the pod
    Ready condition False (endpoints drop it; status stays Running)."""
    server, client, kl, runtime, prober = _probe_plane()
    try:
        prober.set_result("web", "main", "readiness", True)
        client.pods().create(probed_pod("web", "n1", "readiness"))

        def ready_is(v):
            st = client.pods().get("web").status
            return st.phase == "Running" and any(
                c.type == "Ready" and c.status == v for c in st.conditions
            )

        assert wait_until(lambda: ready_is("True"))
        prober.set_result("web", "main", "readiness", False)
        assert wait_until(lambda: ready_is("False"))
        assert client.pods().get("web").status.phase == "Running"
        prober.set_result("web", "main", "readiness", True)
        assert wait_until(lambda: ready_is("True"))
    finally:
        kl.stop()


# --- eviction (pkg/kubelet/eviction) ----------------------------------------


def qos_pod(name, node, qos):
    if qos == "BestEffort":
        containers = [Container(name="main")]
    elif qos == "Guaranteed":
        containers = [Container(name="main",
                                requests={"cpu": "100m", "memory": "100Mi"},
                                limits={"cpu": "100m", "memory": "100Mi"})]
    else:
        containers = [Container(name="main", requests={"cpu": "100m"})]
    return Pod(metadata=ObjectMeta(name=name),
               spec=PodSpec(node_name=node, containers=containers))


def test_memory_pressure_evicts_best_effort_first():
    """eviction/helpers.go rankMemoryPressure: under pressure the node
    reports MemoryPressure (feeding CheckNodeMemoryPressure) and evicts
    BestEffort before Burstable before Guaranteed."""
    available = [8 << 30]
    server = APIServer()
    client = RESTClient(LocalTransport(server))
    cfg = KubeletConfig(
        node_name="n2",
        pleg_relist_period=0.05,
        status_sync_period=0.05,
        node_status_update_frequency=0.05,
        eviction_memory_threshold=1 << 30,
        eviction_sync_period=0.1,
        eviction_pressure_transition_period=0.5,
    )
    runtime2 = FakeRuntime()
    kl2 = Kubelet(client, cfg, runtime2,
                  memory_available_fn=lambda: available[0]).run()
    try:
        for qos in ("Guaranteed", "BestEffort", "Burstable"):
            client.pods().create(qos_pod(f"p-{qos.lower()}", "n2", qos))
        assert wait_until(lambda: all(
            client.pods().get(f"p-{q.lower()}").status.phase == "Running"
            for q in ("Guaranteed", "BestEffort", "Burstable")
        ))
        available[0] = 256 << 20  # under the 1Gi threshold

        def phase(name):
            return client.pods().get(name).status.phase

        assert wait_until(lambda: phase("p-besteffort") == "Failed")
        assert client.pods().get("p-besteffort").status.reason == "Evicted"
        # the node now advertises MemoryPressure for the scheduler
        def mem_pressure():
            n = client.nodes().get("n2")
            return any(c.type == "MemoryPressure" and c.status == "True"
                       for c in n.status.conditions)

        assert wait_until(mem_pressure)
        # CheckNodeMemoryPressure end-to-end: a BestEffort pod no longer
        # fits this node while a Burstable one still does
        from kubernetes_tpu_torch.oracle import ClusterState
        from kubernetes_tpu_torch.oracle import predicates as opreds

        state = ClusterState.build([client.nodes().get("n2")])
        info = state.node_infos["n2"]
        fit, reason = opreds.check_node_memory_pressure(
            qos_pod("probe-be", "", "BestEffort"), info, state)
        assert not fit and reason == "NodeUnderMemoryPressure"
        fit, _ = opreds.check_node_memory_pressure(
            qos_pod("probe-bu", "", "Burstable"), info, state)
        assert fit
        # next ranked eviction: Burstable before Guaranteed
        assert wait_until(lambda: phase("p-burstable") == "Failed")
        assert phase("p-guaranteed") != "Failed"
        # pressure clears after the transition period
        available[0] = 8 << 30
        def mem_clear():
            n = client.nodes().get("n2")
            return any(c.type == "MemoryPressure" and c.status == "False"
                       for c in n.status.conditions)

        assert wait_until(mem_clear)
    finally:
        kl2.stop()
