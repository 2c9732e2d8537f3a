"""Controller-manager loops against an in-process control plane — the
reference's integration-test idiom (test/integration + controller unit
suites): real apiserver + watch plumbing, controllers converging
actual -> desired, no kubelets.

The cases of tests/test_controllers.py, run against the port's copies
(kubernetes_tpu_torch), each with the mark it has there."""

import time

import pytest

from kubernetes_tpu_torch.api.types import (
    Container,
    ContainerPort,
    DaemonSet,
    DaemonSetSpec,
    Deployment,
    DeploymentSpec,
    HorizontalPodAutoscaler,
    HorizontalPodAutoscalerSpec,
    Job,
    JobSpec,
    LabelSelector,
    Namespace,
    Node,
    NodeCondition,
    NodeSpec,
    NodeStatus,
    ObjectMeta,
    PetSet,
    PetSetSpec,
    Pod,
    PodCondition,
    PodSpec,
    PodTemplateSpec,
    ReplicationController,
    ReplicationControllerSpec,
    ReplicaSet,
    ReplicaSetSpec,
    ResourceQuota,
    ResourceQuotaSpec,
    Service,
    ServicePort,
    ServiceSpec,
)
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.rest import RESTClient
from kubernetes_tpu_torch.client.transport import LocalTransport
from kubernetes_tpu_torch.controller.autoscale import (
    HorizontalController,
    ResourceQuotaController,
)
from kubernetes_tpu_torch.controller.daemonset import DaemonSetsController
from kubernetes_tpu_torch.controller.deployment import DeploymentController
from kubernetes_tpu_torch.controller.endpoints import EndpointsController
from kubernetes_tpu_torch.controller.framework import SharedInformerFactory
from kubernetes_tpu_torch.controller.gc import NamespaceController, PodGCController
from kubernetes_tpu_torch.controller.job import JobController
from kubernetes_tpu_torch.controller.manager import (
    ControllerManager,
    ControllerManagerOptions,
)
from kubernetes_tpu_torch.controller.node_lifecycle import NodeLifecycleController
from kubernetes_tpu_torch.controller.petset import PetSetController
from kubernetes_tpu_torch.controller.replication import (
    ReplicationManager,
    new_replicaset_manager,
)


from conftest import wait_until  # noqa: E402


@pytest.fixture()
def plane():
    server = APIServer()
    client = RESTClient(LocalTransport(server))
    informers = SharedInformerFactory(client)
    started = []

    def start(*controllers):
        informers.start()
        informers.wait_for_sync()
        for c in controllers:
            c.run()
            started.append(c)
        return controllers

    yield server, client, informers, start
    for c in started:
        try:
            c.stop()
        except Exception:
            pass
    informers.stop()


def template(labels, cpu="100m"):
    return PodTemplateSpec(
        metadata=ObjectMeta(labels=dict(labels)),
        spec=PodSpec(containers=[Container(requests={"cpu": cpu})]),
    )


def pods_of(client, ns="default"):
    return client.pods(ns).list()[0]


def update_spec(client, resource, name, mutate, ns="default", attempts=20):
    """GET-mutate-PUT with conflict retry (controllers race status writes
    onto the same object; real clients retry exactly like this)."""
    from kubernetes_tpu_torch.client.rest import APIStatusError

    rc = client.resource(resource, ns)
    for _ in range(attempts):
        obj = rc.get(name)
        mutate(obj)
        try:
            return rc.update(obj)
        except APIStatusError as e:
            if e.code != 409:
                raise
            time.sleep(0.02)
    raise AssertionError(f"update of {resource}/{name} kept conflicting")


# --- ReplicationController / ReplicaSet -------------------------------------


def test_rc_scales_up_and_down(plane):
    server, client, informers, start = plane
    rcm = ReplicationManager(client, informers)
    start(rcm)
    rc = ReplicationController(
        metadata=ObjectMeta(name="web"),
        spec=ReplicationControllerSpec(
            replicas=3, selector={"app": "web"}, template=template({"app": "web"})
        ),
    )
    client.resource("replicationcontrollers", "default").create(rc)
    assert wait_until(lambda: len(pods_of(client)) == 3)
    # status converges
    assert wait_until(
        lambda: client.resource("replicationcontrollers", "default")
        .get("web")
        .status.replicas
        == 3
    )
    # scale down to 1: the two newest/pending pods are the victims
    update_spec(client, "replicationcontrollers", "web",
                lambda rc: setattr(rc.spec, "replicas", 1))
    assert wait_until(lambda: len(pods_of(client)) == 1)
    # deleted pods are replaced (reconciliation, not one-shot)
    client.pods().delete(pods_of(client)[0].metadata.name)
    assert wait_until(lambda: len(pods_of(client)) == 1)


def test_replicaset_label_selector(plane):
    server, client, informers, start = plane
    rsm = new_replicaset_manager(client, informers)
    start(rsm)
    rs = ReplicaSet(
        metadata=ObjectMeta(name="web-rs"),
        spec=ReplicaSetSpec(
            replicas=2,
            selector=LabelSelector(match_labels={"app": "web"}),
            template=template({"app": "web"}),
        ),
    )
    client.resource("replicasets", "default").create(rs)
    assert wait_until(lambda: len(pods_of(client)) == 2)


# --- Endpoints ---------------------------------------------------------------


def _make_running(client, pod, ip, ready=True):
    pod.status.phase = "Running"
    pod.status.pod_ip = ip
    if ready:
        pod.status.conditions = [PodCondition(type="Ready", status="True")]
    client.pods(pod.metadata.namespace).update_status(pod)


def test_endpoints_controller(plane):
    server, client, informers, start = plane
    epc = EndpointsController(client, informers)
    start(epc)
    client.resource("services", "default").create(
        Service(
            metadata=ObjectMeta(name="web"),
            spec=ServiceSpec(
                selector={"app": "web"},
                ports=[ServicePort(name="http", port=80, target_port=8080)],
            ),
        )
    )
    pod = Pod(
        metadata=ObjectMeta(name="w1", labels={"app": "web"}),
        spec=PodSpec(
            node_name="n1",
            containers=[Container(ports=[ContainerPort(container_port=8080)])],
        ),
    )
    client.pods().create(pod)
    _make_running(client, client.pods().get("w1"), "10.0.0.1")

    def eps_ips():
        try:
            eps = client.resource("endpoints", "default").get("web")
        except Exception:
            return []
        return [a.ip for s in eps.subsets for a in s.addresses]

    assert wait_until(lambda: eps_ips() == ["10.0.0.1"])
    eps = client.resource("endpoints", "default").get("web")
    assert eps.subsets[0].ports[0].port == 8080
    # pod deleted -> endpoints drain
    client.pods().delete("w1")
    assert wait_until(lambda: eps_ips() == [])


# --- Job ---------------------------------------------------------------------


def test_job_runs_to_completion(plane):
    server, client, informers, start = plane
    jc = JobController(client, informers)
    start(jc)
    job = Job(
        metadata=ObjectMeta(name="batch1"),
        spec=JobSpec(
            parallelism=2,
            completions=3,
            selector=LabelSelector(match_labels={"job": "batch1"}),
            template=template({"job": "batch1"}),
        ),
    )
    client.resource("jobs", "default").create(job)
    assert wait_until(
        lambda: len(
            [p for p in pods_of(client) if p.status.phase == "Pending"]
        )
        == 2
    )
    # complete pods one by one; the controller backfills until 3 succeeded
    for _ in range(3):
        assert wait_until(
            lambda: any(p.status.phase == "Pending" for p in pods_of(client))
        )
        p = next(p for p in pods_of(client) if p.status.phase == "Pending")
        p.status.phase = "Succeeded"
        client.pods().update_status(p)
    assert wait_until(
        lambda: "Complete"
        in client.resource("jobs", "default").get("batch1").status.conditions
    )
    assert client.resource("jobs", "default").get("batch1").status.succeeded == 3


# --- Deployment --------------------------------------------------------------


def test_deployment_rolling_update(plane):
    server, client, informers, start = plane
    dc = DeploymentController(client, informers)
    rsm = new_replicaset_manager(client, informers)
    start(dc, rsm)
    d = Deployment(
        metadata=ObjectMeta(name="web"),
        spec=DeploymentSpec(
            replicas=3,
            selector=LabelSelector(match_labels={"app": "web"}),
            template=template({"app": "web"}),
        ),
    )
    client.resource("deployments", "default").create(d)
    assert wait_until(lambda: len(pods_of(client)) == 3, 15)
    first_rs = [
        rs for rs in client.resource("replicasets", "default").list()[0]
    ]
    assert len(first_rs) == 1

    # roll the template: a second RS appears, the old one drains to zero
    update_spec(client, "deployments", "web",
                lambda d: setattr(d.spec, "template", template({"app": "web"}, cpu="200m")))
    assert wait_until(
        lambda: len(client.resource("replicasets", "default").list()[0]) == 2, 15
    )
    assert wait_until(
        lambda: any(
            rs.spec.replicas == 0
            for rs in client.resource("replicasets", "default").list()[0]
        )
        and sum(
            rs.spec.replicas for rs in client.resource("replicasets", "default").list()[0]
        )
        == 3,
        20,
    )
    assert wait_until(
        lambda: sorted(
            p.spec.containers[0].requests.get("cpu", "")
            for p in pods_of(client)
        )
        == ["200m", "200m", "200m"],
        20,
    )


# --- DaemonSet ---------------------------------------------------------------


def ready_node(name, unschedulable=False):
    return Node(
        metadata=ObjectMeta(name=name),
        spec=NodeSpec(unschedulable=unschedulable),
        status=NodeStatus(
            allocatable={"cpu": "4", "memory": "32Gi", "pods": "110"},
            conditions=[NodeCondition("Ready", "True")],
        ),
    )


def test_daemonset_one_pod_per_node(plane):
    server, client, informers, start = plane
    dsc = DaemonSetsController(client, informers)
    start(dsc)
    client.nodes().create(ready_node("n1"))
    client.nodes().create(ready_node("n2"))
    client.nodes().create(ready_node("cordoned", unschedulable=True))
    ds = DaemonSet(
        metadata=ObjectMeta(name="agent"),
        spec=DaemonSetSpec(
            selector=LabelSelector(match_labels={"ds": "agent"}),
            template=template({"ds": "agent"}),
        ),
    )
    client.resource("daemonsets", "default").create(ds)
    assert wait_until(
        lambda: sorted(p.spec.node_name for p in pods_of(client)) == ["n1", "n2"]
    )
    # a new node gets its daemon
    client.nodes().create(ready_node("n3"))
    assert wait_until(
        lambda: sorted(p.spec.node_name for p in pods_of(client))
        == ["n1", "n2", "n3"]
    )
    # status lands in a follow-up sync after the n3 pod create: poll
    assert wait_until(
        lambda: client.resource("daemonsets", "default")
        .get("agent").status.desired_number_scheduled == 3
    )


# --- GC + namespace ----------------------------------------------------------


def test_podgc_orphans_and_threshold(plane):
    server, client, informers, start = plane
    gc = PodGCController(client, informers, terminated_pod_threshold=1)
    informers.start()
    informers.wait_for_sync()
    client.nodes().create(ready_node("n1"))
    # orphan: bound to a node that does not exist
    orphan = Pod(metadata=ObjectMeta(name="orphan"),
                 spec=PodSpec(node_name="ghost", containers=[Container()]))
    client.pods().create(orphan)
    # two terminated pods; threshold 1 -> oldest collected
    for i, name in enumerate(["dead-old", "dead-new"]):
        p = Pod(metadata=ObjectMeta(name=name),
                spec=PodSpec(node_name="n1", containers=[Container()]))
        client.pods().create(p)
        p = client.pods().get(name)
        p.status.phase = "Failed"
        client.pods().update_status(p)
    # the GC reads the INFORMER view; wait until it has seen the phases
    assert wait_until(
        lambda: sum(
            1
            for p in informers.pods().store.list()
            if p.status.phase == "Failed"
        )
        == 2
        and len(informers.pods().store.list()) == 3
    )
    gc.gc_once()
    names = {p.metadata.name for p in pods_of(client)}
    assert "orphan" not in names
    assert len(names & {"dead-old", "dead-new"}) == 1


def test_namespace_lifecycle(plane):
    server, client, informers, start = plane
    nc = NamespaceController(client, informers)
    start(nc)
    client.resource("namespaces").create(Namespace(metadata=ObjectMeta(name="doomed")))
    client.pods("doomed").create(
        Pod(metadata=ObjectMeta(name="p1", namespace="doomed"),
            spec=PodSpec(containers=[Container()]))
    )
    client.resource("namespaces").delete("doomed")

    def gone():
        try:
            client.resource("namespaces").get("doomed")
            return False
        except Exception:
            return True

    assert wait_until(gone)
    assert pods_of(client, "doomed") == []


# --- node lifecycle ----------------------------------------------------------


def test_node_lifecycle_eviction(plane):
    server, client, informers, start = plane
    fake_now = [time.time()]
    nlc = NodeLifecycleController(
        client, informers,
        node_monitor_grace_period=40.0,
        pod_eviction_timeout=300.0,
        eviction_qps=1000.0,
        now=lambda: fake_now[0],
    )
    informers.start()
    informers.wait_for_sync()
    n = ready_node("flaky")
    n.status.conditions[0].last_heartbeat_time = time.strftime(
        "%Y-%m-%dT%H:%M:%SZ", time.gmtime(fake_now[0])
    )
    client.nodes().create(n)
    client.pods().create(
        Pod(metadata=ObjectMeta(name="victim"),
            spec=PodSpec(node_name="flaky", containers=[Container()]))
    )
    assert wait_until(lambda: len(informers.nodes().store.list()) == 1)
    assert wait_until(lambda: len(informers.pods().store.list()) == 1)
    # within grace: nothing happens
    nlc.monitor_once()
    assert client.nodes().get("flaky").status.conditions[0].status == "True"
    # past grace: Ready -> Unknown
    fake_now[0] += 60
    nlc.monitor_once()
    assert wait_until(
        lambda: client.nodes().get("flaky").status.conditions[0].status
        == "Unknown"
    )
    # past eviction timeout: pods deleted
    fake_now[0] += 301
    assert wait_until(lambda: len(informers.nodes().store.list()) == 1)
    nlc.monitor_once()
    assert wait_until(lambda: pods_of(client) == [])


# --- HPA + quota -------------------------------------------------------------


def test_hpa_scales_rc(plane):
    server, client, informers, start = plane
    rcm = ReplicationManager(client, informers)
    utilization = [160.0]
    hpa_ctl = HorizontalController(
        client, informers, lambda ns, pods: utilization[0]
    )
    start(rcm)
    client.resource("replicationcontrollers", "default").create(
        ReplicationController(
            metadata=ObjectMeta(name="web"),
            spec=ReplicationControllerSpec(
                replicas=2, selector={"app": "web"},
                template=template({"app": "web"}),
            ),
        )
    )
    client.resource("horizontalpodautoscalers", "default").create(
        HorizontalPodAutoscaler(
            metadata=ObjectMeta(name="web-hpa"),
            spec=HorizontalPodAutoscalerSpec(
                scale_target_kind="ReplicationController",
                scale_target_name="web",
                min_replicas=1,
                max_replicas=10,
                target_cpu_utilization_percentage=80,
            ),
        )
    )
    assert wait_until(lambda: len(pods_of(client)) == 2)
    # reconcile_once syncs from the informer view; wait for the watch to
    # deliver the HPA first (the reference's loop just retries in 30s)
    assert wait_until(lambda: len(hpa_ctl.hpa_informer.store.list()) == 1)
    hpa_ctl.reconcile_once()
    # 160% of an 80% target -> double the replicas
    assert client.resource("replicationcontrollers", "default").get("web").spec.replicas == 4
    assert wait_until(lambda: len(pods_of(client)) == 4)
    # back within tolerance: no change
    utilization[0] = 82.0
    hpa_ctl.reconcile_once()
    assert client.resource("replicationcontrollers", "default").get("web").spec.replicas == 4


def test_resource_quota_usage(plane):
    server, client, informers, start = plane
    qc = ResourceQuotaController(client, informers)
    informers.start()
    informers.wait_for_sync()
    client.resource("resourcequotas", "default").create(
        ResourceQuota(
            metadata=ObjectMeta(name="quota"),
            spec=ResourceQuotaSpec(hard={"pods": "10", "requests.cpu": "2"}),
        )
    )
    for i in range(3):
        client.pods().create(
            Pod(metadata=ObjectMeta(name=f"q{i}"),
                spec=PodSpec(containers=[Container(requests={"cpu": "250m"})]))
        )
    assert wait_until(lambda: len(informers.pods().store.list()) == 3)
    qc.sync_once()
    status = client.resource("resourcequotas", "default").get("quota").status
    assert status.used["pods"] == "3"
    assert status.used["requests.cpu"] == "750m"


# --- PetSet ------------------------------------------------------------------


def test_petset_ordered_stable_identity(plane):
    server, client, informers, start = plane
    psc = PetSetController(client, informers)
    start(psc)
    client.resource("petsets", "default").create(
        PetSet(
            metadata=ObjectMeta(name="db"),
            spec=PetSetSpec(
                replicas=3,
                selector=LabelSelector(match_labels={"ps": "db"}),
                template=template({"ps": "db"}),
                service_name="db",
            ),
        )
    )
    assert wait_until(
        lambda: sorted(p.metadata.name for p in pods_of(client))
        == ["db-0", "db-1", "db-2"]
    )
    # scale down deletes the highest ordinal
    update_spec(client, "petsets", "db",
                lambda ps: setattr(ps.spec, "replicas", 2))
    assert wait_until(
        lambda: sorted(p.metadata.name for p in pods_of(client))
        == ["db-0", "db-1"]
    )


# --- the manager -------------------------------------------------------------


def test_controller_manager_starts_all(plane):
    server, client, informers, start = plane
    mgr = ControllerManager(client)
    mgr.start()
    try:
        client.nodes().create(ready_node("n1"))
        client.resource("replicationcontrollers", "default").create(
            ReplicationController(
                metadata=ObjectMeta(name="web"),
                spec=ReplicationControllerSpec(
                    replicas=2, selector={"app": "web"},
                    template=template({"app": "web"}),
                ),
            )
        )
        assert wait_until(lambda: len(pods_of(client)) == 2)
    finally:
        mgr.stop()


def test_controller_manager_leader_election():
    """controllermanager.go:142-170: two managers, one lease — only the
    leader runs loops; the standby takes over when the leader dies."""
    server = APIServer()
    client = RESTClient(LocalTransport(server))
    opts = ControllerManagerOptions(
        leader_elect=True, enable=("replication",),
    )
    m1 = ControllerManager(client, opts).start()
    assert wait_until(lambda: m1.is_leader() and m1.informers._started)
    m2 = ControllerManager(client, ControllerManagerOptions(
        leader_elect=True, enable=("replication",))).start()
    time.sleep(0.5)
    assert not m2.informers._started  # standby idles without the lease
    client.resource("replicationcontrollers", "default").create(
        ReplicationController(
            metadata=ObjectMeta(name="web"),
            spec=ReplicationControllerSpec(
                replicas=2, selector={"app": "web"},
                template=template({"app": "web"}),
            ),
        )
    )
    assert wait_until(lambda: len(pods_of(client)) == 2)
    m1.stop()  # releases the lease: the standby acquires without
    # waiting out the 15s lease_duration
    assert not m1.lost_lease  # voluntary stop is not a lost lease
    assert wait_until(lambda: m2.informers._started)
    update_spec(client, "replicationcontrollers", "web",
                lambda rc: setattr(rc.spec, "replicas", 4))
    assert wait_until(lambda: len(pods_of(client)) == 4, timeout=30.0)
    m2.stop()


def test_service_and_route_controllers(plane):
    """servicecontroller.go + routecontroller.go against the fake cloud:
    LoadBalancer services get balancers spanning the nodes; nodes get pod
    CIDR routes; deletions tear both down."""
    from kubernetes_tpu_torch.cloudprovider import FakeCloud
    from kubernetes_tpu_torch.controller.cloud import RouteController, ServiceController

    server, client, informers, start = plane
    cloud = FakeCloud()
    sc = ServiceController(client, informers, cloud)
    rc = RouteController(client, informers, cloud)
    client.nodes().create(ready_node("n1"))
    client.nodes().create(ready_node("n2"))
    client.resource("services", "default").create(
        Service(
            metadata=ObjectMeta(name="lb"),
            spec=ServiceSpec(
                selector={"app": "web"},
                type="LoadBalancer",
                ports=[ServicePort(port=443)],
            ),
        )
    )
    informers.start()
    informers.wait_for_sync()
    assert wait_until(lambda: len(informers.nodes().store.list()) == 2)
    sc.sync_once()
    rc.sync_once()
    lbs = list(cloud.balancers.values())
    assert len(lbs) == 1
    assert lbs[0].ports == (443,) and lbs[0].hosts == ("n1", "n2")
    assert lbs[0].region == cloud.get_zone().region
    routes = cloud.list_routes("kubernetes")
    assert sorted(r.target_instance for r in routes) == ["n1", "n2"]
    assert all(r.destination_cidr.endswith("/24") for r in routes)
    # service deleted -> balancer torn down; node gone -> route removed
    client.resource("services", "default").delete("lb")
    client.nodes().delete("n2")
    assert wait_until(lambda: len(informers.nodes().store.list()) == 1)
    assert wait_until(
        lambda: len(informers.informer("services").store.list()) == 0
    )
    sc.sync_once()
    rc.sync_once()
    assert cloud.balancers == {}
    assert [r.target_instance for r in cloud.list_routes("kubernetes")] == ["n1"]
