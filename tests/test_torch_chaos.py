"""Fault injection / elastic recovery (the reference's chaosmonkey +
daemon_restart e2e tier, SURVEY.md section 5.3-5.4): every component is a
stateless cache of the API rebuilt via list+watch, so kill + restart must
resume exactly where the dead instance stopped.

The cases of tests/test_chaos.py, run against the port's copies
(kubernetes_tpu_torch), each with the mark it has there.
The scheduler daemon runs with device="cpu" (the port's entry points take
the card unless asked)."""

import time

import pytest

from kubernetes_tpu_torch.api.types import (
    Container,
    Node,
    NodeCondition,
    NodeStatus,
    ObjectMeta,
    Pod,
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
from kubernetes_tpu_torch.kubelet import FakeRuntime, Kubelet, KubeletConfig
from kubernetes_tpu_torch.scheduler.server import SchedulerServer, SchedulerServerOptions


from conftest import wait_until  # noqa: E402

from kubernetes_tpu_torch.analysis import locks as lock_sanitizer


@pytest.fixture(autouse=True)
def _lock_order_sanitizer():
    """The chaos scenarios double as lock-order witnesses: every
    Lock/RLock created by kubernetes_tpu code during the test is
    wrapped (analysis/locks) and the cross-thread acquisition-order
    graph must stay acyclic — a cycle is a latent deadlock even when
    this run's interleaving got lucky."""
    with lock_sanitizer.instrumented():
        yield
    lock_sanitizer.assert_no_cycles("(chaos suite)")


def ready_node(name):
    return Node(
        metadata=ObjectMeta(name=name),
        status=NodeStatus(
            allocatable={"cpu": "64", "memory": "256Gi", "pods": "500"},
            conditions=[NodeCondition("Ready", "True")],
        ),
    )


def pending_pod(name):
    return Pod(
        metadata=ObjectMeta(name=name),
        spec=PodSpec(containers=[Container(requests={"cpu": "50m"})]),
    )


def n_bound(client):
    return sum(1 for p in client.pods().list()[0] if p.spec.node_name)


def test_scheduler_restart_resumes_backlog():
    """daemon_restart.go for the scheduler: kill it mid-backlog; a FRESH
    instance (new process state, nothing carried over) must pick up the
    remaining pending pods from the watch and finish. This is the
    checkpoint/resume model: the API IS the checkpoint."""
    server = APIServer()
    client = RESTClient(LocalTransport(server))
    for i in range(4):
        client.nodes().create(ready_node(f"n{i}"))
    for i in range(20):
        client.pods().create(pending_pod(f"p{i:03d}"))
    first = SchedulerServer(client, SchedulerServerOptions(device="cpu")).start()
    assert wait_until(lambda: n_bound(client) >= 1)
    first.stop()
    # the cluster keeps moving while NO scheduler runs: a backlog builds
    for i in range(20, 40):
        client.pods().create(pending_pod(f"p{i:03d}"))
    before = n_bound(client)
    assert before < 40
    # a FRESH instance must find the backlog via its initial LIST (no
    # watch event will ever replay the creations it missed)
    second = SchedulerServer(client, SchedulerServerOptions(device="cpu")).start()
    try:
        assert wait_until(lambda: n_bound(client) == 40)
        # every pod exactly once: no double-binding across instances
        nodes = [p.spec.node_name for p in client.pods().list()[0]]
        assert all(nodes)
    finally:
        second.stop()


def test_kubelet_restart_recovers_pods():
    """A kubelet restart (fresh runtime — the machine rebooted) must
    re-run its bound pods and report Running again."""
    server = APIServer()
    client = RESTClient(LocalTransport(server))
    cfg = dict(pleg_relist_period=0.05, status_sync_period=0.05)
    kl = Kubelet(client, KubeletConfig(node_name="n1", **cfg), FakeRuntime()).run()
    client.pods().create(
        Pod(metadata=ObjectMeta(name="p1"),
            spec=PodSpec(node_name="n1", containers=[Container(name="c")]))
    )
    assert wait_until(lambda: client.pods().get("p1").status.phase == "Running")
    kl.stop()
    # fresh kubelet, empty runtime: the config watch replays the bound pod
    kl2 = Kubelet(client, KubeletConfig(node_name="n1", **cfg), FakeRuntime()).run()
    try:
        assert wait_until(
            lambda: any(rp.name == "p1" for rp in kl2.runtime.list_pods())
        )
        assert client.pods().get("p1").status.phase == "Running"
    finally:
        kl2.stop()


def test_controller_manager_restart_mid_scale():
    """Kill the replication manager mid-scale-up; a fresh one must
    complete the scale without duplicating pods (expectations are local
    state and die with the process — the API world is the truth)."""
    server = APIServer()
    client = RESTClient(LocalTransport(server))
    informers = SharedInformerFactory(client)
    rcm = ReplicationManager(client, informers)
    informers.start()
    informers.wait_for_sync()
    rcm.run()
    client.resource("replicationcontrollers", "default").create(
        ReplicationController(
            metadata=ObjectMeta(name="web"),
            spec=ReplicationControllerSpec(
                replicas=30, selector={"app": "web"},
                template=PodTemplateSpec(
                    metadata=ObjectMeta(labels={"app": "web"}),
                    spec=PodSpec(containers=[Container(requests={"cpu": "10m"})]),
                ),
            ),
        )
    )
    assert wait_until(lambda: len(client.pods().list()[0]) >= 5)
    rcm.stop()
    informers.stop()
    informers2 = SharedInformerFactory(client)
    rcm2 = ReplicationManager(client, informers2)
    informers2.start()
    informers2.wait_for_sync()
    rcm2.run()
    try:
        assert wait_until(lambda: len(client.pods().list()[0]) == 30)
        time.sleep(0.5)  # stability: no over-creation afterwards
        assert len(client.pods().list()[0]) == 30
    finally:
        rcm2.stop()
        informers2.stop()


def test_assumed_pod_ttl_self_heals():
    """cache.go:278-299: a bind that never lands (assumed pod whose watch
    confirmation is lost) expires after the TTL, releasing the resources
    in the scheduler cache — verified through the SchedulerCache API."""
    from kubernetes_tpu_torch.scheduler.cache import SchedulerCache
    from kubernetes_tpu_torch.utils.clock import FakeClock

    clock = FakeClock(1000.0)
    cache = SchedulerCache(ttl=30.0, clock=clock)
    cache.add_node(ready_node("n1"))
    pod = Pod(metadata=ObjectMeta(name="ghost", uid="u1"),
              spec=PodSpec(node_name="n1",
                           containers=[Container(requests={"cpu": "1"})]))
    cache.assume_pod(pod)
    state = cache.snapshot()
    assert state.node_infos["n1"].requested_milli_cpu == 1000
    # TTL passes with no Add confirmation: cleanup drops the assumption
    clock.step(31.0)
    cache.cleanup_expired(clock.now())
    state = cache.snapshot()
    assert state.node_infos["n1"].requested_milli_cpu == 0


def test_apiserver_restart_mid_backlog(tmp_path):
    """Kill and restart the apiserver (the one component whose death was
    previously unrecoverable) mid-backlog: the durable store recovers
    every object with RV continuity, reflectors relist through the
    Compacted horizon, and the scheduler drains the rest of the backlog.
    Matches the role of etcd-as-only-checkpoint (SURVEY 5.4)."""
    from kubernetes_tpu_torch.client.transport import HTTPTransport

    data_dir = str(tmp_path / "etcd")
    api1 = APIServer(data_dir=data_dir)
    host, port = api1.serve_http()
    client = RESTClient(HTTPTransport(f"http://{host}:{port}", timeout=5.0))
    for i in range(4):
        client.nodes().create(ready_node(f"n{i}"))
    sched = SchedulerServer(
        client, SchedulerServerOptions(algorithm_provider="TPUProvider",
                               device="cpu")
    ).start()
    try:
        for i in range(30):
            client.pods().create(pending_pod(f"pre-{i:03d}"))
        assert wait_until(lambda: n_bound(client) >= 10)

        # --- kill the apiserver process (HTTP down, store dropped) ---
        api1.shutdown_http()
        api1.store.close()
        del api1
        time.sleep(0.3)

        # --- restart on the same port from the same data_dir ---
        api2 = APIServer(data_dir=data_dir)
        api2.serve_http(host=host, port=port)
        try:
            objs, _ = client.pods().list()
            assert len(objs) == 30, "recovered store lost pods"
            bound_before = sum(1 for p in objs if p.spec.node_name)
            assert bound_before >= 10, "recovered store lost bindings"
            # new work + the unfinished backlog drain through the same
            # scheduler: its reflectors must recover on their own
            for i in range(10):
                client.pods().create(pending_pod(f"post-{i:02d}"))
            assert wait_until(lambda: n_bound(client) == 40, timeout=40), (
                f"stuck at {n_bound(client)}/40 bound"
            )
        finally:
            api2.shutdown_http()
            api2.store.close()
    finally:
        sched.stop()


class _ReplicatedHA:
    """The 2-node WAL-shipping profile: primary + WAL-shipped standby
    with an external PromotionMonitor (storage/replicated.py)."""

    name = "replicated"

    def start(self, tmp_path):
        from kubernetes_tpu_torch.client.transport import HTTPTransport
        from kubernetes_tpu_torch.storage.replicated import (
            FollowerStore,
            PromotionMonitor,
            ReplicatedStore,
        )

        self.primary = ReplicatedStore(str(tmp_path / "primary"))
        self.api1 = APIServer(store=self.primary)
        host, port1 = self.api1.serve_http()
        self.follower = FollowerStore(
            str(tmp_path / "standby"), self.primary.repl_address
        )
        assert self.follower.synced(10), (
            "standby never completed initial sync")
        self.api2 = APIServer(store=self.follower)
        # the standby SERVES already (reads + 503 writes); promotion
        # makes it writable — clients reach it via transport failover
        _h2, port2 = self.api2.serve_http()
        url1 = f"http://{host}:{port1}"
        probe = RESTClient(HTTPTransport(url1, timeout=2.0))
        self.monitor = PromotionMonitor(
            self.follower, probe=probe.healthz, interval=0.1,
            failures=3)
        return f"{url1},http://{host}:{port2}"

    def arm(self):
        self.monitor.run()

    def kill_primary(self):
        # kill -9: HTTP torn down, store abandoned without close()
        # (no final snapshot, no WAL truncation)
        self.api1.shutdown_http()
        self.api1 = None
        self.primary = None

    def wait_failover(self):
        assert wait_until(lambda: self.follower.promoted, timeout=15), (
            "standby was never promoted")

    def survivor_store(self):
        return self.follower

    def assert_acked_replicated(self, prefix, n):
        """acked == already durably on the standby, synchronously."""
        with self.follower._lock:
            have = sum(1 for k in self.follower._data
                       if k.startswith(prefix))
        assert have == n, f"follower behind acked writes: {have}/{n}"

    def promote_now(self):
        if self.primary is not None:
            self.primary.close()
            self.primary = None
        self.follower.promote()
        return self.api2

    def close(self):
        self.monitor.stop()
        if self.api1 is not None:
            self.api1.shutdown_http()
        self.api2.shutdown_http()
        if self.primary is not None:
            self.primary.close()
        self.follower.close()


class _QuorumHA:
    """The 3-member majority-ack consensus profile: every member
    serves an apiserver; election is INSIDE the store (storage/
    quorum), so there is no promotion monitor to arm."""

    name = "quorum"

    def start(self, tmp_path):
        from kubernetes_tpu_torch.storage.quorum import build_cluster

        # 0.5s base: fast failover for the test, but wide enough that
        # a GIL stall under the armed sanitizers (~3x slowdown) never
        # reads as leader death mid-propose (a spurious deposition
        # 503s the bare test client, which has no retry loop)
        self.stores = build_cluster(
            str(tmp_path), 3, election_timeout=0.5)
        self.killed = []
        self.apis = [APIServer(store=s) for s in self.stores]
        urls = []
        for api in self.apis:
            host, port = api.serve_http()
            urls.append(f"http://{host}:{port}")
        return ",".join(urls)

    def arm(self):
        pass  # the quorum elects from INSIDE the store

    # generous: during a mid-density failover the scheduler's retry
    # storm shares the GIL with the election itself
    def _leader(self, timeout=60.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            for s in self.stores:
                if s not in self.killed and s.node.is_leader():
                    return s
            time.sleep(0.02)
        raise AssertionError("no quorum leader")

    def kill_primary(self):
        lead = self._leader()
        self.apis[self.stores.index(lead)].shutdown_http()
        lead.kill()
        self.killed.append(lead)

    def wait_failover(self):
        self._leader()  # a new leader IS the failover

    def survivor_store(self):
        return self._leader()

    def assert_acked_replicated(self, prefix, n):
        """acked == durably in a MAJORITY's raft log (applied state
        follows at the next commit notification)."""
        lead = self._leader()
        need = lead.node.status()["applied_index"]
        followers = [s for s in self.stores
                     if s is not lead and s not in self.killed]
        logged = [f for f in followers
                  if f.node.raft_log.last_index >= need]
        assert logged, (
            f"no follower's log reached index {need} at ack time: "
            f"{[(f.node_id, f.node.raft_log.last_index) for f in followers]}")

    def promote_now(self):
        """kill the leader; the surviving majority elects — return an
        apiserver over the new leader."""
        self.kill_primary()
        lead = self._leader()
        return self.apis[self.stores.index(lead)]

    def close(self):
        for api in self.apis:
            api.shutdown_http()
        for s in self.stores:
            s.close()


@pytest.fixture(params=["replicated", "quorum"])
def ha_profile(request):
    return {"replicated": _ReplicatedHA, "quorum": _QuorumHA}[
        request.param]()


def test_replicated_store_failover_zero_lost_bindings(tmp_path,
                                                      ha_profile):
    """Kill the PRIMARY mid-density (no graceful close — the store is
    abandoned, like kill -9 severing its sockets) and assert: the
    surviving replica(s) hold EVERY acknowledged write, failover
    happens (external promotion for the 2-node profile, internal
    election for the quorum), clients fail over through the
    multi-server transport, and the scheduler drains the remaining
    backlog. The etcd-cluster property, at both HA scales."""
    from kubernetes_tpu_torch.client.transport import HTTPTransport

    profile = ha_profile
    urls = profile.start(tmp_path)
    client = RESTClient(HTTPTransport(urls, timeout=5.0))
    for i in range(4):
        client.nodes().create(ready_node(f"n{i}"))
    sched = SchedulerServer(
        client, SchedulerServerOptions(algorithm_provider="TPUProvider",
                               device="cpu")
    ).start()
    try:
        for i in range(30):
            client.pods().create(pending_pod(f"pre-{i:03d}"))
        assert wait_until(lambda: n_bound(client) >= 10)
        profile.arm()

        bound_acked = n_bound(client)
        profile.kill_primary()
        profile.wait_failover()

        objs, _ = client.pods().list()
        assert len(objs) == 30, (
            f"survivors lost pods: {len(objs)}/30"
        )
        bound_after = sum(1 for p in objs if p.spec.node_name)
        assert bound_after >= bound_acked, (
            f"survivors lost acknowledged bindings: {bound_after} < "
            f"{bound_acked}"
        )
        # the scheduler finishes the density against the survivors
        # (its reflectors relist through transport failover)
        # the sanitizer witnesses run this suite instrumented (~3x
        # slower), so the drain deadline is generous
        for i in range(10):
            client.pods().create(pending_pod(f"post-{i:02d}"))
        assert wait_until(lambda: n_bound(client) == 40, timeout=120), (
            f"stuck at {n_bound(client)}/40 bound after failover"
        )
    finally:
        sched.stop()
        profile.close()


def test_replicated_store_sync_semantics(tmp_path, ha_profile):
    """Every write acked by the primary is durably replicated BEFORE
    the ack: commit N objects, kill the primary abruptly, and the
    survivors must hold exactly the committed prefix (nothing torn,
    nothing phantom), then accept writes with RV continuity."""
    profile = ha_profile
    urls = profile.start(tmp_path)
    from kubernetes_tpu_torch.client.transport import HTTPTransport

    client = RESTClient(HTTPTransport(urls, timeout=5.0))
    for i in range(50):
        client.pods().create(pending_pod(f"w-{i:03d}"))
    # replication is synchronous with the ack
    profile.assert_acked_replicated("/pods/", 50)
    api2 = profile.promote_now()
    profile.wait_failover()
    c2 = RESTClient(LocalTransport(api2))
    objs, _ = c2.pods().list()
    assert len(objs) == 50
    # and the surviving store accepts writes with RV continuity
    survivor = profile.survivor_store()
    rv_before = survivor.current_rv
    c2.pods().create(pending_pod("post-promote"))
    assert survivor.current_rv > rv_before
    profile.close()


def test_replicated_store_promotion_fences_stale_primary(tmp_path):
    """The fencing regression (quorum terms subsume this; the 2-node
    profile needs it explicitly): a follower promoted while the
    primary is still ALIVE — deemed dead by the monitor, e.g. just
    slow — must fence the old term's writes. A client holding pooled
    connections to the stale primary gets NotPrimary/503 instead of a
    silently-diverging ack, and fails over to the promoted store."""
    from kubernetes_tpu_torch.storage.replicated import (
        FollowerStore,
        NotPrimary,
        ReplicatedStore,
    )

    primary = ReplicatedStore(str(tmp_path / "p"))
    follower = FollowerStore(str(tmp_path / "f"), primary.repl_address)
    assert follower.synced(10)
    api1 = APIServer(store=primary)
    c_stale = RESTClient(LocalTransport(api1))  # the pooled client
    c_stale.pods().create(pending_pod("pre-fence"))

    # promotion fires while the primary is alive and connected
    follower.promote()
    assert wait_until(lambda: primary.fenced, timeout=10), (
        "fence never reached the stale primary")

    # the stale primary rejects every verb of the old term
    with pytest.raises(Exception) as exc:
        primary.create("/pods/default/stale", pending_pod("stale"))
    assert isinstance(exc.value, NotPrimary)
    # ...and the pooled client's write surfaces as a 503, the signal
    # transports use to fail over
    from kubernetes_tpu_torch.client.rest import APIStatusError

    with pytest.raises(APIStatusError) as aerr:
        c_stale.pods().create(pending_pod("stale-via-client"))
    assert aerr.value.code == 503
    # the promoted store is the live half
    api2 = APIServer(store=follower)
    c_new = RESTClient(LocalTransport(api2))
    c_new.pods().create(pending_pod("post-fence"))
    assert len(c_new.pods().list()[0]) == 2  # pre-fence + post-fence
    primary.close()
    follower.close()
