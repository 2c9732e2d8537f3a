"""The port's scheduler daemon against the port's own control plane, on
the CPU: the counterparts of tests/test_scheduler_shell.py TestEndToEnd,
TestSchedulerExtender and TestUnschedulableNodesIntegration and of
tests/test_gang.py TestPodGroupAPI and TestGangEndToEnd, run with the
port's device providers on device="cpu"; the scheduler_perf harness in
both modes; `hyperkube apiserver` + `hyperkube scheduler` as processes;
and the daemon that never schedules on the CPU by accident (a card that
is missing, a kernel build that fails)."""

import http.server
import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.api.types import (
    POD_GROUP_LABEL,
    Container,
    ObjectMeta,
    Pod,
    PodGroup,
    PodGroupSpec,
    PodSpec,
    PriorityClass,
)
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client import LocalTransport, RESTClient
from kubernetes_tpu_torch.client.rest import APIStatusError
from kubernetes_tpu_torch.harness import perf
from kubernetes_tpu_torch.native import build as B
from kubernetes_tpu_torch.ops import probe_kernel
from kubernetes_tpu_torch.scheduler.algorithm import TorchScheduleAlgorithm
from kubernetes_tpu_torch.scheduler.server import (
    SchedulerServer,
    SchedulerServerOptions,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def wait_until(pred, timeout=20.0, interval=0.05) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return bool(pred())


def options(**kw):
    """The daemon's options on the CPU, the port's device provider unless
    kw names another."""
    kw.setdefault("algorithm_provider", "CUDAProvider")
    return SchedulerServerOptions(device="cpu", **kw)


def pod(name, ns="default", node="", cpu="100m", mem="500Mi",
        annotations=None):
    return t.Pod(
        metadata=t.ObjectMeta(name=name, namespace=ns,
                              annotations=annotations or {}),
        spec=t.PodSpec(node_name=node, containers=[
            t.Container(name="c", requests={"cpu": cpu, "memory": mem})]),
    )


def node(name, cpu="4", mem="32Gi", pods="110"):
    return t.Node(
        metadata=t.ObjectMeta(name=name,
                              labels={"kubernetes.io/hostname": name}),
        status=t.NodeStatus(
            allocatable={"cpu": cpu, "memory": mem, "pods": pods},
            conditions=[t.NodeCondition("Ready", "True")],
        ),
    )


def make_control_plane():
    server = APIServer()
    client = RESTClient(LocalTransport(server))
    return server, client


@pytest.fixture(autouse=True)
def no_thread_left_behind():
    """A stopped daemon leaves no live non-daemon thread (one would stall
    the interpreter's exit, and a test worker with it)."""
    before = set(threading.enumerate())
    yield
    assert wait_until(lambda: not [
        th for th in threading.enumerate()
        if not th.daemon and th not in before], 10), [
        th.name for th in threading.enumerate()
        if not th.daemon and th not in before]


# -- tests/test_scheduler_shell.py TestEndToEnd ------------------------------


class TestEndToEnd:
    def _run(self, opts, n_nodes=3, n_pods=6):
        server, client = make_control_plane()
        for i in range(n_nodes):
            client.nodes().create(node(f"n{i}"))
        srv = SchedulerServer(client, opts).start()
        try:
            for i in range(n_pods):
                client.pods().create(pod(f"p{i}"))
            assert wait_until(lambda: all(
                p.spec.node_name for p in client.pods().list()[0])), [
                (p.metadata.name, p.spec.node_name)
                for p in client.pods().list()[0]]
            return client
        finally:
            srv.stop()

    @pytest.mark.parametrize("provider", ["CUDAProvider", "DefaultProvider"])
    def test_default_provider_schedules_all(self, provider):
        client = self._run(options(algorithm_provider=provider))
        pods, _ = client.pods().list()
        hosts = sorted(p.spec.node_name for p in pods)
        # spreading: 6 pods over 3 identical nodes -> 2 each
        assert [hosts.count(f"n{i}") for i in range(3)] == [2, 2, 2]
        # PodScheduled condition set by the bind subresource
        assert all(any(c.type == "PodScheduled" and c.status == "True"
                       for c in p.status.conditions) for p in pods)

    def test_unschedulable_pod_gets_condition_and_event(self):
        _, client = make_control_plane()
        client.nodes().create(node("n0", cpu="1"))
        srv = SchedulerServer(client, options()).start()
        try:
            client.pods().create(pod("big", cpu="64"))
            assert wait_until(lambda: any(
                c.type == "PodScheduled" and c.status == "False"
                and c.reason == "Unschedulable"
                for c in client.pods().get("big").status.conditions))
            assert wait_until(lambda: any(
                e.reason == "FailedScheduling"
                for e in client.events().list()[0]))
        finally:
            srv.stop()

    def test_multi_scheduler_annotation(self):
        _, client = make_control_plane()
        client.nodes().create(node("n0"))
        srv = SchedulerServer(client, options()).start()
        try:
            client.pods().create(pod("mine"))
            client.pods().create(pod("other", annotations={
                "scheduler.alpha.kubernetes.io/name": "custom-scheduler"}))
            assert wait_until(
                lambda: client.pods().get("mine").spec.node_name == "n0")
            time.sleep(0.3)
            assert client.pods().get("other").spec.node_name == ""
        finally:
            srv.stop()

    def test_tpu_provider_end_to_end(self):
        """The device provider under the JAX package's name takes the
        same factory as CUDAProvider."""
        client = self._run(options(algorithm_provider="TPUProvider"),
                           n_nodes=2, n_pods=4)
        hosts = sorted(p.spec.node_name for p in client.pods().list()[0])
        assert [hosts.count(f"n{i}") for i in range(2)] == [2, 2]

    def test_leader_election_gates_scheduling(self):
        _, client = make_control_plane()
        client.nodes().create(node("n0"))
        srv = SchedulerServer(client, options(
            leader_elect=True, leader_elect_identity="s1")).start()
        try:
            assert wait_until(srv.is_leader)
            client.pods().create(pod("p"))
            assert wait_until(
                lambda: client.pods().get("p").spec.node_name == "n0")
        finally:
            srv.stop()

    def test_waves_take_the_incremental_view(self):
        """Through the provider registry the daemon's algorithm is wired
        to the factory's scheduler cache: its waves come from wave_view."""
        _, client = make_control_plane()
        for i in range(4):
            client.nodes().create(node(f"n{i}"))
        srv = SchedulerServer(client, options()).start()
        try:
            assert wait_until(srv.ready.is_set)
            algo = srv.scheduler.config.algorithm
            assert isinstance(algo, TorchScheduleAlgorithm)
            assert algo._inc is not None
            for i in range(12):
                client.pods().create(pod(f"p{i}"))
            assert wait_until(lambda: all(
                p.spec.node_name for p in client.pods().list()[0]))
            assert algo._wave.stats["waves"] >= 1
            assert algo._wave._dev_source == algo._inc.source_token
        finally:
            srv.stop()


# -- TestSchedulerExtender and TestUnschedulableNodesIntegration --------------


class TestSchedulerExtender:
    """test/integration/extender_test.go:187 TestSchedulerExtender: fake
    HTTP extenders participate in filtering and prioritization."""

    def test_extender_filter_and_prioritize(self, tmp_path):
        calls = {"filter": 0, "prioritize": 0}

        class Ext(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                body = json.loads(
                    self.rfile.read(int(self.headers["Content-Length"])))
                if self.path.endswith("/filter"):
                    calls["filter"] += 1
                    items = [n for n in body["nodes"]["items"]
                             if n["metadata"]["name"] != "n0"]
                    resp = {"nodes": {"kind": "NodeList", "items": items},
                            "failedNodes": {"n0": "extender says no"}}
                else:
                    calls["prioritize"] += 1
                    resp = [{"host": n["metadata"]["name"],
                             "score": 100 if n["metadata"]["name"] == "n2"
                             else 0} for n in body["nodes"]["items"]]
                data = json.dumps(resp).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Ext)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            _, client = make_control_plane()
            for i in range(3):
                client.nodes().create(node(f"n{i}"))
            path = tmp_path / "policy.json"
            path.write_text(json.dumps({
                "kind": "Policy",
                "predicates": [{"name": "GeneralPredicates"}],
                "priorities": [{"name": "EqualPriority", "weight": 1}],
                "extenders": [{
                    "urlPrefix":
                        f"http://127.0.0.1:{httpd.server_port}/api",
                    "apiVersion": "v1beta1",
                    "filterVerb": "filter",
                    "prioritizeVerb": "prioritize",
                    "weight": 10,
                }],
            }))
            srv = SchedulerServer(client, options(
                policy_config_file=str(path))).start()
            try:
                client.pods().create(pod("p"))
                assert wait_until(
                    lambda: client.pods().get("p").spec.node_name == "n2")
                assert calls["filter"] >= 1 and calls["prioritize"] >= 1
            finally:
                srv.stop()
        finally:
            httpd.shutdown()
            httpd.server_close()


class TestUnschedulableNodesIntegration:
    """test/integration/scheduler_test.go:54 TestUnschedulableNodes: the
    scheduler reacts to node schedulability transitions."""

    def test_unschedulable_spec_flag(self):
        _, client = make_control_plane()
        n = node("n0")
        n.spec = t.NodeSpec(unschedulable=True)
        client.nodes().create(n)
        srv = SchedulerServer(client, options()).start()
        try:
            client.pods().create(pod("p"))
            time.sleep(0.4)
            assert client.pods().get("p").spec.node_name == ""
            # flip to schedulable; the failed pod re-queues via backoff
            fresh = client.nodes().get("n0")
            fresh.spec.unschedulable = False
            client.nodes().update(fresh)
            assert wait_until(
                lambda: client.pods().get("p").spec.node_name == "n0",
                timeout=15)
        finally:
            srv.stop()


# -- tests/test_gang.py TestPodGroupAPI and TestGangEndToEnd ------------------


def gang_pod(name, cpu="500m", group=None):
    labels = {"app": "x"}
    if group:
        labels = {POD_GROUP_LABEL: group, "app": group}
    return Pod(metadata=ObjectMeta(name=name, labels=labels),
               spec=PodSpec(containers=[
                   Container(image="t", requests={"cpu": cpu})]))


class TestPodGroupAPI:
    def test_crud_and_validation(self):
        _, client = make_control_plane()
        rc = client.resource("podgroups", "default")
        rc.create(PodGroup(metadata=ObjectMeta(name="g1"),
                           spec=PodGroupSpec(min_member=4,
                                             quota={"pods": "8"})))
        got = rc.get("g1")
        assert got.spec.min_member == 4
        assert got.status.phase == "Pending"
        with pytest.raises(APIStatusError) as ei:
            rc.create(PodGroup(metadata=ObjectMeta(name="bad"),
                               spec=PodGroupSpec(min_member=0)))
        assert ei.value.code == 422
        with pytest.raises(APIStatusError) as ei:
            rc.create(PodGroup(metadata=ObjectMeta(name="bad2"),
                               spec=PodGroupSpec(quota={"gpus": "1"})))
        assert "unknown budget" in str(ei.value)

    def test_priority_class_resolved_at_admission(self):
        _, client = make_control_plane()
        client.resource("priorityclasses").create(PriorityClass(
            metadata=ObjectMeta(name="training-high"), value=1000))
        rc = client.resource("podgroups", "default")
        rc.create(PodGroup(metadata=ObjectMeta(name="g1"), spec=PodGroupSpec(
            priority_class_name="training-high")))
        assert rc.get("g1").spec.priority == 1000
        with pytest.raises(APIStatusError) as ei:
            rc.create(PodGroup(metadata=ObjectMeta(name="g2"),
                               spec=PodGroupSpec(priority_class_name="nope")))
        assert ei.value.code == 403
        assert "unknown priority class" in str(ei.value)

    def test_pod_quota_denied_403_and_released_on_delete(self):
        from kubernetes_tpu_torch.metrics import apiserver_quota_denials_total

        _, client = make_control_plane()
        client.resource("podgroups", "default").create(PodGroup(
            metadata=ObjectMeta(name="g1"),
            spec=PodGroupSpec(quota={"pods": "2"})))
        client.pods().create(gang_pod("p0", group="g1"))
        client.pods().create(gang_pod("p1", group="g1"))
        before = apiserver_quota_denials_total.get(budget="pods")
        with pytest.raises(APIStatusError) as ei:
            client.pods().create(gang_pod("p2", group="g1"))
        assert ei.value.code == 403
        assert "exceeded quota: pods=2" in str(ei.value)
        assert "in use: 2" in str(ei.value)
        assert apiserver_quota_denials_total.get(budget="pods") == before + 1
        # delete releases usage (computed from live store state)
        client.pods().delete("p0")
        client.pods().create(gang_pod("p2", group="g1"))

    def test_device_quota(self):
        _, client = make_control_plane()
        client.resource("podgroups", "default").create(PodGroup(
            metadata=ObjectMeta(name="g1"),
            spec=PodGroupSpec(quota={"devices": "2"})))

        def gpu_pod(name, n):
            return Pod(
                metadata=ObjectMeta(name=name,
                                    labels={POD_GROUP_LABEL: "g1"}),
                spec=PodSpec(containers=[Container(image="t", requests={
                    "cpu": "100m",
                    "alpha.kubernetes.io/nvidia-gpu": str(n)})]))

        client.pods().create(gpu_pod("d0", 2))
        with pytest.raises(APIStatusError) as ei:
            client.pods().create(gpu_pod("d1", 1))
        assert ei.value.code == 403 and "devices=2" in str(ei.value)

    def test_pod_without_group_object_denied(self):
        _, client = make_control_plane()
        with pytest.raises(APIStatusError) as ei:
            client.pods().create(gang_pod("orphan", group="ghost"))
        assert ei.value.code == 403
        assert "does not exist" in str(ei.value)

    def test_status_subresource_patch_reads_back(self):
        """The status a director PATCHes reads back whole (the JAX test
        reads it through kubectl get/describe, which the port does not
        have yet: ROADMAP.md queue 1 item 4)."""
        _, client = make_control_plane()
        rc = client.resource("podgroups", "default")
        rc.create(PodGroup(metadata=ObjectMeta(name="train"),
                           spec=PodGroupSpec(min_member=8, priority=100,
                                             quota={"pods": "16"})))
        rc.patch("train", {"status": {
            "phase": "Parked", "scheduled": 0, "members": 8,
            "unschedulable": ["train-3", "train-7"],
            "message": "gang parked: 2 of 8 members unschedulable "
                       "(insufficient resources); no partial binds"}},
            subresource="status")
        got = rc.get("train")
        assert got.status.phase == "Parked" and got.status.members == 8
        assert got.status.unschedulable == ["train-3", "train-7"]
        assert "insufficient resources" in got.status.message
        assert got.spec.min_member == 8 and got.spec.priority == 100


class TestGangEndToEnd:
    def test_gang_lifecycle_with_device_daemon(self):
        """One live control plane covers: atomic gang bind, minMember parking
        with a readable status, and priority preemption unparking a
        high-priority gang (the JAX test's kubectl describe is left
        out: ROADMAP.md queue 1 item 4)."""
        from kubernetes_tpu_torch.metrics import (
            scheduler_preemption_victims_total,
        )

        _, client = make_control_plane()
        for i in range(2):
            client.nodes().create(node(f"n{i}", cpu="2", pods="8"))
        pgr = client.resource("podgroups", "default")
        pgr.create(PodGroup(metadata=ObjectMeta(name="fit"),
                            spec=PodGroupSpec(min_member=4)))
        pgr.create(PodGroup(metadata=ObjectMeta(name="waiting"),
                            spec=PodGroupSpec(min_member=3)))
        client.resource("priorityclasses").create(PriorityClass(
            metadata=ObjectMeta(name="urgent"), value=100))
        pgr.create(PodGroup(metadata=ObjectMeta(name="burst"),
                            spec=PodGroupSpec(min_member=2,
                                              priority_class_name="urgent")))
        victims_before = scheduler_preemption_victims_total.total()
        srv = SchedulerServer(client, options()).start()
        try:
            # 1) a fitting gang binds atomically
            for i in range(4):
                client.pods().create(gang_pod(f"fit-{i}", cpu="400m",
                                              group="fit"))
            assert wait_until(lambda: all(
                p.spec.node_name for p in
                client.pods().list(label_selector="app=fit")[0]), 30)
            assert wait_until(
                lambda: pgr.get("fit").status.phase == "Scheduled", 10)
            # 2) a minMember-short gang parks with a readable status
            client.pods().create(gang_pod("waiting-0", cpu="100m",
                                          group="waiting"))
            assert wait_until(
                lambda: pgr.get("waiting").status.phase == "Parked", 20)
            assert "minMember 3" in pgr.get("waiting").status.message
            assert client.pods().get("waiting-0").spec.node_name == ""
            # 3) fill the cluster with low-priority pods, then a
            # priority gang preempts its way in
            filler = [f"filler-{i}" for i in range(2)]
            for name in filler:
                client.pods().create(gang_pod(name, cpu="1200m"))
            assert wait_until(lambda: all(
                client.pods().get(n).spec.node_name for n in filler), 20)
            for i in range(2):
                client.pods().create(gang_pod(f"burst-{i}", cpu="1200m",
                                              group="burst"))
            # the fillers (priority 0) are evicted for the gang
            assert wait_until(lambda: not any(
                p.metadata.name in filler
                for p in client.pods().list()[0]), 30), \
                "low-priority fillers were not preempted"
            assert wait_until(lambda: all(
                p.spec.node_name for p in
                client.pods().list(label_selector="app=burst")[0]), 30), \
                "priority gang never bound after preemption"
            assert (scheduler_preemption_victims_total.total()
                    - victims_before) >= 2
        finally:
            srv.stop()


# -- the scheduler_perf harness ----------------------------------------------


def test_schedule_pods_in_process():
    """harness.perf.schedule_pods through the port's apiserver on the
    CPU: every pod bound, 10 a node, read back in the after hook."""
    seen = {}

    def after(sched, client):
        pods = client.pods().list()[0]
        seen["bound"] = sum(bool(p.spec.node_name) for p in pods)
        hosts = [p.spec.node_name for p in pods]
        seen["per_node"] = {hosts.count(h) for h in set(hosts)}
        seen["algorithm"] = sched.scheduler.config.algorithm

    stats = perf.schedule_pods(50, 500, device="cpu", out=open(os.devnull,
                                                               "w"),
                               after=after)
    assert seen["bound"] == 500 and seen["per_node"] == {10}
    assert isinstance(seen["algorithm"], TorchScheduleAlgorithm)
    assert stats["pods_per_sec"] > 0 and stats["sustained_pods_per_sec"] > 0
    assert stats["pipeline_seconds"] >= stats["creation_seconds"] > 0


def test_schedule_pods_separate_processes():
    """harness.perf.schedule_pods_separate: the port's apiserver and pod
    creator in their own interpreters over the binary wire (localhost
    sockets), the daemon here on the CPU."""
    seen = {}

    def after(sched, client):
        pods = client.pods().list()[0]
        seen["bound"] = sum(bool(p.spec.node_name) for p in pods)

    stats = perf.schedule_pods_separate(
        20, 200, device="cpu", out=open(os.devnull, "w"), after=after)
    assert seen["bound"] == 200
    assert stats["batch_objects"] >= 200 and stats["apiserver_requests"] > 0


def test_hyperkube_apiserver_and_scheduler_processes():
    """`hyperkube apiserver --port 0` and `hyperkube scheduler --master
    URL --device cpu`, each its own process: pods created over HTTP are
    bound by the scheduler process."""
    from kubernetes_tpu_torch.client.transport import HTTPTransport

    env = perf._child_env()
    api = subprocess.Popen(
        [sys.executable, "-m", "kubernetes_tpu_torch.hyperkube", "apiserver",
         "--port", "0"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, env=env)
    sched = None
    try:
        url = api.stdout.readline().strip().rsplit(" ", 1)[-1]
        assert url.startswith("http://"), url
        client = RESTClient(HTTPTransport(url, timeout=30.0))
        assert wait_until(client.healthz, 15)
        for i in range(2):
            client.nodes().create(node(f"n{i}"))
        sched = subprocess.Popen(
            [sys.executable, "-m", "kubernetes_tpu_torch.hyperkube",
             "scheduler", "--master", url, "--device", "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            env=env)
        assert sched.stdout.readline().startswith("kube-scheduler running")
        for i in range(4):
            client.pods().create(pod(f"p{i}"))
        assert wait_until(lambda: all(
            p.spec.node_name for p in client.pods().list()[0]), 60)
        hosts = sorted(p.spec.node_name for p in client.pods().list()[0])
        assert hosts == ["n0", "n0", "n1", "n1"]
    finally:
        for proc in (sched, api):
            if proc is not None:
                proc.terminate()
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                proc.stdout.close()


# -- no silent CPU -------------------------------------------------------------


def test_daemon_on_a_missing_card_raises():
    """SchedulerServer(device="cuda") on a machine without a card raises
    from start(), before it starts an informer, a mux or a loop."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    _, client = make_control_plane()
    client.nodes().create(node("n0"))
    srv = SchedulerServer(client, SchedulerServerOptions())
    assert srv.options.device == "cuda"
    with pytest.raises(RuntimeError, match="cannot initialize device"):
        srv.start()
    assert srv.factory is None and srv.scheduler is None
    assert srv._health_server is None and not srv.ready.is_set()


def failing_build(monkeypatch):
    """The daemon's algorithm warms up as if on the card, where warmup
    builds K1 first, and nvcc fails."""
    def no_nvcc(stem):
        raise RuntimeError(f"nvcc failed on {stem}")

    monkeypatch.setattr(B, "build_cuda", no_nvcc)
    monkeypatch.setattr(probe_kernel, "_LIB", None)
    warmup = TorchScheduleAlgorithm.warmup

    def on_the_card(self, num_nodes, phase="all"):
        self.device = torch.device("cuda")
        return warmup(self, num_nodes, phase)

    monkeypatch.setattr(TorchScheduleAlgorithm, "warmup", on_the_card)


@pytest.mark.parametrize("backlog", [False, True],
                         ids=["idle", "backlog_waiting"])
def test_failed_kernel_build_keeps_the_loop_closed(monkeypatch, backlog):
    """A warmup whose kernel build raises leaves the daemon's loop closed
    (no pod is scheduled, on the CPU or anywhere), with or without a
    backlog waiting at start, and the harness's wait raises with it."""
    failing_build(monkeypatch)
    _, client = make_control_plane()
    client.nodes().create(node("n0"))
    if backlog:
        client.pods().create(pod("early"))
    srv = SchedulerServer(client, options()).start()
    try:
        with pytest.raises(RuntimeError, match="warmup failed") as ei:
            perf._wait_sched_ready(srv, open(os.devnull, "w"), timeout=30)
        assert "nvcc failed on probe_kernel" in str(ei.value.__cause__)
        client.pods().create(pod("late"))
        time.sleep(0.3)
        assert not srv.ready.is_set() and srv._thread is None
        assert all(not p.spec.node_name for p in client.pods().list()[0])
    finally:
        srv.stop()


def test_harness_raises_when_the_warmup_fails(monkeypatch):
    failing_build(monkeypatch)
    with pytest.raises(RuntimeError, match="warmup failed"):
        perf.schedule_pods(4, 8, device="cpu", out=open(os.devnull, "w"))
