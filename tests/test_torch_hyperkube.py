"""The port's hyperkube subcommands as real processes on the CPU:
`local-up --device cpu` driven by the port's kubectl, `kubefed join` /
`unjoin` against a `federation-apiserver` process with its controller
manager, the kubelet's refusal to serve /exec on the process runtime
without a token, the KUBERNETES_TPU_PROFILE stack sampler (and its
collision with the scheduler's profile name, copied from the JAX
hyperkube), `local-up` that raises without a card, and every subcommand's
flags against the JAX hyperkube's."""

import json
import re
import signal
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.client.rest import APIStatusError, RESTClient
from kubernetes_tpu_torch.client.transport import HTTPTransport
from kubernetes_tpu_torch.harness.child import (
    HYPERKUBE, URL, Child, child_env, kubectl,
)
from kubernetes_tpu_torch.harness.procs import free_ports
from kubernetes_tpu_torch.utils.wait import poll_until


def wait_until(pred, timeout=20.0) -> bool:
    return poll_until(pred, 0.05, timeout)


@pytest.fixture
def procs():
    """Starts hyperkube subcommands as Child processes, each stopped at
    the test's end."""
    started = []

    def start(args, env=None, cwd=None):
        child = Child.hyperkube(args[0], args, env=env, cwd=cwd)
        started.append(child)
        return child

    yield start
    for child in reversed(started):
        child.stop(timeout=15)


def _url(child) -> str:
    """The first http:// URL the process prints."""
    return child.wait_line(URL, 60).group(0)


def _node(name):
    return t.Node(
        metadata=t.ObjectMeta(name=name,
                              labels={"kubernetes.io/hostname": name}),
        status=t.NodeStatus(
            allocatable={"cpu": "4", "memory": "32Gi", "pods": "110"},
            conditions=[t.NodeCondition("Ready", "True")]))


def _pod(name):
    return t.Pod(
        metadata=t.ObjectMeta(name=name, namespace="default"),
        spec=t.PodSpec(containers=[t.Container(
            name="c", requests={"cpu": "100m", "memory": "500Mi"})]))


def test_local_up_on_the_cpu_serveskubectl(procs):
    """`hyperkube local-up --device cpu --port 0 --nodes 3` prints its
    URL; kubectl lists its 3 hollow nodes Ready and reports the
    scheduler and the controller-manager healthy, and a pod created with
    kubectl is bound by local-up's daemon."""
    lu = procs(["local-up", "--device", "cpu", "--port", "0",
                      "--nodes", "3"])
    url = _url(lu)
    client = RESTClient(HTTPTransport(url, timeout=30.0))

    def ready_nodes():
        items = json.loads(kubectl(url, "get", "nodes", "-o",
                                    "json"))["items"]
        return [n for n in items if any(
            c["type"] == "Ready" and c["status"] == "True"
            for c in n["status"]["conditions"])]

    assert wait_until(lambda: len(ready_nodes()) == 3, 30)
    table = kubectl(url, "get", "nodes")
    assert sorted(re.findall(r"hollow-node-\d+", table)) == [
        "hollow-node-0000", "hollow-node-0001", "hollow-node-0002"]

    def healthy():
        rows = kubectl(url, "get", "componentstatuses").splitlines()
        return {r.split()[0] for r in rows[1:] if r.split()[1] == "Healthy"}

    assert wait_until(lambda: {"scheduler", "controller-manager"}
                      <= healthy(), 30)
    kubectl(url, "run", "web", "--image", "nginx", "--replicas", "2")
    assert wait_until(lambda: (lambda pods: len(pods) == 2 and all(
        p.spec.node_name for p in pods))(client.pods().list()[0]), 60)


def test_kubefed_join_and_unjoin(procs):
    """`kubefed join` registers a member with a `federation-apiserver`
    process, `federation-controller-manager` marks it Ready and
    propagates a federated Service to it, and `kubefed unjoin` removes
    the Cluster and the Service."""
    from kubernetes_tpu_torch import federation  # noqa: F401 (Cluster kind)
    from kubernetes_tpu_torch.apiserver.server import APIServer

    fed_url = _url(procs(["federation-apiserver", "--port", "0"]))
    member = APIServer()
    host, port = member.serve_http(port=0)
    member_url = f"http://{host}:{port}"
    try:
        fed = RESTClient(HTTPTransport(fed_url, timeout=30.0))
        mc = RESTClient(HTTPTransport(member_url, timeout=30.0))
        join = subprocess.run(
            HYPERKUBE + ["kubefed", "join", "east", "--server", fed_url,
                         "--cluster-endpoint", member_url],
            capture_output=True, text=True, env=child_env(), timeout=60)
        assert join.returncode == 0, join.stderr
        assert "cluster 'east' joined" in join.stdout
        assert fed.resource("clusters").get(
            "east").spec.server_address == member_url
        procs(["federation-controller-manager", "--server", fed_url])

        def ready():
            conds = fed.resource("clusters").get("east").status.conditions
            return any(c.type == "Ready" and c.status == "True"
                       for c in conds)

        assert wait_until(ready, 30)
        fed.resource("services", "default").create(t.Service(
            metadata=t.ObjectMeta(name="fed", namespace="default"),
            spec=t.ServiceSpec(selector={"app": "fed"},
                               ports=[t.ServicePort(port=80)])))

        def propagated():
            try:
                mc.resource("services", "default").get("fed")
                return True
            except APIStatusError:
                return False

        assert wait_until(propagated, 30)
        unjoin = subprocess.run(
            HYPERKUBE + ["kubefed", "unjoin", "east", "--server", fed_url],
            capture_output=True, text=True, env=child_env(), timeout=60)
        assert unjoin.returncode == 0, unjoin.stderr
        assert "cluster 'east' unjoined" in unjoin.stdout
        assert fed.resource("clusters").list()[0] == []
        assert not propagated()
    finally:
        member.shutdown_http()


def test_kubelet_refuses_an_open_exec_on_the_process_runtime():
    """`hyperkube kubelet --serve-api` on the process runtime without
    --auth-token exits 2 before it contacts the apiserver."""
    proc = subprocess.run(
        HYPERKUBE + ["kubelet", "--server", "http://127.0.0.1:9",
                     "--node", "n0", "--serve-api"],
        capture_output=True, text=True, env=child_env(), timeout=60)
    assert proc.returncode == 2
    assert "refusing" in proc.stderr and "--auth-token" in proc.stderr


def test_profile_sampler_dumps_its_tally_on_sigterm(procs, tmp_path):
    """KUBERNETES_TPU_PROFILE=<path> arms the stack sampler; SIGTERM
    writes the tally of sampled stacks there and exits 0."""
    dump = tmp_path / "federation.prof"
    proc = procs(["federation-apiserver", "--port", "0"],
                 env=child_env(KUBERNETES_TPU_PROFILE=str(dump)))
    _url(proc)
    time.sleep(0.3)
    assert proc.stop(signal.SIGTERM) == 0
    lines = dump.read_text().splitlines()
    assert lines and all(re.match(r"^\s*\d+  \S+@.+:\d+", ln)
                         for ln in lines)


def _optimizer_waves(metrics_port) -> float:
    text = urllib.request.urlopen(
        f"http://127.0.0.1:{metrics_port}/metrics", timeout=10).read()
    return sum(float(m) for m in re.findall(
        rb"^scheduler_optimizer_waves_total\{[^}]*\} (\S+)$", text, re.M))


@pytest.mark.parametrize("value", ["optimizing", "sched.prof"])
def test_profile_variable_is_both_the_profile_and_the_dump(procs, tmp_path,
                                                           value):
    """As in the JAX hyperkube, KUBERNETES_TPU_PROFILE is read twice by
    `hyperkube scheduler`: as the scheduler's profile name and as the
    sampler's dump path. `optimizing` runs the optimizing profile and
    SIGTERM writes a file named `optimizing` into the working directory;
    a path makes the scheduler warn and run greedy, and the dump lands
    at the path."""
    api = procs(["apiserver", "--port", "0"])
    url = _url(api)
    client = RESTClient(HTTPTransport(url, timeout=30.0))
    assert wait_until(client.healthz, 15)
    for i in range(2):
        client.nodes().create(_node(f"n{i}"))
    mport = free_ports(1)[0]
    sched = procs(
        ["scheduler", "--master", url, "--device", "cpu", "--serve-port",
         str(mport)], env=child_env(KUBERNETES_TPU_PROFILE=value),
        cwd=str(tmp_path))
    sched.wait_line(r"^kube-scheduler running")
    for i in range(4):
        client.pods().create(_pod(f"p{i}"))
    assert wait_until(lambda: all(
        p.spec.node_name for p in client.pods().list()[0]), 60)
    waves = _optimizer_waves(mport)
    assert sched.stop(signal.SIGTERM) == 0
    err = sched.output()
    dump = tmp_path / value
    assert dump.exists() and dump.read_text().strip()
    if value == "optimizing":
        assert waves > 0
        assert "unknown KUBERNETES_TPU_PROFILE" not in err
    else:
        assert waves == 0
        assert "unknown KUBERNETES_TPU_PROFILE='sched.prof'" in err


def test_local_up_without_a_card_exits_with_the_device_error():
    """`hyperkube local-up` on the default device, on a machine without
    a card, exits non-zero with the daemon's device error instead of
    serving hollow nodes with no scheduler."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    proc = subprocess.run(
        HYPERKUBE + ["local-up", "--port", "0", "--nodes", "2"],
        capture_output=True, text=True, env=child_env(), timeout=120)
    assert proc.returncode != 0
    assert "scheduler: cannot initialize device 'cuda'" in proc.stderr
    assert "local cluster up" not in proc.stdout


def _flags(main, argv, capsys):
    with pytest.raises(SystemExit) as ei:
        main(argv + ["--help"])
    assert ei.value.code == 0
    return set(re.findall(r"(?<![\w-])--?[a-zA-Z][\w-]*",
                          capsys.readouterr().out))


@pytest.mark.parametrize("sub", [
    "apiserver", "scheduler", "controller-manager", "kubelet", "extender",
    "proxy", "federation-apiserver", "federation-controller-manager",
    "kubefed", "local-up"])
def test_subcommand_flags_match_the_jax_hyperkube(sub, capsys):
    """Every subcommand takes the JAX hyperkube's flags letter for
    letter; the port adds only --device (and --master, the scheduler's
    --server) where the daemon or the extender runs on a torch device."""
    from kubernetes_tpu.hyperkube import main as jax_main

    from kubernetes_tpu_torch.hyperkube import main as port_main

    port = _flags(port_main, [sub], capsys)
    ref = _flags(jax_main, [sub], capsys)
    extra = {"scheduler": {"--device", "--master"},
             "extender": {"--device"}, "local-up": {"--device"}}
    assert port - ref == extra.get(sub, set())
    assert ref <= port


def test_thread_census_counts_the_threads_it_starts():
    """`python -m kubernetes_tpu_torch.harness.thread_census limit`
    prints its count every 100 threads, each line flushed, and the count
    it reached."""
    proc = subprocess.run(
        [sys.executable, "-m", "kubernetes_tpu_torch.harness.thread_census",
         "limit", "--max", "300", "--stack", "262144"],
        capture_output=True, text=True, env=child_env(), timeout=60)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert [ln.split()[1] for ln in lines[:3]] == [
        "threads=100", "threads=200", "threads=300"]
    assert lines[-1] == "stack=262144 reached 300"
