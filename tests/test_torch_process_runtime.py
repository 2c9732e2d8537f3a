"""ProcessRuntime: the kubelet driving real local processes as
containers (the docker_manager.go capability on a sandbox substrate).

What must hold: a bound pod's container is a LIVE process; PLEG notices
real process death; logs are what the process actually wrote; exec runs
real commands; probes and eviction act on the live substrate; /proc
feeds stats.

The cases of tests/test_process_runtime.py, run against the port's copies
(kubernetes_tpu_torch), each with the mark it has there."""

import os
import signal
import time

import pytest

from kubernetes_tpu_torch.api.types import (
    Container,
    ObjectMeta,
    Pod,
    PodSpec,
    Probe,
)
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.rest import RESTClient
from kubernetes_tpu_torch.client.transport import LocalTransport
from kubernetes_tpu_torch.kubelet import Kubelet, KubeletConfig, ProcessRuntime
from kubernetes_tpu_torch.kubelet.process_runtime import ensure_pause


from conftest import wait_until  # noqa: E402


def _probe_proc() -> bool:
    """Restricted sandboxes mount /proc with hidepid (or without per-pid
    stat files); tests asserting on /proc contents then skip with a
    reason instead of failing on an environment gap."""
    import subprocess

    try:
        p = subprocess.Popen(["/bin/sh", "-c", "sleep 2"])
    except OSError:
        return False
    try:
        time.sleep(0.05)
        with open(f"/proc/{p.pid}/cmdline") as f:
            if not f.read():
                return False
        with open(f"/proc/{p.pid}/statm") as f:
            if int(f.read().split()[1]) <= 0:
                return False
        return True
    except (OSError, ValueError, IndexError):
        return False
    finally:
        p.kill()
        p.wait()


_PROC_OK = _probe_proc()
requires_proc = pytest.mark.skipif(
    not _PROC_OK,
    reason="restricted /proc: per-pid stat files unreadable here",
)


@pytest.fixture()
def plane(tmp_path):
    server = APIServer()
    client = RESTClient(LocalTransport(server))
    runtime = ProcessRuntime(root_dir=str(tmp_path / "proc-root"))
    cfg = KubeletConfig(
        node_name="pnode",
        pleg_relist_period=0.05,
        status_sync_period=0.05,
        housekeeping_interval=0.2,
        node_status_update_frequency=0.2,
    )
    kl = Kubelet(client, cfg, runtime).run()
    yield server, client, kl, runtime
    kl.stop()
    runtime.close()


def bound_pod(name, command=None, restart_policy="Always", probe=None):
    return Pod(
        metadata=ObjectMeta(name=name),
        spec=PodSpec(
            node_name="pnode",
            restart_policy=restart_policy,
            containers=[Container(
                name="main",
                image="kubernetes/pause:go",
                command=command or [],
                requests={"cpu": "100m"},
                liveness_probe=probe,
            )],
        ),
    )


def _runtime_pid(runtime, uid, name="main"):
    with runtime._lock:
        pp = runtime._pods.get(uid)
        c = pp.containers.get(name) if pp else None
        return c.proc.pid if c and c.exit_code is None else None


class TestProcessLifecycle:
    @requires_proc
    def test_pause_container_is_a_live_process(self, plane):
        server, client, kl, runtime = plane
        assert ensure_pause() is not None  # cc exists in this image
        client.pods().create(bound_pod("p1"))
        assert wait_until(
            lambda: client.pods().get("p1").status.phase == "Running"
        )
        uid = client.pods().get("p1").metadata.uid
        pid = _runtime_pid(runtime, uid)
        assert pid is not None
        # genuinely alive: /proc agrees and the binary is pause
        assert os.path.exists(f"/proc/{pid}")
        with open(f"/proc/{pid}/cmdline") as f:
            assert "pause" in f.read()

    def test_pleg_notices_real_process_death(self, plane):
        server, client, kl, runtime = plane
        # a short-lived real command: runs, exits 0
        client.pods().create(bound_pod(
            "p2", command=["/bin/sh", "-c", "sleep 30"]))
        assert wait_until(
            lambda: client.pods().get("p2").status.phase == "Running"
        )
        uid = client.pods().get("p2").metadata.uid
        pid = _runtime_pid(runtime, uid)
        os.kill(pid, signal.SIGKILL)  # the process dies OUTSIDE the kubelet
        # PLEG relist sees the death; restartPolicy Always restarts it
        assert wait_until(lambda: (
            _runtime_pid(runtime, uid) is not None
            and _runtime_pid(runtime, uid) != pid
        ))

    def test_run_to_completion_phase_succeeded(self, plane):
        server, client, kl, runtime = plane
        client.pods().create(bound_pod(
            "p3", command=["/bin/sh", "-c", "exit 0"],
            restart_policy="Never"))
        assert wait_until(
            lambda: client.pods().get("p3").status.phase == "Succeeded"
        )

    def test_failure_phase_failed(self, plane):
        server, client, kl, runtime = plane
        client.pods().create(bound_pod(
            "p4", command=["/bin/sh", "-c", "exit 3"],
            restart_policy="Never"))
        assert wait_until(
            lambda: client.pods().get("p4").status.phase == "Failed"
        )

    def test_logs_are_what_the_process_wrote(self, plane):
        server, client, kl, runtime = plane
        client.pods().create(bound_pod(
            "p5", command=["/bin/sh", "-c",
                           "echo hello-from-pod; sleep 30"]))
        assert wait_until(
            lambda: client.pods().get("p5").status.phase == "Running"
        )
        uid = client.pods().get("p5").metadata.uid
        assert wait_until(
            lambda: any("hello-from-pod" in l
                        for l in runtime.get_logs(uid, "main"))
        )

    def test_exec_runs_a_real_command(self, plane):
        server, client, kl, runtime = plane
        client.pods().create(bound_pod("p6"))
        assert wait_until(
            lambda: client.pods().get("p6").status.phase == "Running"
        )
        uid = client.pods().get("p6").metadata.uid
        out = runtime.exec_in(uid, "main", ["/bin/echo", "live-exec"])
        assert out.strip() == "live-exec"

    @requires_proc
    def test_pod_delete_reaps_the_process(self, plane):
        server, client, kl, runtime = plane
        client.pods().create(bound_pod("p7"))
        assert wait_until(
            lambda: client.pods().get("p7").status.phase == "Running"
        )
        uid = client.pods().get("p7").metadata.uid
        pid = _runtime_pid(runtime, uid)
        client.pods().delete("p7")
        assert wait_until(lambda: not os.path.exists(f"/proc/{pid}")
                          or open(f"/proc/{pid}/stat").read().split()[2] == "Z")

    @requires_proc
    def test_proc_stats(self, plane):
        server, client, kl, runtime = plane
        client.pods().create(bound_pod("p8"))
        assert wait_until(
            lambda: client.pods().get("p8").status.phase == "Running"
        )
        uid = client.pods().get("p8").metadata.uid
        stats = runtime.pod_stats(uid)
        assert "main" in stats
        assert stats["main"]["memory_rss_bytes"] > 0
        assert runtime.machine_memory_available() > 0


class TestLivenessOnLiveProcesses:
    def test_liveness_kill_restarts_real_process(self, plane):
        server, client, kl, runtime = plane
        probe = Probe(handler="exec",
                      exec_command=["/bin/sh", "-c", "exit 1"],
                      period_seconds=0.1, failure_threshold=2,
                      initial_delay_seconds=0)
        client.pods().create(bound_pod("p9", probe=probe))
        assert wait_until(
            lambda: client.pods().get("p9").status.phase == "Running"
        )
        uid = client.pods().get("p9").metadata.uid
        first = _runtime_pid(runtime, uid)
        # failing liveness: the kubelet kills and restarts -> new pid
        assert wait_until(lambda: (
            (p := _runtime_pid(runtime, uid)) is not None and p != first
        ))


class TestHardenedNodeAPI:
    """The node API gate (server.go TLS + authn): with a live-process
    runtime, an open /exec is remote code execution — serve HTTPS and
    demand the bearer token."""

    def test_tls_and_token_gate_logs_and_exec(self, tmp_path):
        import subprocess
        import urllib.error
        import urllib.request

        from kubernetes_tpu_torch.kubectl.cmd import Kubectl

        cert, key = tmp_path / "tls.crt", tmp_path / "tls.key"
        subprocess.run(
            ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
             "-keyout", str(key), "-out", str(cert), "-days", "1",
             "-subj", "/CN=127.0.0.1",
             "-addext", "subjectAltName=IP:127.0.0.1"],
            check=True, capture_output=True,
        )
        server = APIServer()
        client = RESTClient(LocalTransport(server))
        runtime = ProcessRuntime(root_dir=str(tmp_path / "rt"))
        kl = Kubelet(client, KubeletConfig(
            node_name="pnode",
            pleg_relist_period=0.05,
            status_sync_period=0.05,
            serve_api=True,
            api_tls_cert=str(cert),
            api_tls_key=str(key),
            api_auth_token="s3cret",
        ), runtime).run()
        try:
            client.pods().create(bound_pod(
                "sec", command=["/bin/sh", "-c",
                                "echo from-secure-pod; sleep 30"]))
            assert wait_until(
                lambda: client.pods().get("sec").status.phase == "Running"
            )
            node = client.nodes().get("pnode")
            assert node.status.kubelet_https
            base = f"https://127.0.0.1:{node.status.kubelet_port}"
            import ssl
            ctx = ssl.create_default_context(cafile=str(cert))
            # no token -> 401 (and the 401 arrives over TLS)
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(
                    f"{base}/pods", timeout=5, context=ctx)
            assert ei.value.code == 401
            # plain http is refused outright
            with pytest.raises(OSError):
                urllib.request.urlopen(
                    f"http://127.0.0.1:{node.status.kubelet_port}/pods",
                    timeout=5)
            # kubectl with credentials: logs + exec reach the live pod
            kc = Kubectl(client, node_token="s3cret",
                         node_tls_ca=str(cert))
            assert wait_until(
                lambda: "from-secure-pod" in kc.logs("sec"))
            assert kc.exec("sec", ["/bin/echo", "exec-ok"]).strip() == \
                "exec-ok"
            # wrong token -> 401 through kubectl too
            bad = Kubectl(client, node_token="wrong",
                          node_tls_ca=str(cert))
            with pytest.raises(urllib.error.HTTPError) as ei:
                bad.logs("sec")
            assert ei.value.code == 401
        finally:
            kl.stop()
            runtime.close()


def test_ensure_pause_rejects_binary_that_cannot_run_here(
        tmp_path, monkeypatch):
    """Regression: a cached/checked-in pause built on a different image
    exec()s but dies in the dynamic loader (GLIBC skew), leaving every
    'running' pod a restart-flapping corpse. ensure_pause must validate
    the cached binary by RUNNING it and rebuild when it doesn't."""
    import shutil

    import kubernetes_tpu_torch.kubelet.process_runtime as pr

    if not (shutil.which("cc") or shutil.which("gcc")):
        pytest.skip("no C compiler in this image")
    src = tmp_path / "pause.c"
    shutil.copy(pr._PAUSE_SRC, src)
    stale = tmp_path / "pause"
    # a stand-in for the loader-failure binary: exec succeeds, process
    # exits immediately — exactly what the GLIBC mismatch looks like
    stale.write_text("#!/bin/sh\nexit 127\n")
    stale.chmod(0o755)
    monkeypatch.setattr(pr, "_PAUSE_SRC", str(src))
    monkeypatch.setattr(pr, "_PAUSE_BIN", str(stale))
    pr._pause_validated.clear()
    try:
        out = pr.ensure_pause()
        assert out == str(stale)
        # the stale script was REPLACED by a real compiled pause...
        with open(out, "rb") as f:
            assert f.read(2) != b"#!", "stale binary was not rebuilt"
        # ...which actually survives the loader on this image
        assert pr._pause_runs_here(out)
    finally:
        pr._pause_validated.clear()
