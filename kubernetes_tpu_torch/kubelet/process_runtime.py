"""ProcessRuntime: containers as real local processes.

Reference: pkg/kubelet/dockertools/docker_manager.go (~10k ln) — the
runtime layer that actually starts containers, with
fake_docker_client.go as its test seam. The sandbox has no container
engine, but a pod's lifecycle substrate here is honest: every container
is a spawned OS process (the pod "infra" default being the compiled
build/pause/pause.c, exactly the reference's pause container), PLEG
observes real pid lifecycle, logs are real files the process writes,
exec runs real commands, stats come from /proc. The kubelet cannot tell
this apart from a container engine — syncPod, probes, eviction and the
node API all act on live processes.

Image handling: there is no registry to pull from, so `image` is
honored as a name only (docker_manager pulls; we map every image to the
pause process unless the container declares an explicit `command` —
which runs verbatim, exec-style, no shell).

Copy of kubernetes_tpu/kubelet/process_runtime.py: only the import package differs.
"""

from __future__ import annotations

import os
import shutil
import signal
import socket
import subprocess
import tempfile
import threading
import time
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.kubelet.runtime import (
    ContainerRuntime,
    RuntimeContainer,
    RuntimePod,
)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_PAUSE_SRC = os.path.join(_REPO_ROOT, "build", "pause", "pause.c")
_PAUSE_BIN = os.path.join(_REPO_ROOT, "build", "pause", "pause")
_pause_lock = threading.Lock()


_pause_validated: Dict[str, bool] = {}  # bin path -> runs on THIS image


def _pause_runs_here(path: str) -> bool:
    """True when the binary actually executes on this image. A cached
    (or checked-in) pause built against a newer libc exec()s but dies in
    the dynamic loader ("GLIBC_x.y not found"), leaving every "running"
    pod a restart-flapping corpse with an empty /proc cmdline — so the
    mtime cache must be validated by running it once per process."""
    cached = _pause_validated.get(path)
    if cached is not None:
        return cached
    ok = False
    try:
        proc = subprocess.Popen(
            [path], stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL
        )
        try:
            # pause blocks forever; surviving the loader for 200ms is
            # the signal (a loader failure exits within milliseconds)
            proc.wait(timeout=0.2)
        except subprocess.TimeoutExpired:
            ok = True
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    except OSError:
        ok = False
    _pause_validated[path] = ok
    return ok


def ensure_pause() -> Optional[str]:
    """Compile build/pause/pause.c on demand (cached by mtime, validated
    by execution) — the one native artifact the reference ships too."""
    with _pause_lock:
        try:
            if (os.path.exists(_PAUSE_BIN) and
                    os.path.getmtime(_PAUSE_BIN) >=
                    os.path.getmtime(_PAUSE_SRC) and
                    _pause_runs_here(_PAUSE_BIN)):
                return _PAUSE_BIN
        except OSError:
            pass
        cc = shutil.which(os.environ.get("CC", "") or "cc") or shutil.which(
            "gcc")
        if cc is None or not os.path.exists(_PAUSE_SRC):
            return None
        tmp = _PAUSE_BIN + ".tmp"
        proc = subprocess.run(
            [cc, "-O2", "-o", tmp, _PAUSE_SRC],
            capture_output=True, timeout=60,
        )
        if proc.returncode != 0:
            return None
        os.replace(tmp, _PAUSE_BIN)
        _pause_validated.pop(_PAUSE_BIN, None)
        if not _pause_runs_here(_PAUSE_BIN):
            return None  # even a fresh build can't run here: fall back
        return _PAUSE_BIN


class _ProcContainer:
    """One live (or exited) container process."""

    def __init__(self, name: str, proc: subprocess.Popen, log_path: str):
        self.name = name
        self.proc = proc
        self.log_path = log_path
        self.exit_code: Optional[int] = None

    @property
    def state(self) -> str:
        return "running" if self.exit_code is None else "exited"

    def reap(self) -> None:
        if self.exit_code is None:
            rc = self.proc.poll()
            if rc is not None:
                self.exit_code = abs(rc)


class _ProcPod:
    def __init__(self, uid: str, namespace: str, name: str, root: str):
        self.uid = uid
        self.namespace = namespace
        self.name = name
        self.root = root
        self.containers: Dict[str, _ProcContainer] = {}


class ProcessRuntime(ContainerRuntime):
    """Containers as processes; /proc as cadvisor."""

    def __init__(self, root_dir: str = ""):
        self.root = root_dir or tempfile.mkdtemp(prefix="kubelet-proc-")
        self._own_root = not root_dir
        self._lock = threading.Lock()
        self._pods: Dict[str, _ProcPod] = {}
        self._log_cv = threading.Condition(self._lock)
        # (pod_uid, port) -> (host, real_port) override for port_socket;
        # absent entries dial 127.0.0.1:port (process listens directly)
        self._ports: Dict[Tuple[str, int], Tuple[str, int]] = {}
        # the kubelet's terminal-container protocol (see FakeRuntime):
        # (pod_uid, container) -> exit code for containers that must
        # STAY down (liveness kill under restartPolicy Never); entries
        # are written and cleared by the kubelet itself
        self.exits_by_pod: Dict[Tuple[str, str], int] = {}
        self.pause = ensure_pause()

    # -- runtime surface ------------------------------------------------------

    def list_pods(self) -> List[RuntimePod]:
        with self._lock:
            out = []
            for p in self._pods.values():
                for c in p.containers.values():
                    c.reap()
                out.append(RuntimePod(
                    p.uid, p.namespace, p.name,
                    [RuntimeContainer(c.name, c.state, c.exit_code or 0)
                     for c in p.containers.values()],
                ))
            return out

    def _command_for(self, c: t.Container) -> List[str]:
        if c.command:
            return list(c.command)
        if self.pause is None:
            # no compiler: a shell sleep stands in for pause
            return ["/bin/sh", "-c", "while true; do sleep 3600; done"]
        return [self.pause]

    def sync_pod(self, pod: t.Pod) -> None:
        """Converge: start wanted containers that aren't running, stop
        ones no longer wanted (docker_manager.go SyncPod's computePodContainerChanges)."""
        uid = pod.metadata.uid
        # (container, exit code to stamp) killed OUTSIDE the lock: a
        # TERM-ignoring process must not stall PLEG/logs/stats for its
        # whole grace period (kill_pod's pattern)
        victims: List[Tuple[_ProcContainer, Optional[int]]] = []
        with self._lock:
            pp = self._pods.get(uid)
            if pp is None:
                root = os.path.join(self.root, uid)
                os.makedirs(root, exist_ok=True)
                pp = _ProcPod(uid, pod.metadata.namespace,
                              pod.metadata.name, root)
                self._pods[uid] = pp
            wanted = {c.name: c for c in pod.spec.containers}
            # stop containers dropped from the spec
            for name in list(pp.containers):
                if name not in wanted:
                    victims.append((pp.containers.pop(name), None))
            policy = pod.spec.restart_policy or "Always"
            for name, spec in wanted.items():
                cur = pp.containers.get(name)
                term = self.exits_by_pod.get((uid, name))
                if cur is not None:
                    cur.reap()
                    if cur.state == "running":
                        if term is not None:
                            # marked terminal while running: take it
                            # down (exit code stamped after the kill)
                            victims.append((cur, term))
                        continue
                    if term is not None:
                        cur.exit_code = term
                        continue  # stays down (kubelet marked terminal)
                    # exited on its own: restart policy decides
                    # (docker_manager.go shouldContainerBeRestarted)
                    if policy == "Never" or (
                        policy == "OnFailure" and cur.exit_code == 0
                    ):
                        continue
                elif term is not None:
                    continue  # never (re)start a terminal container
                log_path = os.path.join(pp.root, f"{name}.log")
                logf = open(log_path, "ab", buffering=0)
                try:
                    proc = subprocess.Popen(
                        self._command_for(spec),
                        cwd=pp.root,
                        stdout=logf,
                        stderr=subprocess.STDOUT,
                        stdin=subprocess.DEVNULL,
                        start_new_session=True,  # its own process group
                    )
                except OSError as e:
                    logf.write(f"start failed: {e}\n".encode())
                    logf.close()
                    raise RuntimeError(
                        f"cannot start container {name!r}: {e}"
                    ) from e
                logf.close()
                pp.containers[name] = _ProcContainer(name, proc, log_path)
            self._log_cv.notify_all()
        for c, stamp in victims:
            self._kill_container(c)
            if stamp is not None:
                c.exit_code = stamp

    @staticmethod
    def _kill_container(c: _ProcContainer, grace: float = 2.0) -> None:
        """TERM the process group, KILL after grace
        (docker KillContainer's gracePeriod)."""
        c.reap()
        if c.exit_code is not None:
            return
        try:
            os.killpg(c.proc.pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            pass
        try:
            c.proc.wait(timeout=grace)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(c.proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
            try:
                c.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                pass
        c.reap()

    def kill_pod(self, uid: str) -> None:
        with self._lock:
            pp = self._pods.pop(uid, None)
            self._log_cv.notify_all()
        if pp is None:
            return
        for c in pp.containers.values():
            self._kill_container(c)
        shutil.rmtree(pp.root, ignore_errors=True)

    def exit_container(self, uid: str, container: str, code: int = 0) -> None:
        """Terminate one container (a failed liveness probe's kill);
        the recorded exit code is what the probe verdict implies, the
        process itself dies by signal. Whether it restarts on the next
        sync is the kubelet's call (exits_by_pod marks terminal)."""
        with self._lock:
            pp = self._pods.get(uid)
            c = pp.containers.get(container) if pp else None
        if c is None:
            return
        self._kill_container(c)
        c.exit_code = code
        with self._log_cv:
            self._log_cv.notify_all()

    # -- node API surface -----------------------------------------------------

    def get_logs(self, uid: str, container: str, tail=None) -> List[str]:
        path = self._log_path(uid, container)
        if path is None or not os.path.exists(path):
            return []
        with open(path, "r", errors="replace") as f:
            lines = f.readlines()
        return lines[-tail:] if tail else lines

    def _log_path(self, uid: str, container: str) -> Optional[str]:
        with self._lock:
            pp = self._pods.get(uid)
            c = pp.containers.get(container) if pp else None
            return c.log_path if c else None

    def exec_probe(self, uid: str, container: str, command) -> bool:
        """ExecAction probe: run the command in the container's context;
        exit 0 == healthy (prober.go runProbe -> ExecInContainer)."""
        with self._lock:
            pp = self._pods.get(uid)
        if pp is None:
            return False
        try:
            proc = subprocess.run(
                list(command), cwd=pp.root, capture_output=True, timeout=10,
            )
        except (OSError, subprocess.TimeoutExpired):
            return False
        return proc.returncode == 0

    def exec_in(self, uid: str, container: str, command) -> str:
        """Run the command in the container's context (its cwd): a real
        subprocess, stdout+stderr combined (ExecInContainer)."""
        with self._lock:
            pp = self._pods.get(uid)
        if pp is None:
            raise KeyError(f"pod {uid!r} not running")
        proc = subprocess.run(
            list(command), cwd=pp.root, capture_output=True,
            timeout=30, text=True,
        )
        return proc.stdout + proc.stderr

    def attach(self, uid: str, container: str):
        """Follow the container's log file from the attachment point,
        ending when the process exits (AttachContainer semantics over
        the log stream)."""
        path = self._log_path(uid, container)
        if path is None:
            return
        with open(path, "r", errors="replace") as f:
            f.seek(0, os.SEEK_END)
            while True:
                chunk = f.read()
                if chunk:
                    yield chunk
                    continue
                with self._lock:
                    pp = self._pods.get(uid)
                    c = pp.containers.get(container) if pp else None
                    if c is None:
                        return
                    c.reap()
                    if c.state != "running":
                        return
                time.sleep(0.1)

    def port_socket(self, uid: str, port: int):
        with self._lock:
            addr = self._ports.get((uid, port), ("127.0.0.1", port))
            if uid not in self._pods:
                raise KeyError(f"pod {uid!r} not running")
        try:
            return socket.create_connection(addr, timeout=10)
        except OSError as e:
            raise KeyError(
                f"pod {uid!r} has nothing listening on {port}: {e}"
            ) from e

    def expose_port(self, uid: str, port: int, host: str,
                    real_port: int) -> None:
        with self._lock:
            self._ports[(uid, port)] = (host, real_port)

    # -- /proc stats (the cadvisor seam) --------------------------------------

    @staticmethod
    def machine_memory_available() -> int:
        """MemAvailable from /proc/meminfo, bytes (cadvisor machine
        info; feeds the eviction manager's signal)."""
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemAvailable:"):
                        return int(line.split()[1]) * 1024
        except OSError:
            pass
        return 1 << 62

    def pod_stats(self, uid: str) -> Dict[str, Dict[str, int]]:
        """Per-container RSS bytes + cumulative CPU jiffies from
        /proc/<pid> — the stats/summary per-pod body."""
        with self._lock:
            pp = self._pods.get(uid)
            pids = {
                c.name: c.proc.pid
                for c in (pp.containers.values() if pp else ())
                if c.exit_code is None
            }
        out: Dict[str, Dict[str, int]] = {}
        for name, pid in pids.items():
            rss = cpu = 0
            try:
                with open(f"/proc/{pid}/statm") as f:
                    rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
                with open(f"/proc/{pid}/stat") as f:
                    parts = f.read().rsplit(") ", 1)[-1].split()
                    cpu = int(parts[11]) + int(parts[12])  # utime+stime
            except (OSError, IndexError, ValueError):
                continue
            out[name] = {"memory_rss_bytes": rss, "cpu_jiffies": cpu}
        return out

    def image_size(self, image: str):
        return None  # no image store: the image manager defaults

    def close(self) -> None:
        with self._lock:
            pods = list(self._pods.values())
            self._pods.clear()
        for pp in pods:
            for c in pp.containers.values():
                self._kill_container(c)
        if self._own_root:
            shutil.rmtree(self.root, ignore_errors=True)
