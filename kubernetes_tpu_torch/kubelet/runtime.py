"""Container runtime interface + fake (pkg/kubelet/container Runtime,
pkg/kubelet/dockertools/fake_docker_client.go).

The fake tracks desired pods as instantly-running containers, supports
injected failures, and records a call log — the seams the reference's
kubelet unit tests and kubemark hollow nodes rely on.

Copy of kubernetes_tpu/kubelet/runtime.py: only the import package differs."""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api import types as t


@dataclass
class RuntimeContainer:
    name: str
    state: str = "running"  # running | exited
    exit_code: int = 0


@dataclass
class RuntimePod:
    """What the runtime believes is on the machine (container.Pod)."""

    uid: str
    namespace: str
    name: str
    containers: List[RuntimeContainer] = field(default_factory=list)


class ContainerRuntime:
    """The syncPod-facing surface (kubelet/container/runtime.go)."""

    def list_pods(self) -> List[RuntimePod]:
        raise NotImplementedError

    def sync_pod(self, pod: t.Pod) -> None:
        """Converge the machine to the pod spec (docker_manager.go SyncPod)."""
        raise NotImplementedError

    def kill_pod(self, uid: str) -> None:
        raise NotImplementedError

    def get_logs(self, uid: str, container: str, tail=None) -> List[str]:
        """Container log lines (GetContainerLogs)."""
        raise NotImplementedError

    def exec_in(self, uid: str, container: str, command) -> str:
        """Run a command in the container (ExecInContainer)."""
        raise NotImplementedError

    def attach(self, uid: str, container: str):
        """Attach to a running container: an iterator of output chunks
        that yields what the container writes AFTER attachment, ending
        when the container stops (AttachContainer)."""
        raise NotImplementedError

    def port_socket(self, uid: str, port: int):
        """A connected socket to the pod's port (the PortForward
        target). Raises KeyError if nothing listens there."""
        raise NotImplementedError


class FakeRuntime(ContainerRuntime):
    def __init__(self):
        self._lock = threading.Lock()
        self._pods: Dict[str, RuntimePod] = {}
        self.calls: List[Tuple[str, str]] = []
        # injectable behavior
        self.fail_sync: bool = False
        # container name -> exit code: syncs mark it exited (a completed
        # or crashed container, driving phase Succeeded/Failed)
        self.exits: Dict[str, int] = {}
        # (pod_uid, container) -> exit code: per-pod terminal containers
        # (a liveness kill under restartPolicy Never stays down)
        self.exits_by_pod: Dict[Tuple[str, str], int] = {}
        # node-API seams: recorded log lines and injectable exec replies
        self._logs: Dict[Tuple[str, str], List[str]] = {}
        self.exec_replies: Dict[Tuple[str, str], str] = {}
        # attach followers: write_log wakes them (kubelet /attach seam)
        self._log_cv = threading.Condition(self._lock)
        # injectable image sizes for the image manager (docker images
        # inspect seam); absent names get the manager's default sizing
        self.image_sizes: Dict[str, int] = {}
        # (pod_uid, port) -> (host, real_port): where port_socket dials
        # (the hollow-node stand-in for a container's listening socket)
        self._ports: Dict[Tuple[str, int], Tuple[str, int]] = {}

    def list_pods(self) -> List[RuntimePod]:
        with self._lock:
            return [
                RuntimePod(p.uid, p.namespace, p.name, list(p.containers))
                for p in self._pods.values()
            ]

    def sync_pod(self, pod: t.Pod) -> None:
        with self._lock:
            self.calls.append(("sync", pod.metadata.uid))
            if self.fail_sync:
                raise RuntimeError("injected sync failure")
            containers = []
            for c in pod.spec.containers:
                ec = self.exits.get(c.name)
                if ec is None:
                    ec = self.exits_by_pod.get((pod.metadata.uid, c.name))
                containers.append(
                    RuntimeContainer(
                        name=c.name,
                        state="exited" if ec is not None else "running",
                        exit_code=ec or 0,
                    )
                )
            self._pods[pod.metadata.uid] = RuntimePod(
                uid=pod.metadata.uid,
                namespace=pod.metadata.namespace,
                name=pod.metadata.name,
                containers=containers,
            )

    def kill_pod(self, uid: str) -> None:
        with self._lock:
            self.calls.append(("kill", uid))
            self._pods.pop(uid, None)
            self._log_cv.notify_all()  # wake attach followers to exit

    def get_logs(self, uid: str, container: str, tail=None) -> List[str]:
        with self._lock:
            lines = list(self._logs.get((uid, container), []))
        return lines[-tail:] if tail else lines

    def exec_in(self, uid: str, container: str, command) -> str:
        with self._lock:
            self.calls.append(("exec", uid))
            reply = self.exec_replies.get((uid, container))
        if reply is not None:
            return reply
        return " ".join(command) + "\n"  # echo shape (fake shell)

    def attach(self, uid: str, container: str):
        """Follow the container's output from the point of attachment:
        yields chunks as write_log appends them; ends when the pod is
        killed or the container exits."""
        with self._lock:
            start = len(self._logs.get((uid, container), []))

        def _running() -> bool:
            p = self._pods.get(uid)
            if p is None:
                return False
            c = next((c for c in p.containers if c.name == container), None)
            return c is not None and c.state == "running"

        idx = start
        while True:
            chunk = None
            with self._log_cv:
                lines = self._logs.get((uid, container), [])
                if idx < len(lines):
                    chunk = "".join(lines[idx:])
                    idx = len(lines)
                elif not _running():
                    return
                else:
                    self._log_cv.wait(timeout=0.2)
            if chunk is not None:
                # yield OUTSIDE the lock: the consumer writes this chunk
                # to a client socket, and a slow client must not stall
                # the whole runtime (PLEG, status sync, kills)
                yield chunk

    def port_socket(self, uid: str, port: int):
        import socket

        with self._lock:
            addr = self._ports.get((uid, port))
        if addr is None:
            raise KeyError(f"pod {uid!r} has nothing listening on {port}")
        return socket.create_connection(addr, timeout=10)

    # test helpers -----------------------------------------------------------

    def write_log(self, uid: str, container: str, line: str) -> None:
        """Append a container log line (the hollow-node seam for logs)."""
        with self._log_cv:
            self._logs.setdefault((uid, container), []).append(
                line if line.endswith("\n") else line + "\n"
            )
            self._log_cv.notify_all()

    def image_size(self, image: str):
        """Injected size, or None to let the image manager default."""
        return self.image_sizes.get(image)

    def expose_port(self, uid: str, port: int, host: str,
                    real_port: int) -> None:
        """Declare that the pod serves `port` at (host, real_port) — the
        hollow-node seam PortForward bridges to."""
        with self._lock:
            self._ports[(uid, port)] = (host, real_port)

    def exit_container(self, uid: str, container: str, code: int = 0) -> None:
        """Simulate a container terminating on its own (PLEG will notice)."""
        with self._lock:
            p = self._pods.get(uid)
            if p is None:
                return
            for c in p.containers:
                if c.name == container:
                    c.state = "exited"
                    c.exit_code = code
            self._log_cv.notify_all()  # wake attach followers to exit
