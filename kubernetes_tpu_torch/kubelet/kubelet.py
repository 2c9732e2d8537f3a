"""The kubelet core (pkg/kubelet/kubelet.go).

syncLoop (kubelet.go:2491) selects over: pod config updates (an apiserver
watch filtered to spec.nodeName == this node — pkg/kubelet/config), PLEG
events, and a housekeeping tick. Each pod syncs on its own serialized
worker (pod_workers.go: one queue per pod, latest-wins), calling syncPod
(kubelet.go:1734): admit, run containers via the runtime, derive the API
pod status, hand it to the status manager. Heartbeats: node Ready
condition refreshed every nodeStatusUpdateFrequency
(kubelet.go:tryUpdateNodeStatus).

Copy of kubernetes_tpu/kubelet/kubelet.py: only the import package differs."""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.client.informer import Informer, ResourceEventHandler
from kubernetes_tpu_torch.client.rest import APIStatusError, RESTClient
from kubernetes_tpu_torch.kubelet.eviction import EvictionManager
from kubernetes_tpu_torch.kubelet.pleg import PLEG, PodLifecycleEvent
from kubernetes_tpu_torch.kubelet.prober import ProbeManager
from kubernetes_tpu_torch.kubelet.runtime import ContainerRuntime, FakeRuntime
from kubernetes_tpu_torch.kubelet.status import StatusManager


def _now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


@dataclass
class KubeletConfig:
    node_name: str = ""
    node_status_update_frequency: float = 10.0  # kubelet.go:10s default
    sync_frequency: float = 10.0
    housekeeping_interval: float = 2.0
    pleg_relist_period: float = 1.0
    status_sync_period: float = 0.5
    max_pods: int = 110
    pod_cidr_ip: str = "10.42.0.0"
    # node resources advertised in status (hollow nodes fake these, like
    # kubemark's 4-CPU/32Gi shape, perf/util.go:88-118)
    allocatable: Dict[str, object] = field(
        default_factory=lambda: {"cpu": "4", "memory": "32Gi", "pods": "110"}
    )
    register_node: bool = True
    # eviction (pkg/kubelet/eviction): memory.available < threshold =>
    # MemoryPressure + QoS-ranked eviction; 0 disables
    eviction_memory_threshold: int = 0
    eviction_sync_period: float = 1.0
    eviction_pressure_transition_period: float = 5.0
    # node-local API (pkg/kubelet/server, the :10250 surface): serves
    # /containerLogs, /exec, /stats/summary; port registers on the node
    # status so kubectl logs/exec can resolve it
    serve_api: bool = False
    api_host: str = "127.0.0.1"
    # node API hardening (server.go TLS-by-default + authn): with a
    # runtime that runs real processes, an open /exec is remote code
    # execution — gate it the moment the substrate is live
    api_tls_cert: str = ""
    api_tls_key: str = ""
    api_auth_token: str = ""
    # image manager (pkg/kubelet/image_manager.go): disk capacity the
    # LRU garbage collector budgets against
    image_capacity_bytes: int = 20 * 1024 ** 3


class _PodWorker:
    """pod_workers.go: one serialized worker per pod, latest update wins."""

    def __init__(self, sync_fn):
        self._sync = sync_fn
        self._pending: "queue.Queue" = queue.Queue(maxsize=1)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def update(self, pod: Optional[t.Pod]) -> None:
        # collapse to the newest update (managePodLoop semantics)
        try:
            self._pending.get_nowait()
        except queue.Empty:
            pass
        self._pending.put(pod)

    def _loop(self) -> None:
        while True:
            pod = self._pending.get()
            if pod is StopIteration:
                return
            try:
                self._sync(pod)
            except Exception:
                pass

    def stop(self) -> None:
        self.update(StopIteration)  # type: ignore[arg-type]


class Kubelet:
    def __init__(
        self,
        client: RESTClient,
        config: KubeletConfig,
        runtime: Optional[ContainerRuntime] = None,
        recorder=None,
        prober=None,
        memory_available_fn=None,
    ):
        """prober: injected ProbeRunner (kubelet/prober.py FakeProber in
        hollow nodes); memory_available_fn: the cadvisor seam feeding the
        eviction manager (bytes available on the machine)."""
        self.client = client
        self.config = config
        self.runtime = runtime or FakeRuntime()
        self.recorder = recorder
        self.status_manager = StatusManager(client)
        self.pleg = PLEG(self.runtime, config.pleg_relist_period)
        if prober is None and hasattr(self.runtime, "exec_probe"):
            # a live runtime probes for real (exec in the container);
            # fakes keep the injected-result seam
            from kubernetes_tpu_torch.kubelet.prober import RuntimeProber

            prober = RuntimeProber(self.runtime)
        self.probe_manager = ProbeManager(
            runner=prober,
            on_liveness_failure=self._handle_liveness_failure,
            on_result_change=self._on_probe_result_change,
        )
        self._restarts: Dict[tuple, int] = {}
        from kubernetes_tpu_torch.kubelet.images import ImageManager
        from kubernetes_tpu_torch.kubelet.volumes import VolumeManager

        # image presence + LRU GC feeding node status (and therefore
        # the scheduler's ImageLocality priority); the runtime may
        # report real sizes via an image_size(name) hook
        self.image_manager = ImageManager(
            capacity_bytes=config.image_capacity_bytes,
            size_of=getattr(self.runtime, "image_size", None),
        )
        self.volume_manager = VolumeManager(node_name=config.node_name)
        self.eviction_manager: Optional[EvictionManager] = None
        if config.eviction_memory_threshold > 0:
            self.eviction_manager = EvictionManager(
                client,
                self.runtime,
                config.node_name,
                memory_available_fn or (lambda: 1 << 62),
                config.eviction_memory_threshold,
                sync_period=config.eviction_sync_period,
                pressure_transition_period=(
                    config.eviction_pressure_transition_period
                ),
                recorder=recorder,
            )
        self._workers: Dict[str, _PodWorker] = {}
        self._pods: Dict[str, t.Pod] = {}  # uid -> latest spec from config
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._pod_ip_seq = 0
        self._pod_ips: Dict[str, str] = {}
        self._start_times: Dict[str, str] = {}
        # per-node /16-ish pod network: explicit pod_cidr_ip wins, else a
        # stable hash of the node name keeps IPs distinct across kubelets
        if config.pod_cidr_ip and config.pod_cidr_ip != "10.42.0.0":
            octets = config.pod_cidr_ip.split(".")
            self._ip_base = (octets[0], octets[1])
        else:
            import hashlib as _hl

            h = int(_hl.sha1(config.node_name.encode()).hexdigest(), 16)
            self._ip_base = ("10", str(43 + h % 200))
        self.api_server = None
        self._api_addr = ("", 0)
        # config source: watch pods bound to this node (kubelet/config/
        # apiserver.go NewSourceApiserver field selector)
        self._informer = Informer(
            client.resource("pods"),
            field_selector=f"spec.nodeName={config.node_name}",
            name=f"kubelet-{config.node_name}",
        )
        self._informer.add_event_handler(
            ResourceEventHandler(
                on_add=self._on_pod_update,
                on_update=lambda old, new: self._on_pod_update(new),
                on_delete=self._on_pod_delete,
            )
        )

    # -- node registration + heartbeats --------------------------------------

    def _node_object(self) -> t.Node:
        status = t.NodeStatus(
            capacity=dict(self.config.allocatable),
            allocatable=dict(self.config.allocatable),
            conditions=[
                t.NodeCondition(
                    "Ready",
                    "True",
                    last_heartbeat_time=_now(),
                    reason="KubeletReady",
                )
            ],
        )
        self._apply_api_endpoint(status)
        return t.Node(
            metadata=t.ObjectMeta(
                name=self.config.node_name,
                labels={"kubernetes.io/hostname": self.config.node_name},
            ),
            status=status,
        )

    def _apply_api_endpoint(self, status: t.NodeStatus) -> None:
        """Register where this kubelet's node API listens
        (status.daemonEndpoints.kubeletEndpoint in the reference)."""
        if self._api_addr[1]:
            status.addresses = [
                t.NodeAddress("InternalIP", self._api_addr[0])
            ]
            status.kubelet_port = self._api_addr[1]
            # TLS only engages when BOTH halves are present (server.py
            # serve(): `if tls_cert and tls_key`) — advertise exactly that
            status.kubelet_https = bool(
                self.config.api_tls_cert and self.config.api_tls_key
            )

    def register_node(self) -> None:
        """kubelet.go registerWithApiserver."""
        try:
            self.client.nodes().create(self._node_object())
        except APIStatusError as e:
            if e.code != 409:
                raise

    def update_node_status(self) -> None:
        """kubelet.go tryUpdateNodeStatus: refresh the Ready heartbeat."""
        try:
            node = self.client.nodes().get(self.config.node_name)
        except APIStatusError:
            return
        now = _now()
        ready = mem = None
        for c in node.status.conditions:
            if c.type == "Ready":
                ready = c
            elif c.type == "MemoryPressure":
                mem = c
        if ready is None:
            ready = t.NodeCondition("Ready", "True")
            node.status.conditions.append(ready)
        if ready.status != "True":
            ready.last_transition_time = now
        ready.status = "True"
        ready.reason = "KubeletReady"
        ready.last_heartbeat_time = now
        # setNodeMemoryPressureCondition: reported every heartbeat so the
        # scheduler's CheckNodeMemoryPressure sees transitions promptly
        pressure = (
            self.eviction_manager is not None
            and self.eviction_manager.under_memory_pressure
        )
        if mem is None:
            mem = t.NodeCondition("MemoryPressure", "False")
            node.status.conditions.append(mem)
        want = "True" if pressure else "False"
        if mem.status != want:
            mem.last_transition_time = now
        mem.status = want
        mem.reason = (
            "KubeletHasInsufficientMemory" if pressure
            else "KubeletHasSufficientMemory"
        )
        mem.last_heartbeat_time = now
        # setNodeStatusImages: the present-image set rides every
        # heartbeat, so ImageLocality scores track real node state
        node.status.images = self.image_manager.image_list()
        # setNodeStatusVolumesInUse: the attach/detach controller defers
        # detach while a device is still mounted here
        node.status.volumes_in_use = self.volume_manager.in_use_devices()
        self._apply_api_endpoint(node.status)
        try:
            self.client.nodes().update_status(node)
        except APIStatusError:
            pass

    # -- config handling ------------------------------------------------------

    def _worker_for(self, uid: str) -> _PodWorker:  # guarded-by: self._lock
        w = self._workers.get(uid)
        if w is None:
            w = _PodWorker(self._sync_pod)
            self._workers[uid] = w
        return w

    def _on_pod_update(self, pod: t.Pod) -> None:
        with self._lock:
            self._pods[pod.metadata.uid] = pod
            self._worker_for(pod.metadata.uid).update(pod)
        self.probe_manager.add_pod(pod)

    def _on_pod_delete(self, pod: t.Pod) -> None:
        with self._lock:
            self._pods.pop(pod.metadata.uid, None)
            w = self._workers.pop(pod.metadata.uid, None)
        self.probe_manager.remove_pod(pod.metadata.uid)
        self.runtime.kill_pod(pod.metadata.uid)
        self.status_manager.forget(pod.metadata.uid)
        self._start_times.pop(pod.metadata.uid, None)
        with self._lock:
            # _pod_ips is mutated under the lock by every per-pod
            # worker's _pod_ip(); the delete must hold it too
            self._pod_ips.pop(pod.metadata.uid, None)
            for key in [k for k in self._restarts if k[0] == pod.metadata.uid]:
                del self._restarts[key]
        for key in [
            k for k in getattr(self.runtime, "exits_by_pod", {})
            if k[0] == pod.metadata.uid
        ]:
            del self.runtime.exits_by_pod[key]
        if w is not None:
            w.stop()

    # -- syncPod --------------------------------------------------------------

    def _pod_ip(self, uid: str) -> str:
        # per-pod workers call this concurrently; the lock keeps the
        # sequence allocation atomic so no two pods share an IP
        with self._lock:
            ip = self._pod_ips.get(uid)
            if ip is None:
                self._pod_ip_seq += 1
                a, b = divmod(self._pod_ip_seq, 254)
                ip = f"{self._ip_base[0]}.{self._ip_base[1]}.{a % 254}.{b + 1}"
                self._pod_ips[uid] = ip
            return ip

    def _on_probe_result_change(self, pod: t.Pod) -> None:
        """A readiness flip regenerates the pod status now (the
        reference's results channel -> status manager push)."""
        with self._lock:
            cur = self._pods.get(pod.metadata.uid)
            w = self._workers.get(pod.metadata.uid) if cur is not None else None
        if w is not None:
            w.update(cur)

    def _handle_liveness_failure(self, pod: t.Pod, container: str) -> None:
        """prober/worker.go liveness failure -> kill the container; the
        pod worker's next sync restarts it under the restart policy."""
        uid = pod.metadata.uid
        code = 137
        if pod.spec.restart_policy == "Never":
            # stays down: terminal per-pod exit (phase -> Failed)
            if hasattr(self.runtime, "exits_by_pod"):
                self.runtime.exits_by_pod[(uid, container)] = code
        if hasattr(self.runtime, "exit_container"):
            self.runtime.exit_container(uid, container, code)
        if self.recorder is not None:
            self.recorder.eventf(
                pod, "Warning", "Unhealthy",
                f"Liveness probe failed: container {container} restarted",
            )
        with self._lock:
            key = (uid, container)
            if pod.spec.restart_policy != "Never":
                self._restarts[key] = self._restarts.get(key, 0) + 1
            w = self._workers.get(uid)
        if w is not None:
            # re-sync now (the restart) instead of waiting on PLEG
            w.update(pod)

    def _sync_pod(self, pod: t.Pod) -> None:
        """kubelet.go:1734 syncPod (fake-runtime scale): converge runtime,
        compute API status, queue the status update."""
        if pod.metadata.deletion_timestamp is not None:
            self.runtime.kill_pod(pod.metadata.uid)
            self.volume_manager.unmount_pod_volumes(pod.metadata.uid)
            return
        if pod.status.phase in ("Failed", "Succeeded"):
            # terminal pods (incl. Evicted) never run again: release the
            # runtime resources and keep the terminal API status
            # (kubelet.go: terminal phase short-circuits syncPod)
            self.runtime.kill_pod(pod.metadata.uid)
            self.volume_manager.unmount_pod_volumes(pod.metadata.uid)
            return
        try:
            # volumes mount and images pull BEFORE containers start
            # (kubelet.go syncPod: WaitForAttachAndMount, EnsureImageExists)
            self.volume_manager.mount_pod_volumes(pod)
            for c in (pod.spec.containers or []) + (
                pod.spec.init_containers or []
            ):
                self.image_manager.ensure(c.image)
            self.runtime.sync_pod(pod)
        except Exception:
            status = t.PodStatus(
                phase="Pending",
                reason="SyncError",
                host_ip="",
            )
            self.status_manager.set_pod_status(pod, status)
            raise
        self.status_manager.set_pod_status(pod, self._generate_status(pod))

    def _generate_status(self, pod: t.Pod) -> t.PodStatus:
        """kubelet.go generateAPIPodStatus + GetPhase."""
        rpods = {p.uid: p for p in self.runtime.list_pods()}
        rp = rpods.get(pod.metadata.uid)
        statuses: List[t.ContainerStatus] = []
        running = exited_ok = exited_bad = 0
        if rp is not None:
            for c in rp.containers:
                st = "running" if c.state == "running" else "terminated"
                statuses.append(
                    t.ContainerStatus(
                        name=c.name,
                        ready=(
                            c.state == "running"
                            and self.probe_manager.is_ready(
                                pod.metadata.uid, c.name
                            )
                        ),
                        restart_count=self._restarts.get(
                            (pod.metadata.uid, c.name), 0
                        ),
                        state=st,
                    )
                )
                if c.state == "running":
                    running += 1
                elif c.exit_code == 0:
                    exited_ok += 1
                else:
                    exited_bad += 1
        total = len(pod.spec.containers)
        if rp is None or not statuses:
            phase = "Pending"
        elif running > 0:
            phase = "Running"
        elif exited_bad > 0 and pod.spec.restart_policy == "Never":
            phase = "Failed"
        elif exited_bad == 0 and exited_ok == total and (
            pod.spec.restart_policy != "Always"
        ):
            phase = "Succeeded"
        elif pod.spec.restart_policy == "Always":
            phase = "Running"  # restartable containers will come back
        else:
            phase = "Failed" if exited_bad else "Succeeded"
        ready = (
            phase == "Running"
            and running == total
            and all(cs.ready for cs in statuses)
        )
        # start_time is set once on the first sync and preserved after
        # (generateAPIPodStatus keeps the existing status.startTime)
        start = self._start_times.setdefault(pod.metadata.uid, _now())
        return t.PodStatus(
            phase=phase,
            conditions=[
                t.PodCondition(type="Ready", status="True" if ready else "False")
            ],
            host_ip="",
            pod_ip=self._pod_ip(pod.metadata.uid) if phase == "Running" else "",
            start_time=start,
            container_statuses=statuses,
        )

    # -- loops ----------------------------------------------------------------

    def _sync_loop(self) -> None:
        """kubelet.go:2543 syncLoopIteration (PLEG + housekeeping cases;
        config updates arrive via informer handlers above)."""
        last_housekeeping = 0.0
        while not self._stop.is_set():
            try:
                ev: PodLifecycleEvent = self.pleg.events.get(timeout=0.2)
                with self._lock:
                    pod = self._pods.get(ev.pod_uid)
                    if pod is not None:
                        self._worker_for(ev.pod_uid).update(pod)
            except queue.Empty:
                pass
            now = time.monotonic()
            if now - last_housekeeping > self.config.housekeeping_interval:
                last_housekeeping = now
                self._housekeeping()

    def _housekeeping(self) -> None:
        """HandlePodCleanups: kill runtime pods with no config, tear
        down orphaned volume mounts, GC unused images."""
        with self._lock:
            known = set(self._pods)
            in_use = {
                c.image
                for p in self._pods.values()
                for c in (p.spec.containers or [])
                + (p.spec.init_containers or [])
                if c.image
            }
        for rp in self.runtime.list_pods():
            if rp.uid not in known:
                self.runtime.kill_pod(rp.uid)
        self.volume_manager.reconcile(known)
        self.image_manager.garbage_collect(in_use=in_use)

    def _status_loop(self) -> None:
        while not self._stop.wait(self.config.status_sync_period):
            try:
                self.status_manager.sync()
            except Exception:
                pass

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.config.node_status_update_frequency):
            self.update_node_status()

    def run(self) -> "Kubelet":
        """kubelet.go:957 Run."""
        if self.config.serve_api:
            from kubernetes_tpu_torch.kubelet.server import KubeletServer

            self.api_server = KubeletServer(self)
            self._api_addr = self.api_server.serve(
                host=self.config.api_host,
                tls_cert=self.config.api_tls_cert,
                tls_key=self.config.api_tls_key,
                auth_token=self.config.api_auth_token,
            )
        if self.config.register_node:
            self.register_node()
        self._informer.run()
        self.pleg.run()
        if self.eviction_manager is not None:
            self.eviction_manager.run()
        for target, name in [
            (self._sync_loop, "kubelet-syncloop"),
            (self._status_loop, "kubelet-status"),
            (self._heartbeat_loop, "kubelet-heartbeat"),
        ]:
            th = threading.Thread(target=target, name=name, daemon=True)
            th.start()
            self._threads.append(th)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self.api_server is not None:
            self.api_server.shutdown()
        self.pleg.stop()
        self.probe_manager.stop()
        if self.eviction_manager is not None:
            self.eviction_manager.stop()
        self._informer.stop()
        for w in self._workers.values():
            w.stop()
