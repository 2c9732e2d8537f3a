"""The controller manager (cmd/kube-controller-manager/app/
controllermanager.go StartControllers:197): one process starting every
reconciliation loop over a shared informer factory.

HA model mirrors the reference (crash-and-restart): losing the leader
lease stops every loop and sets `lost_lease`; the hosting process is
expected to exit and rejoin as a fresh standby (controllermanager.go
Fatalf on leaderelection loss). Embedders poll `lost_lease` or pass
their own on_stopped_leading via the elector.

Copy of kubernetes_tpu/controller/manager.py: only the import package differs."""

from __future__ import annotations

import socket
import threading
import uuid
from dataclasses import dataclass, field
from typing import List, Optional

from kubernetes_tpu_torch.client.leaderelection import LeaderElector

from kubernetes_tpu_torch.client.record import EventBroadcaster, EventSink
from kubernetes_tpu_torch.client.rest import RESTClient
from kubernetes_tpu_torch.controller.cloud import RouteController, ServiceController
from kubernetes_tpu_torch.controller.autoscale import (
    HorizontalController,
    MetricsClient,
    ResourceQuotaController,
)
from kubernetes_tpu_torch.controller.daemonset import DaemonSetsController
from kubernetes_tpu_torch.controller.deployment import DeploymentController
from kubernetes_tpu_torch.controller.endpoints import EndpointsController
from kubernetes_tpu_torch.controller.framework import SharedInformerFactory
from kubernetes_tpu_torch.controller.gc import NamespaceController, PodGCController
from kubernetes_tpu_torch.controller.job import JobController
from kubernetes_tpu_torch.controller.node_lifecycle import NodeLifecycleController
from kubernetes_tpu_torch.controller.petset import PetSetController
from kubernetes_tpu_torch.controller.attach_detach import AttachDetachController
from kubernetes_tpu_torch.controller.serviceaccount import (
    ServiceAccountsController,
    TokensController,
)
from kubernetes_tpu_torch.controller.podgroup import PodGroupStatusController
from kubernetes_tpu_torch.controller.pv_binder import PersistentVolumeClaimBinder
from kubernetes_tpu_torch.controller.replication import (
    ReplicationManager,
    new_replicaset_manager,
)


@dataclass
class ControllerManagerOptions:
    """componentconfig KubeControllerManagerConfiguration subset."""

    node_monitor_grace_period: float = 40.0
    pod_eviction_timeout: float = 300.0
    node_eviction_rate: float = 0.1
    terminated_pod_gc_threshold: int = 12500
    node_monitor_period: float = 5.0
    # HA active/standby via lease CAS (controllermanager.go:142-170)
    leader_elect: bool = False
    leader_elect_identity: str = ""
    lock_object_namespace: str = "kube-system"
    lock_object_name: str = "kube-controller-manager"
    enable: tuple = (
        "endpoints",
        "replication",
        "podgc",
        "node",
        "namespace",
        "daemonset",
        "job",
        "deployment",
        "replicaset",
        "petset",
        "resourcequota",
        "pv-binder",
        "serviceaccount",
        "serviceaccount-token",
        "attachdetach",
        "podgroup",
    )  # hpa omitted by default: it needs a metrics client
    # the --service-account-private-key-file analogue: the tokens
    # controller only runs with a signing key
    # (controllermanager.go ServiceAccountTokenController gating)
    service_account_private_key: object = None


class ControllerManager:
    def __init__(
        self,
        client: RESTClient,
        options: Optional[ControllerManagerOptions] = None,
        metrics_client: Optional[MetricsClient] = None,
        cloud=None,
    ):
        self.client = client
        self.options = options or ControllerManagerOptions()
        self.informers = SharedInformerFactory(client)
        broadcaster = EventBroadcaster()
        broadcaster.start_recording_to_sink(EventSink(client))
        self._broadcaster = broadcaster
        rec = lambda component: broadcaster.new_recorder(component)
        o, enabled = self.options, set(self.options.enable)
        self.controllers: List[object] = []

        def add(name, ctor):
            if name in enabled:
                self.controllers.append(ctor())

        add("endpoints", lambda: EndpointsController(
            client, self.informers, rec("endpoint-controller")))
        add("replication", lambda: ReplicationManager(
            client, self.informers, rec("replication-controller")))
        add("replicaset", lambda: new_replicaset_manager(
            client, self.informers, rec("replicaset-controller")))
        add("deployment", lambda: DeploymentController(
            client, self.informers, rec("deployment-controller")))
        add("job", lambda: JobController(
            client, self.informers, rec("job-controller")))
        add("daemonset", lambda: DaemonSetsController(
            client, self.informers, rec("daemonset-controller")))
        add("podgc", lambda: PodGCController(
            client, self.informers, o.terminated_pod_gc_threshold))
        add("namespace", lambda: NamespaceController(client, self.informers))
        add("node", lambda: NodeLifecycleController(
            client, self.informers, rec("node-controller"),
            node_monitor_grace_period=o.node_monitor_grace_period,
            pod_eviction_timeout=o.pod_eviction_timeout,
            eviction_qps=o.node_eviction_rate))
        add("petset", lambda: PetSetController(
            client, self.informers, rec("petset-controller")))
        add("resourcequota", lambda: ResourceQuotaController(
            client, self.informers))
        add("pv-binder", lambda: PersistentVolumeClaimBinder(
            client, self.informers))
        add("podgroup", lambda: PodGroupStatusController(
            client, self.informers, rec("podgroup-controller")))
        add("serviceaccount", lambda: ServiceAccountsController(
            client, self.informers))
        add("attachdetach", lambda: AttachDetachController(
            client, self.informers, cloud=cloud))
        if o.service_account_private_key is not None:
            add("serviceaccount-token", lambda: TokensController(
                client, self.informers, o.service_account_private_key))
        if cloud is not None:
            # cloud-facing loops only run with a provider configured
            # (controllermanager.go:239-258 gates on cloudprovider too)
            self.controllers.append(
                ServiceController(client, self.informers, cloud))
            self.controllers.append(
                RouteController(client, self.informers, cloud))
        if metrics_client is not None:
            self.controllers.append(
                HorizontalController(
                    client, self.informers, metrics_client,
                    rec("horizontal-pod-autoscaler"),
                )
            )

    def serve_observability(self, host: str = "127.0.0.1",
                            port: int = 0) -> int:
        """Serve the daemon mux (/healthz /metrics /configz
        /debug/traces /debug/audit) for this controller manager — the
        reference's :10252 surface. Every controller's named workqueue
        renders its depth/latency families here. Returns the bound
        port."""
        from kubernetes_tpu_torch.trace.httpd import start_component_server

        self._obs_server, bound = start_component_server(
            host, port,
            # healthy while it has not LOST a lease: a standby that never
            # led is still a healthy process (crash-restart HA)
            healthz=lambda: not getattr(self, "lost_lease", False),
            name="controller-manager",
        )
        # continuous telemetry behind /debug/telemetry on this mux;
        # idempotent — a co-located scheduler daemon may already own
        # the process collector, in which case we just share it
        from kubernetes_tpu_torch import telemetry
        from kubernetes_tpu_torch.telemetry import scrape as telemetry_scrape

        if telemetry.enabled():
            self._telemetry_owned = telemetry_scrape.default() is None
            self._telemetry = telemetry_scrape.ensure_default(
                "controller-manager",
                recorder=self._broadcaster.new_recorder(
                    "controller-manager"),
            )
        return bound

    def start(self) -> "ControllerManager":
        self._lifecycle_lock = threading.Lock()
        self._stopped = False
        #: set when the leader lease was LOST (not a voluntary stop); the
        #: hosting process should exit and restart (crash-restart HA)
        self.lost_lease = False
        if not self.options.leader_elect:
            self._start_controllers()
            return self
        # hostname+uuid like the reference: a process-unique identity
        # (memory addresses collide across processes)
        identity = self.options.leader_elect_identity or (
            f"{socket.gethostname()}_{uuid.uuid4().hex[:8]}"
        )
        self._elector = LeaderElector(
            self.client,
            self.options.lock_object_namespace,
            self.options.lock_object_name,
            identity,
            on_started_leading=self._start_controllers,
            on_stopped_leading=self._on_lease_lost,
        )
        threading.Thread(target=self._elector.run, daemon=True).start()
        return self

    def _on_lease_lost(self) -> None:
        if not self._stopped:  # voluntary stop() is not a lost lease
            self.lost_lease = True
        self.stop()

    def is_leader(self) -> bool:
        if not self.options.leader_elect:
            return True
        elector = getattr(self, "_elector", None)
        # leader_elect configured but not yet started/acquired: NOT leader
        return elector is not None and elector.is_leader()

    def _start_controllers(self) -> None:
        # serialized with stop(): once stop() has run (and set _stopped),
        # a late-firing on_started_leading must be a no-op rather than
        # starting loops on a non-leader. The sync wait stays inside the
        # lock so no controller's first periodic pass ever sees a
        # half-filled store (a concurrent stop() blocks for at most the
        # bounded sync wait).
        with self._lifecycle_lock:
            if self._stopped:
                return
            self.informers.start()
            self.informers.wait_for_sync()
            for c in self.controllers:
                if isinstance(c, NodeLifecycleController):
                    c.run(self.options.node_monitor_period)
                else:
                    c.run()

    def stop(self) -> None:
        lock = getattr(self, "_lifecycle_lock", None)
        if lock is not None:
            with lock:
                self._stopped = True
        elector = getattr(self, "_elector", None)
        if elector is not None:
            # stop renewing AND zero the lease record so the standby
            # acquires immediately instead of waiting out lease_duration
            elector.stop(release=True)
        for c in self.controllers:
            try:
                c.stop()
            except Exception:
                pass
        self.informers.stop()
        self._broadcaster.shutdown()
        tel = getattr(self, "_telemetry", None)
        if tel is not None and getattr(self, "_telemetry_owned", False):
            from kubernetes_tpu_torch.telemetry import scrape as telemetry_scrape

            telemetry_scrape.release_default(tel)
            self._telemetry = None
        obs = getattr(self, "_obs_server", None)
        if obs is not None:
            obs.shutdown()
            obs.server_close()  # release the listening socket too
            self._obs_server = None
