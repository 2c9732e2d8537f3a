"""Scheduler daemon assembly.

PyTorch counterpart of kubernetes_tpu/scheduler/server.py
(plugin/cmd/kube-scheduler/app/{server.go,options/options.go}). Run()
wires: client, factory + informers, event broadcaster, config from
provider or policy file, optional leader election, then the scheduling
loop. The daemon serves its own observability mux (/healthz, /metrics,
/configz, /debug/traces), as the reference runs its own on :10251
(server.go:92-108).

The daemon schedules on SchedulerServerOptions.device, the card unless
the caller asks for the CPU. Where the JAX daemon starts its device
backend on a side thread and logs a failure, start() initializes the
torch device first and raises if it cannot: a daemon never carries on
scheduling on the CPU. Where the JAX daemon logs a failed warmup and
opens the scheduling loop all the same, this one records the error in
`error`, leaves `ready` unset and the loop closed, so a kernel that
fails to build or launch stops the daemon before its first wave
(harness/perf.py _wait_sched_ready raises with it). Both are recorded
deviations (SchedulerServer.start).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from kubernetes_tpu_torch.client.leaderelection import LeaderElector
from kubernetes_tpu_torch.client.record import EventBroadcaster, EventSink
from kubernetes_tpu_torch.client.rest import RESTClient
from kubernetes_tpu_torch.scheduler import algorithmprovider  # registers providers
from kubernetes_tpu_torch.scheduler.core import Scheduler
from kubernetes_tpu_torch.scheduler.factory import (
    DEFAULT_SCHEDULER_NAME,
    ConfigFactory,
)
from kubernetes_tpu_torch.scheduler.policy import load_policy

log = logging.getLogger(__name__)


@dataclass
class SchedulerServerOptions:
    """options.go:31 SchedulerServer (KubeSchedulerConfiguration knobs).

    Deviation from kubernetes_tpu/scheduler/server.py
    SchedulerServerOptions: it has a `device` field, the torch device
    the daemon schedules on ("cuda" unless the caller asks for the
    CPU); everything else is the JAX options."""

    algorithm_provider: str = algorithmprovider.DEFAULT_PROVIDER_NAME
    policy_config_file: str = ""
    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    hard_pod_affinity_symmetric_weight: int = 1
    failure_domains: List[str] = field(
        default_factory=lambda: [
            "kubernetes.io/hostname",
            "failure-domain.beta.kubernetes.io/zone",
            "failure-domain.beta.kubernetes.io/region",
        ]
    )
    kube_api_qps: float = 50.0
    kube_api_burst: int = 100
    # the daemon's own observability mux (server.go:92-108 runs the
    # reference's on :10251): /healthz, /metrics, /configz,
    # /debug/traces. Port 0 binds ephemeral (the bound port lands on
    # .health_address); None disables the listener entirely.
    serve_address: str = "127.0.0.1"
    serve_port: Optional[int] = 0
    # SLO watchdog (trace/slo.py): objective <= 0 disables; on breach a
    # Warning Event is emitted through the scheduler's recorder
    slo_objective_seconds: float = 0.0
    slo_check_interval: float = 10.0
    leader_elect: bool = False
    leader_elect_identity: str = ""
    lock_object_namespace: str = "kube-system"
    lock_object_name: str = "kube-scheduler"
    # lease timing (leaderelection.go defaults); the HA soak shrinks
    # these so a killed holder's standby takes over inside a CI-sized
    # SLO instead of the production 15s
    leader_elect_lease_duration: float = 15.0
    leader_elect_renew_deadline: float = 10.0
    leader_elect_retry_period: float = 2.0
    # AI-cluster workloads: path to a JSON throughput matrix
    # {workload_class: {accel_type: normalized_throughput}} feeding the
    # gang director's Gavel-style placement score; node accelerator
    # types come from the `accel_label_key` node label
    throughput_matrix_file: str = ""
    accel_label_key: str = "accelerator"
    # the torch device of the scheduling algorithm and the gang
    # director's victim scorer
    device: str = "cuda"

    @classmethod
    def from_component_config(cls, cfg) -> "SchedulerServerOptions":
        """Build options from a versioned KubeSchedulerConfiguration
        (apis/componentconfig.py) — options.go:31's embed, as a
        conversion. Flags-as-API-object is the configuration contract;
        this dataclass stays the daemon-internal form."""
        return cls(
            algorithm_provider=cfg.algorithm_provider,
            policy_config_file=cfg.policy_config_file,
            scheduler_name=cfg.scheduler_name,
            hard_pod_affinity_symmetric_weight=(
                cfg.hard_pod_affinity_symmetric_weight
            ),
            failure_domains=list(cfg.failure_domains),
            kube_api_qps=cfg.kube_api_qps,
            kube_api_burst=cfg.kube_api_burst,
            leader_elect=cfg.leader_election.leader_elect,
            lock_object_namespace=cfg.lock_object_namespace,
            lock_object_name=cfg.lock_object_name,
        )

    @classmethod
    def from_config_file(cls, path: str) -> "SchedulerServerOptions":
        from kubernetes_tpu_torch.apis.componentconfig import (
            load_component_config,
        )

        return cls.from_component_config(
            load_component_config(path, "KubeSchedulerConfiguration")
        )


class SchedulerServer:
    """app.Run (server.go:71)."""

    def __init__(self, client: RESTClient, options: Optional[SchedulerServerOptions] = None):
        self.options = options or SchedulerServerOptions()
        self.client = client
        self.factory: Optional[ConfigFactory] = None
        self.scheduler: Optional[Scheduler] = None
        self._elector: Optional[LeaderElector] = None
        self._thread: Optional[threading.Thread] = None
        self._health_server = None
        self._slo = None
        self._telemetry = None
        self._telemetry_owned = False
        #: (host, port) of the daemon's observability mux once serving
        self.health_address: Optional[tuple] = None
        # set once the scheduling loop is open for business (informers
        # synced + run-path warmup done). Callers that want steady-state
        # behavior (the perf harness, local-up readiness) wait on this;
        # pods arriving earlier still just queue.
        self.ready = threading.Event()

    def start(self) -> "SchedulerServer":
        """Deviation from kubernetes_tpu/scheduler/server.py
        SchedulerServer.start: it initializes the torch device of the
        options first and raises when it cannot (the JAX daemon starts
        its backend on a side thread and logs a failure), and a warmup
        that raises leaves the loop closed: an exception propagates from
        the scheduling algorithm's warmup into `error`, `ready` stays
        unset and no pod is scheduled (the JAX daemon logs it and opens
        the loop). The warmup always runs on the card, on a small
        synthetic cluster when a backlog is already waiting, so that a
        kernel that fails to build or launch never reaches a real wave;
        a failed scan-phase warmup closes the loop it finds open. The
        factory takes the options' device."""
        opts = self.options
        #: the warmup's exception, when it raised (the loop stays closed)
        self.error: Optional[BaseException] = None
        # the device first: a daemon whose card cannot be reached must
        # not start its informers, its mux or a loop on the CPU
        try:
            device = torch.device(opts.device)
            torch.empty(1, device=device)
        except Exception as e:
            raise RuntimeError(
                f"scheduler: cannot initialize device {opts.device!r}: {e}"
            ) from e
        # config introspection (server.go:72-76: configz.New +
        # InstallHandler; served at the shared mux's /configz)
        from kubernetes_tpu_torch.utils import configz

        configz.install("componentconfig", opts)
        # compile-vs-execute attribution must be listening before the
        # first jit fires (warmup included)
        from kubernetes_tpu_torch.trace import profile as trace_profile

        trace_profile.install_compile_listener()
        # the daemon's own mux (reference :10251): metrics/healthz no
        # longer depend on riding the apiserver's shared mux
        if opts.serve_port is not None:
            from kubernetes_tpu_torch.trace.httpd import start_component_server

            try:
                self._health_server, bound = start_component_server(
                    opts.serve_address, opts.serve_port, name="scheduler"
                )
                self.health_address = (opts.serve_address, bound)
            except OSError as e:
                # a sandbox that forbids socket binding must not turn
                # the optional metrics mux into a daemon boot failure
                log.warning("observability mux failed to bind: %s", e)
                self._health_server = None
        matrix = None
        if opts.throughput_matrix_file:
            import json as _json

            try:
                with open(opts.throughput_matrix_file) as f:
                    matrix = _json.load(f)
            except (OSError, ValueError):
                log.warning("unreadable throughput matrix %r; gangs "
                            "schedule without the heterogeneity term",
                            opts.throughput_matrix_file)
        self.factory = ConfigFactory(
            self.client,
            scheduler_name=opts.scheduler_name,
            hard_pod_affinity_weight=opts.hard_pod_affinity_symmetric_weight,
            failure_domains=opts.failure_domains,
            throughput_matrix=matrix,
            accel_label_key=opts.accel_label_key,
            device=opts.device,
        )
        self.factory.run_components()

        # createConfig (server.go:163): policy file wins over provider
        if opts.policy_config_file:
            config = self.factory.create_from_config(
                load_policy(opts.policy_config_file)
            )
        else:
            config = self.factory.create_from_provider(opts.algorithm_provider)

        # event broadcaster -> apiserver (server.go:117-120)
        self._broadcaster = EventBroadcaster()
        self._broadcaster.start_recording_to_sink(EventSink(self.client))
        config.recorder = self._broadcaster.new_recorder("scheduler")

        # SLO watchdog: e2e latency sampled against the objective, with
        # breaches emitted as Warning Events through the same recorder
        if opts.slo_objective_seconds > 0:
            from kubernetes_tpu_torch.trace.slo import SLOWatchdog

            self._slo = SLOWatchdog(
                config.recorder,
                opts.slo_objective_seconds,
                interval=opts.slo_check_interval,
            ).run()

        # continuous telemetry (telemetry/): the process collector
        # behind this mux's /debug/telemetry endpoints. ensure_default
        # is idempotent — whoever attached first owns shutdown.
        from kubernetes_tpu_torch import telemetry
        from kubernetes_tpu_torch.telemetry import scrape as telemetry_scrape

        if telemetry.enabled() and self._health_server is not None:
            self._telemetry_owned = telemetry_scrape.default() is None
            self._telemetry = telemetry_scrape.ensure_default(
                "scheduler",
                slo_seconds=(opts.slo_objective_seconds
                             if opts.slo_objective_seconds > 0 else 5.0),
                recorder=config.recorder,
            )

        self.scheduler = Scheduler(config)
        if not opts.leader_elect:
            # build and launch the kernels off the hot path: wait for
            # the node informer to sync (cluster size sets the warmup's
            # shape), warm up, then open the scheduling loop. Pods
            # arriving meanwhile queue in the FIFO.
            def _warm_then_run():
                algo = config.algorithm
                if hasattr(algo, "warmup"):
                    # the queue check must see the reflector's initial
                    # list, not race it
                    self.factory.unassigned_reflector.wait_for_sync(
                        timeout=10
                    )
                    n = len(self.factory.node_lister.list())
                    # a full-size warmup only pays off for a genuinely
                    # idle daemon: if work arrives within the grace
                    # window, the warmup runs on a few synthetic nodes,
                    # which builds and launches every kernel of the
                    # run path without delaying the first real wave
                    idle = True
                    if n:
                        deadline = time.time() + 0.3
                        while time.time() < deadline:
                            if len(self.factory.pod_queue) > 0:
                                idle = False
                                break
                            time.sleep(0.05)
                    if not self._warm(algo, n if (n and idle)
                                      else max(1, min(n, 64))):
                        return
                    if n and idle:
                        def _scan_phase():
                            # the scan-path warmup only matters for
                            # heterogeneous backlogs; run it only after
                            # SUSTAINED idleness — warmup holds the
                            # algorithm lock, and firing in the gap
                            # between loop-open and the first wave
                            # would block that wave behind it. "Idle" =
                            # queue empty AND no wave in flight (a
                            # drained wave leaves the queue empty while
                            # still computing).
                            import time as _t

                            lock = getattr(algo, "_sched_lock", None)
                            idle_since = _t.monotonic()
                            stop = self.scheduler.config.stop_everything
                            while not stop.is_set():
                                busy = len(self.factory.pod_queue) > 0
                                if not busy and lock is not None:
                                    if lock.acquire(blocking=False):
                                        lock.release()
                                    else:
                                        busy = True  # wave in flight
                                if busy:
                                    idle_since = _t.monotonic()
                                elif _t.monotonic() - idle_since >= 5.0:
                                    if not self._warm(algo, n, "scan"):
                                        # the loop is open: close it
                                        self.ready.clear()
                                        self.scheduler.stop()
                                    return
                                time.sleep(0.5)

                        threading.Thread(
                            target=_scan_phase, daemon=True,
                            name="sched-warmup-scan",
                        ).start()
                self._thread = self.scheduler.run()
                self.ready.set()

            threading.Thread(
                target=_warm_then_run, daemon=True, name="sched-warmup"
            ).start()
            return self

        # leader election (server.go:140-157): run() schedules only while
        # holding the lease; losing it stops the world (crash-restart).
        # The new leader warms up (a few synthetic nodes) before its
        # loop opens, so a kernel that fails stops it there too.
        def _lead():
            algo = config.algorithm
            if hasattr(algo, "warmup") and not self._warm(algo, 1):
                self.scheduler.stop()
                return
            self._thread = self.scheduler.run()
            self.ready.set()

        identity = opts.leader_elect_identity or f"scheduler-{id(self):x}"
        self._elector = LeaderElector(
            self.client,
            opts.lock_object_namespace,
            opts.lock_object_name,
            identity,
            lease_duration=opts.leader_elect_lease_duration,
            renew_deadline=opts.leader_elect_renew_deadline,
            retry_period=opts.leader_elect_retry_period,
            on_started_leading=_lead,
            on_stopped_leading=self._lost_lease,
        )
        threading.Thread(target=self._elector.run, daemon=True).start()
        return self

    def _warm(self, algo, num_nodes: int, phase: str = "run") -> bool:
        """algo.warmup(num_nodes, phase) -> whether it ran; an exception
        is logged and kept in `error` (the caller keeps the loop closed,
        or closes it)."""
        try:
            algo.warmup(num_nodes, phase=phase)
        except Exception as e:
            log.error("%s warmup failed; the scheduling loop stays closed",
                      phase, exc_info=True)
            self.error = e
            return False
        return True

    def _lost_lease(self) -> None:
        log.error("lost leader lease; stopping scheduler (restart to rejoin)")
        if self.scheduler is not None:
            self.scheduler.stop()

    def is_leader(self) -> bool:
        return self._elector is None or self._elector.is_leader()

    def stop(self) -> None:
        from kubernetes_tpu_torch.utils import configz

        configz.delete("componentconfig")
        if self._slo is not None:
            self._slo.stop()
        if self._telemetry is not None and self._telemetry_owned:
            from kubernetes_tpu_torch.telemetry import scrape as telemetry_scrape

            telemetry_scrape.release_default(self._telemetry)
            self._telemetry = None
        if self._health_server is not None:
            self._health_server.shutdown()
            self._health_server.server_close()
            self._health_server = None
        if self._elector is not None:
            self._elector.stop()
        if self.scheduler is not None:
            self.scheduler.stop()
        if self.factory is not None:
            self.factory.stop()
        if getattr(self, "_broadcaster", None) is not None:
            self._broadcaster.shutdown()
