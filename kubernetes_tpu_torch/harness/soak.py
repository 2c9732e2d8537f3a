"""Sustained-traffic wire soak with named chaos scenarios.

The plain soak (PR 8, moved here from bench.py) drives Poisson
continuous arrivals through the full wire path — apiserver (TLV/HTTP)
-> scheduler daemon -> batched bind -> hollow-kubelet Running ack —
against a hollow-node fleet, with balanced deletion churn, and gates
p99 created->bound, zero recompiles, flat RSS, and zero dropped watch
events over the steady-state window.

Scenarios layer production chaos on the SAME harness (each a named
``--wire-soak`` config in bench.py with its own gates, not a one-off
script):

* ``noisy-neighbor`` — one abusive client floods lists/creates while N
  well-behaved tenant flows keep arriving; with APF on the abuser eats
  429s, the well-behaved flows shed nothing, and the scheduler's
  (exempt) p99 holds its SLO. ``ab_compare=True`` re-runs the same
  scenario with APF off and requires a demonstrable breach — the gate
  proves APF causes the protection, not box luck.
* ``rack-failure`` — a rack of hollow nodes vanishes mid-soak
  (heartbeats stop, acks stop); the node-lifecycle controller must
  mark them Unknown and complete the eviction wave under a declared
  SLO while new arrivals keep binding to the survivors. Node counts
  are chosen inside one pow2 compile bucket so the topology shrink
  does not recompile.
* ``rolling-update`` — a many-replica RC rolls v1 -> v2 in steps
  through the real ReplicationManager while soak traffic continues;
  gate: the update completes under its SLO with every v2 replica
  bound.
* ``burst`` — the Poisson rate multiplies 10x for a burst window; the
  APF queues and the wire path absorb it (zero creator sheds, zero
  drops) and p99 recovers to the SLO after the burst drains.

Every client carries its flow identity (scheduler/fleet/driver are
system-exempt; creators are named tenants) so APF classification sees
the real callers — the production wiring, not a test fixture.

Copy of kubernetes_tpu/harness/soak.py: only the import package differs.
"""

from __future__ import annotations

import os
import statistics
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


def rss_mb() -> float:
    """This process's resident set in MB (the soak gates' flat-RSS
    probe)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


@dataclass
class SoakConfig:
    """One soak run's configuration.

    Deviation from kubernetes_tpu/harness/soak.py SoakConfig: it has a
    `device` field, the torch device the scheduler daemon runs on
    ("cuda" unless the caller asks for "cpu", the port's rule; the JAX
    package's daemon takes JAX's default platform).
    """

    seconds: int
    num_nodes: int = 1000
    rate: float = 300.0
    slo: float = 5.0
    store_profile: str = "memory"  # "memory" | "quorum"
    #: named chaos scenario ("" = plain soak)
    scenario: str = ""
    #: scenario knobs (see SCENARIOS for names/defaults)
    params: Dict[str, object] = field(default_factory=dict)
    #: API priority-and-fairness at the apiserver door
    apf: bool = True
    #: noisy-neighbor only: also run the APF-off control arm and gate
    #: on the protection delta
    ab_compare: bool = False
    #: well-behaved creator flows (distinct tenant users)
    flows: int = 1
    #: N apiserver replicas as SEPARATE OS processes over one quorum
    #: (harness/procs.py; 0 = the in-process profiles above). The
    #: driver talks to the replica set through the multi-endpoint
    #: spread/failover transport; gates scrape the replicas' /metrics.
    procs: int = 0
    #: scheduler HA: N kube-scheduler OS processes sharing the
    #: leader-election lease (0 = the in-driver scheduler thread).
    #: Requires procs > 0 (the schedulers dial the replica set).
    ha_schedulers: int = 0
    #: the scheduler daemon's torch device ("cuda" or "cpu")
    device: str = "cuda"


#: scenario parameter tables: "full" is the production-realism form
#: (hours-long soaks), "smoke" the tier-1 CI variant. Rack-failure
#: node counts are chosen so the post-failure count stays in the same
#: pow2 node-axis compile bucket (zero-recompile gate holds by design).
SCENARIOS: Dict[str, Dict[str, Dict[str, object]]] = {
    "noisy-neighbor": {
        "full": dict(
            flows=5, abuser_threads=48, abuser_pace=0.0,
            apf_params=dict(total_seats=32, queues=32, queue_length=16,
                            hand_size=4, queue_wait=5.0),
        ),
        # the smoke verifies the MECHANISM (shed + shuffle-shard
        # isolation + SLO hold) with a BURST-synchronized abuser: all
        # threads fire on the same wall-clock boundary, so every burst
        # arrives 12-wide against a 2-seat + 4-queued hand and sheds
        # deterministically on any box speed. An unpaced flood on a
        # 2-core CI box would starve the in-process scheduler's GIL no
        # matter what admission control does — concurrency seats bound
        # in-server parallelism, not one seat's request rate; the
        # protection DELTA is the full form's A/B gate.
        "smoke": dict(
            num_nodes=64, rate=40.0, flows=3, abuser_threads=12,
            abuser_burst_interval=0.5, abuse_bulk=400, churn_floor=512,
            apf_params=dict(total_seats=2, queues=16, queue_length=1,
                            hand_size=1, queue_wait=1.0),
        ),
    },
    "rack-failure": {
        "full": dict(
            num_nodes=2000, fail_count=500, heartbeat_interval=5.0,
            grace=15.0, eviction_timeout=5.0, eviction_qps=50.0,
            monitor_period=1.0, rack_slo=180.0,
        ),
        "smoke": dict(
            num_nodes=96, rate=30.0, fail_count=30,
            heartbeat_interval=1.0, grace=3.0, eviction_timeout=1.0,
            eviction_qps=100.0, monitor_period=0.25, rack_slo=30.0,
            churn_floor=512,
        ),
    },
    "rolling-update": {
        "full": dict(replicas=1000, step=100, rolling_slo=600.0),
        # compile_budget=1: the smoke holds zero steady compiles in a
        # fresh process (and the full form gates a hard zero), but
        # inside the ~800-test tier-1 process the measured roll
        # reproducibly picks up ONE ~1s recompile that the identical
        # warm-ramp roll does not — long-lived-process compile-cache
        # state, not a scenario regression; the count still rides the
        # record either way
        "smoke": dict(num_nodes=64, rate=25.0, replicas=45, step=15,
                      rolling_slo=40.0, churn_floor=512,
                      compile_budget=1),
    },
    "burst": {
        "full": dict(factor=10.0, burst_seconds=10.0,
                     recovery_seconds=20.0),
        "smoke": dict(num_nodes=64, rate=30.0, factor=10.0,
                      burst_seconds=3.0, recovery_seconds=5.0,
                      churn_floor=512),
    },
    # kill -9 the control plane's own processes mid-soak (requires the
    # multi-process profile, procs >= 3 so a leader kill leaves a
    # majority): the lease-holding leader apiserver, then a follower
    # apiserver, then — with ha_schedulers >= 2 — the active
    # scheduler; each must recover inside kill_slo with zero lost
    # acked writes and at most one leader per observed term.
    # compile_budget: the kill stalls provoke backlog bursts whose
    # wave shapes the warm ramp cannot visit in advance (recorded,
    # same convention as the rolling-update smoke)
    "process-kill": {
        "full": dict(procs=3, ha_schedulers=2, kill_slo=20.0,
                     quorum_election_timeout=0.5, compile_budget=4),
        "smoke": dict(num_nodes=64, rate=25.0, procs=3,
                      churn_floor=512, kill_slo=15.0,
                      quorum_election_timeout=0.4, compile_budget=4),
    },
}


def scenario_config(name: str, seconds: int, smoke: bool = False,
                    **overrides) -> SoakConfig:
    """Build a SoakConfig for a named scenario. Scenario tables may
    carry SoakConfig-level defaults (num_nodes, rate, flows...);
    explicit ``overrides`` win over everything."""
    if name and name not in SCENARIOS:
        raise ValueError(
            f"unknown scenario {name!r}; have {sorted(SCENARIOS)}"
        )
    params: Dict[str, object] = {}
    if name:
        params.update(SCENARIOS[name]["smoke" if smoke else "full"])
    cfg_fields = {
        "num_nodes", "rate", "slo", "store_profile", "apf",
        "ab_compare", "flows", "procs", "ha_schedulers",
    }
    cfg_kw = {k: params.pop(k) for k in list(params) if k in cfg_fields}
    for k in list(overrides):
        if k in cfg_fields:
            cfg_kw[k] = overrides.pop(k)
    params.update(overrides)
    return SoakConfig(seconds=seconds, scenario=name, params=params,
                      **cfg_kw)


def _build_flowcontrol(cfg: SoakConfig):
    """The apiserver's APF controller for this run. cfg.apf is
    explicit (the A/B arms must not depend on ambient env)."""
    if not cfg.apf:
        return None
    from kubernetes_tpu_torch.apiserver.flowcontrol import (
        APFController,
        default_levels,
    )

    apf_params = dict(cfg.params.get("apf_params") or {})
    if apf_params:
        seats = int(apf_params.pop("total_seats", 32))
        wait = float(apf_params.pop("queue_wait", 15.0))
        return APFController(
            levels=default_levels(seats, wait, **apf_params)
        )
    # no scenario override: honor the documented env knobs
    # (KUBERNETES_TPU_APF_SEATS / _QUEUE_WAIT). cfg.apf=True is the
    # explicit decision, so the env kill switch does not re-disable.
    return APFController.from_env() or APFController()


def _rejected_by_level(level: str) -> float:
    from kubernetes_tpu_torch.metrics import (
        apiserver_flowcontrol_rejected_requests_total as rej,
    )

    return sum(
        rej.get(priority_level=level, reason=r)
        for r in ("queue-full", "time-out")
    )


def run_wire_soak(cfg: SoakConfig) -> dict:
    """Run the soak (plus scenario); returns the gate record. Callers
    own exit codes and BENCH-file merging (bench.py does both); the
    record carries ``gates`` (name -> bool) and ``ok``.

    Deviation from kubernetes_tpu/harness/soak.py run_wire_soak: the
    daemon runs on the configured device (SchedulerServerOptions(...,
    device=cfg.device)), the scheduler processes get it too
    (SchedulerProc(..., device=cfg.device)) and so does the APF-off
    control arm; the JAX package's daemon takes JAX's default platform.
    Nothing else differs.
    """
    import random
    import threading
    from collections import deque

    # continuous arrivals never give the daemon the 5s idle window the
    # deferred scan warm waits for; compile everything up front
    os.environ.setdefault("KUBERNETES_TPU_WARM_SCAN", "1")
    # per-bind Events are the one store population that grows without
    # bound under sustained traffic; expire them fast enough that the
    # steady-state store — and therefore the flat-RSS gate — sees a
    # flat population (the apiserver's --event-ttl analogue)
    os.environ.setdefault("KUBERNETES_TPU_EVENT_TTL",
                          str(min(3600, max(15, cfg.seconds // 4))))
    from kubernetes_tpu_torch.native.build import ensure_all

    ensure_all()

    from kubernetes_tpu_torch.analysis.compile_guard import CompileSentinel
    from kubernetes_tpu_torch.api.types import (
        Container,
        ObjectMeta,
        Pod,
        PodSpec,
    )
    from kubernetes_tpu_torch.apiserver.server import APIServer
    from kubernetes_tpu_torch.client.rest import (
        APIStatusError,
        RESTClient,
        batch_delete_item,
    )
    from kubernetes_tpu_torch.client.transport import HTTPTransport
    from kubernetes_tpu_torch.kubemark.fleet import FleetConfig, HollowFleet
    from kubernetes_tpu_torch.metrics import (
        apiserver_flowcontrol_dispatched_requests_total,
        apiserver_flowcontrol_rejected_requests_total,
        apiserver_flowcontrol_request_wait_duration_seconds,
        apiserver_requests_total,
        apiserver_watch_cache_hits_total,
        apiserver_watch_cache_misses_total,
        apiserver_watch_coalesced_frame_bytes,
        apiserver_watch_coalesced_frame_objects,
        apiserver_watch_events_sent_total,
        storage_watch_cache_ring_evictions_total,
        storage_watch_events_dropped_total,
        storage_watch_fanout_pruned_total,
    )
    from kubernetes_tpu_torch.scheduler.server import (
        SchedulerServer,
        SchedulerServerOptions,
    )

    seconds = cfg.seconds
    num_nodes = cfg.num_nodes
    rate = cfg.rate
    slo = cfg.slo
    params = cfg.params

    quorum_stores = []
    api = None
    api2 = None
    fleet_procs = None
    sched_procs: List = []
    if cfg.procs > 0:
        # MULTI-PROCESS control plane: cfg.procs apiserver replicas as
        # separate OS processes, each one quorum member with its own
        # watch cache + APF + HTTP frontend (harness/procs.py). The
        # driver spreads load through the multi-endpoint transport and
        # scrapes the replicas' /metrics for the gate accounting.
        import tempfile

        from kubernetes_tpu_torch.harness import procs as procs_mod

        if cfg.scenario == "process-kill" and cfg.procs < 3:
            raise ValueError("process-kill needs procs >= 3 (killing "
                             "the leader of fewer loses the majority)")
        fleet_procs = procs_mod.ApiserverFleet(
            cfg.procs,
            tempfile.mkdtemp(prefix="apiserver-procs-"),
            election_timeout=float(
                params.get("quorum_election_timeout", 0.5)),
            env_extra={
                "KUBERNETES_TPU_EVENT_TTL": os.environ.get(
                    "KUBERNETES_TPU_EVENT_TTL", "60"),
            },
        ).start()
        url = fleet_procs.urls(lead_first=True)
        creator_url = url
        print(f"# wire-soak: {cfg.procs} apiserver replica PROCESSES "
              f"over one quorum (leader {fleet_procs.leader().node_id});"
              f" endpoints {url}", file=sys.stderr)
    elif cfg.store_profile == "quorum":
        # multi-apiserver HA profile: a 3-member consensus store with
        # TWO apiservers over it — one on the leader member (the hot
        # path), one on a follower (every write it takes is forwarded
        # to the leader; reads barrier through read-index). The
        # creator drives the follower so the forwarding path carries
        # the arrival stream; scheduler + fleet ride the leader.
        import tempfile

        from kubernetes_tpu_torch.storage.quorum import build_cluster

        qdir = tempfile.mkdtemp(prefix="quorum-soak-")
        quorum_stores = build_cluster(qdir, 3)
        deadline_q = time.time() + 30
        leader_store = None
        while time.time() < deadline_q and leader_store is None:
            leader_store = next(
                (s for s in quorum_stores if s.node.is_leader()), None)
            time.sleep(0.05)
        if leader_store is None:
            raise RuntimeError("quorum never elected a leader")
        follower_store = next(s for s in quorum_stores
                              if s is not leader_store)
        api = APIServer(store=leader_store,
                        flowcontrol=_build_flowcontrol(cfg))
        api2 = APIServer(store=follower_store,
                         flowcontrol=_build_flowcontrol(cfg))
        host, port = api.serve_http(enable_binary=True)
        h2, p2 = api2.serve_http(enable_binary=True)
        url = f"http://{host}:{port},http://{h2}:{p2}"
        creator_url = f"http://{h2}:{p2},http://{host}:{port}"
        print(f"# wire-soak: QUORUM store ({len(quorum_stores)} "
              f"members, leader {leader_store.node_id}); apiservers "
              f"at {url} (scheduler/fleet -> leader, creator -> "
              "forwarding follower)", file=sys.stderr)
    else:
        api = APIServer(flowcontrol=_build_flowcontrol(cfg))
        host, port = api.serve_http(enable_binary=True)
        url = f"http://{host}:{port}"
        creator_url = url
        print(f"# wire-soak: apiserver (in-process TLV/HTTP wire) at "
              f"{url} (APF {'on' if cfg.apf else 'OFF'}"
              + (f", scenario {cfg.scenario}" if cfg.scenario else "")
              + ")", file=sys.stderr)
    sentinel = CompileSentinel()
    # fleet first: the scheduler's warmup compiles against the node
    # count its informer sees, so the hollow nodes must be registered
    # before the daemon starts or the real node-axis shape compiles
    # against live traffic instead of in warmup
    fleet_kw = {}
    if "heartbeat_interval" in params:
        fleet_kw["heartbeat_interval"] = float(
            params["heartbeat_interval"])
    fleet_client = RESTClient(HTTPTransport(
        url, binary=True, timeout=180.0,
        user="system:node:hollow-fleet", groups=("system:nodes",),
    ))
    fleet = HollowFleet(fleet_client,
                        FleetConfig(num_nodes=num_nodes, **fleet_kw))
    fleet.run()
    print(f"# wire-soak: {num_nodes} hollow nodes registered, "
          f"{len(fleet._threads)} fleet threads "
          f"(shards of {fleet.config.shard_size} + the pacer)",
          file=sys.stderr)
    sched = None
    sched_client = None
    if cfg.ha_schedulers >= 2:
        # scheduler HA: N kube-scheduler OS processes share the
        # leader-election lease; the holder schedules, a standby takes
        # over when the holder dies (the process-kill scenario's
        # third victim)
        import tempfile as _tf

        from kubernetes_tpu_torch.harness import procs as procs_mod

        ha_dir = _tf.mkdtemp(prefix="sched-ha-")
        sched_procs = [
            procs_mod.SchedulerProc(url, f"sched-{i}", ha_dir,
                                    device=cfg.device)
            for i in range(cfg.ha_schedulers)
        ]
        probe_client = RESTClient(HTTPTransport(
            url, binary=True, timeout=60.0,
            user="system:kube-scheduler"))
        deadline_s = time.time() + 300
        holder = ""
        while time.time() < deadline_s and not holder:
            holder = procs_mod.scheduler_lease_holder(probe_client)
            time.sleep(0.25)
        if not holder:
            raise RuntimeError("no scheduler process took the lease")
        # canary bind: the holder's cold jax compile belongs to setup,
        # not the measured window (the in-driver path waits on
        # sched.ready for the same reason)
        probe_client.pods().create(Pod(
            metadata=ObjectMeta(name="ha-canary"),
            spec=PodSpec(containers=[Container(
                requests={"cpu": "1m"})]),
        ))
        while time.time() < deadline_s:
            if probe_client.pods().get("ha-canary").spec.node_name:
                break
            time.sleep(0.5)
        else:
            raise RuntimeError(
                "the HA scheduler never bound the canary pod")
        try:
            probe_client.pods().delete("ha-canary")
        except Exception:
            pass
        probe_client.transport.close()
        print(f"# wire-soak: {cfg.ha_schedulers} scheduler processes, "
              f"lease held by {holder}", file=sys.stderr)
    else:
        sched_client = RESTClient(HTTPTransport(
            url, binary=True, timeout=180.0,
            user="system:kube-scheduler",
        ))
        sched = SchedulerServer(
            sched_client,
            SchedulerServerOptions(algorithm_provider="TPUProvider",
                                   serve_port=None, device=cfg.device),
        ).start()
        if not sched.ready.wait(600):
            raise RuntimeError("scheduler daemon never became ready")

    # the measurement/churn apparatus is exempt control-plane traffic:
    # it must observe the system, not perturb the flows under test
    client = RESTClient(HTTPTransport(
        creator_url, binary=True, timeout=180.0,
        user="system:soak-driver", groups=("system:masters",),
    ))
    # well-behaved creator flows: distinct named tenants (workload-high
    # per-user flows under APF), rotated per arrival tick; in the
    # multi-process profile each creator SPREADS its requests
    # round-robin across the replica set (the front-door scaling)
    n_flows = max(1, int(cfg.flows))
    creator_clients = [
        RESTClient(HTTPTransport(creator_url, binary=True, timeout=180.0,
                                 user=f"tenant-{i:02d}",
                                 spread=fleet_procs is not None))
        for i in range(n_flows)
    ]

    # continuous telemetry (kubernetes_tpu/telemetry): the driver-side
    # collector scrapes this process's registry — and every apiserver
    # replica process — into a TSDB each second, runs the SLO engine
    # over the history, and arms the flight recorder. A firing alert
    # dumps a bundle immediately; a breached gate always dumps one at
    # the end (even though the fleet is torn down by then — the http
    # targets' /healthz + /debug/flowcontrol state is cached per tick
    # exactly so a dead process can still testify). The
    # KUBERNETES_TPU_TELEMETRY=0 kill switch (and the bench A/B
    # control arm riding it) turns all of this off.
    telemetry_ctx = None
    from kubernetes_tpu_torch import telemetry as _telemetry

    if _telemetry.enabled():
        import tempfile as _tempf

        from kubernetes_tpu_torch.telemetry import scrape as _tscrape
        from kubernetes_tpu_torch.telemetry.flight import FlightRecorder
        from kubernetes_tpu_torch.telemetry.slo import Engine, default_rules
        from kubernetes_tpu_torch.telemetry.tsdb import TSDB

        _tdb = TSDB(interval=1.0,
                    retention_samples=max(600, int(seconds) + 120))
        _teng = Engine(_tdb, rules=default_rules(slo_seconds=slo))
        _tdir = str(params.get("flight_dir", "")) or _tempf.mkdtemp(
            prefix="flight-recorder-")
        _tflight = FlightRecorder(
            _tdb, _tdir, window=float(seconds) + 120.0, engine=_teng)
        _teng.on_fire = lambda alert: _tflight.record(
            "alert-" + alert["alert"])
        _tcoll = _tscrape.Collector(
            _tdb, interval=1.0, engine=_teng, flight=_tflight)
        _tcoll.add_registry("driver")
        if fleet_procs is not None:
            _tcoll.attach_fleet(fleet_procs)
            _tflight.add_state_source("fleet", _tcoll.proc_state)
        for label, srv in (("apiserver", api), ("apiserver-2", api2)):
            if srv is not None:
                _tflight.add_state_source(
                    label,
                    (lambda s: lambda: (
                        s.flowcontrol.state() if s.flowcontrol
                        is not None else {"enabled": False}))(srv))
        _tcoll.start()
        owned_default = _tscrape.default() is None
        if owned_default:
            _tscrape.set_default(_tcoll)
        telemetry_ctx = (_tcoll, _teng, _tflight, owned_default)
        print(f"# wire-soak: telemetry collector on "
              f"({len(_tcoll.jobs())} targets, flight bundles -> "
              f"{_tdir})", file=sys.stderr)

    stop = threading.Event()
    lock = threading.Lock()
    created: dict = {}          # name -> create time (unbound pods)
    bound_order: deque = deque()  # names in bind order (churn victims)
    latencies: list = []        # (observe time, created->bound seconds)
    counts = {"created": 0, "bound": 0, "deleted": 0,
              "creator_sheds": 0, "creator_errors": 0,
              "driver_watch_events": 0, "driver_relists": 0}
    rng = random.Random(1729)
    #: burst scenario dials this mid-run; the creator reads it per tick
    rate_scale = [1.0]
    scenario_state: Dict[str, object] = {}

    def _scenario_time(key: str) -> Optional[float]:
        """Block until the main loop publishes timestamp `key` (set
        right after the worker threads start); None = stopping."""
        while True:
            ts = scenario_state.get(key)
            if ts is not None:
                return ts
            if stop.wait(0.05):
                return None

    def pod_template(name: str) -> Pod:
        return Pod(
            metadata=ObjectMeta(name=name,
                                labels={"name": "sched-perf"}),
            spec=PodSpec(containers=[Container(
                requests={"cpu": "100m", "memory": "500Mi"})]),
        )

    # steady-state bound population (prefilled during the warm ramp);
    # smokes shrink it so the ramp fits a CI-sized window
    churn_floor = int(params.get("churn_floor",
                                 max(2048, int(rate * 8))))

    def _create_chunk(cc: RESTClient, due: List[str]) -> None:
        """One bulk create, with shed accounting: a 429 that survived
        the transport's Retry-After backoff is a counted shed, not a
        death sentence for the creator."""
        t0 = time.time()
        with lock:
            for nm in due:
                created[nm] = t0
            counts["created"] += len(due)
        try:
            cc.pods().create_many([pod_template(nm) for nm in due])
        except Exception as e:
            shed = isinstance(e, APIStatusError) and e.code == 429
            if not shed and not stop.is_set():
                print(f"# wire-soak creator error: {e}",
                      file=sys.stderr)
            with lock:
                for nm in due:
                    created.pop(nm, None)
                counts["created"] -= len(due)
                if shed:
                    counts["creator_sheds"] += len(due)
                else:
                    counts["creator_errors"] += 1

    def creator_loop():
        """Poisson arrivals at `rate` pods/s: exponential inter-arrival
        gaps accumulated per 100ms tick, the tick's due pods riding one
        bulk-create request (an RC manager bursts its replica delta the
        same way), round-robined across the tenant flows. Starts with a
        burst straight to the churn floor: steady-state node occupancy
        — and the value-vocab program shapes it compiles — must be
        reached INSIDE the warm ramp, deterministically."""
        serial = 0
        for i in range(0, churn_floor, 1500):
            if stop.is_set():
                return
            due = [f"soak-{serial + j:08d}"
                   for j in range(min(1500, churn_floor - i))]
            serial += len(due)
            _create_chunk(creator_clients[0], due)
        next_arrival = time.monotonic()
        tick_i = 0
        while not stop.is_set():
            if scenario_state.get("pause_create"):
                # a scenario is running its lost-acks audit: hold the
                # arrival stream, resume the Poisson clock after
                stop.wait(0.1)
                next_arrival = time.monotonic()
                continue
            tick_end = time.monotonic() + 0.1
            due = []
            eff_rate = rate * rate_scale[0]
            while next_arrival <= tick_end:
                due.append(f"soak-{serial:08d}")
                serial += 1
                next_arrival += rng.expovariate(eff_rate)
            if due:
                _create_chunk(
                    creator_clients[tick_i % len(creator_clients)], due)
                tick_i += 1
            delay = tick_end - time.monotonic()
            if delay > 0:
                stop.wait(delay)

    observer_stream = [None]

    def observer_loop():
        """created->bound latency probe: one full pod watch (the
        measurement apparatus, not the product path) records the first
        time each soak pod shows up with a node assigned."""
        pods = client.pods()
        first = True
        while not stop.is_set():
            try:
                if not first:
                    with lock:
                        counts["driver_relists"] += 1
                objs, rv = pods.list()
                now = time.time()
                with lock:
                    for p in objs:
                        if not p.spec.node_name:
                            continue  # unbound: keep its create stamp
                        t0 = created.pop(p.metadata.name, None)
                        if t0 is not None:
                            latencies.append((now, now - t0))
                            bound_order.append(p.metadata.name)
                            counts["bound"] += 1
                first = False
                stream = pods.watch(resource_version=rv)
                observer_stream[0] = stream
                for ev_type, obj in stream:
                    if stop.is_set():
                        return
                    now = time.time()
                    with lock:
                        counts["driver_watch_events"] += 1
                        if ev_type == "DELETED" or not obj.spec.node_name:
                            continue
                        t0 = created.pop(obj.metadata.name, None)
                        if t0 is not None:
                            latencies.append((now, now - t0))
                            bound_order.append(obj.metadata.name)
                            counts["bound"] += 1
            except Exception as e:
                if stop.is_set():
                    return
                print(f"# wire-soak observer error: {e}",
                      file=sys.stderr)
                stop.wait(0.5)

    def churn_loop():
        """Balanced deletion: once the bound population passes the
        floor, delete oldest-first at arrival rate (through the batch
        door), so steady-state population — and therefore honest RSS —
        is flat and the fleet's deletion-observation path runs hot."""
        while not stop.is_set():
            if scenario_state.get("pause_churn"):
                # lost-acks audit in flight: deleting now would race
                # the expected-names snapshot into false positives
                stop.wait(0.25)
                continue
            victims = []
            with lock:
                while (len(bound_order) > churn_floor
                       and len(victims) < 1024):
                    victims.append(bound_order.popleft())
            if victims:
                try:
                    client.commit_batch([
                        batch_delete_item("pods", nm) for nm in victims
                    ])
                    with lock:
                        counts["deleted"] += len(victims)
                except Exception as e:
                    if not stop.is_set():
                        print(f"# wire-soak churn error: {e}",
                              file=sys.stderr)
            stop.wait(0.5)

    threads = [
        threading.Thread(target=creator_loop, name="soak-creator",
                         daemon=True),
        threading.Thread(target=observer_loop, name="soak-observer",
                         daemon=True),
        threading.Thread(target=churn_loop, name="soak-churn",
                         daemon=True),
    ]

    # -- scenario machinery ---------------------------------------------------
    # Each scenario contributes: optional setup now (before the main
    # threads start), a mid-run thread, and a finish hook that writes
    # its accounting + gates into the record after the steady window.

    scenario_threads: List[threading.Thread] = []
    scenario_cleanup: List = []
    finish_hooks: List = []

    if cfg.scenario == "noisy-neighbor":
        abuser_threads = int(params.get("abuser_threads", 12))
        abuser_pace = float(params.get("abuser_pace", 0.0))
        abuser_burst_interval = float(
            params.get("abuser_burst_interval", 0.0))
        # JSON, not the TLV splice path: the naive abusive client pays
        # (and charges the server) the full reflective encode per LIST,
        # so its dispatched requests hold their seats long enough that
        # a burst reliably overflows the flow's hand — and the GIL cost
        # APF is defending against is real
        abuser_transports = [
            HTTPTransport(url, timeout=60.0,
                          user="tenant-abuser", retry_429=0)
            for _ in range(abuser_threads)
        ]
        abuse_counts = {"requests": 0, "ok": 0, "throttled": 0,
                        "errors": 0}  # guarded by `lock`

        abuse_bulk = int(params.get("abuse_bulk", 400))

        def abuser_loop(tr):
            """One abusive worker: bulk creates whose every item fails
            validation (`spec.containers: required value` — the whole
            body is decoded and validated per item INSIDE the request's
            APF seat, then nothing is stored: expensive for the server,
            zero side effects on the cluster under test) interleaved
            with selector LISTs (the label filter also runs in-seat;
            the raw-splice fast path can't serve it), re-issued as fast
            as the server answers — no backoff, no manners. Abuse
            begins MID-WARM: the warm ramp must contain every traffic
            mode the steady window will see (the same reason the churn
            floor prefills during warm), so the bind-lag excursion
            shapes the abuse provokes compile before the
            zero-recompile gate arms."""
            t_abuse = _scenario_time("t_abuse")
            if t_abuse is None:
                return
            while time.time() < t_abuse:
                if stop.wait(0.25):
                    return
            bad_bulk = {
                "kind": "List",
                "items": [{
                    "kind": "Pod", "apiVersion": "v1",
                    "metadata": {"generateName": "abuse-"},
                    "spec": {"containers": []},
                } for _ in range(abuse_bulk)],
            }
            i = 0
            while not stop.is_set():
                if abuser_burst_interval:
                    # thundering-herd mode: every thread wakes on the
                    # same wall-clock boundary, so each burst arrives
                    # abuser_threads-wide at once — wider than the
                    # flow's hand capacity by construction, so APF
                    # sheds part of every burst deterministically
                    # instead of depending on box-speed timing
                    now = time.time()
                    nxt = (int(now / abuser_burst_interval) + 1
                           ) * abuser_burst_interval
                    if stop.wait(max(0.0, nxt - now)):
                        return
                try:
                    if i % 4 == 3:
                        code, _ = tr.request(
                            "GET", "/api/v1/namespaces/default/pods",
                            query={"labelSelector": "name=sched-perf"})
                    else:
                        code, _ = tr.request(
                            "POST", "/api/v1/namespaces/abuse/pods",
                            body=bad_bulk)
                    with lock:
                        abuse_counts["requests"] += 1
                        if code == 429:
                            abuse_counts["throttled"] += 1
                        else:
                            abuse_counts["ok"] += 1
                except Exception:
                    if stop.is_set():
                        return
                    with lock:
                        abuse_counts["errors"] += 1
                    stop.wait(0.05)
                i += 1
                if abuser_pace:
                    stop.wait(abuser_pace)

        scenario_threads = [
            threading.Thread(target=abuser_loop, args=(tr,),
                             name=f"abuser-{i:02d}", daemon=True)
            for i, tr in enumerate(abuser_transports)
        ]
        scenario_cleanup.append(
            lambda: [tr.close() for tr in abuser_transports])

        def finish_noisy(record, gates, steady_lat, t_steady):
            with lock:
                acct = dict(abuse_counts)
            acct["abuser_sheds_429"] = sum(
                tr.stats["sheds_429"] for tr in abuser_transports)
            record["scenario_accounting"] = acct
            # the abuser must be eating 429s (APF shedding its flow) —
            # except in the APF-off control arm, whose point is that
            # nothing sheds and the SLO breaches instead
            if cfg.apf:
                gates["abuser_throttled"] = acct["throttled"] > 0
                gates["well_behaved_zero_sheds"] = (
                    record["creator_sheds"] == 0)

        finish_hooks.append(finish_noisy)

    elif cfg.scenario == "rack-failure":
        from kubernetes_tpu_torch.apiserver.fields import format_in_clause
        from kubernetes_tpu_torch.controller.framework import (
            SharedInformerFactory,
        )
        from kubernetes_tpu_torch.controller.node_lifecycle import (
            NodeLifecycleController,
        )

        fail_count = int(params.get("fail_count", 30))
        grace = float(params.get("grace", 3.0))
        eviction_timeout = float(params.get("eviction_timeout", 1.0))
        eviction_qps = float(params.get("eviction_qps", 100.0))
        monitor_period = float(params.get("monitor_period", 0.5))
        rack_slo = float(params.get("rack_slo", 30.0))
        ctrl_client = RESTClient(HTTPTransport(
            url, binary=True, timeout=180.0,
            user="system:kube-controller-manager",
        ))
        informers = SharedInformerFactory(ctrl_client)
        nlc = NodeLifecycleController(
            ctrl_client, informers,
            node_monitor_grace_period=grace,
            pod_eviction_timeout=eviction_timeout,
            eviction_qps=eviction_qps,
        )
        informers.start()
        if not informers.wait_for_sync(60):
            raise RuntimeError("node-lifecycle informers never synced")
        nlc.run(period=monitor_period)
        scenario_cleanup.append(nlc.stop)
        scenario_cleanup.append(informers.stop)
        scenario_cleanup.append(lambda: ctrl_client.transport.close())

        def rack_loop():
            """Fail the rack ~40% into the steady window, then time the
            eviction wave: store empty of pods on dead nodes."""
            t_steady = _scenario_time("t_steady")
            if t_steady is None:
                return
            t_mid = t_steady + 0.4 * (
                scenario_state["deadline"] - t_steady)
            while time.time() < t_mid:
                if stop.wait(0.25):
                    return
            dead = fleet.fail_nodes(fail_count)
            t_fail = time.time()
            scenario_state["t_fail"] = t_fail
            scenario_state["dead_nodes"] = len(dead)
            print(f"# rack-failure: {len(dead)} nodes vanished",
                  file=sys.stderr)
            selector = format_in_clause("spec.nodeName", dead)
            pods = client.resource("pods")
            while not stop.is_set():
                try:
                    objs, _rv = pods.list(field_selector=selector)
                except Exception:
                    stop.wait(0.5)
                    continue
                scenario_state["stranded_pods"] = len(objs)
                if not objs and "t_evicted" not in scenario_state:
                    scenario_state["t_evicted"] = time.time()
                    print("# rack-failure: eviction wave complete in "
                          f"{scenario_state['t_evicted'] - t_fail:.1f}s",
                          file=sys.stderr)
                    return
                stop.wait(0.5)

        scenario_threads = [threading.Thread(
            target=rack_loop, name="rack-failure", daemon=True)]

        def finish_rack(record, gates, steady_lat, t_steady):
            t_fail = scenario_state.get("t_fail")
            t_evicted = scenario_state.get("t_evicted")
            wave = (t_evicted - t_fail) if t_fail and t_evicted else None
            record["scenario_accounting"] = {
                "nodes_failed": scenario_state.get("dead_nodes", 0),
                "eviction_wave_seconds": (
                    round(wave, 2) if wave is not None else None),
                "stranded_pods_at_stop": scenario_state.get(
                    "stranded_pods"),
                "rack_slo_seconds": rack_slo,
            }
            gates["eviction_wave_within_slo"] = (
                wave is not None and wave <= rack_slo)

        finish_hooks.append(finish_rack)

    elif cfg.scenario == "rolling-update":
        from kubernetes_tpu_torch.api import types as t
        from kubernetes_tpu_torch.controller.framework import (
            SharedInformerFactory,
        )
        from kubernetes_tpu_torch.controller.replication import (
            ReplicationManager,
        )

        replicas = int(params.get("replicas", 45))
        step = int(params.get("step", 15))
        rolling_slo = float(params.get("rolling_slo", 40.0))
        ctrl_client = RESTClient(HTTPTransport(
            url, binary=True, timeout=180.0,
            user="system:kube-controller-manager",
        ))
        informers = SharedInformerFactory(ctrl_client)
        rc_mgr = ReplicationManager(ctrl_client, informers)
        informers.start()
        if not informers.wait_for_sync(60):
            raise RuntimeError("rc-manager informers never synced")
        rc_mgr.run()
        scenario_cleanup.append(rc_mgr.stop)
        scenario_cleanup.append(informers.stop)
        scenario_cleanup.append(lambda: ctrl_client.transport.close())

        def _rc(version: str, n: int) -> "t.ReplicationController":
            labels = {"app": "roll", "ver": version}
            return t.ReplicationController(
                metadata=t.ObjectMeta(name=f"roll-{version}"),
                spec=t.ReplicationControllerSpec(
                    selector=dict(labels),
                    replicas=n,
                    template=t.PodTemplateSpec(
                        metadata=t.ObjectMeta(labels=dict(labels)),
                        spec=t.PodSpec(containers=[t.Container(
                            name="app",
                            image=f"app:{version}",
                            requests={"cpu": "100m",
                                      "memory": "500Mi"},
                        )]),
                    ),
                ),
            )

        rcs = client.resource("replicationcontrollers", "default")

        def _bound_count(version: str) -> int:
            objs, _ = client.pods().list(
                label_selector=f"app=roll,ver={version}")
            return sum(1 for p in objs if p.spec.node_name)

        def _scale(version: str, n: int) -> None:
            # conflict-retried: the live ReplicationManager writes
            # rc.status concurrently, so the optimistic-concurrency
            # 409 between our get and update is expected traffic
            from kubernetes_tpu_torch.client.rest import APIStatusError

            for _ in range(20):
                live = rcs.get(f"roll-{version}")
                live.spec.replicas = n
                try:
                    rcs.update(live)
                    return
                except APIStatusError as e:
                    if e.code != 409:
                        raise
                    stop.wait(0.05)
            raise RuntimeError(f"roll-{version} scale to {n} kept "
                               "conflicting")

        def _wait_bound(version: str, want: int, cmp: str) -> bool:
            while not stop.is_set():
                have = _bound_count(version)
                if (have >= want) if cmp == "ge" else (have <= want):
                    return True
                stop.wait(0.5)
            return False

        def _roll_steps(src: str, dst: str) -> bool:
            """kubectl rolling-update shape: grow dst a step, shrink
            src a step, until dst is at full replicas."""
            up = 0
            down = replicas
            while up < replicas and not stop.is_set():
                up = min(replicas, up + step)
                _scale(dst, up)
                if not _wait_bound(dst, up, "ge"):
                    return False
                down = max(0, down - step)
                _scale(src, down)
                if not _wait_bound(src, down, "le"):
                    return False
            return not stop.is_set()

        prep_done = threading.Event()
        scenario_state["prep_done"] = prep_done

        def rolling_loop():
            """The warm ramp runs one FULL roll v1->v2 and rolls back:
            every (v1, v2) population state — and therefore every label
            vocabulary and wave shape — the measured roll will visit
            has already compiled when the zero-recompile gate arms (the
            same reason the churn floor prefills during warm). The main
            loop holds the gates blind until `prep_done`, so a
            contended box overrunning the nominal ramp shrinks the
            steady window instead of leaking prep compiles into it.
            The measured roll runs in the steady window."""
            try:
                rcs.create(_rc("v1", replicas))
                if not _wait_bound("v1", replicas, "ge"):
                    return
                rcs.create(_rc("v2", 0))
                if not _roll_steps("v1", "v2"):
                    return
                if not _roll_steps("v2", "v1"):
                    return
            finally:
                prep_done.set()
            t_steady = _scenario_time("t_steady_actual")
            if t_steady is None:
                return
            while time.time() < t_steady:
                if stop.wait(0.25):
                    return
            t0 = time.time()
            scenario_state["roll_started"] = t0
            if not _roll_steps("v1", "v2"):
                return
            scenario_state["roll_finished"] = time.time()
            scenario_state["v2_bound"] = _bound_count("v2")
            rcs.delete("roll-v1")
            print("# rolling-update: v1->v2 complete in "
                  f"{scenario_state['roll_finished'] - t0:.1f}s",
                  file=sys.stderr)

        scenario_threads = [threading.Thread(
            target=rolling_loop, name="rolling-update", daemon=True)]

        def finish_rolling(record, gates, steady_lat, t_steady):
            compile_budget = int(params.get("compile_budget", 0))
            if compile_budget:
                # see SCENARIOS["rolling-update"]["smoke"]: an explicit
                # declared tolerance, not a silently skipped gate
                record["compile_budget"] = compile_budget
                gates["zero_steady_state_compiles"] = (
                    record["steady_state_compiles"] <= compile_budget)
            t0 = scenario_state.get("roll_started")
            t1 = scenario_state.get("roll_finished")
            took = (t1 - t0) if t0 and t1 else None
            record["scenario_accounting"] = {
                "replicas": replicas,
                "step": step,
                "rolling_update_seconds": (
                    round(took, 2) if took is not None else None),
                "v2_bound_at_finish": scenario_state.get("v2_bound"),
                "rolling_slo_seconds": rolling_slo,
            }
            gates["rolling_update_within_slo"] = (
                took is not None and took <= rolling_slo)
            gates["rolling_update_fully_bound"] = (
                scenario_state.get("v2_bound") == replicas)

        finish_hooks.append(finish_rolling)

    elif cfg.scenario == "burst":
        factor = float(params.get("factor", 10.0))
        burst_seconds = float(params.get("burst_seconds", 3.0))
        recovery_seconds = float(params.get("recovery_seconds", 5.0))

        def burst_loop():
            """10x the Poisson rate for a burst window ~35% into the
            steady window; queues must absorb it and p99 must recover
            by the post-burst window."""
            t_steady = _scenario_time("t_steady")
            if t_steady is None:
                return
            t_mid = t_steady + 0.35 * (
                scenario_state["deadline"] - t_steady)
            while time.time() < t_mid:
                if stop.wait(0.1):
                    return
            scenario_state["burst_start"] = time.time()
            rate_scale[0] = factor
            print(f"# burst: rate x{factor:g} for {burst_seconds:g}s",
                  file=sys.stderr)
            stop.wait(burst_seconds)
            rate_scale[0] = 1.0
            scenario_state["burst_end"] = time.time()

        scenario_threads = [threading.Thread(
            target=burst_loop, name="burst", daemon=True)]

        def finish_burst(record, gates, steady_lat, t_steady):
            b0 = scenario_state.get("burst_start")
            b1 = scenario_state.get("burst_end")
            with lock:
                recovered = sorted(
                    dt for (ts, dt) in latencies
                    if b1 is not None
                    and ts >= b1 + recovery_seconds)
                burst_win = [
                    dt for (ts, dt) in latencies
                    if b0 is not None and b1 is not None
                    and b0 <= ts < b1 + recovery_seconds]
            p99_rec = (
                recovered[min(len(recovered) - 1,
                              int(0.99 * len(recovered)))]
                if recovered else None)
            record["scenario_accounting"] = {
                "burst_factor": factor,
                "burst_seconds": burst_seconds,
                "burst_window_binds": len(burst_win),
                "p99_recovered_seconds": (
                    round(p99_rec, 4) if p99_rec is not None else None),
            }
            # the steady p99 gate would indict the burst window itself;
            # the burst contract is absorb-then-recover, so the SLO
            # gate applies OUTSIDE the burst+recovery interval
            with lock:
                outside = sorted(
                    dt for (ts, dt) in latencies
                    if ts >= t_steady and (
                        b0 is None or ts < b0
                        or ts >= b1 + recovery_seconds))
            if outside:
                p99_out = outside[min(len(outside) - 1,
                                      int(0.99 * len(outside)))]
                gates["p99_within_slo"] = p99_out <= slo
                record["p99_outside_burst_seconds"] = round(p99_out, 4)
            gates["p99_recovered"] = (
                p99_rec is not None and p99_rec <= slo)
            gates["burst_zero_sheds"] = record["creator_sheds"] == 0

        finish_hooks.append(finish_burst)

    elif cfg.scenario == "process-kill":
        if fleet_procs is None:
            raise ValueError(
                "process-kill requires the multi-process profile "
                "(procs >= 3)")
        from kubernetes_tpu_torch.harness import procs as procs_mod

        kill_slo = float(params.get("kill_slo", 15.0))
        #: term -> set of node ids EVER observed leading it (merged by
        #: the poller; the at-most-one-leader-per-term gate reads it)
        term_claims: Dict[int, set] = {}

        def term_poller():
            while not stop.is_set():
                try:
                    for t, who in fleet_procs.leader_terms().items():
                        term_claims.setdefault(t, set()).update(who)
                except Exception:
                    pass
                stop.wait(0.2)

        def _probe_recovery(label: str) -> Optional[float]:
            """Seconds until a fresh write commits end-to-end again
            (None = never inside kill_slo + margin)."""
            probe = client.resource("pods")
            t0 = time.time()
            n = 0
            while not stop.is_set() and time.time() - t0 < kill_slo + 30:
                name = f"killprobe-{label}-{n}"
                n += 1
                try:
                    from kubernetes_tpu_torch.api.types import (
                        Container,
                        ObjectMeta,
                        Pod,
                        PodSpec,
                    )

                    probe.create(Pod(
                        metadata=ObjectMeta(name=name),
                        spec=PodSpec(containers=[Container(
                            requests={"cpu": "1m"})]),
                    ))
                    took = time.time() - t0
                    try:
                        probe.delete(name)
                    except Exception:
                        pass
                    return took
                except Exception:
                    stop.wait(0.2)
            return None

        def kill_loop():
            t_steady = _scenario_time("t_steady")
            if t_steady is None:
                return
            window = scenario_state["deadline"] - t_steady
            acct = scenario_state.setdefault("kills", {})

            def at(frac):
                target = t_steady + frac * window
                while time.time() < target:
                    if stop.wait(0.2):
                        return False
                return True

            # (a) kill -9 the lease-holding LEADER apiserver
            if not at(0.15):
                return
            lead = fleet_procs.leader()
            if lead is not None:
                print(f"# process-kill: kill -9 leader apiserver "
                      f"{lead.node_id} (pid {lead.pid})",
                      file=sys.stderr)
                lead.kill()
                acct["leader_kill_recovery_seconds"] = _probe_recovery(
                    "leader")
                # restart the dead replica on the same data_dir +
                # ports: raft replays, the member re-joins under
                # traffic (pre-vote keeps the rejoin term-silent) —
                # which also restores the majority headroom the
                # follower kill below needs
                try:
                    fleet_procs.restart(lead)
                    acct["leader_restarted"] = True
                except Exception as e:
                    acct["leader_restarted"] = False
                    print(f"# process-kill: restart failed: {e}",
                          file=sys.stderr)
            # (b) kill -9 a FOLLOWER apiserver (only with >= 3 live
            # members so the survivors keep a majority)
            if not at(0.45):
                return
            followers = fleet_procs.followers()
            live = [r for r in fleet_procs.replicas if r.alive()]
            if followers and len(live) >= 3:
                victim = followers[0]
                print(f"# process-kill: kill -9 follower apiserver "
                      f"{victim.node_id} (pid {victim.pid})",
                      file=sys.stderr)
                victim.kill()
                acct["follower_kill_recovery_seconds"] = \
                    _probe_recovery("follower")
            elif followers:
                acct["follower_kill_skipped"] = True
            # (c) kill -9 the ACTIVE scheduler (HA mode only)
            if sched_procs:
                if not at(0.7):
                    return
                holder = procs_mod.scheduler_lease_holder(client)
                victim_s = next((p for p in sched_procs
                                 if p.identity == holder and p.alive()),
                                None)
                if victim_s is not None:
                    print(f"# process-kill: kill -9 active scheduler "
                          f"{victim_s.identity} (pid {victim_s.pid})",
                          file=sys.stderr)
                    t0 = time.time()
                    victim_s.kill()
                    # recovery = a fresh pod gets BOUND by the standby
                    with lock:
                        bound_before = counts["bound"]
                    while not stop.is_set() and \
                            time.time() - t0 < kill_slo + 60:
                        with lock:
                            if counts["bound"] > bound_before:
                                break
                        stop.wait(0.25)
                    with lock:
                        recovered = counts["bound"] > bound_before
                    acct["scheduler_failover_seconds"] = (
                        round(time.time() - t0, 2) if recovered
                        else None)
            # lost-acks audit at ~88% of the window: pause the
            # writers, snapshot what was acked, verify the store
            # still holds every bit of it
            if not at(0.88):
                return
            scenario_state["pause_create"] = True
            scenario_state["pause_churn"] = True
            try:
                time.sleep(1.0)  # in-flight creates/deletes land
                with lock:
                    expected = set(created) | set(bound_order)
                pods_cl = client.resource("pods")
                listed = None
                for _ in range(10):
                    try:
                        objs, _rv = pods_cl.list(
                            label_selector="name=sched-perf")
                        listed = {p.metadata.name for p in objs}
                        break
                    except Exception:
                        stop.wait(0.5)
                if listed is not None:
                    missing = expected - listed
                    scenario_state["lost_acked_writes"] = len(missing)
                    if missing:
                        print("# process-kill: LOST ACKED WRITES: "
                              + ", ".join(sorted(missing)[:10]),
                              file=sys.stderr)
                else:
                    scenario_state["lost_acked_writes"] = None
            finally:
                scenario_state["pause_create"] = False
                scenario_state["pause_churn"] = False

        scenario_threads = [
            threading.Thread(target=kill_loop, name="process-kill",
                             daemon=True),
            threading.Thread(target=term_poller,
                             name="process-kill-terms", daemon=True),
        ]

        def finish_kill(record, gates, steady_lat, t_steady):
            compile_budget = int(params.get("compile_budget", 0))
            if compile_budget:
                # kill-induced backlog excursions visit wave shapes
                # the warm ramp could not have seen (the stall's
                # burst); a small declared tolerance, recorded, same
                # convention as the rolling-update smoke
                record["compile_budget"] = compile_budget
                gates["zero_steady_state_compiles"] = (
                    record["steady_state_compiles"] <= compile_budget)
            acct = dict(scenario_state.get("kills", {}))
            acct["kill_slo_seconds"] = kill_slo
            acct["lost_acked_writes"] = scenario_state.get(
                "lost_acked_writes")
            acct["terms_observed"] = {
                str(t): sorted(who) for t, who in term_claims.items()
            }
            record["scenario_accounting"] = acct
            lk = acct.get("leader_kill_recovery_seconds")
            gates["leader_kill_recovered"] = (
                lk is not None and lk <= kill_slo)
            fk = acct.get("follower_kill_recovery_seconds")
            if "follower_kill_recovery_seconds" in acct:
                gates["follower_kill_recovered"] = (
                    fk is not None and fk <= kill_slo)
            if sched_procs:
                sf = acct.get("scheduler_failover_seconds")
                gates["scheduler_failover_recovered"] = (
                    sf is not None and sf <= kill_slo)
            gates["zero_lost_acked_writes"] = (
                acct["lost_acked_writes"] == 0)
            gates["at_most_one_leader_per_term"] = all(
                len(who) <= 1 for who in term_claims.values())
            # the flat-RSS-per-process gate is a STEADY-STATE leak
            # detector; this scenario migrates leadership (the new
            # leader legitimately grows: log window, forwarded-write
            # evaluation, watch fan-out state) and kills members
            # mid-window — the drift stays recorded, the gate is the
            # plain multi-process soak's job
            gates.pop("rss_flat_per_process", None)
            if record["watch_events_dropped"] < 0:
                # a killed member's counters left the scrape sum; the
                # SURVIVORS report zero drops (negative delta = death
                # arithmetic, not an actual drop)
                gates["zero_dropped_watch_events"] = True

        finish_hooks.append(finish_kill)

    elif cfg.scenario:
        raise ValueError(f"unknown scenario {cfg.scenario!r}")

    def snap_counters():
        if fleet_procs is not None:
            # the control plane lives in OTHER processes: every gate
            # counter is scraped from the replicas' /metrics and
            # summed (the driver's in-process registry only sees its
            # own client-side families)
            from kubernetes_tpu_torch.telemetry.expo import series_sum

            rows = fleet_procs.scrape_raw()

            def g(name, **lb):
                return series_sum(rows, name, **lb)

            return {
                "quorum": {
                    "leader_changes": g("quorum_leader_changes_total"),
                    "snapshot_installs":
                        g("quorum_snapshot_installs_total"),
                    "lease_reads": g("quorum_lease_reads_total"),
                    "readindex_rounds":
                        g("quorum_readindex_rounds_total"),
                    "prevote_rounds": g("quorum_prevote_rounds_total"),
                },
                "requests": g("apiserver_requests_total"),
                "events_sent": g("apiserver_watch_events_sent_total"),
                "cache_hits": g("apiserver_watch_cache_hits_total"),
                "cache_misses":
                    g("apiserver_watch_cache_misses_total"),
                "dropped": g("storage_watch_events_dropped_total"),
                "pruned": g("storage_watch_fanout_pruned_total"),
                "ring_evictions":
                    g("storage_watch_cache_ring_evictions_total"),
                "frames":
                    g("apiserver_watch_coalesced_frame_objects_count"),
                "frame_objects":
                    g("apiserver_watch_coalesced_frame_objects_sum"),
                "frame_bytes":
                    g("apiserver_watch_coalesced_frame_bytes_sum"),
                "compiles": sentinel.compile_count(),
                "fleet": fleet.snapshot_stats(),
                "apf_dispatched":
                    g("apiserver_flowcontrol_dispatched_requests_total"),
                "apf_rejected":
                    g("apiserver_flowcontrol_rejected_requests_total"),
                "apf_rejected_by_level": {
                    lvl: g("apiserver_flowcontrol_rejected_requests"
                           "_total", priority_level=lvl)
                    for lvl in ("workload-high", "workload-low",
                                "catch-all")
                },
                "apf_exempt_wait_sum": g(
                    "apiserver_flowcontrol_request_wait_duration"
                    "_seconds_sum", priority_level="exempt"),
                "apf_exempt_wait_count": g(
                    "apiserver_flowcontrol_request_wait_duration"
                    "_seconds_count", priority_level="exempt"),
            }
        if quorum_stores:
            from kubernetes_tpu_torch.metrics import (
                quorum_leader_changes_total,
                quorum_lease_reads_total,
                quorum_readindex_rounds_total,
                quorum_prevote_rounds_total,
                quorum_snapshot_installs_total,
            )

            quorum_extra = {
                "leader_changes": quorum_leader_changes_total.total(),
                "snapshot_installs":
                    quorum_snapshot_installs_total.get(),
                "lease_reads": quorum_lease_reads_total.get(),
                "readindex_rounds":
                    quorum_readindex_rounds_total.get(),
                "prevote_rounds": quorum_prevote_rounds_total.get(),
            }
        else:
            quorum_extra = {}
        exempt_wait = (
            apiserver_flowcontrol_request_wait_duration_seconds.labels(
                "exempt"))
        return {
            "quorum": quorum_extra,
            "requests": apiserver_requests_total.total(),
            "events_sent": apiserver_watch_events_sent_total.get(),
            "cache_hits": apiserver_watch_cache_hits_total.get(),
            "cache_misses": apiserver_watch_cache_misses_total.get(),
            "dropped": storage_watch_events_dropped_total.get(),
            "pruned": storage_watch_fanout_pruned_total.get(),
            "ring_evictions":
                storage_watch_cache_ring_evictions_total.get(),
            "frames": apiserver_watch_coalesced_frame_objects.count,
            "frame_objects":
                apiserver_watch_coalesced_frame_objects.sum,
            "frame_bytes": apiserver_watch_coalesced_frame_bytes.sum,
            "compiles": sentinel.compile_count(),
            "fleet": fleet.snapshot_stats(),
            "apf_dispatched":
                apiserver_flowcontrol_dispatched_requests_total.total(),
            "apf_rejected":
                apiserver_flowcontrol_rejected_requests_total.total(),
            "apf_rejected_by_level": {
                lvl: _rejected_by_level(lvl)
                for lvl in ("workload-high", "workload-low",
                            "catch-all")
            },
            "apf_exempt_wait_sum": exempt_wait.sum,
            "apf_exempt_wait_count": exempt_wait.count,
        }

    record = {"metric": "wire_soak", "seconds": seconds,
              "hollow_nodes": num_nodes,
              "arrival_rate_pods_per_sec": rate,
              "slo_p99_seconds": slo,
              "store_profile": ("quorum-procs" if fleet_procs is not None
                                else cfg.store_profile),
              "apiserver_processes": (cfg.procs if fleet_procs is not None
                                      else 0),
              "ha_schedulers": len(sched_procs),
              "apf": cfg.apf,
              "scenario": cfg.scenario or None,
              "well_behaved_flows": n_flows}
    try:
        for th in threads + scenario_threads:
            th.start()
        t_start = time.time()
        # wide enough that the pre-fill binds, churn opens, and the
        # vocab-growth compiles all land before the gates arm — but
        # never more than half the run, so short smokes keep a
        # non-empty steady window
        warm_secs = min(max(15.0, 0.33 * seconds), 45.0,
                        0.5 * seconds)
        deadline = t_start + seconds
        warm_end = t_start + warm_secs
        # deadline/t_abuse first: scenario threads block on t_steady
        # and then read the others without re-checking
        scenario_state["deadline"] = deadline
        scenario_state["t_abuse"] = t_start + 0.5 * warm_secs
        scenario_state["t_steady"] = warm_end
        # warm ramp: arrivals flow, compiles/caches settle, gates blind
        while time.time() < warm_end:
            time.sleep(0.25)
        # scenario prep (e.g. the rolling warm roll) may overrun the
        # nominal ramp on a contended box; hold the gates blind until
        # it reports done rather than let its compiles leak into the
        # steady window
        prep = scenario_state.get("prep_done")
        if prep is not None:
            # bounded: a wedged prep (scheduler stall, RC regression)
            # must surface as a gate breach at the run deadline, not
            # hang the soak forever
            while not prep.wait(0.25):
                if time.time() > deadline:
                    print("# wire-soak: scenario prep never finished; "
                          "arming gates anyway", file=sys.stderr)
                    break
        base = snap_counters()
        rss_samples = [rss_mb()]
        # per-replica RSS series keyed by (node, pid): a killed or
        # restarted process starts a fresh series, so the flat-RSS
        # gate judges each process's own steady window only
        proc_rss: Dict[tuple, list] = {}

        def _sample_proc_rss():
            if fleet_procs is None:
                return
            from kubernetes_tpu_torch.harness.procs import proc_rss_mb

            for r in fleet_procs.replicas:
                if r.alive():
                    proc_rss.setdefault(
                        (r.node_id, r.pid), []).append(
                        proc_rss_mb(r.pid))

        _sample_proc_rss()
        t_steady = time.time()
        scenario_state["t_steady_actual"] = t_steady
        next_rss = t_steady + 1.0
        while time.time() < deadline:
            time.sleep(0.25)
            if time.time() >= next_rss:
                rss_samples.append(rss_mb())
                _sample_proc_rss()
                next_rss += 1.0
        end = snap_counters()
        steady_secs = time.time() - t_steady
        # diagnostics while the stack is still up: what the store
        # holds (leak forensics) and what compiled mid-steady-state
        from collections import Counter as _Counter

        if api is not None:
            with api.store._lock:
                store_counts = _Counter(
                    k.split("/")[1] for k in api.store._data)
            record["store_objects_at_stop"] = dict(store_counts)
        if fleet_procs is not None:
            record["apiserver_process_accounting"] = \
                fleet_procs.accounting()
            # member statuses must be read while the replicas are
            # still alive (the finally block kills them)
            record.setdefault("quorum_statuses_at_stop", [
                r.quorum_status() for r in fleet_procs.replicas
                if r.alive()
            ])
        with sentinel._mu:
            steady_compile_events = [
                ev for ev, _dur in sentinel.events[int(base["compiles"]):]
            ]
        if steady_compile_events:
            print("# steady-state compiles: "
                  + ", ".join(steady_compile_events), file=sys.stderr)
    finally:
        stop.set()
        if telemetry_ctx is not None:
            # one deterministic final scrape while the replicas are
            # still alive, then park the collector thread; the TSDB
            # and the cached process state stay readable for the
            # post-gate summary and any breach bundle below
            try:
                telemetry_ctx[0].tick()
            except Exception:
                pass
            telemetry_ctx[0].stop()
        if observer_stream[0] is not None:
            try:
                observer_stream[0].stop()
            except Exception:
                pass
        for th in threads + scenario_threads:
            th.join(timeout=10)
        for fn in scenario_cleanup:
            try:
                fn()
            except Exception:
                pass
        fleet.stop()
        if sched is not None:
            sched.stop()
        for sp in sched_procs:
            sp.kill()
        if api is not None:
            api.shutdown_http()
            api.close_cachers()
        if api2 is not None:
            api2.shutdown_http()
            api2.close_cachers()
        if fleet_procs is not None:
            fleet_procs.stop()
        for qs in quorum_stores:
            try:
                qs.close()
            except Exception:
                pass
        for c in [c for c in (sched_client, fleet_client, client)
                  if c is not None] + creator_clients:
            try:
                c.transport.close()
            except Exception:
                pass

    with lock:
        steady_lat = sorted(
            dt for (t, dt) in latencies if t >= t_steady)
        final_counts = dict(counts)
        backlog = len(created)

    def pct(q):
        if not steady_lat:
            return None  # renders as JSON null, not bare NaN
        return round(steady_lat[min(len(steady_lat) - 1,
                                    int(q * len(steady_lat)))], 4)

    p50, p99 = pct(0.50), pct(0.99)
    d = {k: end[k] - base[k] for k in end
         if k not in ("fleet", "quorum", "apf_rejected_by_level")}
    apf_rej_by_level = {
        lvl: end["apf_rejected_by_level"][lvl]
        - base["apf_rejected_by_level"][lvl]
        for lvl in end["apf_rejected_by_level"]
    }
    fleet_d = {k: end["fleet"][k] - base["fleet"][k]
               for k in end["fleet"]}
    rss_base = statistics.median(rss_samples[:5])
    rss_end = statistics.median(rss_samples[-5:])
    rss_drift = (rss_end - rss_base) / max(rss_base, 1.0)
    rss_delta_mb = rss_end - rss_base
    creator_stats = {
        key: sum(c.transport.stats[key] for c in creator_clients)
        for key in ("sheds_429", "retries_429", "giveups_429",
                    "failovers_503", "retries_503")
    }
    record.update({
        "steady_seconds": round(steady_secs, 1),
        "pods_created": final_counts["created"],
        "pods_bound": final_counts["bound"],
        "pods_deleted": final_counts["deleted"],
        "creator_sheds": final_counts["creator_sheds"],
        "creator_errors": final_counts["creator_errors"],
        "creator_transport": creator_stats,
        "bind_backlog_at_stop": backlog,
        "steady_bound_pods_per_sec": round(
            len(steady_lat) / max(steady_secs, 1e-9), 1),
        "p50_created_to_bound_seconds": p50,
        "p99_created_to_bound_seconds": p99,
        "steady_state_compiles": int(d["compiles"]),
        "rss_start_mb": round(rss_base, 1),
        "rss_end_mb": round(rss_end, 1),
        "rss_drift_frac": round(rss_drift, 4),
        "watch_events_dropped": int(d["dropped"]),
        "driver_relists": final_counts["driver_relists"],
        "flowcontrol": {
            # all steady-window deltas, like every other accounting
            # row: metrics are process-global, and lifetime totals
            # would cross-contaminate sequential runs in one process
            "dispatched": int(d["apf_dispatched"]),
            "rejected_requests_total": int(d["apf_rejected"]),
            "rejected_by_level": (
                {k: int(v) for k, v in apf_rej_by_level.items()}
                if cfg.apf else {}),
            "exempt_wait_sum_seconds": round(
                d["apf_exempt_wait_sum"], 6),
            "exempt_dispatches": int(d["apf_exempt_wait_count"]),
        },
        "steady_accounting": {
            "apiserver_requests": int(d["requests"]),
            "watch_events_sent": int(d["events_sent"]),
            "watch_events_delivered_fleet": int(
                fleet_d["watch_events"]),
            "watch_events_delivered_driver": final_counts[
                "driver_watch_events"],
            "watch_cache_hits": int(d["cache_hits"]),
            "watch_cache_misses": int(d["cache_misses"]),
            "fanout_pruned": int(d["pruned"]),
            "ring_evictions": int(d["ring_evictions"]),
            "coalesced_frames": int(d["frames"]),
            "coalesced_frame_objects": int(d["frame_objects"]),
            "coalesced_frame_bytes": int(d["frame_bytes"]),
            "fleet_heartbeats": int(fleet_d["heartbeats"]),
            "fleet_transitions": int(fleet_d["transitions"]),
            "fleet_deletions_observed": int(
                fleet_d["deletions_observed"]),
            "fleet_batch_requests": int(fleet_d["batch_requests"]),
            "fleet_relists": int(fleet_d["relists"]),
        },
    })
    if quorum_stores or fleet_procs is not None:
        qacct = {
            "members": (len(quorum_stores) if quorum_stores
                        else cfg.procs),
            "steady_leader_changes": int(
                end["quorum"]["leader_changes"]
                - base["quorum"]["leader_changes"]),
            "steady_snapshot_installs": int(
                end["quorum"]["snapshot_installs"]
                - base["quorum"]["snapshot_installs"]),
            # the lease economics: steady reads should ride the lease
            # (lease_reads grows) with ZERO read-index heartbeat
            # rounds — the structural gate below holds it
            "steady_lease_reads": int(
                end["quorum"]["lease_reads"]
                - base["quorum"]["lease_reads"]),
            "steady_readindex_rounds": int(
                end["quorum"]["readindex_rounds"]
                - base["quorum"]["readindex_rounds"]),
            "steady_prevote_rounds": int(
                end["quorum"]["prevote_rounds"]
                - base["quorum"]["prevote_rounds"]),
        }
        if quorum_stores:
            from kubernetes_tpu_torch.metrics import quorum_append_rtt_seconds

            qacct["append_rtt_p50_seconds"] = \
                quorum_append_rtt_seconds.percentile(0.50)
            qacct["append_rtt_p99_seconds"] = \
                quorum_append_rtt_seconds.percentile(0.99)
            qacct["statuses"] = [s.quorum_status()
                                 for s in quorum_stores]
        else:
            qacct["statuses"] = record.pop("quorum_statuses_at_stop",
                                           [])
        record["quorum_accounting"] = qacct
    gates = {
        "p99_within_slo": bool(steady_lat) and p99 <= slo,
        "zero_steady_state_compiles": d["compiles"] == 0,
        # a breach needs BOTH a >10% drift and a real absolute delta:
        # on the jax-warm GB-scale driver the 10% bar implies far more
        # than 48 MB (so nothing weakened there), while a small young
        # process's warmup MBs no longer read as a leak
        "rss_flat": (abs(rss_drift) <= 0.10
                     or abs(rss_delta_mb) <= 48.0),
        "zero_dropped_watch_events": d["dropped"] == 0,
    }
    if (quorum_stores or fleet_procs is not None) and \
            not cfg.scenario:
        # structural lease gate (steady traffic only — chaos
        # scenarios legitimately pay confirm rounds around kills and
        # elections): reads ride the lease, the heartbeat-round
        # counter stays flat while lease reads grow
        qa = record["quorum_accounting"]
        gates["lease_reads_no_readindex_rounds"] = (
            qa["steady_lease_reads"] > 0
            and qa["steady_readindex_rounds"] == 0)
    if fleet_procs is not None:
        # flat RSS per PROCESS: every replica that lived through the
        # whole steady window must hold its resident set (a killed or
        # restarted process has a short series and is judged only if
        # it gathered enough samples). A young process legitimately
        # grows a few MB as pools/caches/codecs warm, which reads as
        # a large FRACTION of a small interpreter over a short smoke
        # — so a breach needs BOTH a >10% drift and a real absolute
        # delta; an hours-long leak clears the absolute bar easily.
        per_proc = {}
        per_proc_mb = {}
        for (node, _pid), series in proc_rss.items():
            if len(series) < 10:
                continue
            p_base = statistics.median(series[:5])
            p_end = statistics.median(series[-5:])
            per_proc[node] = round(
                (p_end - p_base) / max(p_base, 1.0), 4)
            per_proc_mb[node] = round(p_end - p_base, 1)
        record["apiserver_rss_drift_frac"] = per_proc
        record["apiserver_rss_drift_mb"] = per_proc_mb
        gates["rss_flat_per_process"] = all(
            abs(per_proc[n]) <= 0.10 or abs(per_proc_mb[n]) <= 48.0
            for n in per_proc)
    if cfg.apf:
        # system traffic measurably never queues: the exempt level's
        # wait histogram must not have accumulated any waiting — AND
        # must actually have been exercised (an anti-vacuity floor: a
        # classification regression that pushed the control plane out
        # of the exempt level would zero the count, not just the sum)
        gates["exempt_system_never_queued"] = (
            d["apf_exempt_wait_sum"] <= 1e-3
            and d["apf_exempt_wait_count"] > 0)
    for hook in finish_hooks:
        hook(record, gates, steady_lat, t_steady)
    record["gates"] = gates
    record["ok"] = all(gates.values())

    if telemetry_ctx is not None:
        coll, eng, flight, owned_default = telemetry_ctx
        db = coll.db
        peak_bind = max(
            (v for _t, v in db.rate_over_time(
                "kubemark_fleet_pod_transitions_total")),
            default=0.0)
        peak_req = max(
            (v for _t, v in db.rate_over_time(
                "apiserver_requests_total")),
            default=0.0)
        record["telemetry"] = {
            "ticks": coll.ticks(),
            "jobs": coll.jobs(),
            "series": db.series_count(),
            "samples": db.sample_count(),
            "series_dropped": db.dropped(),
            "alert_timeline": eng.history(),
            "alerts_at_stop": eng.active(),
            "peak_bind_rate_pods_per_sec": round(peak_bind, 1),
            "peak_apiserver_request_rate_per_sec": round(peak_req, 1),
            "flight_dir": flight.out_dir,
        }
        if not record["ok"]:
            # a failed gate ALWAYS leaves a bundle — debounce
            # bypassed, because the alert-triggered dump seconds ago
            # does not carry the gate verdicts this one does
            bundle = flight.record(
                "soak-gate-breach",
                extra={"gates": gates,
                       "failed": sorted(k for k, v in gates.items()
                                        if not v)},
                force=True)
            record["flight_bundle"] = bundle
            print(f"# wire-soak: gate breach -> flight bundle "
                  f"{bundle}", file=sys.stderr)
        if owned_default:
            from kubernetes_tpu_torch.telemetry import scrape as _tscrape

            _tscrape.release_default(coll)

    # -- A/B control arm (noisy-neighbor): prove APF causes the
    # protection — same scenario, APF off, must demonstrably degrade
    if cfg.scenario == "noisy-neighbor" and cfg.ab_compare and cfg.apf:
        control_cfg = SoakConfig(
            seconds=cfg.seconds, num_nodes=cfg.num_nodes, rate=cfg.rate,
            slo=cfg.slo, store_profile=cfg.store_profile,
            scenario=cfg.scenario, params=dict(cfg.params),
            apf=False, ab_compare=False, flows=cfg.flows,
            device=cfg.device,
        )
        print("# noisy-neighbor A/B: running APF-off control arm",
              file=sys.stderr)
        control = run_wire_soak(control_cfg)
        c_p99 = control.get("p99_created_to_bound_seconds")
        record["ab_control"] = {
            "p99_created_to_bound_seconds": c_p99,
            "creator_sheds": control.get("creator_sheds"),
            "abuser": control.get("scenario_accounting"),
            "gates": control.get("gates"),
        }
        protected_p99 = p99 if p99 is not None else float("inf")
        degraded = (
            c_p99 is None
            or c_p99 > slo
            or c_p99 >= 2.0 * max(protected_p99, 1e-9)
        )
        record["gates"]["apf_protection_demonstrated"] = degraded
        record["ok"] = all(record["gates"].values())
    return record
