"""Multi-process control plane (round 13): apiserver replicas as
separate OS processes over one quorum behind the multi-endpoint
spread/failover transport, scheduler HA through leader election, and
the 503/refused-connect failover contract.

The tier-1 smoke runs a SHORT 2-apiserver-process soak end-to-end
(hollow fleet -> spread transport -> replica processes -> quorum ->
scheduler -> batched binds -> fleet acks) with every PR-8 integrity
gate armed plus the structural lease gate; the process-kill chaos form
(kill -9 leader / follower / active scheduler mid-soak) is the
slow-marked ``--wire-soak-scenario process-kill`` protocol in bench.py.

The cases of tests/test_multiproc.py, run against the port's copies
(kubernetes_tpu_torch), each with the mark it has there.
The schedulers run with device="cpu" (the port's entry points take the
card unless asked).
"""

import dataclasses
import time

import pytest

from conftest import wait_until  # noqa: E402

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.rest import RESTClient
from kubernetes_tpu_torch.client.transport import HTTPTransport, LocalTransport
from kubernetes_tpu_torch.harness.procs import ApiserverFleet


def _pod(name: str) -> t.Pod:
    return t.Pod(
        metadata=t.ObjectMeta(name=name),
        spec=t.PodSpec(containers=[t.Container(
            requests={"cpu": "100m", "memory": "100Mi"})]),
    )


def _node(name: str) -> t.Node:
    return t.Node(
        metadata=t.ObjectMeta(name=name),
        status=t.NodeStatus(
            allocatable={"cpu": "4", "memory": "32Gi", "pods": "110"},
            conditions=[t.NodeCondition("Ready", "True")],
        ),
    )


@pytest.fixture
def fleet3(tmp_path):
    """Three apiserver replica PROCESSES over one quorum."""
    fleet = ApiserverFleet(3, str(tmp_path / "procs"),
                           election_timeout=0.3).start()
    try:
        yield fleet
    finally:
        fleet.stop()


class TestReplicaProcesses:
    def test_replicas_share_one_quorum_and_serve_reads(self, fleet3):
        """Every replica answers /healthz with its member identity;
        a write through ANY endpoint is readable through every other
        (one quorum behind N frontends)."""
        ids = set()
        for r in fleet3.replicas:
            q = r.quorum_status()
            assert q is not None, r.node_id
            ids.add(q["node"])
            assert set(q["members"]) == {"q0", "q1", "q2"}
        assert ids == {"q0", "q1", "q2"}
        lead = fleet3.leader()
        follower = next(r for r in fleet3.replicas if r is not lead)
        # write through a FOLLOWER frontend (forwarded to the leader)
        wtr = HTTPTransport(follower.url, binary=True, timeout=30.0,
                            user="system:admin",
                            groups=("system:masters",))
        RESTClient(wtr).pods().create(_pod("via-follower"))
        # readable through every replica (linearizable barrier reads)
        for r in fleet3.replicas:
            rtr = HTTPTransport(r.url, binary=True, timeout=30.0,
                                user="system:admin",
                                groups=("system:masters",))
            got = RESTClient(rtr).pods().get("via-follower")
            assert got.metadata.name == "via-follower", r.node_id
            rtr.close()
        wtr.close()

    def test_failover_on_killed_replica(self, fleet3):
        """The killed-member regression for the multi-endpoint
        transport: a dead replica's refused connects and the
        survivors' 503s both rotate the endpoint (counted in
        transport.stats) and the caller's writes keep committing."""
        tr = HTTPTransport(fleet3.urls(), binary=True, timeout=30.0,
                           user="system:admin",
                           groups=("system:masters",), spread=True)
        client = RESTClient(tr)
        pods = client.pods()
        for i in range(4):
            pods.create(_pod(f"pre-{i}"))
        lead = fleet3.leader()
        lead.kill()
        # writes recover through rotation within the failover SLO
        t0 = time.monotonic()
        recovered = False
        while time.monotonic() - t0 < 20:
            try:
                pods.create(_pod(f"post-{int((time.monotonic()-t0)*1e3)}"))
                recovered = True
                break
            except Exception:
                time.sleep(0.2)
        assert recovered, "writes never recovered after the leader kill"
        # the rotation was COUNTED (the regression: only connect
        # errors used to rotate; refused/503 now do too)
        assert tr.stats["failovers_503"] >= 1, tr.stats
        # no acked write lost: everything created pre-kill still lists
        objs, _rv = pods.list()
        names = {p.metadata.name for p in objs}
        assert {f"pre-{i}" for i in range(4)} <= names
        tr.close()

    def test_lease_reads_flat_readindex_rounds(self, fleet3):
        """Structural lease gate at the process level: hammering
        linearizable reads against the replicas grows
        quorum_lease_reads_total while quorum_readindex_rounds_total
        stays flat (scraped from the replicas' /metrics)."""
        lead = fleet3.leader()
        tr = HTTPTransport(lead.url, binary=True, timeout=30.0,
                           user="system:admin",
                           groups=("system:masters",))
        client = RESTClient(tr)
        client.pods().create(_pod("lease-probe"))
        time.sleep(0.7)  # a full heartbeat round so the lease is live
        base = fleet3.scrape()
        # uncached reads: guaranteed_update runs a read_index per CAS
        for i in range(20):
            client.pods().patch("lease-probe",
                                {"metadata": {"labels": {"i": str(i)}}})
        end = fleet3.scrape()
        lease_reads = (end.get("quorum_lease_reads_total", 0)
                       - base.get("quorum_lease_reads_total", 0))
        rounds = (end.get("quorum_readindex_rounds_total", 0)
                  - base.get("quorum_readindex_rounds_total", 0))
        assert lease_reads >= 10, (lease_reads, rounds)
        assert rounds == 0, (lease_reads, rounds)
        tr.close()


class TestMultiProcessSoakSmoke:
    @pytest.mark.slow
    def test_two_process_soak_end_to_end(self):
        """The multi-process soak: 2 apiserver replica processes over
        one quorum, hollow fleet + Poisson arrivals through the spread
        transport, every integrity gate armed (p99, zero recompiles,
        flat RSS per process, zero drops) plus the structural lease
        gate and zero leader churn.

        Slow-marked (round 14 tier-1 budget reclaim): the ~46s soak
        rides the slow lane; tier-1 keeps the replica/failover/lease
        tests above for the multi-process machinery."""
        from kubernetes_tpu_torch.harness.soak import SoakConfig, run_wire_soak

        rec = run_wire_soak(SoakConfig(
            device="cpu",
            seconds=30, num_nodes=64, rate=20.0, slo=5.0, procs=2,
            params={"churn_floor": 256,
                    "quorum_election_timeout": 0.4},
        ))
        assert rec["ok"], rec["gates"]
        assert rec["apiserver_processes"] == 2
        # the lease economics held: steady reads rode the lease,
        # zero read-index heartbeat rounds
        assert rec["gates"]["lease_reads_no_readindex_rounds"]
        qa = rec["quorum_accounting"]
        assert qa["steady_lease_reads"] > 0
        assert qa["steady_readindex_rounds"] == 0
        assert qa["steady_leader_changes"] == 0
        # per-process accounting made it into the record
        assert len(rec["apiserver_process_accounting"]) == 2
        for row in rec["apiserver_process_accounting"]:
            assert row["cpu_seconds"] > 0.0


@pytest.mark.slow
class TestProcessKillScenario:
    """The kill -9 chaos protocol (slow: ~2-5 min each; the tier-1
    budget carries the plain 2-process soak above instead — these are
    the `--wire-soak-scenario process-kill` forms CI runs separately,
    and their recorded runs are in BENCH_r09.json)."""

    def test_smoke(self):
        from kubernetes_tpu_torch.harness.soak import (
            run_wire_soak,
            scenario_config,
        )

        rec = run_wire_soak(dataclasses.replace(scenario_config(
            "process-kill", 70, smoke=True), device="cpu"))
        assert rec["ok"], rec["gates"]
        acct = rec["scenario_accounting"]
        assert acct["lost_acked_writes"] == 0
        assert all(len(v) <= 1
                   for v in acct["terms_observed"].values())

    def test_full_with_scheduler_ha(self):
        from kubernetes_tpu_torch.harness.soak import (
            run_wire_soak,
            scenario_config,
        )

        rec = run_wire_soak(dataclasses.replace(scenario_config(
            "process-kill", 180, smoke=False,
            num_nodes=256, rate=60.0), device="cpu"))
        assert rec["ok"], rec["gates"]
        acct = rec["scenario_accounting"]
        assert acct["scheduler_failover_seconds"] is not None
        assert acct["lost_acked_writes"] == 0


class TestSchedulerHA:
    def test_standby_takes_over_when_holder_dies(self):
        """Scheduler HA through client/leaderelection: two scheduler
        servers share the lease; when the holder CRASHES (no lease
        release — the kill -9 shape), the standby acquires after the
        lease window and schedules new pods inside the SLO."""
        from kubernetes_tpu_torch.scheduler.server import (
            SchedulerServer,
            SchedulerServerOptions,
        )

        server = APIServer()
        client = RESTClient(LocalTransport(server))
        client.nodes().create(_node("n0"))

        def opts(ident):
            return SchedulerServerOptions(
                device="cpu",
                leader_elect=True,
                leader_elect_identity=ident,
                leader_elect_lease_duration=1.2,
                leader_elect_renew_deadline=0.8,
                leader_elect_retry_period=0.3,
                serve_port=None,
            )

        s1 = SchedulerServer(
            RESTClient(LocalTransport(server)), opts("sched-1")
        ).start()
        s2 = None
        try:
            assert wait_until(lambda: s1._elector.is_leader(),
                              timeout=20)
            s2 = SchedulerServer(
                RESTClient(LocalTransport(server)), opts("sched-2")
            ).start()
            # the holder schedules; the standby must NOT
            client.pods().create(_pod("held"))
            assert wait_until(
                lambda: client.pods().get("held").spec.node_name,
                timeout=40)
            time.sleep(0.5)
            assert not s2._elector.is_leader()
            # CRASH the holder: stop its elector WITHOUT releasing the
            # lease (kill -9 never says goodbye), stop its loop
            t0 = time.monotonic()
            s1._elector._stop.set()
            s1.scheduler.stop()
            # the standby acquires after lease expiry and schedules
            assert wait_until(lambda: s2._elector.is_leader(),
                              timeout=20)
            client.pods().create(_pod("after-failover"))
            assert wait_until(
                lambda: client.pods().get(
                    "after-failover").spec.node_name,
                timeout=40)
            took = time.monotonic() - t0
            # lease 1.2s + acquire retries + one scheduling pass; the
            # SLO is generous for a loaded 1-core CI box
            assert took <= 45.0, took
        finally:
            s1.stop()
            if s2 is not None:
                s2.stop()
