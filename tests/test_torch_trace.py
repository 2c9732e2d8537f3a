"""The tracing + device-profiling layer (kubernetes_tpu/trace).

Covers: span nesting and context propagation, trace-id continuity
across the TLV wire (apiserver process -> scheduler process as ONE
trace), the per-phase histograms, the /debug/traces and scheduler
/metrics endpoints, SLO-breach Event emission, and the two
storage/replicated.py regressions that rode this PR (stale ack after a
follower reconnect; stalled-follower drop closes the socket).

The cases of tests/test_trace.py, run against the port's copies
(kubernetes_tpu_torch), each with the mark it has there.
The scheduling algorithm and the scheduler daemon run with
device="cpu" (the port's entry points take the card unless asked).
"""

import json
import io
import socket
import threading
import time
import urllib.request

import pytest

import kubernetes_tpu_torch.trace as trace
from kubernetes_tpu_torch.api.types import (
    Container,
    Node,
    NodeCondition,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodSpec,
)
from kubernetes_tpu_torch.trace import profile as trace_profile
from kubernetes_tpu_torch.trace.spans import TraceBuffer

from conftest import wait_until  # noqa: E402


def _node(name="n1"):
    return Node(
        metadata=ObjectMeta(name=name),
        status=NodeStatus(
            allocatable={"cpu": "4", "memory": "32Gi", "pods": "110"},
            conditions=[NodeCondition("Ready", "True")],
        ),
    )


def _pod(name="p1"):
    return Pod(
        metadata=ObjectMeta(name=name),
        spec=PodSpec(containers=[Container(requests={"cpu": "100m"})]),
    )


# -- span API -----------------------------------------------------------------


def test_span_nesting_and_propagation():
    with trace.span("outer", kind="test") as outer:
        assert outer.parent_id is None
        with trace.span("inner") as inner:
            assert inner.trace_id == outer.trace_id
            assert inner.parent_id == outer.span_id
        # sibling after the inner closed: parent is outer again
        with trace.span("sibling") as sib:
            assert sib.parent_id == outer.span_id
    spans = trace.BUFFER.snapshot(trace_id=outer.trace_id)
    # newest first: outer closed last
    assert [s["name"] for s in spans] == ["outer", "sibling", "inner"]
    by_name = {s["name"]: s for s in spans}
    assert by_name["outer"]["attrs"] == {"kind": "test"}
    assert by_name["inner"]["parent_id"] == outer.span_id
    assert all(s["duration"] >= 0 for s in spans)


def test_span_threads_do_not_share_context():
    seen = {}

    def worker():
        with trace.span("thread-root") as s:
            seen["tid"] = s.trace_id
            seen["parent"] = s.parent_id

    with trace.span("main-root") as root:
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    # a fresh thread has no inherited context: it starts its own trace
    assert seen["parent"] is None
    assert seen["tid"] != root.trace_id


def test_trace_context_adopts_remote_trace():
    tid = trace.new_trace_id()
    with trace.trace_context(tid):
        with trace.span("adopted") as s:
            assert s.trace_id == tid
    assert trace.current_trace_id() is None


def test_buffer_ring_limit_and_jsonl_export():
    buf = TraceBuffer(capacity=4)
    for i in range(10):
        buf.record({"trace_id": "t", "span_id": str(i), "name": "s",
                    "start": 0.0, "duration": 0.0})
    assert buf.total_recorded == 10
    snap = buf.snapshot(limit=100)
    assert len(snap) == 4  # ring evicted the oldest
    assert [s["span_id"] for s in snap] == ["9", "8", "7", "6"]
    out = io.StringIO()
    assert buf.export_jsonl(out) == 4
    lines = [json.loads(l) for l in out.getvalue().splitlines()]
    assert [l["span_id"] for l in lines] == ["6", "7", "8", "9"]


def test_disabled_tracing_records_nothing():
    trace.set_enabled(False)
    try:
        before = trace.BUFFER.total_recorded
        with trace.span("never"):
            pass
        with trace_profile.phase_timer("probe"):
            pass
        trace.record_span("never", "sometrace", 0.0, 1.0)
        assert trace.BUFFER.total_recorded == before
        assert trace.inject(_pod()) is None
    finally:
        trace.set_enabled(True)


def test_inject_extract_rides_the_tlv_wire():
    from kubernetes_tpu_torch.runtime import tlv

    pod = _pod()
    tid = trace.inject(pod)
    assert tid and trace.extract(pod) == tid
    # the annotation is ordinary ObjectMeta data: a TLV round trip (the
    # cross-process wire) preserves it bit-for-bit
    decoded = tlv.loads(tlv.dumps(pod))
    assert trace.extract(decoded) == tid
    # injecting under an open span reuses that span's trace
    with trace.span("creator") as s:
        p2 = _pod("p2")
        assert trace.inject(p2) == s.trace_id


# -- phase histograms ---------------------------------------------------------


def test_phase_timer_buckets_and_totals():
    from kubernetes_tpu_torch.metrics import scheduler_wave_phase_seconds

    before = trace_profile.phase_totals()
    assert set(before) == set(trace_profile.PHASES)
    hist = scheduler_wave_phase_seconds.labels("encode")
    count_before = hist.count
    with trace_profile.phase_timer("encode"):
        time.sleep(0.01)
    assert hist.count == count_before + 1
    after = trace_profile.phase_totals()
    delta = after["encode"] - before["encode"]
    assert 0.005 < delta < 5.0
    # rendering carries the phase label on every sample line
    text = scheduler_wave_phase_seconds.render()
    assert 'scheduler_wave_phase_seconds_bucket{phase="encode",le="' in text
    assert 'scheduler_wave_phase_seconds_sum{phase="encode"}' in text


def test_exclusive_accountant_partitions_overlapping_phases():
    """Concurrent phase occurrences must not double-count: two phases
    held open simultaneously on different threads split the elapsed
    window between them (sum <= wall), with the higher-priority phase
    (earlier in PHASES) earning the overlap."""
    from kubernetes_tpu_torch.trace.profile import _ExclusiveAccountant

    acct = _ExclusiveAccountant()
    t0 = time.perf_counter()
    acct.enter("bind")
    time.sleep(0.05)
    acct.enter("encode")  # higher priority: preempts bind's lane
    time.sleep(0.05)
    acct.exit("encode")
    time.sleep(0.05)
    acct.exit("bind")
    wall = time.perf_counter() - t0
    totals = acct.snapshot()
    assert totals["encode"] >= 0.04
    assert totals["bind"] >= 0.08  # the two bind-only stretches
    assert sum(totals.values()) <= wall + 1e-6
    # and close to wall: a phase was active the whole time
    assert sum(totals.values()) >= 0.9 * wall


def test_wave_schedule_populates_phase_histograms():
    """A raw tensor-path backlog leaves encode/score (or probe/replay)
    time in the histograms — the bench breakdown's data source."""
    from kubernetes_tpu_torch.oracle import ClusterState
    from kubernetes_tpu_torch.scheduler.algorithm import TorchScheduleAlgorithm

    before = trace_profile.phase_totals()
    state = ClusterState.build([_node(f"n{i}") for i in range(8)])
    pods = [_pod(f"w{i}") for i in range(32)]
    algo = TorchScheduleAlgorithm(device="cpu")
    hosts = algo.schedule_backlog(pods, state)
    assert all(h is not None for h in hosts)
    after = trace_profile.phase_totals()
    assert after["encode"] > before["encode"]
    device_work = sum(
        after[p] - before[p] for p in ("probe", "score", "replay")
    )
    assert device_work > 0
    assert after["transfer"] > before["transfer"]


# -- SLO watchdog -------------------------------------------------------------


def test_slo_watchdog_emits_breach_event():
    from kubernetes_tpu_torch.client.record import FakeRecorder
    from kubernetes_tpu_torch.metrics import Histogram
    from kubernetes_tpu_torch.trace.slo import SLOWatchdog

    hist = Histogram("test_slo_hist", "")
    rec = FakeRecorder()
    dog = SLOWatchdog(rec, objective_seconds=0.5, histogram=hist)
    # no new observations: never fires
    assert dog.check_once() is False
    # fast observations under the objective: no breach
    hist.observe(1000.0)  # 1ms in microseconds
    assert dog.check_once() is False
    # a slow one breaches (histogram is microsecond-unit)
    for _ in range(100):
        hist.observe(2_000_000.0)  # 2s
    assert dog.check_once() is True
    assert dog.breaches == 1
    assert any("SchedulingSLOBreach" in e for e in rec.events), rec.events
    # no NEW observations since: re-checking must not re-alert
    assert dog.check_once() is False
    # alert-storm regression: the quantile is over the WINDOW delta, so
    # a recovered scheduler (new fast observations) must not keep
    # re-firing off the historical slow tail in the cumulative buckets
    for _ in range(10):
        hist.observe(1000.0)
    assert dog.check_once() is False
    assert dog.breaches == 1


def test_slo_watchdog_event_reaches_apiserver():
    """Daemon wiring: a breach flows recorder -> broadcaster -> sink ->
    a Warning Event on the apiserver, kind Scheduler."""
    from kubernetes_tpu_torch.apiserver.server import APIServer
    from kubernetes_tpu_torch.client.record import EventBroadcaster, EventSink
    from kubernetes_tpu_torch.client.rest import RESTClient
    from kubernetes_tpu_torch.client.transport import LocalTransport
    from kubernetes_tpu_torch.metrics import Histogram
    from kubernetes_tpu_torch.trace.slo import SLOWatchdog

    server = APIServer()
    client = RESTClient(LocalTransport(server))
    broadcaster = EventBroadcaster()
    broadcaster.start_recording_to_sink(EventSink(client))
    hist = Histogram("test_slo_hist2", "")
    dog = SLOWatchdog(
        broadcaster.new_recorder("scheduler"), 0.01, histogram=hist
    )
    for _ in range(50):
        hist.observe(5_000_000.0)
    assert dog.check_once() is True

    def breach_event():
        evs, _ = client.events().in_namespace("kube-system").list()
        return [e for e in evs if e.reason == "SchedulingSLOBreach"]

    assert wait_until(lambda: breach_event(), timeout=10)
    ev = breach_event()[0]
    assert ev.type == "Warning"
    assert ev.involved_object.kind == "Scheduler"
    broadcaster.shutdown()


# -- endpoints ----------------------------------------------------------------


def test_component_server_endpoints():
    from kubernetes_tpu_torch.trace.httpd import start_component_server

    srv, port = start_component_server(name="test")
    try:
        base = f"http://127.0.0.1:{port}"
        assert urllib.request.urlopen(f"{base}/healthz").read() == b"ok"
        metrics = urllib.request.urlopen(f"{base}/metrics").read().decode()
        assert "scheduler_e2e_scheduling_latency" in metrics
        assert "scheduler_xla_compile_seconds" in metrics
        assert "scheduler_wave_phase_seconds" in metrics
        with trace.span("endpoint-span"):
            pass
        traces = json.loads(
            urllib.request.urlopen(f"{base}/debug/traces?limit=5").read()
        )
        assert traces["kind"] == "TraceList" and traces["enabled"]
        assert 0 < len(traces["items"]) <= 5
        assert "endpoint-span" in {s["name"] for s in traces["items"]}
        # 404 for unknown paths
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/nope")
    finally:
        srv.shutdown()
        srv.server_close()


def test_apiserver_debug_traces_route():
    from kubernetes_tpu_torch.apiserver.server import APIServer

    with trace.span("api-route-span"):
        pass
    code, payload = APIServer().handle("GET", "/debug/traces",
                                       {"limit": "10"}, None)
    assert code == 200 and payload["kind"] == "TraceList"
    assert len(payload["items"]) <= 10


def test_kubelet_serves_metrics_and_traces():
    from kubernetes_tpu_torch.apiserver.server import APIServer
    from kubernetes_tpu_torch.client.rest import RESTClient
    from kubernetes_tpu_torch.client.transport import LocalTransport
    from kubernetes_tpu_torch.kubelet.kubelet import Kubelet, KubeletConfig
    from kubernetes_tpu_torch.kubelet.runtime import FakeRuntime
    from kubernetes_tpu_torch.kubelet.server import KubeletServer

    client = RESTClient(LocalTransport(APIServer()))
    kl = Kubelet(client, KubeletConfig(node_name="kn1"), FakeRuntime())
    srv = KubeletServer(kl)
    host, port = srv.serve()
    try:
        base = f"http://{host}:{port}"
        metrics = urllib.request.urlopen(f"{base}/metrics").read().decode()
        assert "scheduler_wave_phase_seconds" in metrics
        traces = json.loads(
            urllib.request.urlopen(f"{base}/debug/traces").read()
        )
        assert traces["kind"] == "TraceList"
    finally:
        srv.shutdown()


# -- end-to-end trace continuity ---------------------------------------------


def test_scheduler_daemon_trace_and_metrics_endpoints():
    """In-process control plane: one annotated pod scheduled through
    the daemon yields apiserver.create + scheduler.schedule +
    scheduler.bind on ONE trace id, and the scheduler's own mux serves
    /metrics with the e2e + compile histograms."""
    from kubernetes_tpu_torch.apiserver.server import APIServer
    from kubernetes_tpu_torch.client.rest import RESTClient
    from kubernetes_tpu_torch.client.transport import LocalTransport
    from kubernetes_tpu_torch.scheduler.server import (
        SchedulerServer,
        SchedulerServerOptions,
    )

    server = APIServer()
    client = RESTClient(LocalTransport(server))
    client.nodes().create(_node())
    sched = SchedulerServer(client, SchedulerServerOptions(device="cpu")).start()
    try:
        assert sched.ready.wait(120), "scheduler never became ready"
        pod = _pod()
        tid = trace.inject(pod)
        client.pods().create(pod)
        assert wait_until(
            lambda: client.pods().get("p1").spec.node_name, timeout=60
        )
        host, port = sched.health_address
        base = f"http://{host}:{port}"
        metrics = urllib.request.urlopen(f"{base}/metrics").read().decode()
        assert "scheduler_e2e_scheduling_latency" in metrics
        assert "scheduler_xla_compile_seconds" in metrics

        def span_names():
            payload = json.loads(urllib.request.urlopen(
                f"{base}/debug/traces?limit=1000&trace={tid}"
            ).read())
            return {s["name"] for s in payload["items"]}

        # bind spans land asynchronously (bind pool)
        assert wait_until(
            lambda: {"apiserver.create", "scheduler.schedule",
                     "scheduler.bind"} <= span_names(),
            timeout=30,
        ), span_names()
    finally:
        sched.stop()


def test_trace_id_crosses_the_tlv_wire_between_processes():
    """The acceptance shape: apiserver in its OWN process on the TLV
    binary wire, scheduler here; the pod's trace id is preserved across
    the process boundary and each process's /debug/traces shows its leg
    of the same trace."""
    import subprocess
    import sys

    from kubernetes_tpu_torch.client.rest import RESTClient
    from kubernetes_tpu_torch.client.transport import HTTPTransport
    from kubernetes_tpu_torch.scheduler.server import (
        SchedulerServer,
        SchedulerServerOptions,
    )

    api_proc = subprocess.Popen(
        [sys.executable, "-m", "kubernetes_tpu_torch.hyperkube", "apiserver",
         "--port", "0", "--enable-binary-wire"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    sched = None
    try:
        url = api_proc.stdout.readline().strip().rsplit(" ", 1)[-1]
        client = RESTClient(HTTPTransport(url, binary=True))
        assert wait_until(client.healthz, timeout=15)
        client.nodes().create(_node())
        sched = SchedulerServer(client, SchedulerServerOptions(device="cpu")).start()
        assert sched.ready.wait(120)
        pod = _pod()
        tid = trace.inject(pod)
        client.pods().create(pod)
        assert wait_until(
            lambda: client.pods().get("p1").spec.node_name, timeout=60
        )
        # the apiserver process recorded its leg (queried over HTTP)
        api_payload = json.loads(urllib.request.urlopen(
            f"{url}/debug/traces?trace={tid}"
        ).read())
        api_names = {s["name"] for s in api_payload["items"]}
        assert "apiserver.create" in api_names
        assert all(s["trace_id"] == tid for s in api_payload["items"])

        # the scheduler process recorded its legs on the SAME trace id
        def sched_names():
            return {
                s["name"]
                for s in trace.BUFFER.snapshot(limit=4096, trace_id=tid)
            }

        assert wait_until(
            lambda: {"scheduler.schedule", "scheduler.bind"}
            <= sched_names(),
            timeout=30,
        ), sched_names()
    finally:
        if sched is not None:
            sched.stop()
        api_proc.terminate()
        api_proc.wait(timeout=10)


# -- replicated.py regressions (satellites) -----------------------------------


def _attach_raw_follower(store, timeout=5.0):
    """Handshake as a follower and read the initial snapshot, acking
    nothing: the stalled-peer simulation."""
    from kubernetes_tpu_torch.storage import replicated as R

    conn = socket.create_connection(store.repl_address, timeout=timeout)
    conn.sendall(R._MAGIC)
    R._read_frame(conn)  # the snapshot
    return conn


def test_stale_ack_from_replaced_follower_is_ignored(tmp_path):
    """ADVICE r5: an ack arriving through a connection that is no
    longer the current follower must not advance _acked — it counts the
    OLD stream's byte offsets and would void the synchronous-commit
    guarantee for the new follower."""
    from kubernetes_tpu_torch.storage import replicated as R
    from kubernetes_tpu_torch.storage.replicated import ReplicatedStore

    store = ReplicatedStore(str(tmp_path / "p"), sync_timeout=2.0)
    try:
        current = _attach_raw_follower(store)
        assert wait_until(lambda: store._follower is not None)
        # a REPLACED connection: hand its server side to an ack loop
        # directly (deterministic stand-in for the raced real thread)
        old_srv, old_peer = socket.socketpair()
        t = threading.Thread(
            target=store._ack_loop, args=(old_srv,), daemon=True
        )
        t.start()
        old_peer.sendall(R._ACK.pack(10**9))  # a huge stale ack
        old_peer.close()
        t.join(timeout=5)
        assert not t.is_alive()
        # the guard: _acked untouched by the stale stream's ack
        assert store._acked == 0
        # and the CURRENT follower was not dropped by the stale loop
        assert store._follower is not None
        current.close()
    finally:
        store.close()


def test_stalled_follower_drop_closes_socket_and_allows_reattach(tmp_path):
    """ADVICE r5: the sync-timeout path must CLOSE the stalled
    follower's socket (not just clear the slot) so the peer observes
    the break and re-attaches instead of serving stale reads forever."""
    from kubernetes_tpu_torch.storage.durable import FileStore
    from kubernetes_tpu_torch.storage.replicated import (
        FollowerStore,
        ReplicatedStore,
    )

    store = ReplicatedStore(str(tmp_path / "p"), sync_timeout=0.3)
    follower = None
    try:
        stalled = _attach_raw_follower(store)
        assert wait_until(lambda: store._follower is not None)
        # a write times out against the silent peer and degrades
        t0 = time.monotonic()
        store.create("/pods/default/a", {"n": 1})
        assert time.monotonic() - t0 >= 0.25
        assert store._follower is None
        # the stalled peer OBSERVES the break: EOF once the buffered
        # frames drain (pre-fix the socket stayed open and this timed
        # out still connected)
        stalled.settimeout(5.0)
        saw_eof = False
        for _ in range(100):
            try:
                if stalled.recv(65536) == b"":
                    saw_eof = True
                    break
            except OSError:
                saw_eof = True  # reset also observes the break
                break
        assert saw_eof, "stalled follower never saw the socket close"
        stalled.close()
        # a fresh follower can attach and replication resumes
        follower = FollowerStore(
            str(tmp_path / "f"), store.repl_address
        )
        assert follower.synced(10)
        store.create("/pods/default/b", {"n": 2})
        assert wait_until(
            lambda: "/pods/default/b" in follower._data, timeout=10
        )
    finally:
        if follower is not None:
            follower.close()
        store.close()


def test_update_batch_isolates_arbitrary_exceptions():
    """ADVICE r5 (store.py): one raising mutation in a bulk bind stays
    with its item instead of 500ing the whole BindingList."""
    from kubernetes_tpu_torch.storage import MemoryStore

    store = MemoryStore()
    store.create("/pods/default/a", {"v": 1})
    store.create("/pods/default/b", {"v": 1})

    def boom(cur):
        raise TypeError("bad mutation")

    def ok(cur):
        cur["v"] = 2
        return cur

    res = store.update_batch([
        ("/pods/default/a", boom),
        ("/pods/default/b", ok),
        ("/pods/default/missing", ok),
    ])
    assert isinstance(res[0], TypeError)
    assert res[1] is None
    assert isinstance(res[2], Exception)
    assert store.get("/pods/default/b")[0]["v"] == 2
    # the poisoned item really did not commit
    assert store.get("/pods/default/a")[0]["v"] == 1


def test_transport_ssl_context_for_any_https_member():
    """ADVICE r5 (transport.py): a mixed endpoint list builds the SSL
    context even when the FIRST member is plain http, and rotation is
    lock-guarded."""
    from kubernetes_tpu_torch.client.transport import HTTPTransport

    t = HTTPTransport("http://a:1,https://b:2")
    assert t._ssl_ctx is not None
    t2 = HTTPTransport("http://a:1,http://b:2")
    assert t2._ssl_ctx is None
    # rotation under concurrent hammering stays in range and makes
    # progress (the lock prevents torn read-modify-writes)
    threads = [
        threading.Thread(
            target=lambda: [t._rotate() for _ in range(500)]
        )
        for _ in range(8)
    ]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert t._active in (0, 1)
