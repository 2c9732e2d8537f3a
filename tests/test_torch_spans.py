"""The spans inside one schedule_backlog call (trace/spans.py's record,
totals and window) and trace/timeline.py's clock alignment and idle
attribution.

A CPU call records its named spans nested under
scheduler.schedule_backlog, with perf_counter_ns stamps inside their
parent's; self and total seconds add up; with tracing off nothing is
recorded and no total moves. The alignment is held to synthetic device
traces with a known offset.
"""

import time

import pytest

import kubernetes_tpu_torch.api.types as TT
from kubernetes_tpu_torch.harness import scenarios as S
from kubernetes_tpu_torch.oracle import ClusterState
from kubernetes_tpu_torch.parallel.shard import DeviceMesh
from kubernetes_tpu_torch.scheduler.algorithm import TorchScheduleAlgorithm
from kubernetes_tpu_torch.trace import spans, timeline
from kubernetes_tpu_torch.trace.spans import TraceBuffer

ROOT = "scheduler.schedule_backlog"
#: the spans one zoned call records under its root, each at least once
CALL_SPANS = {"encode.dedup", "encode.nodes", "encode.pods", "encode.pad",
              "wave.setup", "wave.classify", "wave.pod_row",
              "wave.replay.launch", "wave.replay.wait", "scheduler.results"}


@pytest.fixture
def tracing():
    was = spans.enabled()
    spans.set_enabled(True)
    yield
    spans.set_enabled(was)


def zoned_call(algo=None, nodes=9, pods=60):
    """One zoned backlog call (one RC template onto zoned nodes: the
    device replay's route) -> (the spans it recorded, oldest first, the
    algorithm)."""
    state = ClusterState.build(
        S.zoned_density_nodes(TT, nodes, zones=("a", "b")),
        services=[S.service(TT, "svc", {"name": "sched-perf"})])
    algo = algo or TorchScheduleAlgorithm(device="cpu")
    before = spans.BUFFER.total_recorded
    hosts = algo.schedule_backlog(S.pause_pods(TT, pods), state)
    assert None not in hosts
    return spans.BUFFER.since(before), algo


def children_of(recs):
    kids = {}
    for r in recs:
        kids.setdefault(r["parent_id"], []).append(r)
    return kids


def test_a_call_records_its_spans_under_one_root(tracing):
    recs, algo = zoned_call()
    assert "zreplay" in algo._wave.dispatches
    roots = [r for r in recs if r["name"] == ROOT]
    assert len(roots) == 1
    root = roots[0]
    assert root["attrs"] == {"pods": 60, "reps": 1, "nodes": 9}
    assert {r["name"] for r in recs} == CALL_SPANS | {ROOT}
    nodes = [r for r in recs if r["name"] == "encode.nodes"]
    assert [r["attrs"] for r in nodes] == [{"nodes": 9, "volume_pods": 0}]
    by_id = {r["span_id"]: r for r in recs}
    for r in recs:
        assert r["trace_id"] == root["trace_id"]
        assert r["start_ns"] <= r["end_ns"]
        if r is root:
            continue
        parent = by_id[r["parent_id"]]
        assert parent is root
        assert parent["start_ns"] <= r["start_ns"] <= r["end_ns"] \
            <= parent["end_ns"]
    launch = [r for r in recs if r["name"] == "wave.replay.launch"]
    assert [r["attrs"] for r in launch] == [{"k3": 1}]
    # the root's children run one after another, in call order
    kids = sorted(children_of(recs)[root["span_id"]],
                  key=lambda r: r["start_ns"])
    assert [r["name"] for r in kids][:4] == [
        "encode.dedup", "encode.nodes", "encode.pods", "encode.pad"]
    assert kids[-1]["name"] == "scheduler.results"
    for a, b in zip(kids, kids[1:]):
        assert a["end_ns"] <= b["start_ns"]


def test_the_mesh_call_records_its_encode_spans(tracing):
    algo = TorchScheduleAlgorithm(device="cpu", mesh=DeviceMesh(["cpu"] * 2))
    recs, _ = zoned_call(algo)
    root = next(r for r in recs if r["name"] == ROOT)
    assert root["attrs"] == {"pods": 60, "reps": 1, "nodes": 9}
    nodes = [r for r in recs if r["name"] == "encode.nodes"]
    assert [r["attrs"] for r in nodes] == [{"nodes": 9, "volume_pods": 0}]
    names = {r["name"] for r in recs
             if r["parent_id"] == root["span_id"]}
    assert {"encode.dedup", "encode.nodes", "encode.pods", "encode.pad",
            "scheduler.results"} <= names


def test_the_node_encode_span_counts_assigned_pods_with_volumes(tracing):
    """volume_pods counts the assigned pods that carry volumes, which take
    the volume compiler's per-pod path; the others are skipped."""
    nodes = S.zoned_density_nodes(TT, 4, zones=("a", "b"))
    disk = TT.Volume(name="d", gce_persistent_disk=TT.GCEPersistentDisk(
        pd_name="pd-1", read_only=True))
    bound = [TT.Pod(metadata=TT.ObjectMeta(name=f"b{i}"),
                    spec=TT.PodSpec(node_name=n.metadata.name,
                                    containers=[TT.Container()],
                                    volumes=[disk] if i % 2 else []))
             for i, n in enumerate(nodes * 2)]
    state = ClusterState.build(nodes, assigned_pods=bound)
    before = spans.BUFFER.total_recorded
    TorchScheduleAlgorithm(device="cpu").schedule_backlog(
        S.pause_pods(TT, 8), state)
    recs = spans.BUFFER.since(before)
    nodes_recs = [r for r in recs if r["name"] == "encode.nodes"]
    assert [r["attrs"] for r in nodes_recs] == [
        {"nodes": 4, "volume_pods": 4}]


def test_self_and_total_seconds_add_up(tracing):
    before = spans.BUFFER.totals()
    n0 = spans.BUFFER.total_recorded
    with spans.span("t.outer"):
        with spans.span("t.inner"):
            time.sleep(0.002)
        with spans.span("t.inner"):
            with spans.span("t.leaf"):
                time.sleep(0.002)
        time.sleep(0.001)
    recs = spans.BUFFER.since(n0)
    kids = children_of(recs)
    for r in recs:
        covered = sum(c["duration"] for c in kids.get(r["span_id"], ()))
        assert r["self"] == pytest.approx(r["duration"] - covered, abs=1e-9)
        assert r["duration"] == pytest.approx(
            (r["end_ns"] - r["start_ns"]) / 1e9, abs=1e-9)
    outer = next(r for r in recs if r["name"] == "t.outer")
    assert sum(r["self"] for r in recs) == pytest.approx(outer["duration"],
                                                         abs=1e-9)
    assert outer["self"] >= 0.001
    after = spans.BUFFER.totals()
    for name, n in (("t.outer", 1), ("t.inner", 2), ("t.leaf", 1)):
        mine = [r for r in recs if r["name"] == name]
        assert after["count"][name] - before["count"].get(name, 0) == n
        assert after["seconds"][name] - before["seconds"].get(
            name, 0) == pytest.approx(sum(r["duration"] for r in mine))
        assert after["self_seconds"][name] - before["self_seconds"].get(
            name, 0) == pytest.approx(sum(r["self"] for r in mine))


def test_a_calls_self_times_sum_to_its_wall(tracing):
    recs, _ = zoned_call()
    root = next(r for r in recs if r["name"] == ROOT)
    assert sum(r["self"] for r in recs) == pytest.approx(root["duration"],
                                                         abs=1e-6)
    assert 0 <= root["self"] < root["duration"]


def test_a_span_under_an_adopted_remote_parent_adds_no_child_time(tracing):
    n0 = spans.BUFFER.total_recorded
    with spans.span("t.local") as local:
        with spans.trace_context(spans.new_trace_id()):
            with spans.span("t.remote_child"):
                time.sleep(0.002)
    rec = {r["name"]: r for r in spans.BUFFER.since(n0)}
    assert rec["t.remote_child"]["parent_id"] != local.span_id
    assert rec["t.local"]["self"] == pytest.approx(
        rec["t.local"]["duration"], abs=1e-9)


def test_tracing_off_records_nothing_and_moves_no_total():
    was = spans.enabled()
    spans.set_enabled(False)
    try:
        n0 = spans.BUFFER.total_recorded
        before = spans.BUFFER.totals()
        recs, _ = zoned_call()
        assert recs == []
        assert spans.BUFFER.total_recorded == n0
        assert spans.BUFFER.totals() == before
    finally:
        spans.set_enabled(was)


def test_totals_survive_eviction_and_since_refuses_a_lost_span():
    buf = TraceBuffer(capacity=4)
    for i in range(6):
        buf.record({"trace_id": "t", "span_id": str(i), "name": "s",
                    "start": 0.0, "duration": 1.0, "self": 0.5})
    buf.record({"trace_id": "t", "span_id": "r", "name": "retro",
                "start": 0.0, "duration": 2.0})
    assert buf.totals() == {"count": {"s": 6, "retro": 1},
                            "seconds": {"s": 6.0, "retro": 2.0},
                            "self_seconds": {"s": 3.0, "retro": 2.0}}
    assert [r["span_id"] for r in buf.since(3)] == ["3", "4", "5", "r"]
    assert buf.since(7) == []
    with pytest.raises(LookupError):
        buf.since(2)


# -- trace/timeline -----------------------------------------------------------

MS = 1_000_000


def rec(name, start, end, **attrs):
    r = {"name": name, "start_ns": start, "end_ns": end}
    if attrs:
        r["attrs"] = attrs
    return r


def replay_window(offset):
    """Two calls' spans on the host clock and their device trace on a
    clock `offset` ns behind it (host = device + offset): call 1
    launches one K3 (device 2-8 ms on the host clock), call 2 a group of
    two (13-15 and 15-19 ms)."""
    host = [rec("scheduler.schedule_backlog", 0, 10 * MS),
            rec("encode.dedup", 0, 1 * MS),
            rec("wave.replay.launch", 1 * MS, 3 * MS, k3=1),
            rec("wave.replay.wait", 3 * MS, 9 * MS),
            rec("scheduler.schedule_backlog", 11 * MS, 21 * MS),
            rec("wave.replay.launch", 12 * MS, 14 * MS, k3=2),
            rec("wave.replay.wait", 14 * MS, 20 * MS)]
    dev = [("void zreplay_kernel<32>", 2 * MS, 8 * MS),
           ("Memcpy DtoH", 8 * MS, 8 * MS + MS // 2),
           ("void zreplay_kernel<32>", 13 * MS, 15 * MS),
           ("void zreplay_kernel<32>", 15 * MS, 19 * MS)]
    return host, [(n, s - offset, e - offset) for n, s, e in dev]


def test_clock_offset_finds_the_offset_it_was_given():
    for offset in (0, 1_700_000_000 * 10**9):
        host, dev = replay_window(offset)
        lo, hi, off = timeline.clock_offset(host, dev)
        # each K3 may start as early as its launch began and end as late
        # as the next wait ended: the tightest pairs leave 1 ms each way
        assert (lo, hi) == (offset - MS, offset + MS)
        assert off == offset


def test_clock_offset_raises_where_no_offset_fits_or_events_are_lost():
    host, dev = replay_window(0)
    late = dev[:3] + [(dev[3][0], dev[3][1], 25 * MS)]  # past its wait
    early = [(dev[0][0], -3 * MS, dev[0][2])] + dev[1:]  # before its launch
    with pytest.raises(ValueError, match="no host-minus-device offset"):
        timeline.clock_offset(host, late)
    with pytest.raises(ValueError, match="no host-minus-device offset"):
        timeline.clock_offset(host, early)
    with pytest.raises(ValueError, match="3 zreplay_kernel events in the "
                                         "trace, 1 enqueued"):
        timeline.clock_offset(host[:4], dev)
    with pytest.raises(ValueError, match="no wave.replay.wait span"):
        timeline.clock_offset(host[:3], dev[:1])
    assert timeline.clock_offset(host[:2], []) is None


def test_idle_by_span_under_a_known_offset():
    offset = 5 * 10**12
    host, dev = replay_window(offset)
    idle = timeline.idle_by_span(host, dev, offset, 0, 22 * MS)
    # busy 2-8.5 and 13-19 ms; idle 0-2, 8.5-13, 19-22 ms
    assert idle == {"encode.dedup": 1 * MS,
                    "wave.replay.launch": 1 * MS + 1 * MS,
                    "wave.replay.wait": MS // 2 + 1 * MS,
                    "scheduler.schedule_backlog": 3 * MS,
                    None: 1 * MS + 1 * MS}
    assert sum(idle.values()) == 22 * MS - (6 * MS + MS // 2) - 6 * MS
    # the same trace read as one clock misplaces every kernel
    assert timeline.idle_by_span(host, dev, 0, 0, 22 * MS) == {
        "encode.dedup": 1 * MS, "wave.replay.launch": 4 * MS,
        "wave.replay.wait": 12 * MS, "scheduler.schedule_backlog": 3 * MS,
        None: 2 * MS}
