"""Many ReplicationControllers under SelectorSpread: the benchmark's
`rc-spread-500x40` cell (500 RCs x 40 replicas on 3,000 zoned nodes), cut
in counts only, through the port's grouped device replay on the CPU.

The cluster and backlog come from the benchmark's own generator
(benchmark/traffic.py) on the cell's configuration and traffic files:
24 copies of the RC group over 300 zoned nodes, the same widths and
requests, the default min_run. Every run of a call takes one
`zreplay_group` dispatch (models/zreplay.ZReplay.run_group), whose pick
loops run K3's plain version here. The answers are held to the
benchmark's plain NumPy reference (benchmark/reference/scheduler.py) and
to the port's serial oracle; the group's spans to its runs.
"""

import copy

import pytest

from benchmark import run, sut, traffic
from benchmark.reference.scheduler import Cluster

from kubernetes_tpu_torch.oracle import GenericScheduler
from kubernetes_tpu_torch.ops import zreplay_kernel as ZK
from kubernetes_tpu_torch.trace import spans

CONFIG, MIX = "spread-3k-zoned", "rc-spread-500x40"
COPIES, NODES, PODS = 24, 300, 40
SEEDS = (7, 2**31 + 5, 2**40 + 3)
PAUSE = [{"requests": {"cpu": "100m", "memory": "500Mi"}}]


def description(seed, nodes=NODES, copies=COPIES, allocatable=None,
                extra=()):
    """The cell's description cut to `nodes` nodes and `copies` RCs (the
    nodes' allocatable replaced where given; `extra` groups queued after
    the RCs)."""
    manifest = run.load_manifest(run.ROOT)
    conf = dict(run.load_config(run.ROOT, manifest, CONFIG), nodes=nodes)
    if allocatable:
        conf["node"] = {"allocatable": allocatable}
    mix = copy.deepcopy(run.load_traffic(run.BENCH_DIR, MIX))
    mix["groups"][0]["copies"] = copies
    mix["groups"] += list(extra)
    return traffic.describe(conf, mix, seed)


def reference(desc, s):
    return Cluster(desc["states"][s], desc["services"], desc["controllers"],
                   desc["namespace"]).schedule(desc["groups"], 0)[0]


def port_call(desc, s, monkeypatch):
    """Call the port on state s from lastNodeIndex 0. -> (names, the
    system, the pick loops K3's plain version ran)."""
    loops = []
    plain = ZK.replay_picks_plain

    def counted(*args, **kw):
        loops.append(kw["k_real"])
        return plain(*args, **kw)

    monkeypatch.setattr(ZK, "replay_picks_plain", counted)
    system = sut.System(desc, "cpu")
    system.algo._last_node_index = 0
    return system.call(s), system, loops


@pytest.fixture
def tracing():
    was = spans.enabled()
    spans.set_enabled(True)
    yield
    spans.set_enabled(was)


@pytest.mark.parametrize("state", [0, 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_many_rcs_take_one_device_group(seed, state, tracing, monkeypatch):
    desc = description(seed)
    assert len(desc["controllers"]) == COPIES
    before = spans.BUFFER.total_recorded
    got, system, loops = port_call(desc, state, monkeypatch)
    recs = spans.BUFFER.since(before)
    assert None not in got
    assert got == reference(desc, state)
    if seed == SEEDS[0]:
        # the serial oracle takes ~1 minute a call at this size: held to
        # the first seed's two states
        assert got == GenericScheduler().schedule_backlog(
            system.backlog, system.states[state].clone())
    assert system.algo._wave.dispatches == {"zreplay_group": 1}
    assert loops == [PODS] * COPIES

    classify = [r for r in recs if r["name"] == "wave.classify"]
    assert [r["attrs"] for r in classify] == [{"runs": COPIES,
                                               "device_runs": COPIES}]
    (launch,) = [r for r in recs if r["name"] == "wave.replay.launch"]
    assert launch["attrs"] == {"k3": COPIES, "picks": COPIES * PODS,
                               "k_bucket": 64}
    runs = [r for r in recs if r["name"] == "wave.replay.run"]
    assert len(runs) == COPIES
    assert all(r["parent_id"] == launch["span_id"] for r in runs)
    assert sum(r["attrs"]["k"] for r in runs) == launch["attrs"]["picks"]
    assert launch["self"] < launch["duration"]


def test_group_spans_are_off_with_tracing_off(monkeypatch):
    was = spans.enabled()
    spans.set_enabled(False)
    try:
        before = spans.BUFFER.totals()["count"]
        got, _system, _loops = port_call(description(SEEDS[1], copies=4), 0,
                                         monkeypatch)
        assert spans.BUFFER.totals()["count"] == before
    finally:
        spans.set_enabled(was)
    assert None not in got


def test_a_run_past_the_room_stays_in_its_group(monkeypatch):
    """24 RCs onto 24 nodes that hold 936 of their 960 pods: the last
    run's pick loop runs out of fitting nodes mid-run. It ends the run
    (the rest unschedulable), so the group is whole: no run resumes
    alone."""
    desc = description(SEEDS[2], nodes=24)
    got, system, loops = port_call(desc, 0, monkeypatch)
    assert got.count(None) == COPIES * PODS - Cluster(
        desc["states"][0], (), (), "default").room(desc["groups"])
    assert got[-1] is None and None not in got[:-PODS]
    assert got == reference(desc, 0)
    assert got == GenericScheduler().schedule_backlog(
        system.backlog, system.states[0].clone())
    assert system.algo._wave.dispatches == {"zreplay_group": 1}
    assert loops == [PODS] * COPIES


def test_a_run_past_the_table_horizon_resumes_alone(monkeypatch):
    """A group whose last run puts more pods on a node than the probe's
    table holds (1,024 rows): that run's pick loop stops at the horizon,
    the group returns partial, and the rest of the run resumes through
    the single-run device replay, re-probed against the group's commits,
    still equal to the reference."""
    big = {"name": "big", "pods": 2100, "controller": True,
           "labels": {"name": "big"}, "containers": PAUSE}
    desc = description(SEEDS[0], nodes=2, copies=2, extra=[big],
                       allocatable={"cpu": "1000", "memory": "4000Gi",
                                    "pods": "5000"})
    got, system, loops = port_call(desc, 1, monkeypatch)
    assert None not in got
    assert got == reference(desc, 1)
    assert system.algo._wave.dispatches == {"zreplay_group": 1,
                                            "zreplay": 1}
    assert loops[:2] == [PODS, PODS]
    assert sum(loops[2:]) > 2100  # the horizon's run, then the rest
