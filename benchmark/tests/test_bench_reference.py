"""The plain NumPy reference gives the port's decisions
(TorchScheduleAlgorithm on the CPU) at small sizes of both
configurations, and its control (the spread arithmetic in bfloat16)
does not."""

import pytest

from benchmark import run, sut, traffic
from benchmark.reference.scheduler import Cluster, round_bf16
from conftest import BENCH_DIR, ROOT

import numpy as np

#: a backlog of several templates: three RCs' pods in turn, then pods
#: of a template no selector selects, with a CPU request only
MANY = {"why": "a test's mix", "states": 2, "groups": [
    {"name": "rc-{i}", "copies": 3, "pods_per_node": 2, "controller": True,
     "labels": {"name": "rc-{i}"},
     "containers": [{"requests": {"cpu": "100m", "memory": "500Mi"}}]},
    {"name": "batch", "pods": 25, "labels": {"job": "batch"},
     "containers": [{"requests": {"cpu": "300m"}}]}]}


CASES = [
    # config, traffic, nodes, lastNodeIndex at the call, node overrides
    ("kubemark-5k-zoned", "rc-backlog-10-per-node", 60, 0, None),
    ("kubemark-5k-zoned", "rc-backlog-10-per-node", 61, 7 * 610, None),
    ("scheduler-perf-1k-zoned", "rc-backlog-30-per-node", 40, 3 * 1200,
     None),
    # nodes fill: 9 pods a node, fewer than the backlog for some states
    ("scheduler-perf-1k-zoned", "rc-backlog-10-per-node", 30, 11,
     {"cpu": "4", "memory": "32Gi", "pods": "9"}),
    # a node's CPU fills before its pod count
    ("kubemark-5k-zoned", "rc-backlog-30-per-node", 20, 5,
     {"cpu": "2500m", "memory": "32Gi", "pods": "110"}),
    # several templates, each with its own selector
    ("kubemark-5k-zoned", MANY, 30, 2 * 205, None),
    ("scheduler-perf-1k-zoned", MANY, 25, 17,
     {"cpu": "2", "memory": "32Gi", "pods": "110"}),
]


def description(config, mix, nodes, seed, allocatable=None):
    manifest = run.load_manifest(ROOT)
    conf = dict(run.load_config(ROOT, manifest, config), nodes=nodes)
    if allocatable:
        conf["node"] = dict(conf["node"], allocatable=allocatable)
    if isinstance(mix, str):
        mix = run.load_traffic(BENCH_DIR, mix)
    return traffic.describe(conf, mix, seed)


def cluster(desc, s):
    return Cluster(desc["states"][s], desc["services"], desc["controllers"],
                   desc["namespace"])


def reference(desc, s, last, bf16=False):
    return cluster(desc, s).schedule(desc["groups"], last, bf16=bf16)


@pytest.mark.parametrize("config,mix,nodes,last,alloc", CASES)
@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_reference_gives_the_ports_decisions(config, mix, nodes, last,
                                             alloc, seed):
    desc = description(config, mix, nodes, seed, alloc)
    system = sut.System(desc, "cpu")
    for s in range(len(desc["states"])):
        system.algo._last_node_index = last
        got = system.call(s)
        want, want_last, picks = reference(desc, s, last)
        assert got == want
        assert system.algo._last_node_index == want_last
        assert picks > 0


def test_a_full_cluster_leaves_pods_unplaced():
    desc = description("scheduler-perf-1k-zoned", "rc-backlog-10-per-node",
                       30, 4, {"cpu": "4", "memory": "32Gi", "pods": "9"})
    want, last, _ = reference(desc, 0, 0)
    placed = sum(n is not None for n in want)
    assert placed < len(want)
    # lastNodeIndex moves only with a scheduled pod
    assert last == placed


def test_room_bounds_the_backlog():
    desc = description("scheduler-perf-1k-zoned", "rc-backlog-10-per-node",
                       30, 4, {"cpu": "4", "memory": "32Gi", "pods": "9"})
    c = cluster(desc, 0)
    want, _last, _ = c.schedule(desc["groups"], 0)
    assert c.room(desc["groups"]) == sum(n is not None for n in want)


def test_schedule_leaves_the_cluster_as_it_was():
    desc = description("kubemark-5k-zoned", MANY, 20, 3)
    c = cluster(desc, 1)
    first = c.schedule(desc["groups"], 9)
    assert c.schedule(desc["groups"], 9) == first


def test_room_with_several_templates_takes_the_largest_requests():
    desc = description("scheduler-perf-1k-zoned", MANY, 10, 3,
                       {"cpu": "1", "memory": "32Gi", "pods": "110"})
    c = cluster(desc, 0)
    # 1 CPU less the bound pods' 100m each, in 300m pods
    free = (1000 - c.req_cpu) // 300
    assert c.room(desc["groups"]) == int(free.sum())


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("config,mix,nodes", [
    ("kubemark-5k-zoned", "rc-backlog-10-per-node", 300),
    ("scheduler-perf-1k-zoned", "rc-backlog-30-per-node", 100)])
def test_control_in_bfloat16_departs(config, mix, nodes, seed):
    """The control: the reference with SelectorSpread's float32 steps
    rounded to bfloat16 picks other nodes for many pods."""
    desc = description(config, mix, nodes, seed)
    want, _, _ = reference(desc, 0, 0)
    got, _, _ = reference(desc, 0, 0, bf16=True)
    assert sum(a != b for a, b in zip(want, got)) > len(want) // 10


def test_round_bf16():
    x = np.array([1.0, 1.00390625, 1.01171875, 3.3333333, np.nan],
                 np.float32)
    out = round_bf16(x)
    assert out[0] == 1.0 and out[1] == 1.0 and out[2] == 1.015625
    assert out[3] == np.float32(3.328125) and np.isnan(out[4])
