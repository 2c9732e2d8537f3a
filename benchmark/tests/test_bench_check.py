"""The sample of calls the reference re-derives, the capacity check of
every call, and the check's refusal of traffic that the nodes cannot
hold."""

import pytest

from benchmark import run, traffic
from benchmark.reference.scheduler import Cluster
from conftest import BENCH_DIR, ROOT


def description(nodes=10, mix="rc-backlog-10-per-node", seed=1, **alloc):
    manifest = run.load_manifest(ROOT)
    conf = dict(run.load_config(ROOT, manifest, "scheduler-perf-1k-zoned"),
                nodes=nodes)
    if alloc:
        conf["node"] = dict(conf["node"], allocatable=dict(
            conf["node"]["allocatable"], **alloc))
    return traffic.describe(conf, run.load_traffic(BENCH_DIR, mix), seed)


def cluster(desc, s=0):
    return Cluster(desc["states"][s], desc["services"], desc["controllers"],
                   desc["namespace"])


@pytest.mark.parametrize("n,k", [(1, 2), (2, 2), (5, 2), (40, 2), (40, 4),
                                 (7, 10)])
def test_sample_takes_the_last_call_and_both_states(n, k):
    picked = run.sample_calls(n, k, 2**31 + 9)
    assert picked == sorted(set(picked))
    assert picked[-1] == n - 1
    assert len(picked) == min(n, k)
    if n >= 2:
        assert {w % 2 for w in picked} == {0, 1}
    assert picked == run.sample_calls(n, k, 2**31 + 9)


def test_sample_follows_the_seed():
    draws = {tuple(run.sample_calls(200, 4, seed)) for seed in range(20)}
    assert len(draws) > 10


def test_check_refuses_a_backlog_the_nodes_cannot_hold():
    desc = description(pods="9")
    with pytest.raises(SystemExit, match="may hold fewer"):
        run.check(desc, [[]], 2, 1)


def test_sample_covers_check_pods():
    desc = description(nodes=10)
    assert run.sample_size(desc) == run.CHECK_PODS // 100
    desc = description(nodes=10**5 // 5)
    assert run.sample_size(desc) == len(desc["states"])


def test_capacity_of_a_sound_call_holds():
    desc = description(nodes=12, seed=3)
    c = cluster(desc)
    names, _, _ = c.schedule(desc["groups"], 0)
    assert run.capacity_violations(c, desc["groups"], names) == 0


@pytest.mark.parametrize("alloc,piled", [({}, 200), ({"cpu": "1"}, 9),
                                         ({"memory": "4500Mi"}, 9)])
def test_capacity_catches_an_overfull_node(alloc, piled):
    """Pods piled onto one node past its pods, CPU or memory."""
    desc = description(nodes=30, **alloc)
    c = cluster(desc)
    names, _, _ = c.schedule(desc["groups"], 0)
    names[:piled] = [names[0]] * piled
    assert run.capacity_violations(c, desc["groups"], names) == 1


def test_capacity_counts_a_pod_on_no_node():
    desc = description(nodes=12)
    c = cluster(desc)
    names, _, _ = c.schedule(desc["groups"], 0)
    names[5] = "node-that-is-not"
    assert run.capacity_violations(c, desc["groups"], names) == 1


def test_every_call_is_checked_for_capacity(monkeypatch):
    """A call outside the reference's sample that overfills a node is
    caught."""
    monkeypatch.setattr(run, "CHECK_PODS", 100)
    desc = description(nodes=10, seed=5)
    count = traffic.backlog_size(desc)
    outputs = [cluster(desc, g % 2).schedule(desc["groups"], g * count)[0]
               for g in range(2, 12)]
    checks = run.check(desc, outputs, 2, 7)["checks"]
    assert all(v["value"] == 0 for v in checks.values())
    sample = run.sample_calls(10, run.sample_size(desc), 7)
    assert len(sample) == 2
    w = min(set(range(10)) - set(sample))
    outputs[w] = [outputs[w][0]] * count
    checks = run.check(desc, outputs, 2, 7)["checks"]
    assert checks["mismatched_pods"]["value"] == 0
    assert checks["overfull_nodes"]["value"] == 1
