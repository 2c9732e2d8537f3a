"""The traffic generator: one seed repeats exactly, seeds differ, and
every seed gets the same sizes."""

import collections
import copy

import pytest

from benchmark import run, traffic
from conftest import BENCH_DIR, ROOT

CELLS = [(c["config"], c["traffic"])
         for c in run.load_manifest(ROOT)["workloads"]]


def describe(config, mix, seed, nodes=300):
    manifest = run.load_manifest(ROOT)
    conf = dict(run.load_config(ROOT, manifest, config), nodes=nodes)
    return traffic.describe(conf, run.load_traffic(BENCH_DIR, mix), seed)


def sizes(desc):
    """What every seed must share: per state, the nodes a zone and the
    bound pods a node as multisets; the backlog."""
    out = []
    for st in desc["states"]:
        zones = collections.Counter(
            tuple(sorted(n["labels"].items())) for n in st["nodes"])
        per_node = collections.Counter(
            collections.Counter(b["node"] for b in st["bound"]).values())
        out.append((len(st["nodes"]), sorted(zones.values()),
                    sorted(per_node.items()), len(st["bound"])))
    return out, desc["groups"], desc["services"], desc["controllers"]


@pytest.mark.parametrize("config,mix", CELLS)
def test_one_seed_repeats_exactly(config, mix):
    assert describe(config, mix, 2**31 + 17) == describe(config, mix,
                                                         2**31 + 17)


@pytest.mark.parametrize("config,mix", CELLS)
def test_seeds_differ_in_order_only(config, mix):
    a, b = describe(config, mix, 1), describe(config, mix, 2**31 + 3)
    assert a["states"] != b["states"]
    assert sizes(a) == sizes(b)


def test_initial_states_differ_within_a_seed():
    d = describe("kubemark-5k-zoned", "rc-backlog-10-per-node", 5)
    assert len(d["states"]) == 2
    assert d["states"][0] != d["states"][1]


def test_any_whole_number_is_a_seed():
    for seed in (0, -1, 2**31 - 1, 2**31 + 5, 2**40):
        assert describe("scheduler-perf-1k-zoned", "rc-backlog-30-per-node",
                        seed, nodes=12)["states"]


def test_backlog_size_follows_the_nodes():
    d = describe("kubemark-5k-zoned", "rc-backlog-30-per-node", 3, nodes=40)
    assert traffic.backlog_size(d) == d["groups"][0]["count"] == 30 * 40
    assert d["controllers"][0]["replicas"] == 30 * 40


def test_copies_expand_in_order():
    mix = {"why": "w", "states": 1, "groups": [
        {"name": "rc-{i}", "copies": 3, "pods": 4, "controller": True,
         "labels": {"name": "rc-{i}", "tier": "web"}, "containers": []},
        {"name": "plain", "pods_per_node": 2, "labels": {}, "containers": []}]}
    conf = dict(run.load_config(ROOT, run.load_manifest(ROOT),
                                "kubemark-5k-zoned"), nodes=5)
    d = traffic.describe(conf, mix, 1)
    assert [(g["name"], g["count"]) for g in d["groups"]] == [
        ("rc-0", 4), ("rc-1", 4), ("rc-2", 4), ("plain", 10)]
    assert d["groups"][1]["labels"] == {"name": "rc-1", "tier": "web"}
    assert [c["selector"] for c in d["controllers"]] == [
        {"name": f"rc-{i}", "tier": "web"} for i in range(3)]
    assert traffic.backlog_size(d) == 22


@pytest.mark.parametrize("where,key", [
    ("config", "profile"), ("node", "ready"), ("traffic", "loop"),
    ("traffic", "check_pods"), ("group", "order"), ("bound_load", "extra")])
def test_keys_nothing_reads_are_refused(where, key):
    manifest = run.load_manifest(ROOT)
    conf = copy.deepcopy(run.load_config(ROOT, manifest,
                                         "kubemark-5k-zoned"))
    mix = run.load_traffic(BENCH_DIR, "rc-backlog-10-per-node")
    target = {"config": conf, "node": conf["node"], "traffic": mix,
              "group": mix["groups"][0],
              "bound_load": conf["assumed"]["bound_load"]}[where]
    target[key] = 1
    with pytest.raises(ValueError, match="does not read"):
        traffic.describe(conf, mix, 1)


def test_another_provider_is_refused():
    conf = dict(run.load_config(ROOT, run.load_manifest(ROOT),
                                "kubemark-5k-zoned"),
                provider="ClusterAutoscalerProvider")
    with pytest.raises(ValueError, match="implements DefaultProvider"):
        traffic.describe(conf, run.load_traffic(
            BENCH_DIR, "rc-backlog-10-per-node"), 1)
