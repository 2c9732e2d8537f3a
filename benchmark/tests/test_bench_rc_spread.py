"""The many-RC SelectorSpread cell, `rc-spread-500x40`: its configuration
and traffic files through the generator, a cut copy of the cell through
run_cell on the CPU, and the `group_run_idle_us` reader on made-up
traces."""

import json
import time

import pytest

from benchmark import run, traffic
from benchmark.reference.scheduler import Cluster
from conftest import BENCH_DIR, ROOT, tiny_cell

CONFIG, MIX, CELL = "spread-3k-zoned", "rc-spread-500x40", "rc-spread-500x40"
US = 1_000  # ns


def files():
    manifest = run.load_manifest(ROOT)
    return (run.load_config(ROOT, manifest, CONFIG),
            run.load_traffic(BENCH_DIR, MIX))


def test_the_cell_is_declared_on_one_card():
    manifest = run.load_manifest(ROOT)
    cell = run.find_cell(manifest, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (CONFIG, MIX,
                                                               1)
    (conf,) = [c for c in manifest["configs"] if c["name"] == CONFIG]
    assert conf["reduced"] == []
    assert [m["name"] for m in run.cell_metrics(manifest, CELL, "per_layer")
            if "workloads" in m] == ["group_run_idle_us"]


def test_files_pass_the_generator_check():
    conf, mix = files()
    traffic.validate(conf, mix)
    assert conf["services"] == [] and conf["reduced"] == []
    assert conf["provider"] == traffic.PROVIDER


def test_describe_gives_the_spec_sizes_and_room_holds_them():
    conf, mix = files()
    desc = traffic.describe(conf, mix, 2**31 + 11)
    assert [len(s["nodes"]) for s in desc["states"]] == [3000, 3000]
    assert len(desc["controllers"]) == 500
    assert len(desc["groups"]) == 500
    assert traffic.backlog_size(desc) == 20_000
    assert {g["count"] for g in desc["groups"]} == {40}
    assert [c["selector"] for c in desc["controllers"][:2]] == [
        {"name": "spread-0"}, {"name": "spread-1"}]
    assert desc["services"] == []
    for s in range(2):
        zones = [n["labels"][conf["zone_label"]]
                 for n in desc["states"][s]["nodes"]]
        assert {z: zones.count(z) for z in "abc"} == {z: 1000 for z in "abc"}
        cluster = Cluster(desc["states"][s], desc["services"],
                          desc["controllers"], desc["namespace"])
        assert cluster.room(desc["groups"]) >= 20_000
    # the check re-derives 200,000 pods: ten calls
    assert run.sample_size(desc) == 10


def test_a_cut_copy_of_the_cell_is_correct(tmp_path):
    root, manifest, cell = tiny_cell(tmp_path, config=CONFIG, traffic=MIX,
                                     nodes=96)
    mix = run.load_traffic(BENCH_DIR, MIX)
    mix["groups"][0]["copies"] = 12
    (tmp_path / "traffic").mkdir()
    with open(tmp_path / "traffic" / "cut.json", "w") as f:
        json.dump(mix, f)
    cell["traffic"] = "cut"
    res = run.run_cell(root, str(tmp_path), manifest, cell, 2**33 + 7, 0.2,
                       False, "cpu", time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["attempted"] == 480 * res["calls"]
    assert res["checks"]["mismatched_pods"]["of"] == 480 * len(
        res["checked_calls"]) > 0


def read(events):
    return run.load_metric(BENCH_DIR, "group_run_idle_us").read(
        {"events": events})


def test_group_run_idle_leaves_out_what_other_kernels_cover():
    # three gaps between four K3 launches: 10 us with a 4 us copy inside
    # (6 idle), 20 us wholly idle, 8 us with a probe and a fold covering
    # 3 + 2 us of it (3 idle)
    events = [("zreplay_kernel<1>", 0, 50 * US),
              ("Memcpy HtoD", 52 * US, 56 * US),
              ("zreplay_kernel<1>", 60 * US, 100 * US),
              ("zreplay_kernel<1>", 120 * US, 150 * US),
              ("resource_probe_kernel", 151 * US, 154 * US),
              ("index_add", 155 * US, 157 * US),
              ("zreplay_kernel<1>", 158 * US, 180 * US)]
    assert read(events) == pytest.approx(6.0)


def test_group_run_idle_counts_overlapping_events_once():
    # in the first 10 us gap two overlapping events cover 12-17 us (5 us,
    # once) and a third, reaching past the gap's end, 19-20: 4 idle; in
    # the second an event that starts before the gap covers 3 us: 7 idle
    events = [("zreplay_kernel<1>", 0, 10 * US),
              ("a", 12 * US, 15 * US), ("b", 13 * US, 17 * US),
              ("c", 19 * US, 25 * US),
              ("zreplay_kernel<1>", 20 * US, 30 * US),
              ("d", 28 * US, 33 * US),
              ("zreplay_kernel<1>", 40 * US, 45 * US)]
    assert read(events) == pytest.approx((4.0 + 7.0) / 2)


@pytest.mark.parametrize("events", [
    [],
    [("zreplay_kernel<1>", 0, 10 * US), ("resource_probe_kernel", 20 * US,
                                         30 * US)],
])
def test_group_run_idle_needs_two_launches(events):
    assert read(events) is None
