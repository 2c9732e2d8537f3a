"""A configuration, a traffic mix or a metric file dropped into a copy of
the benchmark is found by name, with no edit to a file that is there."""

import json
import shutil
import time

from benchmark import run
from conftest import BENCH_DIR, ROOT, tiny_cell


def copy_bench(tmp_path):
    dst = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(f"{ROOT}/BENCHMARK.json", tmp_path)
    return dst


def test_new_traffic_mix_is_found_and_runs(tmp_path):
    bench = copy_bench(tmp_path)
    mix = json.loads((bench / "traffic" / "rc-backlog-10-per-node.json")
                     .read_text())
    mix["groups"][0]["pods_per_node"] = 3
    (bench / "traffic" / "rc-backlog-3-per-node.json").write_text(
        json.dumps(mix))
    assert run.load_traffic(str(bench), "rc-backlog-3-per-node") == mix
    root, manifest, cell = tiny_cell(tmp_path / "cfg", nodes=16,
                                     traffic="rc-backlog-3-per-node")
    res = run.run_cell(root, str(bench), manifest, cell, 4, 0.3, False,
                       "cpu", time.perf_counter())
    assert res["correct"] and res["attempted"] == 48 * res["calls"]


def test_new_mix_of_many_templates_runs_from_data_alone(tmp_path):
    """A backlog of several RCs' templates, each RC's pods in turn (the
    shape of BASELINE.json's 500 RCs x 40), added as a data file only."""
    bench = copy_bench(tmp_path)
    mix = {"why": "a test's mix", "states": 2, "groups": [
        {"name": "rc-{i}", "copies": 4, "pods": 9, "controller": True,
         "labels": {"name": "rc-{i}"},
         "containers": [{"requests": {"cpu": "100m", "memory": "500Mi"}}]},
        {"name": "sched-perf", "pods_per_node": 1, "controller": True,
         "labels": {"name": "sched-perf"},
         "containers": [{"requests": {"cpu": "250m"}}]}]}
    (bench / "traffic" / "rc-spread-4x9.json").write_text(json.dumps(mix))
    root, manifest, cell = tiny_cell(tmp_path / "cfg", nodes=16,
                                     traffic="rc-spread-4x9")
    res = run.run_cell(root, str(bench), manifest, cell, 2**31 + 4, 0.3,
                       False, "cpu", time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["attempted"] == (4 * 9 + 16) * res["calls"]


def test_new_config_is_found_by_its_manifest_entry(tmp_path):
    bench = copy_bench(tmp_path)
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    conf = run.load_config(ROOT, manifest, "kubemark-5k-zoned")
    conf = dict(conf, name="kubemark-2k-zoned", nodes=2000)
    (bench / "configs" / "kubemark-2k-zoned.json").write_text(
        json.dumps(conf))
    manifest["configs"].append(dict(manifest["configs"][0],
                                    name="kubemark-2k-zoned",
                                    file="benchmark/configs/"
                                         "kubemark-2k-zoned.json"))
    assert run.load_config(str(tmp_path), manifest,
                           "kubemark-2k-zoned")["nodes"] == 2000


def test_new_metric_is_found_and_read(tmp_path):
    bench = copy_bench(tmp_path)
    (bench / "metrics" / "calls_per_s.py").write_text(
        "def read(ctx):\n"
        "    return ctx['calls'] / ctx['window_s'] if ctx['calls'] "
        "else None\n")
    reader = run.load_metric(str(bench), "calls_per_s")
    assert reader.read({"calls": 6, "window_s": 3.0}) == 2.0
    assert reader.read({"calls": 0, "window_s": 3.0}) is None
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["per_layer"].append({
        "name": "calls_per_s", "unit": "calls/s", "better": "higher",
        "source": "host_clock", "layer": "entry", "moves": "pods_per_s",
        "workloads": [manifest["workloads"][0]["name"]]})
    names = [m["name"] for m in run.cell_metrics(
        manifest, manifest["workloads"][0]["name"], "per_layer")]
    assert "calls_per_s" in names
    names = [m["name"] for m in run.cell_metrics(
        manifest, manifest["workloads"][1]["name"], "per_layer")]
    assert "calls_per_s" not in names
