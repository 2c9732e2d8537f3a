"""BENCHMARK.json and the result line keep to the benchmark's contract:
names, units, keys, files found by name, the run length's budget; a run
without a card prints no result."""

import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest

from benchmark import run
from conftest import BENCH_DIR, ROOT, tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
MANIFEST = run.load_manifest(ROOT)


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"]
    assert len(MANIFEST["command"]) <= 32
    assert all(one_line(w) for w in MANIFEST["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_run_seconds_fits_the_full_check():
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    assert (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200 <= 43200


def test_configs():
    names = [c["name"] for c in MANIFEST["configs"]]
    assert len(set(names)) == len(names)
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == set(names)
    files = set()
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        conf = run.load_config(ROOT, MANIFEST, c["name"])
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])


def test_workloads():
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(BENCH_DIR, "traffic",
                                           f"{w['traffic']}.json"))
    names = [w["name"] for w in MANIFEST["workloads"]]
    assert len(set(names)) == len(names)
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(names) // 4)


def test_metrics():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(set(names)) == len(names)
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and one_line(m["layer"])
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(BENCH_DIR, "metrics",
                                           f"{m['name']}.py"))
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        assert len(run.cell_metrics(MANIFEST, cell, "end_to_end")) >= 2
        assert run.cell_metrics(MANIFEST, cell, "per_layer")


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, _dirs, files in os.walk(BENCH_DIR):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


def test_result_line_keys(tmp_path):
    root, manifest, cell = tiny_cell(tmp_path, nodes=24)
    res = run.run_cell(root, BENCH_DIR, manifest, cell, 9, 0.5, False, "cpu",
                       time.perf_counter())
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(res)
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in MANIFEST["end_to_end"]}
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(res["device"])
    for c in res["checks"].values():
        assert {"value", "limit"} <= set(c)
    json.dumps(res)


def test_no_card_no_result(tmp_path, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", MANIFEST["workloads"][0]["name"],
                   "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_benchmark_alone_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the files under
    paths, a run fails and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         MANIFEST["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
