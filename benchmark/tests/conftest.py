"""Shared pieces of the benchmark's tests. They run on the CPU, at small
sizes: the cells' own configurations and traffic mixes with fewer nodes.

    python -m pytest benchmark/tests -q

Tests that need the card take the cuda_device fixture and skip without
one."""

from __future__ import annotations

import copy
import json
import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny_cell(tmp_path, config: str = "kubemark-5k-zoned",
              traffic: str = "rc-backlog-10-per-node", nodes: int = 48,
              **overrides):
    """A cell of a configuration cut to `nodes` nodes (other keys of the
    configuration overridden by `overrides`), its file under tmp_path.
    -> (root, manifest, cell) for benchmark.run.run_cell."""
    from benchmark import run

    manifest = run.load_manifest(ROOT)
    conf = run.load_config(ROOT, manifest, config)
    conf["nodes"] = nodes
    conf.update(overrides)
    os.makedirs(tmp_path / "configs", exist_ok=True)
    with open(tmp_path / "configs" / "tiny.json", "w") as f:
        json.dump(conf, f)
    tiny = copy.deepcopy(manifest)
    tiny["configs"] = [{"name": "tiny", "source": conf["source"],
                        "file": "configs/tiny.json", "reduced": ["nodes"],
                        "why": "a test's cut"}]
    cell = {"name": "tiny-cell", "config": "tiny", "traffic": traffic,
            "chips": 1, "why": "a test's cut"}
    tiny["workloads"] = [cell]
    return str(tmp_path), tiny, cell


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the measured path runs on the card")
    return torch.device("cuda")
