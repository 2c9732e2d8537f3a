"""No module the benchmark runs has the top-level name jax, jaxlib, flax
or kubernetes_tpu (names compared whole: kubernetes_tpu_torch is another
name), and the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import run
from conftest import BENCH_DIR, ROOT

PROGRAM = "kubernetes_tpu_torch"
#: never imported by the benchmark: JAX, the JAX package, and the JAX
#: package's bench and chip scripts at the repository's root
BANNED = set(run.FORBIDDEN_MODULES) | {"bench", "chip_smoke"}


def sources():
    for dirpath, _dirs, files in os.walk(BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported_tops(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_sources_import_no_banned_module(path):
    assert not set(imported_tops(path)) & BANNED


def test_yardstick_imports_nothing_of_the_program():
    yardstick = [p for p in sources()
                 if os.path.relpath(p, BENCH_DIR).split(os.sep)[0]
                 in ("reference", "metrics")
                 or os.path.basename(p) in ("traffic.py", "roofline.py")]
    assert yardstick
    for path in yardstick:
        assert PROGRAM not in set(imported_tops(path)), path


CHILD = r"""
import sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import pathlib, tempfile
from benchmark import run, roofline, traffic
from benchmark.reference import scheduler
for name in {metrics!r}:
    run.load_metric({bench!r}, name)
assert not any(m.split(".")[0] == "kubernetes_tpu_torch" for m in sys.modules), "yardstick"
from conftest import tiny_cell
root, manifest, cell = tiny_cell(pathlib.Path(tempfile.mkdtemp()), nodes=24)
res = run.run_cell(root, {bench!r}, manifest, cell, 5, 0.5, False, "cpu",
                   time.perf_counter())
assert res["correct"], res
assert any(m.split(".")[0] == "kubernetes_tpu_torch" for m in sys.modules)
print("FORBIDDEN", run.forbidden_modules())
"""


def test_a_run_loads_no_forbidden_module():
    metrics = [m["name"] for m in run.load_manifest(ROOT)["per_layer"]]
    code = CHILD.format(root=ROOT, tests=os.path.dirname(__file__),
                        bench=BENCH_DIR, metrics=metrics)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("kubernetes_tpu_torch", "kubernetes_tpu_torch.ops",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    monkeypatch.delitem(sys.modules, "kubernetes_tpu", raising=False)
    for name in [m for m in sys.modules
                 if m.split(".", 1)[0] in run.FORBIDDEN_MODULES]:
        monkeypatch.delitem(sys.modules, name)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "kubernetes_tpu.ops", object())
    assert run.forbidden_modules() == ["kubernetes_tpu"]
