"""The PyTorch port stands alone: it and chip_smoke.py import neither
jax nor anything of kubernetes_tpu, and its copies of the JAX package's
host modules have not drifted from their originals."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "kubernetes_tpu_torch"
JAX_PKG = ROOT / "kubernetes_tpu"

#: host modules the port keeps verbatim (only the import package renamed)
COPIES = (
    "api/__init__.py", "api/resource.py", "api/labels.py", "api/types.py",
    "oracle/__init__.py", "oracle/state.py", "oracle/predicates.py",
    "oracle/priorities.py", "oracle/scheduler.py",
    "snapshot/__init__.py", "snapshot/encode.py", "snapshot/interpod.py",
    "snapshot/volumes.py", "snapshot/services.py", "snapshot/pad.py",
    "models/replay.py", "models/hosttab.py", "native/replay.c",
    "scheduler/plugins.py", "scheduler/policy.py", "runtime/__init__.py",
    "runtime/scheme.py", "metrics/__init__.py", "metrics/metrics.py",
)
#: functions the port's own modules keep verbatim from their counterparts
FUNCTION_COPIES = {
    "models/probe.py": ("RunTables", "_tab_dtype", "tables_from_packed",
                        "tables_from_stk"),
    "models/wave.py": ("_WAVE_PRIORITIES", "config_eligible",
                       "_lt_pernode_dom", "run_eligible", "pick_j",
                       "split_runs", "gather_batch", "_permute_tables",
                       "run_pure", "_host_group_cap", "gang_score_add",
                       "host_group_replay", "svc_run_context",
                       "classify_runs"),
    "ops/preempt.py": ("INVALID_PRIO", "RES_ROWS", "pack_candidates"),
    "scheduler/gang.py": ("GangParked", "_place_gang",
                          "_victims_from_slots"),
    "scheduler/algorithmprovider.py": (
        "DEFAULT_PROVIDER_NAME", "TPU_PROVIDER_NAME",
        "CANONICAL_PREDICATE_ORDER", "_max_pd_vols", "_register_all"),
}
#: functions the port keeps in another form, each with the reason its
#: docstring records (tests/test_torch_grouped.py checks group_buffer's
#: rows against the JAX package's packed buffer; tests/test_torch_policy.py
#: the device providers the factory registers; tests/test_torch_gang.py the
#: director on the CPU against the JAX package's)
DEVIATIONS = {
    ("models/wave.py", "group_buffer"): "models/pack.py",
    ("scheduler/algorithmprovider.py", "_tpu_algorithm_factory"):
        "TorchScheduleAlgorithm",
    ("scheduler/gang.py", "GangDirector"): "VictimScorer(device=device)",
}


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "kubernetes_tpu")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = (
        "import sys\n"
        "import kubernetes_tpu_torch.scheduler.algorithm\n"
        "import kubernetes_tpu_torch.scheduler.factory\n"
        "import kubernetes_tpu_torch.scheduler.extender_server\n"
        "import kubernetes_tpu_torch.hyperkube\n"
        "import kubernetes_tpu_torch.ops.services\n"
        "import kubernetes_tpu_torch.harness.scenarios\n"
        "import kubernetes_tpu_torch.scheduler.gang\n"
        "import kubernetes_tpu_torch.ops.preempt_kernel\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'kubernetes_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def _copy_note(rel: str) -> str:
    return f"Copy of kubernetes_tpu/{rel}: only the import package differs."


def _normalized_copy(rel: str) -> str:
    """The copy with its docstring note removed and its imports renamed
    back to the JAX package."""
    text = (PORT / rel).read_text()
    if rel == "native/replay.c":
        note = (" *\n * Copy of kubernetes_tpu/native/replay.c, unchanged; "
                "native/build.py of\n * this package builds it.\n")
        assert note in text
        return text.replace(note, "", 1)
    if rel == "snapshot/pad.py":
        note = ("\n\n" + _copy_note(rel)[:-1] + ",\nand pad_snapshot is a "
                "copy of kubernetes_tpu/parallel/mesh.py\n_pad_snapshot, "
                "which pad_to_buckets imports from there (a JAX module).")
    else:
        note = "\n\n" + _copy_note(rel)
    assert note in text, f"{rel}: the copy note is missing"
    return text.replace(note, "", 1).replace("kubernetes_tpu_torch.",
                                             "kubernetes_tpu.")


@pytest.mark.parametrize("rel", [c for c in COPIES if c != "snapshot/pad.py"])
def test_host_copy_has_not_drifted(rel):
    assert _normalized_copy(rel) == (JAX_PKG / rel).read_text()


def _top_level_source(path: pathlib.Path, name: str) -> str:
    text = path.read_text()
    lines = text.splitlines()
    for node in ast.parse(text).body:
        names = ([t.id for t in node.targets if isinstance(t, ast.Name)]
                 if isinstance(node, ast.Assign) else [getattr(node, "name",
                                                               None)])
        if name in names:
            start = node.lineno - 1 - len(getattr(node, "decorator_list", []))
            return "\n".join(lines[start:node.end_lineno])
    raise AssertionError(f"{name} not found in {path}")


def test_pad_copy_deviates_only_by_pad_snapshot():
    """The one listed deviation: pad.py carries pad_snapshot, a copy of
    kubernetes_tpu/parallel/mesh.py _pad_snapshot, in place of its lazy
    import from that JAX module."""
    rel = "snapshot/pad.py"
    port_fn = _top_level_source(PORT / rel, "pad_snapshot")
    mesh_fn = _top_level_source(JAX_PKG / "parallel/mesh.py", "_pad_snapshot")
    assert port_fn == mesh_fn.replace("def _pad_snapshot(", "def pad_snapshot(") \
        .replace("kubernetes_tpu.", "kubernetes_tpu_torch.")
    text = _normalized_copy(rel).replace("\n\n\n" + port_fn.replace(
        "kubernetes_tpu_torch.", "kubernetes_tpu.") + "\n", "\n")
    original = (JAX_PKG / rel).read_text().replace(
        "    from kubernetes_tpu.parallel.mesh import _pad_snapshot\n\n", ""
    ).replace("_pad_snapshot(snap, n_bucket)", "pad_snapshot(snap, n_bucket)")
    assert text == original


@pytest.mark.parametrize("rel,name", [
    (rel, name) for rel, names in FUNCTION_COPIES.items() for name in names])
def test_function_copy_has_not_drifted(rel, name):
    port = _top_level_source(PORT / rel, name)
    ref = _top_level_source(JAX_PKG / rel, name)
    assert port.replace("kubernetes_tpu_torch.", "kubernetes_tpu.") == ref


@pytest.mark.parametrize("rel,name", sorted(DEVIATIONS))
def test_deviation_is_recorded(rel, name):
    """A recorded deviation exists in both packages, differs, and says in
    its docstring what it deviates from and why."""
    port = _top_level_source(PORT / rel, name)
    ref = _top_level_source(JAX_PKG / rel, name)
    assert port.replace("kubernetes_tpu_torch.", "kubernetes_tpu.") != ref
    doc = ast.get_docstring(ast.parse(port).body[0])
    assert f"Deviation from kubernetes_tpu/{rel} {name}" in \
        " ".join(doc.split())
    assert DEVIATIONS[(rel, name)] in doc
