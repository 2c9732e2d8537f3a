"""The PyTorch port stands alone: it and chip_smoke.py import neither
jax nor anything of kubernetes_tpu, and its copies of the JAX package's
host modules have not drifted from their originals."""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

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
    "native/_kquantity.c", "native/_ktlv.c",
    "scheduler/plugins.py", "scheduler/policy.py", "runtime/__init__.py",
    "runtime/scheme.py", "metrics/__init__.py", "metrics/metrics.py",
    "utils/__init__.py", "utils/clock.py", "utils/entropy.py",
    "utils/trace.py", "utils/flowcontrol.py", "utils/workqueue.py",
    "analysis/locks.py", "analysis/races.py", "trace/__init__.py",
    "trace/spans.py", "scheduler/cache.py", "scheduler/core.py",
    "scheduler/extender.py", "snapshot/incremental.py",
    # the control plane: wire codecs, storage, auth, audit, component
    # config, observability, the apiserver, the client stack, the pod
    # creator of the scheduler_perf harness
    "runtime/binary.py", "runtime/tlv.py", "runtime/versioning.py",
    "storage/__init__.py", "storage/store.py", "storage/cacher.py",
    "storage/durable.py", "storage/replicated.py",
    "storage/quorum/__init__.py", "storage/quorum/io.py",
    "storage/quorum/log.py", "storage/quorum/node.py",
    "storage/quorum/rpc.py", "storage/quorum/store.py",
    "auth/__init__.py", "auth/authn.py", "auth/authz.py", "auth/rbac.py",
    "audit/__init__.py", "audit/audit.py",
    "apis/__init__.py", "apis/componentconfig.py",
    "utils/configz.py", "utils/pprof.py", "trace/httpd.py", "trace/slo.py",
    "telemetry/__init__.py", "telemetry/expo.py", "telemetry/flight.py",
    "telemetry/scrape.py", "telemetry/slo.py", "telemetry/tsdb.py",
    "apiserver/__init__.py", "apiserver/admission.py",
    "apiserver/fields.py", "apiserver/flowcontrol.py",
    "apiserver/http_frontend.py", "apiserver/registry.py",
    "apiserver/server.py", "apiserver/thirdparty.py", "apiserver/ui.py",
    "client/__init__.py", "client/cache/__init__.py",
    "client/cache/fifo.py", "client/cache/listers.py",
    "client/cache/reflector.py", "client/cache/store.py",
    "client/informer.py", "client/leaderelection.py", "client/record.py",
    "client/rest.py", "client/transport.py",
    "harness/creator.py", "harness/faults.py",
    # the optimizing profile's host modules and the controller machinery
    # its defragmentation controller imports
    "scheduler/optimizer/__init__.py", "scheduler/optimizer/ops/__init__.py",
    "scheduler/optimizer/controller/__init__.py",
    "scheduler/optimizer/controller/defrag.py", "controller/framework.py",
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
                       "classify_runs", "ENV_PIPELINE",
                       "_pipeline_enabled", "group_buffer"),
    "models/pack.py": ("pack_arrays",),
    "parallel/resident.py": (
        "AXIS", "CARRY_FIELDS", "CARRY_BLOCKS", "_PURE_CARRY",
        "_STATIC_SHARDED_1D", "_STATIC_SHARDED_2D", "host_static",
        "host_carry", "_eq", "ResidentClusterState.SCATTER_FRAC",
        "ResidentClusterState.begin_wave", "ResidentClusterState.count_h2d",
        "ResidentClusterState._placed_dtype", "ResidentClusterState._placed",
        "ResidentClusterState._signature", "ResidentClusterState._specs",
        "ResidentClusterState._block_of", "ResidentClusterState.note_commit",
        "ResidentClusterState.note_scan", "ResidentClusterState.invalidate",
        "ResidentClusterState.usage", "ResidentClusterState.invalidate_all"),
    "parallel/mesh.py": ("_opaque_blocks", "_sparse_counts",
                         "_sparse_group_counts"),
    "parallel/quant.py": ("ENV", "SHADOW_ENV", "NARROWABLE",
                          "_NARROW_STEPS", "mode", "narrow_enabled",
                          "score_mode", "narrow_dtype", "narrow",
                          "ShadowGate"),
    "ops/preempt.py": ("INVALID_PRIO", "RES_ROWS", "pack_candidates"),
    "scheduler/gang.py": ("GangParked", "_place_gang",
                          "_victims_from_slots"),
    "scheduler/algorithmprovider.py": (
        "DEFAULT_PROVIDER_NAME", "TPU_PROVIDER_NAME",
        "CANONICAL_PREDICATE_ORDER", "_max_pd_vols", "_register_all"),
    "scheduler/factory.py": (
        "node_schedulable", "SCHEDULER_ANNOTATION_KEY",
        "DEFAULT_SCHEDULER_NAME", "_ResponsibleFIFO",
        "ConfigFactory._cache_add_pod", "ConfigFactory._cache_update_pod",
        "ConfigFactory._cache_delete_pod", "ConfigFactory.run_components",
        "ConfigFactory.stop", "ConfigFactory.plugin_args",
        "ConfigFactory.create_from_provider", "ConfigFactory.create_scheduler",
        "ConfigFactory._snapshot_extras", "ConfigFactory._next_pod",
        "ConfigFactory._drain_waiting", "ConfigFactory._bind",
        "ConfigFactory._bind_many", "ConfigFactory._update_pod_conditions_many",
        "ConfigFactory._update_podgroup_status", "ConfigFactory._preempt_many",
        "ConfigFactory._update_pod_condition",
        "ConfigFactory._make_error_handler"),
    "scheduler/server.py": (
        "SchedulerServerOptions.from_component_config",
        "SchedulerServerOptions.from_config_file", "SchedulerServer.__init__",
        "SchedulerServer._lost_lease", "SchedulerServer.is_leader",
        "SchedulerServer.stop"),
    "harness/perf.py": ("_pipeline_snapshot", "_phase_table", "_measure",
                        "_scrape_counters"),
    "hyperkube.py": ("_client", "_client_from", "_wait_forever",
                     "run_apiserver"),
    "analysis/__init__.py": ("Finding", "render_report"),
    "trace/profile.py": ("PHASES", "_ExclusiveAccountant", "_ACCOUNTANT",
                         "_PhaseTimer", "_NullTimer", "_NULL", "_HIST",
                         "phase_timer", "phase_totals", "exclusive_totals",
                         "overlap_totals"),
}
#: functions the port keeps in another form, each with the reason its
#: docstring records (tests/test_torch_policy.py
#: the device providers the factory registers; tests/test_torch_gang.py the
#: director on the CPU against the JAX package's; tests/test_torch_daemon.py
#: the warmup that raises where the JAX package's logs; tests/
#: test_torch_server.py the daemon on the CPU, the harness, the daemon that
#: raises on a missing card or a failed kernel build; tests/
#: test_torch_wire.py the daemon against the JAX package's). A name "Class.
#: method" is a method of a top-level class; "<module>" is the module
#: itself, its docstring saying what it leaves out (controller/__init__.py
#: exports framework's names alone until the host-only subsystems;
#: parallel/mesh.py and parallel/resident.py donate nothing and compile
#: no programs; tests/test_torch_mesh.py and test_torch_resident.py hold
#: them to the JAX package's).
DEVIATIONS = {
    ("controller/__init__.py", "<module>"): "queue 1 item 4",
    ("parallel/mesh.py", "<module>"): "runtime_donation",
    ("parallel/resident.py", "<module>"): "KUBERNETES_TPU_MESH_DONATE",
    ("parallel/resident.py", "ResidentClusterState"): "in place",
    ("scheduler/algorithm.py", "TorchScheduleAlgorithm._warmup_mesh"):
        "an exception propagates",
    ("scheduler/algorithmprovider.py", "_build_mesh"): "_visible_devices",
    ("scheduler/algorithmprovider.py", "_tpu_algorithm_factory"):
        "TorchScheduleAlgorithm",
    ("scheduler/gang.py", "GangDirector"): "VictimScorer(device=device)",
    ("trace/profile.py", "install_compile_listener"): "chip_smoke.py",
    ("scheduler/algorithm.py", "TorchScheduleAlgorithm._warm_one"):
        "an exception propagates",
    ("scheduler/factory.py", "ConfigFactory.__init__"): "device",
    ("scheduler/factory.py", "ConfigFactory.create_from_config"):
        "TorchScheduleAlgorithm",
    ("scheduler/factory.py", "ConfigFactory.create_from_keys"): "device",
    ("scheduler/factory.py", "ConfigFactory._make_config"): "GangDirector",
    ("scheduler/server.py", "SchedulerServerOptions"): "device",
    ("scheduler/server.py", "SchedulerServer.start"): "raises",
    ("harness/perf.py", "_wait_sched_ready"): "raises",
    ("harness/perf.py", "schedule_pods"): "device",
    ("harness/perf.py", "schedule_pods_separate"):
        "KUBERNETES_TPU_WARM_SCAN",
    ("hyperkube.py", "run_scheduler"): "--device",
}
#: the JAX counterpart of a deviation whose file or name differs there
COUNTERPARTS = {
    ("scheduler/algorithm.py", "TorchScheduleAlgorithm._warm_one"):
        ("scheduler/tpu_algorithm.py", "TPUScheduleAlgorithm._warm_one"),
    ("scheduler/algorithm.py", "TorchScheduleAlgorithm._warmup_mesh"):
        ("scheduler/tpu_algorithm.py", "TPUScheduleAlgorithm._warmup_mesh"),
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
        "import kubernetes_tpu_torch.scheduler.core\n"
        "import kubernetes_tpu_torch.scheduler.cache\n"
        "import kubernetes_tpu_torch.scheduler.extender\n"
        "import kubernetes_tpu_torch.snapshot.incremental\n"
        "import kubernetes_tpu_torch.utils\n"
        "import kubernetes_tpu_torch.analysis.races\n"
        "import kubernetes_tpu_torch.trace.profile\n"
        "import kubernetes_tpu_torch.scheduler.server\n"
        "import kubernetes_tpu_torch.apiserver.server\n"
        "import kubernetes_tpu_torch.client\n"
        "import kubernetes_tpu_torch.client.transport\n"
        "import kubernetes_tpu_torch.harness.perf\n"
        "import kubernetes_tpu_torch.harness.creator\n"
        "import kubernetes_tpu_torch.storage.quorum\n"
        "import kubernetes_tpu_torch.storage.replicated\n"
        "import kubernetes_tpu_torch.parallel.quant\n"
        "import kubernetes_tpu_torch.models.pack\n"
        "import kubernetes_tpu_torch.scheduler.optimizer.profile\n"
        "import kubernetes_tpu_torch.scheduler.optimizer.ops.assign_kernel\n"
        "import kubernetes_tpu_torch.scheduler.optimizer.controller.defrag\n"
        "import kubernetes_tpu_torch.controller\n"
        "import kubernetes_tpu_torch.parallel.mesh\n"
        "import kubernetes_tpu_torch.parallel.resident\n"
        "import kubernetes_tpu_torch.parallel.resident_kernel\n"
        "import kubernetes_tpu_torch.parallel.shard\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'kubernetes_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def _port_module(name: str):
    """The port's file of a dotted module name (the C source of a
    CPython extension that native/build.py builds), or None."""
    p = PORT.joinpath(*name.split(".")[1:])
    if (p / "__init__.py").exists():
        return p / "__init__.py"
    for suffix in (".py", ".c"):
        if p.with_suffix(suffix).exists():
            return p.with_suffix(suffix)
    return None


def _top_level_names(path: pathlib.Path) -> set:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(n.id for t in node.targets for n in ast.walk(t)
                         if isinstance(n, ast.Name))
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            if isinstance(node.target, ast.Name):
                names.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, (ast.If, ast.Try)):
            for sub in ast.walk(node):
                if isinstance(sub, (ast.FunctionDef, ast.ClassDef)):
                    names.add(sub.name)
                elif isinstance(sub, ast.Assign):
                    names.update(n.id for t in sub.targets
                                 for n in ast.walk(t)
                                 if isinstance(n, ast.Name))
                elif isinstance(sub, (ast.Import, ast.ImportFrom)):
                    names.update((a.asname or a.name).split(".")[0]
                                 for a in sub.names)
    return names


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_every_import_resolves_in_the_port(path):
    """The closure walk: every import of the port's own package, lazy
    ones inside functions included, names a module the port has, and
    every name it takes from one is defined there (or is a submodule),
    so no copy reaches for a module that was left behind."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names
                    if a.name.split(".")[0] == "kubernetes_tpu_torch"
                    and _port_module(a.name) is None]
        elif (isinstance(node, ast.ImportFrom) and node.module
              and node.module.split(".")[0] == "kubernetes_tpu_torch"):
            mod = _port_module(node.module)
            if mod is None or mod.suffix != ".py":
                bad.append(node.module)
                continue
            have = _top_level_names(mod)
            bad += [f"{node.module}.{a.name}" for a in node.names
                    if a.name != "*" and a.name not in have
                    and _port_module(f"{node.module}.{a.name}") is None]
    assert not bad, f"{path} imports what the port lacks: {bad}"


def _copy_note(rel: str) -> str:
    return f"Copy of kubernetes_tpu/{rel}: only the import package differs."


def _normalized_copy(rel: str) -> str:
    """The copy with its docstring note removed and its imports renamed
    back to the JAX package."""
    text = (PORT / rel).read_text()
    if rel.endswith(".c"):
        note = (f" *\n * Copy of kubernetes_tpu/{rel}, unchanged; "
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
    return _renamed(text.replace(note, "", 1))


def _renamed(text: str) -> str:
    """The port's package name in imports (and dotted names) back to the
    JAX package's."""
    return text.replace("kubernetes_tpu_torch.", "kubernetes_tpu.").replace(
        "from kubernetes_tpu_torch import", "from kubernetes_tpu import")


@pytest.mark.parametrize("rel", [c for c in COPIES if c != "snapshot/pad.py"])
def test_host_copy_has_not_drifted(rel):
    assert _normalized_copy(rel) == (JAX_PKG / rel).read_text()


def _top_level_source(path: pathlib.Path, name: str) -> str:
    """The source of a top-level definition or assignment, or of a
    method ("Class.method", dedented)."""
    text = path.read_text()
    lines = text.splitlines()
    body = ast.parse(text).body
    *outer, name = name.split(".")
    for cls in outer:
        body = next(n for n in body if isinstance(n, ast.ClassDef)
                    and n.name == cls).body
    for node in body:
        names = ([t.id for t in node.targets if isinstance(t, ast.Name)]
                 if isinstance(node, ast.Assign) else [getattr(node, "name",
                                                               None)])
        if name in names:
            start = node.lineno - 1 - len(getattr(node, "decorator_list", []))
            return textwrap.dedent("\n".join(lines[start:node.end_lineno]))
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
    assert _renamed(port) == ref


@pytest.mark.parametrize("rel,name", sorted(DEVIATIONS))
def test_deviation_is_recorded(rel, name):
    """A recorded deviation exists in both packages, differs, and says in
    its docstring what it deviates from and why."""
    jrel, jname = COUNTERPARTS.get((rel, name), (rel, name))
    if name == "<module>":
        port = (PORT / rel).read_text()
        ref = (JAX_PKG / jrel).read_text()
        tree = ast.parse(port)
    else:
        port = _top_level_source(PORT / rel, name)
        ref = _top_level_source(JAX_PKG / jrel, jname)
        tree = ast.parse(port).body[0]
    assert _renamed(port) != ref
    doc = " ".join(ast.get_docstring(tree).split())
    assert f"Deviation from kubernetes_tpu/{jrel} {jname}" in doc
    assert DEVIATIONS[(rel, name)] in doc
