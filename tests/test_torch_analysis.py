"""The port's static-analysis suite (kubernetes_tpu_torch/analysis) against
the JAX package's: the program registry holds the JAX registry's names
(less mesh_assign_auction, which no driver dispatches), declared
contracts and host-bound output counts; each registered program traces
clean on fake CUDA tensors; each audit rule flags its seeded violation;
the lint's rules kept from the JAX lint find what it finds, and its
program-scope rules fire in a registered program and its callees and
not in cold code; the rebuild sentinel fires on a build or a load inside
a guarded window only; the CLI gates.

The two scans (scan, mesh_scan) are a Python loop of 44 steps each and
take most of a full trace (tens of seconds on fake tensors), so their
host-bound count here comes from a run on CPU tensors;
`python -m kubernetes_tpu_torch.analysis` traces them whole, and
chip_smoke.py phase 15 runs them on the card."""

import dataclasses
import json
import threading

import jax
import numpy as np
import pytest
import torch

from kubernetes_tpu.analysis import lint as jax_lint
from kubernetes_tpu.analysis.programs import \
    build_programs as jax_build_programs
from kubernetes_tpu_torch.analysis import Finding, lint, races, render_report
from kubernetes_tpu_torch.analysis import program_audit as PA
from kubernetes_tpu_torch.analysis.compile_guard import CompileSentinel
from kubernetes_tpu_torch.analysis.programs import (
    Sharded,
    build_programs,
    leaves,
)

#: the one JAX registry name the port leaves out, with the reason in
#: analysis/programs._mesh_programs
NO_COUNTERPART = "mesh_assign_auction"

#: the JAX registry's names (kubernetes_tpu/analysis/programs.py), the
#: mesh's included
JAX_NAMES = (
    "scan", "probe", "probe_pallas", "probe_quant_int8",
    "probe_quant_int16", "probe_fused_same", "group_probe_G8",
    "apply_group", "group_probe_G16", "group_probe_G32", "apply",
    "zreplay", "zreplay_group", "victim_score", "assign_auction",
    "assign_beam", "mesh_scan", "mesh_probe", "mesh_apply",
    "mesh_group_probe", "mesh_apply_group", NO_COUNTERPART,
    "resident_scatter",
)
PORT_NAMES = tuple(n for n in JAX_NAMES if n != NO_COUNTERPART)
#: traced whole only by the CLI and on the card (see the docstring)
LONG = ("scan", "mesh_scan")


def _active(findings):
    return [f for f in findings if not f.suppressed]


@pytest.fixture(scope="module")
def jax_registry():
    """name -> (spec, non-carry out-leaves of its jaxpr)."""
    out = {}
    for spec in jax_build_programs(include_mesh=True):
        jx = jax.make_jaxpr(spec.fn)(*spec.args)
        out[spec.name] = (spec, len(jx.out_avals) - spec.carry_out_leaves)
    return out


@pytest.fixture(scope="module")
def cpu_registry():
    return {s.name: s for s in build_programs(
        include_mesh=True, device="cpu", mesh_devices=["cpu"] * 4)}


@pytest.fixture(scope="module")
def fake():
    return PA.registered_programs(include_mesh=True)


_TRACES: dict = {}


def _trace(fake, name):
    if name not in _TRACES:
        spec = next(s for s in fake.specs if s.name == name)
        _TRACES[name] = (spec, fake.trace_program(spec))
    return _TRACES[name]


def _spec(fake, name):
    return next(s for s in fake.specs if s.name == name)


# -- the registry against the JAX package's -----------------------------------


def test_registry_names_equal_jax_less_mesh_assign_auction(jax_registry,
                                                          fake):
    jax_names = set(jax_registry)
    assert jax_names == set(JAX_NAMES)
    port = [s.name for s in fake.specs]
    assert len(port) == len(set(port))
    # the one expected difference, named so it is not lost silently
    assert jax_names - set(port) == {NO_COUNTERPART}
    assert set(port) == set(PORT_NAMES)


@pytest.mark.parametrize("name", PORT_NAMES)
def test_declared_contracts_equal_jax(name, jax_registry, cpu_registry):
    jspec, _ = jax_registry[name]
    spec = cpu_registry[name]
    assert spec.carry_out_leaves == jspec.carry_out_leaves
    assert spec.expected_host_leaves == jspec.expected_host_leaves
    assert spec.narrow_dtypes == jspec.narrow_dtypes
    assert spec.donate_argnums == jspec.donate_argnums
    assert spec.donated_leaves == jspec.donated_leaves
    assert spec.allow_f64 == jspec.allow_f64


@pytest.mark.parametrize("name", PORT_NAMES)
def test_host_bound_count_equals_jax(name, jax_registry, cpu_registry,
                                     fake):
    _jspec, jax_host = jax_registry[name]
    if name in LONG:
        spec = cpu_registry[name]
        host = len(leaves(spec.fn(*spec.args))) - spec.carry_out_leaves
    else:
        host = _trace(fake, name)[1].host_leaves
    assert host == jax_host


@pytest.mark.parametrize("name", [n for n in PORT_NAMES if n not in LONG])
def test_program_traces_clean(name, fake):
    """No finding, the declared device-to-host copies, and every kernel
    of the program reached (once a probe or a scoring step)."""
    spec, trace = _trace(fake, name)
    found = PA.audit_trace(spec, trace)
    assert not _active(found), render_report(found)
    copies = (spec.host_copies if spec.host_copies is not None
              else spec.expected_host_leaves)
    assert trace.d2h == copies
    if name.startswith(("probe", "group_probe", "mesh_probe",
                        "mesh_group_probe", "zreplay")):
        assert trace.kernels.get("probe_kernel", 0) \
            + trace.kernels.get("probe_kernel_bf16", 0) >= 1
    if name.startswith("zreplay"):
        assert trace.kernels["zreplay_kernel"] >= 1
    expect = {"victim_score": "preempt_kernel",
              "assign_auction": "assign_auction",
              "assign_beam": "assign_beam",
              "resident_scatter": "resident_scatter"}.get(name)
    if expect:
        assert trace.kernels == {expect: 1}


def test_kernel_libraries_are_refused_while_tracing(fake):
    """A launch that bypasses the swap (a wrapper calling its library
    directly) fails loudly instead of handing null pointers to a card."""
    from kubernetes_tpu_torch.ops import probe_kernel

    lib, launch = probe_kernel._lib, probe_kernel._launch
    with fake.active():
        with pytest.raises(PA.KernelReached):
            probe_kernel._lib()
        assert probe_kernel._launch is not launch
    # restored after the window
    assert probe_kernel._lib is lib and probe_kernel._launch is launch


# -- one seeded violation per rule --------------------------------------------


def _rules(fake, spec):
    return {f.rule for f in _active(PA.audit_trace(
        spec, fake.trace_program(spec)))}


def test_seeded_item_in_a_probe_copy_is_a_host_sync(fake):
    base = _spec(fake, "probe")

    def seeded(static, carry, pod):  # the probe, and a value read back
        out = base.fn(static, carry, pod)
        if out["packed"].sum().item() < 0:
            return {"packed": out["packed"] + 1}
        return out

    assert "host-sync" in _rules(fake, dataclasses.replace(base, fn=seeded))
    assert "host-sync" not in _rules(fake, base)


def test_seeded_integer_matmul_is_denylisted(fake):
    base = _spec(fake, "probe")

    def seeded(static, carry, pod):
        a = static["alloc_mcpu"]
        return {"packed": a[:, None] @ a[None, :]}

    assert "denylisted-primitive" in _rules(
        fake, dataclasses.replace(base, fn=seeded))


def test_seeded_f64_upcast_is_flagged(fake):
    base = _spec(fake, "probe")

    def seeded(static, carry, pod):
        return {"packed": static["alloc_mcpu"].to(torch.float64) * 1.5}

    assert "f64-upcast" in _rules(fake, dataclasses.replace(base, fn=seeded))
    # the same program registered allow_f64 is clean of it
    assert "f64-upcast" not in _rules(fake, dataclasses.replace(
        base, fn=seeded, allow_f64=True))


def test_seeded_overwrite_index_put_in_a_fold_is_flagged(fake):
    base = _spec(fake, "apply")

    def seeded(static, carry, pod, counts):
        carry = base.fn(static, carry, pod, counts)
        idx = torch.zeros((2,), dtype=torch.int64, device=counts.device)
        carry["res"][0][idx] = counts[:2]  # overwrite, colliding ids
        return carry

    found = PA.audit_trace(base, fake.trace_program(
        dataclasses.replace(base, fn=seeded)))
    sc = [f for f in found if f.rule == "scatter-contract"]
    assert sc and "overwrite index_put_" in sc[0].message, found


def test_seeded_widened_int8_node_table_is_flagged(fake):
    base = _spec(fake, "probe_quant_int8")
    assert "dtype-contract" not in _rules(fake, base)

    def seeded(static, carry, pod):
        out = base.fn(static, carry, pod)
        wide = static["taint_count"].to(torch.int64)  # a node table
        return {"packed": out["packed"] + (wide * 2).sum()}

    assert "dtype-contract" in _rules(fake, dataclasses.replace(
        base, fn=seeded))
    # an index feed is exempt: the widened zone ids only index
    def index_only(static, carry, pod):
        out = base.fn(static, carry, pod)
        z = static["zone_id"].to(torch.int64)
        cnt = torch.zeros((8,), dtype=torch.int64, device=z.device)
        cnt.index_add_(0, z.clamp(0, 7), torch.ones_like(z))
        return {"packed": out["packed"] + cnt.sum()}

    assert "dtype-contract" not in _rules(fake, dataclasses.replace(
        base, fn=index_only))


def test_seeded_narrow_table_arriving_wide_is_flagged(fake):
    base = _spec(fake, "probe_quant_int8")
    wide = dict(base.args[0])
    wide["zone_id"] = _spec(fake, "probe").args[0]["zone_id"]
    spec = dataclasses.replace(base, args=(wide,) + base.args[1:])
    found = PA.audit_trace(spec, fake.trace_program(spec))
    assert any(f.rule == "dtype-contract" and "arrives as" in f.message
               for f in found), found


def test_seeded_donated_carry_returned_new_is_flagged(fake):
    base = _spec(fake, "mesh_apply")
    assert "donation-contract" not in _rules(fake, base)

    def seeded(*args):
        out = base.fn(*args)
        return tuple(Sharded(t.clone() for t in leaf) for leaf in out)

    assert "donation-contract" in _rules(fake, dataclasses.replace(
        base, fn=seeded))


def test_seeded_shard_on_the_wrong_device_is_flagged(fake):
    base = _spec(fake, "mesh_probe")
    statics = [dict(d) for d in base.args[0]]
    with fake.active():
        statics[1]["alloc_mcpu"] = statics[1]["alloc_mcpu"].to("cuda:0")
    found = PA._placement_findings(dataclasses.replace(
        base, args=(statics,) + base.args[1:]))
    assert [f.rule for f in found] == ["sharding-drift"], found
    assert "shard 1 lies on cuda:0" in found[0].message
    assert not PA._placement_findings(base)


def test_seeded_extra_cpu_output_is_flagged(fake):
    base = _spec(fake, "probe")

    def seeded(static, carry, pod):
        out = base.fn(static, carry, pod)
        return out, static["alloc_mcpu"] + 1  # a second host-bound leaf

    found = PA.audit_trace(base, fake.trace_program(
        dataclasses.replace(base, fn=seeded)))
    tc = [f.message for f in found if f.rule == "transfer-contract"]
    assert any("2 host-bound output leaf(s)" in m for m in tc), found
    assert any("2 device-to-host copies" in m for m in tc), found


def test_seeded_data_dependent_shape_is_flagged(fake):
    base = _spec(fake, "probe")

    def seeded(static, carry, pod):
        out = base.fn(static, carry, pod)
        live = static["alloc_mcpu"].nonzero()
        return {"packed": out["packed"] + live.sum()}

    assert "dynamic-shape" in _rules(fake, dataclasses.replace(
        base, fn=seeded))


def test_audit_all_reports_an_unbuilt_mesh(monkeypatch):
    class NoMesh:
        specs = []

    monkeypatch.setattr(PA, "registered_programs", lambda **_k: NoMesh())
    found = PA.audit_all(include_mesh=True)
    assert [f.rule for f in found] == ["mesh-unavailable"]


# -- the lint -----------------------------------------------------------------


def test_tree_lint_clean():
    findings = lint.lint_tree()
    assert not _active(findings), render_report(findings)


def test_program_seeds_cover_the_registry(cpu_registry):
    """Every registered program seeds the program scope, and every seed
    names a function of its module."""
    import ast
    import importlib

    assert set(lint.PROGRAM_SEEDS) == set(cpu_registry)
    for name, seeds in lint.PROGRAM_SEEDS.items():
        for mod, fn in seeds:
            m = importlib.import_module(f"kubernetes_tpu_torch.{mod}")
            tree = ast.parse(open(m.__file__).read())
            defs = {n.name for n in ast.walk(tree)
                    if isinstance(n, ast.FunctionDef)}
            assert fn in defs, (name, mod, fn)


_SEEDS = {"seeded": (("models._seeded_fixture", "_program_body"),)}

_HOT_FIXTURE = '''\
import torch


def _program_body(x):
    k = x.sum(){item}  # seeded host sync
    return x * k


def run(x):
    return _program_body(x)
'''


def test_seeded_item_in_a_program_is_flagged():
    src = _HOT_FIXTURE.format(item=".item()")
    found = lint.lint_sources(
        {"kubernetes_tpu_torch/models/_seeded_fixture.py": src}, _SEEDS)
    hs = [f for f in found if f.rule == "host-sync"]
    assert len(hs) == 1 and not hs[0].suppressed, found
    assert "_seeded_fixture.py:5" in hs[0].where


def test_lint_suppression_syntax():
    src = _HOT_FIXTURE.format(
        item=".item()  # lint: allow[host-sync]")
    found = lint.lint_sources(
        {"kubernetes_tpu_torch/models/_seeded_fixture.py": src}, _SEEDS)
    hs = [f for f in found if f.rule == "host-sync"]
    assert len(hs) == 1 and hs[0].suppressed, found


def test_program_scope_is_transitive_and_cold_code_is_exempt():
    src = '''\
import numpy as np
import torch


def helper(x):
    return x.sum().cpu()  # reached from a program


def _program_body(x):
    torch.cuda.synchronize()
    return helper(x) + np.asarray(x.tolist())


def host_driver(arr):
    return arr.sum().item()  # NOT a program: no finding here
'''
    found = lint.lint_sources(
        {"kubernetes_tpu_torch/models/_seeded_fixture.py": src}, _SEEDS)
    hs = sorted(int(f.where.rsplit(":", 1)[1]) for f in found
                if f.rule == "host-sync")
    assert hs == [6, 10, 11, 11], found


def test_program_scope_seeds_a_registered_program():
    """The default seeds: a .cpu() in a copy of models/probe.py's
    _probe_fn and in its callee is flagged, a cold function is not."""
    src = '''\
def _helper(x):
    return x.cpu()


def _probe_fn(config, num_zones, num_values, J, static, carry, pod):
    return {"packed": _helper(static["alloc_mcpu"]).tolist()}


def cold(x):
    return x.cpu()
'''
    found = lint.lint_sources({"kubernetes_tpu_torch/models/probe.py": src})
    hs = sorted(int(f.where.rsplit(":", 1)[1]) for f in found
                if f.rule == "host-sync")
    assert hs == [2, 6], found


def test_program_impure_rules_fire():
    src = '''\
import random
import time

import numpy as np
import torch


def _program_body(x, g):
    t = time.time()  # seeded impurity
    print("trace me")
    noise = torch.rand(3)
    fine = torch.rand(3, generator=g)
    r = random.random() + np.random.rand()
    return x
'''
    found = lint.lint_sources(
        {"kubernetes_tpu_torch/ops/_seeded_fixture.py": src},
        {"s": (("ops._seeded_fixture", "_program_body"),)})
    impure = sorted(int(f.where.rsplit(":", 1)[1]) for f in found
                    if f.rule == "traced-impure")
    assert impure == [9, 10, 11, 13, 13], found


_WALL_CLOCK_FIXTURE = '''\
import time
from time import time as walltime


class Lease:
    def renew(self, window):
        self.expiry = time.time() + window        # arithmetic
        return self.expiry

    def valid(self):
        return time.time() < self.expiry          # comparison

    def wait_for(self, cond):
        cond.wait(timeout=time.time())            # deadline keyword
        self.deadline = walltime()                # deadline-ish bind

    def stamp_event(self):
        return time.time()                        # bare read: legal

    def monotonic_path(self, window):
        return time.monotonic() + window          # the correct form
'''


def test_seeded_wall_clock_deadline_is_flagged():
    found = lint.lint_sources(
        {"kubernetes_tpu_torch/storage/quorum/_seeded_lease.py":
         _WALL_CLOCK_FIXTURE})
    wc = [f for f in found if f.rule == "wall-clock-deadline"]
    assert len(wc) == 4 and not any(f.suppressed for f in wc), found
    lines = sorted(int(f.where.rsplit(":", 1)[1]) for f in wc)
    assert lines == [7, 11, 14, 15], wc


def test_wall_clock_rule_covers_all_named_modules_and_no_others():
    src = "import time\ndeadline = time.time() + 5.0\n"
    for rel in ("kubernetes_tpu_torch/storage/quorum/_seeded.py",
                "kubernetes_tpu_torch/client/transport.py",
                "kubernetes_tpu_torch/apiserver/flowcontrol.py"):
        found = lint.lint_sources({rel: src})
        assert any(f.rule == "wall-clock-deadline" for f in found), rel
    found = lint.lint_sources(
        {"kubernetes_tpu_torch/scheduler/_seeded.py": src})
    assert not any(f.rule == "wall-clock-deadline" for f in found)


def test_wall_clock_suppression_syntax():
    src = ("import time\n"
           "t = time.time() + 5  # lint: allow[wall-clock-deadline]\n")
    found = lint.lint_sources(
        {"kubernetes_tpu_torch/storage/quorum/_seeded.py": src})
    wc = [f for f in found if f.rule == "wall-clock-deadline"]
    assert len(wc) == 1 and wc[0].suppressed, found


_PACKAGE_WIDE_FIXTURE = '''\
import threading
from {pkg}.metrics import Counter


def f(x=[]):
    try:
        pass
    except:
        pass
    threading.Thread(target=f).start()
    return Counter("loose_total", "constructed outside the registry")
'''


def test_lint_package_wide_rules_fire():
    src = _PACKAGE_WIDE_FIXTURE.format(pkg="kubernetes_tpu_torch")
    found = lint.lint_sources(
        {"kubernetes_tpu_torch/client/_seeded3.py": src})
    rules = {f.rule for f in found}
    assert {"mutable-default", "bare-except", "nondaemon-thread",
            "metric-outside-registry"} <= rules, found


def test_lint_syntax_error_is_a_finding_not_a_crash():
    found = lint.lint_sources({
        "kubernetes_tpu_torch/models/_broken.py": "def f(:\n",
        "kubernetes_tpu_torch/models/_fine.py": "x = 1\n",
    })
    se = [f for f in found if f.rule == "syntax-error"]
    assert len(se) == 1 and "_broken.py" in se[0].where, found


_GUARDED_FIXTURE = '''\
import threading


class Box:
    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._data = {{}}  # guarded-by: self._lock

    def good(self, k, v):
        with self._lock:
            self._data[k] = v

    def also_good(self, k, v):
        with self._cond:  # Condition aliases its lock
            self._data[k] = v

    def _helper(self, k):  # guarded-by: self._lock
        self._data.pop(k, None)

    def _drop_locked(self, k):
        self._data.pop(k, None)

    def bad(self, k, v):
        {bad_write}
'''


def test_seeded_guarded_by_violation_is_flagged():
    src = _GUARDED_FIXTURE.format(bad_write="self._data[k] = v")
    found = lint.lint_sources(
        {"kubernetes_tpu_torch/client/_seeded_gb.py": src})
    gb = [f for f in found if f.rule == "guarded-by"]
    assert len(gb) == 1 and not gb[0].suppressed, found
    assert "Box._data" in gb[0].message
    assert "self._lock" in gb[0].message


def test_guarded_by_clean_class_is_clean():
    src = _GUARDED_FIXTURE.format(
        bad_write="with self._lock:\n            self._data[k] = v")
    found = lint.lint_sources(
        {"kubernetes_tpu_torch/client/_seeded_gb.py": src})
    assert not [f for f in found if f.rule == "guarded-by"], found


def test_guarded_by_suppression_is_honored():
    src = _GUARDED_FIXTURE.format(
        bad_write="self._data[k] = v  # lint: allow[guarded-by]")
    found = lint.lint_sources(
        {"kubernetes_tpu_torch/client/_seeded_gb.py": src})
    gb = [f for f in found if f.rule == "guarded-by"]
    assert len(gb) == 1 and gb[0].suppressed, found


_ESCAPE_FIXTURE = '''\
import threading


class Esc:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []

    def start(self):
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self):
        with self._lock:
            self._items.append(1)

    def nudge(self):
        self._items.append(2)
'''


def test_unguarded_shared_write_in_escaping_class_is_flagged():
    found = lint.lint_sources(
        {"kubernetes_tpu_torch/client/_seeded_esc.py": _ESCAPE_FIXTURE})
    uw = [f for f in found if f.rule == "unguarded-shared-write"]
    assert len(uw) == 1, found
    assert "Esc._items" in uw[0].message
    solo = _ESCAPE_FIXTURE.replace(
        "        threading.Thread(target=self._run, daemon=True)"
        ".start()\n", "        pass\n")
    found2 = lint.lint_sources(
        {"kubernetes_tpu_torch/client/_seeded_esc.py": solo})
    assert not [f for f in found2
                if f.rule == "unguarded-shared-write"], found2


_JOIN_FIXTURE = '''\
import os
import threading


def f():
    p = os.path.join("a", "b")
    s = ", ".join(["x", "y"])
    threading.Thread(target=print).start()
    return p, s
'''


def test_nondaemon_thread_rule_ignores_path_and_str_joins():
    found = lint.lint_sources(
        {"kubernetes_tpu_torch/client/_seeded5.py": _JOIN_FIXTURE})
    assert any(f.rule == "nondaemon-thread" for f in found), found
    joined = _JOIN_FIXTURE.replace(
        "    return p, s",
        "    t = threading.Thread(target=print)\n"
        "    t.start()\n"
        "    t.join()\n"
        "    return p, s",
    )
    found2 = lint.lint_sources(
        {"kubernetes_tpu_torch/client/_seeded5.py": joined})
    assert not any(f.rule == "nondaemon-thread" for f in found2), found2


@pytest.mark.parametrize("rel,src", [
    ("client/_seeded3.py", _PACKAGE_WIDE_FIXTURE),
    ("storage/quorum/_seeded_lease.py", _WALL_CLOCK_FIXTURE),
    ("client/_seeded_gb.py",
     _GUARDED_FIXTURE.format(bad_write="self._data[k] = v")),
    ("client/_seeded_esc.py", _ESCAPE_FIXTURE),
    ("client/_seeded5.py", _JOIN_FIXTURE),
    ("models/_broken.py", "def f(:\n"),
])
def test_kept_rules_find_what_the_jax_lint_finds(rel, src):
    """The package-wide, scoped and concurrency rules are the JAX lint's:
    on the same source, under each package's path, equal findings."""
    def rows(pkg, findings):
        return sorted((f.rule, f.where.replace(pkg, ""), f.message,
                       f.suppressed) for f in findings)

    mine = lint.lint_sources({f"kubernetes_tpu_torch/{rel}": src.replace(
        "{pkg}", "kubernetes_tpu_torch")})
    theirs = jax_lint.lint_sources({f"kubernetes_tpu/{rel}": src.replace(
        "{pkg}", "kubernetes_tpu")})
    assert mine and rows("kubernetes_tpu_torch", mine) == rows(
        "kubernetes_tpu", theirs)


# -- the rebuild sentinel -----------------------------------------------------


def test_compile_sentinel_fires_on_a_build_or_load_in_a_window(
        tmp_path, monkeypatch):
    from kubernetes_tpu_torch.native import build

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    sentinel = CompileSentinel()
    path = build.ensure_replay()  # built OUTSIDE any guarded window
    if path is None:
        pytest.skip("no C compiler to build the host replay engine")
    assert sentinel.compile_count() == 1
    with sentinel.expect_no_compiles("warm"):
        assert build.ensure_replay() == path  # cached: no event
    with pytest.raises(AssertionError, match=r"cold.*replay\.c"):
        with sentinel.expect_no_compiles("cold"):
            (tmp_path / "_replay.so").unlink()
            build.ensure_replay()
    with pytest.raises(AssertionError, match=r"load _replay\.so \("):
        with sentinel.expect_no_compiles("load"):
            build.load_library(path)
    assert sentinel.compile_count() == 3


# -- the CLI gate -------------------------------------------------------------


class _Shared:
    def __init__(self):
        self.val = 0


def _run_pair(t1, t2):
    a = threading.Thread(target=t1)
    b = threading.Thread(target=t2)
    a.start()
    b.start()
    a.join()
    b.join()


def test_cli_lint_gate_exits_zero():
    from kubernetes_tpu_torch.analysis.__main__ import main

    assert main(["--lint-only"]) == 0


def test_cli_json_mode_emits_machine_readable_rows(capsys, tmp_path):
    from kubernetes_tpu_torch.analysis.__main__ import main

    report = tmp_path / "races.jsonl"
    try:
        with races.instrumented(reset=True):
            obj = races.track(_Shared(), "seeded.CLI")

            def t1():
                obj.val = 1

            def t2():
                obj.val = 2

            _run_pair(t1, t2)
            assert races.dump_jsonl(str(report)) >= 1
    finally:
        races.reset()

    rc = main(["--lint-only", "--json", "--race-report", str(report)])
    out = capsys.readouterr().out
    rows = [json.loads(line) for line in out.splitlines() if line]
    assert rc == 1  # the merged unsuppressed race fails the gate
    assert all({"pass", "rule", "where", "message", "suppressed"}
               <= set(r) for r in rows)
    assert any(r["pass"] == "races" and r["rule"] == "data-race"
               for r in rows)
    empty = tmp_path / "none.jsonl"
    empty.write_text("")
    assert main(["--lint-only", "--json", "--race-report",
                 str(empty)]) == 0
    capsys.readouterr()


def test_cli_malformed_race_report_fails_the_gate(tmp_path, capsys):
    from kubernetes_tpu_torch.analysis.__main__ import main

    bad = tmp_path / "corrupt.jsonl"
    bad.write_text("this is not json\n")
    assert main(["--lint-only", "--race-report", str(bad)]) == 1
    assert "malformed-report" in capsys.readouterr().out
    assert main(["--lint-only", "--race-report"]) == 2


def test_cli_flags_a_seeded_program_and_emits_its_json_row(
        capsys, monkeypatch, fake):
    """The program pass through the CLI: a registry holding one seeded
    program exits 1 with a named row; --json emits one row per
    finding."""
    from kubernetes_tpu_torch.analysis.__main__ import main

    base = _spec(fake, "probe")

    def seeded(static, carry, pod):
        out = base.fn(static, carry, pod)
        return out, static["alloc_mcpu"] + 1

    class One:
        specs = [dataclasses.replace(base, name="seeded_probe", fn=seeded)]
        trace_program = fake.trace_program

    monkeypatch.setattr(PA, "registered_programs", lambda **_k: One())
    rc = main(["--programs-only", "--no-mesh", "--json"])
    rows = [json.loads(line) for line in
            capsys.readouterr().out.splitlines() if line]
    assert rc == 1
    assert [(r["pass"], r["rule"], r["where"]) for r in rows] == [
        ("programs", "transfer-contract", "seeded_probe")] * 2


def test_static_passes_model_check_the_store():
    from kubernetes_tpu_torch.analysis import run_static_passes

    assert run_static_passes(include_programs=False,
                             include_lint=False) == []


def test_findings_report_shape():
    rep = render_report([
        Finding("lint", "host-sync", "a.py:1", "x", suppressed=False),
        Finding("lint", "host-sync", "b.py:2", "y", suppressed=True),
    ], "t:")
    assert "1 finding(s), 1 suppressed" in rep
    assert "a.py:1" in rep
    assert "[suppressed lint/host-sync] b.py:2" in rep


def test_scan_repairs_leave_decisions_unchanged():
    """The audit's repairs (torch.take for a 0-d device index, torch.full
    for the float32 constants, place() through pinned memory on CUDA)
    keep the scan's picks: equal to the oracle on the registry's
    scenario."""
    from kubernetes_tpu_torch.analysis.programs import _scenario
    from kubernetes_tpu_torch.models.batch import BatchScheduler

    snap, batch = _scenario()
    chosen, _carry = BatchScheduler(device="cpu").schedule(snap, batch)
    from kubernetes_tpu.analysis.programs import _scenario as jax_scenario
    from kubernetes_tpu.models.batch import BatchScheduler as JaxBatch

    jsnap, jbatch = jax_scenario()
    jchosen, _ = JaxBatch().schedule(jsnap, jbatch)
    np.testing.assert_array_equal(chosen, np.asarray(jchosen))
