"""The port's soaks on the CPU: the mesh churn soak
(kubernetes_tpu_torch/harness/mesh_soak) against the JAX mesh and the
oracle, and the wire soak (harness/soak, the JAX package's with the
daemon's device) through its gates.

The mesh soak's parity is exact: the port's run_mesh_soak at 2 shards
and the JAX package's TPUScheduleAlgorithm(mesh=...) over 2 of the CPU
devices tests/conftest.py forces take the same waves of bench.py
run_soak's pods on its build(1000, 1) cluster, evictions included, and
bind every pod to the same node; the first wave also equals the port's
serial oracle, and the resident statistics equal the JAX mesh's."""

import ast
import copy
import pathlib

import jax
import numpy as np
from jax.sharding import Mesh

import bench
from kubernetes_tpu.scheduler.tpu_algorithm import TPUScheduleAlgorithm

from kubernetes_tpu_torch.harness import mesh_soak
from kubernetes_tpu_torch.harness.soak import SoakConfig, run_wire_soak
from kubernetes_tpu_torch.oracle import GenericScheduler

ROOT = pathlib.Path(__file__).resolve().parent.parent
WAVES = 6


def _source(path: pathlib.Path, name: str) -> str:
    text = path.read_text()
    node = next(n for n in ast.parse(text).body
                if getattr(n, "name", None) == name)
    return "\n".join(text.splitlines()[node.lineno - 1:node.end_lineno])


def _soak_record_keys() -> set:
    """The keys of bench.py run_soak's record, from its source."""
    fn = next(n for n in ast.parse((ROOT / "bench.py").read_text()).body
              if getattr(n, "name", None) == "run_soak")
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "record" for t in node.targets):
            keys |= {k.value for k in node.value.keys}
        elif isinstance(node, ast.Subscript) and isinstance(
                node.ctx, ast.Store) and getattr(node.value, "id",
                                                 None) == "record":
            keys.add(node.slice.value)
    return keys


def test_build_is_bench_build():
    """mesh_soak.build is bench.py build with the port's imports."""
    port = _source(ROOT / "kubernetes_tpu_torch/harness/mesh_soak.py",
                   "build")
    assert port.replace("kubernetes_tpu_torch.", "kubernetes_tpu.") == \
        _source(ROOT / "bench.py", "build")


def test_mesh_soak_binds_what_the_jax_mesh_and_the_oracle_bind():
    port_waves = []
    rec = mesh_soak.run_mesh_soak(
        shards=2, device="cpu", waves=WAVES,
        on_wave=lambda pods, hosts, ev: port_waves.append(
            ([p.metadata.name for p in pods], list(hosts), ev)))
    assert set(rec) == _soak_record_keys()
    assert rec["waves"] == WAVES
    assert rec["steady_state_compiles"] == 0
    assert rec["quiet_wave_table_bytes_max"] == 0
    # churn from the third loop wave on, every other wave
    assert [ev for _n, _h, ev in port_waves] == [
        0, 0, 0, 0, 2 * mesh_soak.WAVE, 0, 2 * mesh_soak.WAVE, 0]
    assert rec["pods_churned"] == 4 * mesh_soak.WAVE

    state, template = bench.build(1000, 1)
    algo = TPUScheduleAlgorithm(
        mesh=Mesh(np.array(jax.devices()[:2]), ("nodes",)))
    churn = mesh_soak.Churn(state, template[0])
    jax_waves = [churn.wave(algo, False) for _ in range(2)]
    jax_waves += [churn.wave(algo, w % 2 == 0) for w in range(WAVES)]
    for i, ((names, hosts, ev), (pods, jhosts, jev)) in enumerate(
            zip(port_waves, jax_waves)):
        assert names == [p.metadata.name for p in pods], i
        assert ev == jev, i
        assert hosts == list(jhosts), f"wave {i}"
    assert rec["resident_stats"] == {
        k: int(v) for k, v in algo._mesh_sched.resident.stats.items()
        if isinstance(v, int)}
    assert rec["resident_stats"]["scatters"] == 0

    oracle_state, template = mesh_soak.build(1000, 1)
    first = mesh_soak.Churn(oracle_state, template[0]).make_pods(
        mesh_soak.WAVE)
    assert GenericScheduler().schedule_backlog(
        copy.deepcopy(first), oracle_state) == port_waves[0][1]


def test_wire_soak_smoke_passes_its_gates_on_the_cpu():
    """The plain wire soak at tests/test_scenarios.py's smoke size: the
    daemon on the CPU, every gate met, the record keyed as the JAX
    package's soak record (tests/test_telemetry.py's soak, the smallest
    the JAX tests run)."""
    rec = run_wire_soak(SoakConfig(
        seconds=30, num_nodes=64, rate=30.0, device="cpu",
        params={"churn_floor": 512}))
    assert rec["ok"], {k: v for k, v in rec["gates"].items() if not v}
    assert rec["pods_bound"] > 0 and rec["watch_events_dropped"] == 0
    assert rec["steady_state_compiles"] == 0

    from kubernetes_tpu.harness.soak import SoakConfig as JaxSoakConfig
    from kubernetes_tpu.harness.soak import run_wire_soak as jax_soak

    jax_rec = jax_soak(JaxSoakConfig(seconds=8, num_nodes=16, rate=5.0,
                                     params={"churn_floor": 64}))
    # a breached gate adds its flight bundle's path
    assert set(rec) == set(jax_rec) - {"flight_bundle"}
    assert set(rec["gates"]) == set(jax_rec["gates"])
