"""The port's wave driver against the JAX package's and the oracle, on
the scenarios of tests/test_wave.py, on the CPU.

Each scenario is described once with harness/scenarios.py, whose
builders take a package's `types` module, and built through each
package's own API types; decisions must be identical (node names per
pod, exactly)."""

import copy
import random

import numpy as np
import pytest

import kubernetes_tpu.api.types as JT
from kubernetes_tpu.models.wave import WaveScheduler as JaxWave
from kubernetes_tpu.oracle import ClusterState as JaxState
from kubernetes_tpu.oracle import GenericScheduler as JaxOracle
from kubernetes_tpu.scheduler.tpu_algorithm import TPUScheduleAlgorithm

import kubernetes_tpu_torch.api.types as TT
from kubernetes_tpu_torch.harness import scenarios as S
from kubernetes_tpu_torch.models.wave import WaveScheduler
from kubernetes_tpu_torch.oracle import ClusterState as PortState
from kubernetes_tpu_torch.oracle import GenericScheduler as PortOracle
from kubernetes_tpu_torch.scheduler.algorithm import TorchScheduleAlgorithm
from kubernetes_tpu_torch.snapshot.encode import pod_feature_key

from tests.test_torch_ops import encode, port_state, scenario, to_port


def run_all(build, min_run=1):
    """build(types, ClusterState) -> (state, pods). -> (port names, JAX
    names, oracle names), the oracle being the port's copy."""
    pstate, ppods = build(TT, PortState)
    jstate, jpods = build(JT, JaxState)
    want = PortOracle().schedule_backlog(ppods, pstate.clone())
    got = TorchScheduleAlgorithm(device="cpu", min_run=min_run) \
        .schedule_backlog(ppods, pstate)
    jax = TPUScheduleAlgorithm(min_run=min_run).schedule_backlog(jpods,
                                                                 jstate)
    assert got == want
    assert jax == want
    return got


def spread_state(T, CS, nodes):
    return CS.build(nodes, services=[
        S.service(T, "svc", {"name": "sched-perf"})])


def test_tie_heavy():
    run_all(lambda T, CS: (spread_state(T, CS, S.density_nodes(T, 20)),
                           S.pause_pods(T, 150)))


def test_capacity_exhaustion_tail():
    got = run_all(lambda T, CS: (
        spread_state(T, CS, S.density_nodes(T, 5, pods_cap="4")),
        S.pause_pods(T, 40)))
    assert got.count(None) == 20


def test_taints_and_fill_rebuilds():
    run_all(lambda T, CS: (
        CS.build(S.density_nodes(T, 9, pods_cap="3", taint_every=3)),
        S.pause_pods(T, 30)))


def test_cpu_bound_fill():
    got = run_all(lambda T, CS: (
        CS.build(S.density_nodes(T, 4, cpu="1")),
        S.pause_pods(T, 50, requests={"cpu": "250m", "memory": "100Mi"})))
    assert got.count(None) == 50 - 4 * 4


def test_host_port_self_conflict():
    got = run_all(lambda T, CS: (CS.build(S.density_nodes(T, 6)),
                                 S.port_pods(T, 10)))
    assert got.count(None) == 4 and len({x for x in got if x}) == 6


def test_min_run_fallback_to_scan():
    run_all(lambda T, CS: (CS.build(S.density_nodes(T, 5)),
                           S.pause_pods(T, 20)), min_run=64)


def test_reprobe_on_table_horizon():
    """~333 pods per node against a table of 128 rows (max_j=128): the
    replay bails at the table horizon and re-probes from the folded
    carry; the JAX driver with the same bound agrees."""
    pods = S.pause_pods(JT, 1000, requests={"cpu": "10m", "memory": "10Mi"})
    state = JaxState.build(S.density_nodes(JT, 3, pods_cap="500"))
    snap, batch, psnap, pbatch = encode(state, [pods[0]])
    rep_idx = np.zeros(len(pods), np.int64)
    want, _, want_last = JaxWave(min_run=1, max_j=128).schedule_backlog(
        snap, batch, rep_idx)
    ws = WaveScheduler(min_run=1, max_j=128, device="cpu")
    got, carry, last = ws.schedule_backlog(psnap, pbatch, rep_idx)
    assert np.array_equal(got, want) and last == want_last
    assert ws.dispatches["probe"] > 1  # the horizon forced re-probes
    assert int(carry["last_idx"]) == last
    names = JaxOracle().schedule_backlog(pods, state.clone())
    assert [snap.node_names[c] for c in got] == names


@pytest.mark.parametrize("seed", range(4))
def test_mixed_backlog_random(seed):
    """test_wave's mixed random backlogs (the conformance generator's
    scenarios, each pod cloned into a run), the port's copy built by
    converting the JAX-package objects."""
    rng = random.Random(1000 + seed)
    state, pending = scenario(1000 + seed, n_nodes=8, n_existing=10,
                              n_pending=10,
                              interpod_p=0.25 if seed % 2 else 0.0,
                              volumes_p=0.25 if seed >= 2 else 0.0)
    backlog = []
    for p in pending:
        for c in range(rng.randint(1, 7)):
            q = copy.deepcopy(p)
            q.metadata.name = f"{p.metadata.name}-c{c}"
            backlog.append(q)
    want = JaxOracle().schedule_backlog(backlog, state.clone())
    assert TPUScheduleAlgorithm(min_run=1).schedule_backlog(
        backlog, state) == want
    got = TorchScheduleAlgorithm(device="cpu", min_run=1).schedule_backlog(
        to_port(backlog), port_state(state))
    assert got == want


def test_zoned_spread():
    run_all(lambda T, CS: (
        spread_state(T, CS, S.zoned_density_nodes(T, 15, unzoned_every=3)),
        S.pause_pods(T, 90)))


def test_zoned_capacity_exhaustion():
    got = run_all(lambda T, CS: (
        spread_state(T, CS, S.zoned_density_nodes(T, 6, pods_cap="5")),
        S.pause_pods(T, 45)))
    assert got[-1] is None


@pytest.mark.parametrize("seed", range(3))
def test_zoned_random_backlogs(seed):
    def build(T, CS):
        rng = random.Random(1000 + seed)
        zones = ["a", "b", "c", "d"][: rng.randint(1, 4)]
        nodes = S.zoned_density_nodes(
            T, rng.randint(4, 24), zones=tuple(zones),
            unzoned_every=rng.choice([0, 2, 3]),
            pods_cap=str(rng.randint(3, 30)))
        pods = S.pause_pods(T, rng.randint(20, 160))
        pods += S.pause_pods(T, rng.randint(10, 40), name0=10**5,
                             requests={"cpu": "200m", "memory": "1Gi"})
        return spread_state(T, CS, nodes), pods

    run_all(build)


def test_self_anti_one_per_node():
    got = run_all(lambda T, CS: (CS.build(S.hostname_nodes(T, 12)),
                                 S.anti_pods(T, 20, {"app": "exclusive"})))
    placed = [h for h in got if h]
    assert len(placed) == len(set(placed)) == 12 and got.count(None) == 8


def test_self_anti_carry_feeds_later_pods():
    got = run_all(lambda T, CS: (
        CS.build(S.hostname_nodes(T, 8)),
        S.anti_pods(T, 6, {"tier": "a"})
        + S.anti_pods(T, 6, {"tier": "a"}, name0=100,
                      requests={"cpu": "200m"})))
    placed = [h for h in got if h]
    assert len(placed) == len(set(placed)) == 8


def test_self_anti_zone_topology_falls_back():
    got = run_all(lambda T, CS: (
        CS.build(S.zoned_density_nodes(T, 9)),
        S.anti_pods(T, 9, {"app": "zonal"}, topo=S.ZONE)))
    assert got.count(None) == 6


@pytest.mark.parametrize("seed", range(3))
def test_self_anti_mixed_random(seed):
    def build(T, CS):
        rng = random.Random(2000 + seed)
        nodes = S.hostname_nodes(T, rng.randint(5, 16),
                                 pods_cap=str(rng.randint(2, 8)))
        pods = S.anti_pods(T, rng.randint(16, 40), {"g": "x"})
        pods += S.pause_pods(T, rng.randint(10, 50))
        pods += S.anti_pods(T, rng.randint(16, 30), {"g": "y"}, name0=500,
                            requests={"cpu": "150m"})
        rng.shuffle(pods)
        pods.sort(key=pod_feature_key)
        for i, p in enumerate(pods):
            p.metadata.name = f"pod-{i:06d}"
        return CS.build(nodes), pods

    run_all(build)
