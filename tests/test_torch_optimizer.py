"""The optimizing profile and the defragmentation controller of the port
against the JAX package's, on the CPU: the counterparts of
tests/test_optimizer.py.

Every profile test builds its scenario with the JAX package's types,
converts it to the port's (tests/test_torch_ops.to_port), runs
TorchScheduleAlgorithm(device="cpu", profile=...) and
TPUScheduleAlgorithm(profile=...) on it, and asserts equality, exactly:
the node names, the dispatch tally (the port's extra scan_pods count
aside), the optimizer's stats (slots, placed, fallbacks) and the final
lastNodeIndex; then the reference test's own checks. The defrag tests
hold the port's plans to JAX propose_migrations on the same state.

TestPodGroupStatusController runs the reference's cases against the
port's controller/podgroup.py (a copy) and control plane, its pods the
reference's, converted. Held elsewhere:
  * test_assign_programs_registered (:440): the port's registry holds
    the assign programs, in tests/test_torch_analysis.py
    test_registry_names_equal_jax_less_mesh_assign_auction;
  * TestGangBackoff (:668) tests only GangDirector, whose counterparts
    are in tests/test_torch_gang.py already.
"""

import copy
import random

import numpy as np
import pytest

import kubernetes_tpu.api.types as JT
from kubernetes_tpu.models import batch as JB
from kubernetes_tpu.oracle import ClusterState as JaxState
from kubernetes_tpu.oracle import GenericScheduler as JaxOracle
from kubernetes_tpu.scheduler.optimizer import active_profile as jax_profile
from kubernetes_tpu.scheduler.optimizer.controller import defrag as JD
from kubernetes_tpu.scheduler.tpu_algorithm import TPUScheduleAlgorithm

import kubernetes_tpu_torch.api.types as TT
from kubernetes_tpu_torch.harness import scenarios as S
from kubernetes_tpu_torch.models import batch as PB
from kubernetes_tpu_torch.oracle import ClusterState as PortState
from kubernetes_tpu_torch.scheduler.algorithm import TorchScheduleAlgorithm
from kubernetes_tpu_torch.scheduler.optimizer import (
    PROFILE_GREEDY,
    PROFILE_OPTIMIZING,
    active_profile,
)
from kubernetes_tpu_torch.scheduler.optimizer.controller import defrag as D

from tests.test_conformance import (
    ORACLE_PREDICATES,
    ORACLE_PRIORITIES,
    random_scenario,
)
from tests.test_optimizer import (
    LRBA,
    _assert_oracle_valid,
    interleaved_pack,
    node,
    pod,
)
from tests.test_torch_ops import port_state, to_port

PORT_LRBA = PB.SchedulerConfig(predicates=LRBA.predicates,
                               priorities=LRBA.priorities)


def tally(dispatches: dict) -> dict:
    """A wave's dispatch tally without the port's scan_pods count."""
    return {k: v for k, v in dispatches.items() if k != "scan_pods"}


def run_both(state, pods, profile, lrba=False, gangs=None):
    """The JAX scenario (state, pods) through the JAX algorithm and,
    converted, through the port's on the CPU: asserts equal names,
    dispatch tallies, optimizer stats and final lastNodeIndex. -> (names,
    the port's algorithm, the JAX algorithm)."""
    pstate, ppods = port_state(state), to_port(pods)
    port = TorchScheduleAlgorithm(device="cpu", profile=profile,
                                  config=PORT_LRBA if lrba else None)
    jax = TPUScheduleAlgorithm(profile=profile, config=LRBA if lrba else None)
    got = port.schedule_backlog(ppods, pstate, gangs=gangs)
    want = jax.schedule_backlog(pods, state, gangs=gangs)
    assert got == want
    if profile == PROFILE_OPTIMIZING:
        assert port._opt is not None and jax._opt is not None
        assert tally(port._opt.dispatches) == tally(jax._opt.dispatches)
        assert port._opt.dispatches is port._wave.dispatches
        assert port._opt.stats == jax._opt.stats
    else:
        assert port._opt is None
        assert tally(port._wave.dispatches) == tally(jax._wave.dispatches)
    assert port._last_node_index == jax._last_node_index
    return got, port, jax


# -- profile flag -------------------------------------------------------------


class TestProfileFlag:
    def test_default_and_override(self, monkeypatch):
        monkeypatch.delenv("KUBERNETES_TPU_PROFILE", raising=False)
        assert active_profile() == PROFILE_GREEDY == jax_profile()
        monkeypatch.setenv("KUBERNETES_TPU_PROFILE", "optimizing")
        assert active_profile() == PROFILE_OPTIMIZING == jax_profile()
        assert active_profile("greedy") == PROFILE_GREEDY
        assert TorchScheduleAlgorithm(device="cpu")._profile == "optimizing"
        assert TorchScheduleAlgorithm(
            device="cpu", profile="greedy")._profile == "greedy"

    def test_unknown_falls_back_to_greedy(self, monkeypatch):
        monkeypatch.setenv("KUBERNETES_TPU_PROFILE", "simulated-annealing")
        assert active_profile() == PROFILE_GREEDY == jax_profile()
        assert TorchScheduleAlgorithm(device="cpu")._profile == "greedy"

    def test_environment_reaches_the_daemon_algorithm(self, monkeypatch):
        """The daemon builds its algorithm through the provider registry
        without a profile argument: KUBERNETES_TPU_PROFILE decides."""
        from kubernetes_tpu_torch.scheduler import plugins
        from kubernetes_tpu_torch.scheduler import algorithmprovider  # noqa

        monkeypatch.setenv("KUBERNETES_TPU_PROFILE", "optimizing")
        provider = plugins.get_algorithm_provider("CUDAProvider")
        algo = provider.algorithm_factory(plugins.PluginFactoryArgs(),
                                          device="cpu")
        assert algo._profile == "optimizing"

    def test_no_card_still_raises(self):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError):
            TorchScheduleAlgorithm(profile="optimizing")


# -- profile: oracle validity fuzz -------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_optimizer_placements_pass_serial_oracle_fuzz(seed):
    rng = random.Random(1000 + seed)
    state, pending = random_scenario(
        rng, n_nodes=10, n_existing=8, n_pending=30)
    hosts, _port, _jax = run_both(copy.deepcopy(state), pending,
                                  PROFILE_OPTIMIZING)
    _assert_oracle_valid(state, pending, hosts)


@pytest.mark.parametrize("seed", range(4))
def test_optimizer_mixed_features_route_and_stay_feasible(seed):
    rng = random.Random(2000 + seed)
    state, pending = random_scenario(
        rng, n_nodes=8, n_existing=6, n_pending=20,
        interpod_p=0.3, volumes_p=0.3)
    hosts, port, _jax = run_both(copy.deepcopy(state), pending,
                                 PROFILE_OPTIMIZING)
    for p, h in zip(pending, hosts):
        if h is None:
            continue
        q = JT.shallow_copy(p)
        q.spec = JT.shallow_copy(p.spec)
        q.spec.node_name = h
        state.assign(q)
    for _nm, info in state.node_infos.items():
        if info.node is None:
            continue
        alloc = info.node.status.allocatable or {}
        assert info.requested_milli_cpu <= JT.resource_list_cpu_milli(alloc)
        assert info.requested_memory <= JT.resource_list_memory(alloc)
        assert len(info.pods) <= int(str(alloc.get("pods", 0) or 0))


def test_optimizer_strictly_beats_greedy_on_stranding_mix():
    n = 16
    pods = interleaved_pack(n)

    def cluster():
        return JaxState.build([node(f"n{i:03d}") for i in range(n)])

    hg, _p, _j = run_both(cluster(), pods, PROFILE_GREEDY, lrba=True)
    ho, _p, _j = run_both(cluster(), pods, PROFILE_OPTIMIZING, lrba=True)
    assert sum(1 for h in ho if h) > sum(1 for h in hg if h)
    assert sum(1 for h in ho if h) == len(pods)


def test_optimizer_o1_dispatches_per_wave(monkeypatch):
    nodes = [node(f"n{i:03d}") for i in range(16)]
    pods = [pod(f"p-{i:03d}-t{i % 12}", f"{200 + 100 * (i % 12)}m")
            for i in range(48)]
    _h, port, _j = run_both(JaxState.build(nodes), pods, PROFILE_OPTIMIZING,
                            lrba=True)
    assert sum(tally(port._opt.dispatches).values()) <= 4, \
        port._opt.dispatches
    # template count doubles; dispatch count must not
    pods2 = [pod(f"q-{i:03d}-t{i % 24}", f"{200 + 50 * (i % 24)}m")
             for i in range(96)]
    port2, jax2, got, want, solved, rem = run_split(
        monkeypatch, JaxState.build(nodes), pods2)
    assert sum(tally(port2._opt.dispatches).values()) <= 4
    assert_scan_is_serial(nodes, pods2, got, solved, rem)


def run_split(monkeypatch, state, pods):
    """The optimizing profile under LRBA in both packages, the port's
    solve and scan told apart: -> (port algorithm, JAX algorithm, port
    names, JAX names, the port's node ids after the solve (-1 where the
    scan decides), the positions the scan decided). Asserts the
    dispatch tallies, stats and final lastNodeIndex equal, and the names
    of the solve's placements equal."""
    from kubernetes_tpu_torch.scheduler.optimizer import profile as PP

    seen = {}
    orig = PP.OptimizingWaveDriver._solve_units

    def spy(self, *args):
        result = orig(self, *args)
        seen["solved"] = args[8].copy()  # `out` after the solve
        seen["remainder"] = sorted(args[9])
        return result

    monkeypatch.setattr(PP.OptimizingWaveDriver, "_solve_units", spy)
    port = TorchScheduleAlgorithm(device="cpu", profile=PROFILE_OPTIMIZING,
                                  config=PORT_LRBA)
    jax = TPUScheduleAlgorithm(profile=PROFILE_OPTIMIZING, config=LRBA)
    got = port.schedule_backlog(to_port(pods), port_state(state))
    want = jax.schedule_backlog(pods, state)
    assert tally(port._opt.dispatches) == tally(jax._opt.dispatches)
    assert port._opt.stats == jax._opt.stats
    assert port._last_node_index == jax._last_node_index
    solved = seen["solved"]
    placed = [i for i in range(len(pods)) if solved[i] >= 0]
    assert [got[i] for i in placed] == [want[i] for i in placed]
    return port, jax, got, want, solved, seen["remainder"]


def assert_scan_is_serial(nodes, pods, got, solved, rem):
    """The profile's remainder scan against the port's serial oracle
    (PodFitsResources, LeastRequested + BalancedAllocation), run from
    the solve's placements with the round-robin counter past them.

    Here the JAX package's jitted scan can pick another node: XLA:CPU
    contracts BalancedAllocation's 10 - diff*10 into an FMA
    (ROADMAP.md queue 3), and on the second wave of
    test_optimizer_o1_dispatches_per_wave it scores node n011 1 where
    the oracle, the JAX function run eagerly and the port score 2, so
    the remainder's names are held to the oracle, which the port's
    greedy scan equals everywhere else (tests/test_torch_wave.py)."""
    from kubernetes_tpu_torch.oracle import GenericScheduler as PortOracle
    from kubernetes_tpu_torch.oracle import predicates as OPR
    from kubernetes_tpu_torch.oracle.scheduler import DEFAULT_PRIORITIES

    ppods, pnodes = to_port(pods), to_port(nodes)
    placed = [i for i in range(len(pods)) if solved[i] >= 0]
    assigned = []
    for i in placed:
        q = TT.shallow_copy(ppods[i])
        q.spec = TT.shallow_copy(ppods[i].spec)
        q.spec.node_name = got[i]
        assigned.append(q)
    oracle = PortOracle(
        predicates=(("PodFitsResources", OPR.pod_fits_resources),),
        priorities=tuple(c for c in DEFAULT_PRIORITIES if c.name in (
            "LeastRequestedPriority", "BalancedResourceAllocation")),
        last_node_index=len(placed))
    want = oracle.schedule_backlog([ppods[i] for i in rem], PortState.build(
        pnodes, assigned_pods=assigned))
    assert [got[i] for i in rem] == want


def test_greedy_profile_untouched_by_optimizer_import():
    rng = random.Random(7)
    state, pending = random_scenario(rng, n_nodes=8, n_pending=20)
    oracle = JaxOracle(predicates=ORACLE_PREDICATES,
                       priorities=ORACLE_PRIORITIES)
    expected = oracle.schedule_backlog(pending, copy.deepcopy(state))
    got, port, _j = run_both(state, pending, PROFILE_GREEDY)
    assert got == expected
    assert port._opt is None


def test_solve_takes_the_beam_on_a_small_wave_and_the_auction_above():
    """A wave of at most 32 eligible slots goes to the beam, a larger one
    to the auction, in both packages (scheduler_optimizer_waves_total's
    solver label)."""
    from kubernetes_tpu import metrics as JM

    from kubernetes_tpu_torch import metrics as PM

    nodes = [node(f"n{i:03d}") for i in range(8)]
    for count, solver in ((24, "beam"), (40, "auction")):
        pods = [pod(f"w{count}-{i:03d}", f"{500 + 500 * (i % 3)}m")
                for i in range(count)]
        pb = PM.scheduler_optimizer_waves_total.get(solver=solver)
        jb = JM.scheduler_optimizer_waves_total.get(solver=solver)
        run_both(JaxState.build(nodes), pods, PROFILE_OPTIMIZING, lrba=True)
        assert PM.scheduler_optimizer_waves_total.get(solver=solver) \
            == pb + 1
        assert JM.scheduler_optimizer_waves_total.get(solver=solver) \
            == jb + 1


# -- gangs under the optimizer ------------------------------------------------


class TestOptimizerGangs:
    def test_unfittable_gang_never_partially_binds(self):
        nodes = [node(f"n{i}", cpu="4") for i in range(4)]
        members = [pod(f"g-{i}", "3000m") for i in range(6)]
        singles = [pod(f"s-{i}", "1000m") for i in range(4)]
        hosts, _p, _j = run_both(
            JaxState.build(nodes), singles + members, PROFILE_OPTIMIZING,
            lrba=True,
            gangs=[{"start": 4, "length": 6, "score_by_name": None}])
        assert all(h is None for h in hosts[4:]), hosts
        assert all(h is not None for h in hosts[:4])

    def test_fittable_gang_binds_whole(self):
        nodes = [node(f"n{i}", cpu="4") for i in range(4)]
        members = [pod(f"g-{i}", "3000m") for i in range(4)]
        hosts, _p, _j = run_both(
            JaxState.build(nodes), members, PROFILE_OPTIMIZING, lrba=True,
            gangs=[{"start": 0, "length": 4, "score_by_name": None}])
        assert all(h is not None for h in hosts)

    @pytest.mark.parametrize("seed", range(4))
    def test_gang_atomicity_fuzz(self, seed):
        rng = random.Random(3000 + seed)
        n = rng.choice([4, 6, 8])
        nodes = [node(f"n{i}", cpu="4") for i in range(n)]
        gang_len = rng.choice([2, 3, n + 2])
        members = [pod(f"g-{i}", f"{rng.choice([2000, 3000])}m")
                   for i in range(gang_len)]
        singles = [pod(f"s-{i}", "500m")
                   for i in range(rng.randint(0, 6))]
        hosts, _p, _j = run_both(
            JaxState.build(nodes), singles + members, PROFILE_OPTIMIZING,
            lrba=True,
            gangs=[{"start": len(singles), "length": gang_len,
                    "score_by_name": None}])
        placed = sum(1 for h in hosts[len(singles):] if h is not None)
        assert placed in (0, gang_len)

    def test_gang_score_row_rides_the_solve(self):
        """A gang's per-node score term (score_by_name) enters the solve's
        score rows in both packages alike."""
        nodes = [node(f"n{i}", cpu="8") for i in range(6)]
        members = [pod(f"g-{i}", "2000m") for i in range(4)]
        by_name = {f"n{i}": 10 * i for i in range(6)}
        hosts, _p, _j = run_both(
            JaxState.build(nodes), members, PROFILE_OPTIMIZING, lrba=True,
            gangs=[{"start": 0, "length": 4, "score_by_name": by_name}])
        assert all(h is not None for h in hosts)


@pytest.mark.parametrize("n_nodes", [1000, 1024])
def test_gang_on_the_pack_cluster_matches_jax(n_nodes):
    """A gang of 64 x 3 CPU ahead of 64 1-CPU singletons on
    pack_config2's empty cluster: equal to the JAX package, all or
    nothing. On 1,024 nodes it binds whole. On 1,000 nodes (padded to
    1,024) both packages park it although it fits: the auction's tie
    rotation (p + n) % N runs over the padded node axis, so slots 0..24
    all rank the last real node first and one of them is seated a round,
    and 16 rounds leave members unassigned (ROADMAP.md queue 3)."""
    cfg = S.pack_config2(JT, n_nodes=n_nodes)
    pods, gangs = S.pack_gang_wave(JT, 64, singles=64, name="fit")
    hosts, port, _jax = run_both(S.pack_state(JaxState, cfg), pods,
                                 PROFILE_OPTIMIZING, lrba=True, gangs=gangs)
    bound = sum(1 for h in hosts[:64] if h is not None)
    assert bound in (0, 64)
    assert all(h is not None for h in hosts[64:])
    if n_nodes == 1024:
        assert bound == 64
    assert port._opt.stats["slots"] == 128


# -- the pack gates -----------------------------------------------------------


@pytest.mark.parametrize("key", sorted(S.PACK_CONFIGS))
def test_pack_smoke_gates_strict_improvement(key):
    """bench.py run_pack(smoke=True)'s gates through harness/scenarios.py:
    the optimizing arm schedules strictly more pods at strictly higher
    utilization than greedy, both within 6 dispatches; every arm equal
    to the JAX package's on the same config."""
    build = S.PACK_CONFIGS[key]
    arms = {}
    for prof in (PROFILE_GREEDY, PROFILE_OPTIMIZING):
        pcfg, jcfg = build(TT, smoke=True), build(JT, smoke=True)
        port = TorchScheduleAlgorithm(
            device="cpu", profile=prof,
            config=S.pack_scheduler_config(PB, pcfg))
        jax = TPUScheduleAlgorithm(
            profile=prof, config=S.pack_scheduler_config(JB, jcfg))
        hosts = port.schedule_backlog(pcfg["pods"],
                                      S.pack_state(PortState, pcfg))
        assert hosts == jax.schedule_backlog(jcfg["pods"],
                                             S.pack_state(JaxState, jcfg))
        pd = (port._opt or port._wave).dispatches
        jd = (jax._opt or jax._wave).dispatches
        assert tally(pd) == tally(jd)
        assert port._last_node_index == jax._last_node_index
        arms[prof] = {**S.pack_outcome(pcfg["pods"], hosts,
                                       pcfg["alloc_mcpu"]),
                      "dispatches": sum(tally(pd).values())}
    g, o = arms[PROFILE_GREEDY], arms[PROFILE_OPTIMIZING]
    assert o["scheduled"] > g["scheduled"]
    assert o["utilization"] > g["utilization"]
    assert o["dispatches"] <= 6 and g["dispatches"] <= 6


def test_pack_configs_are_bench_configs():
    """harness/scenarios.py's pack configs build what bench.py's do."""
    import bench

    for key, build in S.PACK_CONFIGS.items():
        ref = getattr(bench, f"_{key}")(True)
        state, pods, config, alloc = ref
        cfg = build(JT, smoke=True)
        assert [p.metadata.name for p in pods] == [
            p.metadata.name for p in cfg["pods"]]
        assert [p.spec.containers[0].requests for p in pods] == [
            p.spec.containers[0].requests for p in cfg["pods"]]
        assert [p.metadata.labels for p in pods] == [
            p.metadata.labels for p in cfg["pods"]]
        ours = S.pack_state(JaxState, cfg)
        assert sorted(state.node_infos) == sorted(ours.node_infos)
        assert [n.metadata.labels for n in state.nodes()] == [
            n.metadata.labels for n in ours.nodes()]
        assert len(state.services) == len(ours.services)
        assert len(state.controllers) == len(ours.controllers)
        assert alloc == cfg["alloc_mcpu"]
        want = None if config is None else (config.predicates,
                                            config.priorities)
        assert want == cfg["config"]


# -- defragmentation ----------------------------------------------------------


def _strand_state(CS, T, n=8, used_cpu="2000m"):
    nodes = [to_node(T, f"n{i}") for i in range(n)]
    assigned = [to_pod(T, f"p{i}", used_cpu, node_name=f"n{i}")
                for i in range(n)]
    return CS.build(nodes, assigned_pods=assigned)


def to_node(T, name):
    n = node(name)
    return n if T is JT else to_port(n)


def to_pod(T, name, cpu, node_name=None):
    p = pod(name, cpu, node_name=node_name)
    return p if T is JT else to_port(p)


def plan_names(plan):
    return [(p.metadata.name, s, d) for p, s, d in plan]


class TestDefrag:
    TARGET = np.array([3000, 3 << 30, 0, 1], np.int64)

    def test_fragmentation_measure(self):
        state = _strand_state(PortState, TT)
        assert D.fragmentation(state, self.TARGET) == 1.0 == \
            JD.fragmentation(_strand_state(JaxState, JT), self.TARGET)
        empty = PortState.build([to_node(TT, "e0"), to_node(TT, "e1")])
        assert D.fragmentation(empty, self.TARGET) == 0.0

    def test_proposal_pairs_and_unstrands(self):
        state = _strand_state(PortState, TT, 8)
        plan = D.propose_migrations(state, self.TARGET, budget=8)
        jplan = JD.propose_migrations(_strand_state(JaxState, JT, 8),
                                      self.TARGET, budget=8)
        assert plan_names(plan) == plan_names(jplan)
        assert 0 < len(plan) <= 8
        D.apply_migrations_to_state(state, plan)
        assert D.fragmentation(state, self.TARGET) == 0.0

    def test_budget_caps_plan(self):
        plan = D.propose_migrations(_strand_state(PortState, TT, 8),
                                    self.TARGET, budget=2)
        assert plan_names(plan) == plan_names(JD.propose_migrations(
            _strand_state(JaxState, JT, 8), self.TARGET, budget=2))
        assert len(plan) <= 2

    def test_priority_protection(self):
        plan = D.propose_migrations(
            _strand_state(PortState, TT, 8), self.TARGET, budget=8,
            beneficiary_priority=1, priority_of=lambda p: 5)
        assert plan == []

    @pytest.mark.parametrize("seed", range(8))
    def test_migrations_never_reduce_schedulability_fuzz(self, seed):
        rng = random.Random(4000 + seed)
        n = rng.choice([6, 8, 10])
        nodes = [node(f"n{i}") for i in range(n)]
        assigned = []
        k = 0
        for i in range(n):
            for _ in range(rng.randint(0, 3)):
                assigned.append(pod(
                    f"a{k}", f"{rng.choice([500, 1000, 2000])}m",
                    node_name=f"n{i}"))
                k += 1
        pending = [pod(f"w{i}", f"{rng.choice([1000, 3000])}m")
                   for i in range(6)]
        pnodes, passigned, ppending = (to_port(nodes), to_port(assigned),
                                       to_port(pending))
        target = D.target_shape(
            PortState.build(pnodes, assigned_pods=passigned), ppending)
        assert np.array_equal(target, JD.target_shape(
            JaxState.build(nodes, assigned_pods=assigned), pending))

        def schedulable(state):
            algo = TorchScheduleAlgorithm(device="cpu", config=PORT_LRBA,
                                          profile="greedy")
            hosts = algo.schedule_backlog(list(ppending), state)
            return sum(1 for h in hosts if h is not None)

        before = schedulable(PortState.build(pnodes,
                                             assigned_pods=list(passigned)))
        after_state = PortState.build(pnodes, assigned_pods=list(passigned))
        frag_before = D.fragmentation(after_state, target)
        plan = D.propose_migrations(after_state, target, budget=6)
        jplan = JD.propose_migrations(
            JaxState.build(nodes, assigned_pods=list(assigned)), target,
            budget=6)
        assert plan_names(plan) == plan_names(jplan)
        D.apply_migrations_to_state(after_state, plan)
        assert D.fragmentation(after_state, target) <= frag_before
        assert schedulable(after_state) >= before

    def test_busy_backoff(self):
        clock = {"t": 0.0}
        ctrl = D.DefragController(
            lambda: _strand_state(PortState, TT), busy_fn=lambda: True,
            clock=lambda: clock["t"])
        assert ctrl.sync_once()["outcome"] == "busy"
        first = ctrl._backoff
        assert first > 0
        ctrl.sync_once()
        assert ctrl._backoff >= first
        assert ctrl._backoff <= ctrl.backoff_max

    def test_calm_below_threshold(self):
        state = PortState.build([to_node(TT, "n0"), to_node(TT, "n1")])
        res = D.DefragController(lambda: state).sync_once()
        assert res["outcome"] == "calm"
        assert res["migrations"] == 0

    def test_execute_evicts_and_rebinds_through_batch_door(self):
        """The port's controller against the port's apiserver: the
        evictions go through its /api/v1/batch door, the pods come back
        assigned, and the plan equals the JAX controller's on the JAX
        apiserver with the same cluster."""
        from kubernetes_tpu.apiserver.server import APIServer as JaxAPI
        from kubernetes_tpu.client import LocalTransport as JaxLocal
        from kubernetes_tpu.client import RESTClient as JaxClient

        from kubernetes_tpu_torch.apiserver.server import APIServer
        from kubernetes_tpu_torch.client import LocalTransport, RESTClient

        n = 4
        outcomes = {}
        for name, T, CS, mod, api, client_of in (
                ("port", TT, PortState, D, APIServer,
                 lambda s: RESTClient(LocalTransport(s))),
                ("jax", JT, JaxState, JD, JaxAPI,
                 lambda s: JaxClient(JaxLocal(s)))):
            client = client_of(api())
            for i in range(n):
                client.nodes().create(to_node(T, f"n{i}"))
            for i in range(n):
                client.pods().create(to_pod(T, f"p{i}", "2000m",
                                            node_name=f"n{i}"))

            def state_fn(client=client, CS=CS):
                nodes_live, _ = client.nodes().list()
                pods_live, _ = client.pods().list()
                return CS.build(list(nodes_live),
                                assigned_pods=[p for p in pods_live
                                               if p.spec.node_name])

            ctrl = mod.DefragController(
                state_fn, client=client,
                pending_fn=lambda T=T: [to_pod(T, "want", "3000m")],
                frag_threshold=0.1)
            res = ctrl.sync_once()
            pods_live, _ = client.pods().list()
            outcomes[name] = (res["outcome"], res["migrations"],
                              sorted((p.metadata.name, p.spec.node_name)
                                     for p in pods_live))
            if name == "port":
                assert res["outcome"] == "migrated"
                assert res["migrations"] > 0
                by_node = {}
                for p in pods_live:
                    by_node.setdefault(p.spec.node_name, []).append(p)
                assert len(pods_live) == n
                assert [f"n{i}" for i in range(n) if f"n{i}" not in by_node]
                assert D.fragmentation(state_fn(), np.array(
                    [3000, 3 << 30, 0, 1], np.int64)) < 1.0
        assert outcomes["port"] == outcomes["jax"]


# -- PodGroup status reconciliation ------------------------------------------


class TestPodGroupStatusController:
    """tests/test_optimizer.py TestPodGroupStatusController against the
    port's controller, apiserver and client."""

    def _plane(self):
        from kubernetes_tpu_torch.apiserver.server import APIServer
        from kubernetes_tpu_torch.client import LocalTransport, RESTClient
        from kubernetes_tpu_torch.controller.framework import (
            SharedInformerFactory,
        )
        from kubernetes_tpu_torch.controller.podgroup import (
            PodGroupStatusController,
        )

        server = APIServer()
        client = RESTClient(LocalTransport(server))
        informers = SharedInformerFactory(client)
        ctrl = PodGroupStatusController(client, informers)
        informers.start()
        informers.wait_for_sync()
        return client, informers, ctrl

    def test_reconciles_terminal_drift(self):
        client, informers, ctrl = self._plane()
        try:
            pgr = client.resource("podgroups", "default")
            pgr.create(TT.PodGroup(
                metadata=TT.ObjectMeta(name="train"),
                spec=TT.PodGroupSpec(min_member=2),
            ))
            for i in range(2):
                client.pods().create(to_port(pod(
                    f"m{i}", "100m",
                    labels={TT.POD_GROUP_LABEL: "train", "app": "train"},
                    node_name=f"n{i}")))
            # the scheduler recorded a fully bound gang, then died
            pgr.patch("train", {"status": {
                "phase": "Scheduled", "members": 2, "scheduled": 2,
            }}, subresource="status")
            # one member finishes while the scheduler is away
            client.pods().patch("m0", {"status": {
                "phase": "Succeeded"}}, subresource="status")
            informers.wait_for_sync()
            import time as _t

            deadline = _t.time() + 5
            while _t.time() < deadline:
                if ctrl.sync_once():
                    break
                _t.sleep(0.1)
            got = pgr.get("train")
            assert got.status.members == 1
            assert got.status.scheduled == 1
            assert got.status.phase == "Pending"  # below minMember now
        finally:
            informers.stop()

    def test_no_patch_when_in_sync(self):
        client, informers, ctrl = self._plane()
        try:
            pgr = client.resource("podgroups", "default")
            pgr.create(TT.PodGroup(
                metadata=TT.ObjectMeta(name="idle"),
                spec=TT.PodGroupSpec(min_member=1),
            ))
            import time as _t

            deadline = _t.time() + 5
            while _t.time() < deadline:
                ctrl.sync_once()
                got = pgr.get("idle")
                if got.status.phase == "Pending" \
                        and got.status.members == 0:
                    break
                _t.sleep(0.1)
            rv = pgr.get("idle").metadata.resource_version
            assert ctrl.sync_once() == 0  # steady state: zero PATCHes
            assert pgr.get("idle").metadata.resource_version == rv
        finally:
            informers.stop()
