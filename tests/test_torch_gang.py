"""The port's gangs (models/wave.py gang spans, scheduler/algorithm.py
gangs=, scheduler/gang.py GangDirector) against the JAX package's, on the
CPU, on the scenarios of tests/test_gang.py TestGangWaves and
TestDirectorPlanning, and on a director cycle with preemption.

Each scenario is built once per package from that package's API types;
hosts, the wave's dispatch tally, the gang layout, parking reasons,
PodGroup status updates and victim sets must be equal exactly."""

import random

import numpy as np
import pytest

import kubernetes_tpu.api.types as JT
from kubernetes_tpu.models.wave import WaveScheduler as JaxWave
from kubernetes_tpu.oracle import ClusterState as JaxState
from kubernetes_tpu.scheduler import gang as JG
from kubernetes_tpu.scheduler.tpu_algorithm import TPUScheduleAlgorithm
from kubernetes_tpu.snapshot.encode import SnapshotEncoder as JaxEncoder

import kubernetes_tpu_torch.api.types as TT
from kubernetes_tpu_torch.harness import scenarios as S
from kubernetes_tpu_torch.models.wave import WaveScheduler
from kubernetes_tpu_torch.oracle import ClusterState as PortState
from kubernetes_tpu_torch.oracle import GenericScheduler as PortOracle
from kubernetes_tpu_torch.scheduler import gang as PG
from kubernetes_tpu_torch.scheduler.algorithm import TorchScheduleAlgorithm
from kubernetes_tpu_torch.snapshot.encode import SnapshotEncoder

from tests.test_torch_wave import dispatch_shape

PACKAGES = {
    "port": (TT, PortState, PG,
             lambda **kw: TorchScheduleAlgorithm(device="cpu", **kw),
             {"device": "cpu"}),
    "jax": (JT, JaxState, JG, lambda **kw: TPUScheduleAlgorithm(**kw), {}),
}


def node(T, name, cpu="4", mem="32Gi", pods="110", labels=None):
    return T.Node(
        metadata=T.ObjectMeta(name=name, labels=labels or {}),
        status=T.NodeStatus(
            allocatable={"cpu": cpu, "memory": mem, "pods": pods},
            conditions=[T.NodeCondition("Ready", "True")]))


def pod(T, name, cpu="500m", labels=None, group=None, ts=None):
    lbl = dict(labels or {"app": "x"})
    if group:
        lbl[T.POD_GROUP_LABEL] = group
        lbl.setdefault("app", group)
    p = T.Pod(metadata=T.ObjectMeta(name=name, labels=lbl),
              spec=T.PodSpec(containers=[
                  T.Container(image="t", requests={"cpu": cpu})]))
    p.metadata.creation_timestamp = ts
    return p


def both(build, min_run=16):
    """build(T, CS) -> (state, backlog, gangs). Runs the backlog through
    each package's ScheduleAlgorithm with the gang layout; asserts equal
    hosts and dispatch tallies. -> (hosts, the port's tally)."""
    out = {}
    for name, (T, CS, _G, make, _kw) in PACKAGES.items():
        state, backlog, gangs = build(T, CS)
        algo = make(min_run=min_run)
        hosts = algo.schedule_backlog(backlog, state, gangs=gangs)
        out[name] = (hosts, dispatch_shape(algo._wave.dispatches))
    assert out["port"] == out["jax"]
    return out["port"]


def test_parked_gang_never_partially_binds():
    def build(T, CS):
        state = CS.build([node(T, f"n{i:02d}", cpu="2") for i in range(4)])
        backlog = ([pod(T, f"g{i}", group="g1") for i in range(20)]
                   + [pod(T, f"s{i}") for i in range(4)])
        return state, backlog, [{"start": 0, "length": 20}]

    hosts, _ = both(build)
    assert set(hosts[:20]) == {None}
    assert all(h is not None for h in hosts[20:])


def test_fitting_gang_binds_every_member():
    def build(T, CS):
        state = CS.build([node(T, f"n{i:02d}", cpu="2") for i in range(4)])
        return state, [pod(T, f"g{i}", group="g1") for i in range(8)], [
            {"start": 0, "length": 8}]

    hosts, _ = both(build)
    assert all(h is not None for h in hosts)


def test_gang_dispatches_stay_flat_with_gang_count():
    """Doubling the gang count does not grow the wave's dispatches: the
    gangs ride the grouped probe like any run, never the serial scan,
    with the JAX driver's tally at 4 and at 8 gangs."""
    counts = {}
    for n_gangs in (4, 8):
        def build(T, CS):
            state = CS.build([node(T, f"n{i:02d}", cpu="64", pods="500")
                              for i in range(8)])
            backlog, gangs = [], []
            for g in range(n_gangs):
                gangs.append({"start": len(backlog), "length": 8})
                backlog += [pod(T, f"w{g}-{i}", cpu=f"{100 + (g % 3) * 50}m",
                                group=f"grp{g}") for i in range(8)]
            return state, backlog, gangs

        hosts, tally = both(build)
        assert all(h is not None for h in hosts)
        assert tally.get("scan", 0) == 0, tally
        counts[n_gangs] = sum(tally.values())
    assert counts[8] <= counts[4] + 1 and counts[8] <= 6, counts


def test_no_gang_config_equal_to_oracle():
    """Gang-labelled pods without a layout schedule exactly as the port's
    oracle copy and the JAX driver do."""
    rng = random.Random(1414)
    for trial in range(4):
        spec = [rng.choice([1, 2, 4]) for _ in range(rng.randint(2, 6))]
        runs = []
        for t in range(rng.randint(1, 4)):
            runs.append((rng.random() < 0.5, t, rng.randint(1, 20)))

        def build(T, CS):
            state = CS.build([node(T, f"n{i:02d}", cpu=str(c))
                              for i, c in enumerate(spec)])
            backlog = []
            for is_gang, t, n in runs:
                backlog += [
                    pod(T, f"t{trial}-g{t}-{i}", cpu="300m",
                        group=f"grp-{t}") if is_gang else
                    pod(T, f"t{trial}-s{t}-{i}",
                        cpu=f"{200 + 100 * (t % 3)}m")
                    for i in range(n)]
            return state, backlog, None

        hosts, _ = both(build, min_run=8)
        state, backlog, _ = build(TT, PortState)
        assert hosts == PortOracle().schedule_backlog(backlog,
                                                      state.clone())


@pytest.mark.parametrize("trial", range(6))
def test_randomized_gang_fuzz_no_partial_binds(trial):
    rng = random.Random(77 + 1000 * trial)
    n_nodes, cap = rng.randint(2, 6), rng.choice([1, 2, 3])
    sizes = [rng.randint(2, 12) for _ in range(rng.randint(1, 4))]
    n_singles = rng.randint(0, 4)

    def build(T, CS):
        state = CS.build([node(T, f"n{i:02d}", cpu=str(cap))
                          for i in range(n_nodes)])
        singles = [pod(T, f"t{trial}-s{i}", cpu="600m")
                   for i in range(n_singles)]
        backlog, gangs = list(singles), []
        for g, size in enumerate(sizes):
            gangs.append({"start": len(backlog), "length": size})
            backlog += [pod(T, f"t{trial}-g{g}-{i}", cpu="600m",
                            group=f"grp-{g}") for i in range(size)]
        return state, backlog, gangs

    hosts, _ = both(build)
    state, backlog, gangs = build(TT, PortState)
    for gd in gangs:
        span = hosts[gd["start"]:gd["start"] + gd["length"]]
        assert all(h is not None for h in span) or \
            all(h is None for h in span), span
    alone = TorchScheduleAlgorithm(device="cpu", min_run=16) \
        .schedule_backlog(backlog[:n_singles], state)
    assert hosts[:n_singles] == alone


def test_gang_table_horizon_partial_continues_not_parks():
    """One huge node, max_j = 128: a 200-member gang horizon-bails at 128
    picks and continues (placed whole); a 500-member gang does not fit
    and parks whole. The wave driver alone, in both packages."""
    for k, placed in ((200, True), (500, False)):
        outs = []
        for T, CS, Wave, Enc, kw in (
                (TT, PortState, WaveScheduler, SnapshotEncoder,
                 {"device": "cpu"}),
                (JT, JaxState, JaxWave, JaxEncoder, {})):
            state = CS.build([node(T, "n00", cpu="400", pods="300")])
            gang = [pod(T, f"h{i}", cpu="1000m", group="g1")
                    for i in range(k)]
            enc = Enc(state, [gang[0]])
            snap, batch = enc.encode_nodes(), enc.encode_pods()
            w = Wave(min_run=16, max_j=128, **kw)
            out, _carry, last = w.schedule_backlog(
                snap, batch, np.zeros(k, np.int64),
                gangs=[{"start": 0, "length": k, "score_add": None}])
            outs.append((np.asarray(out).tolist(), int(last),
                         dispatch_shape(w.dispatches)))
        assert outs[0] == outs[1]
        assert all(h >= 0 for h in outs[0][0]) == placed
        assert all(h < 0 for h in outs[0][0]) == (not placed)


def test_het_score_steers_gang_to_fast_accelerator():
    def build(T, CS):
        state = CS.build([node(T, "slow-0", cpu="8"),
                          node(T, "slow-1", cpu="8"),
                          node(T, "fast-0", cpu="8")])
        return state, [pod(T, f"g{i}", group="g1") for i in range(4)], [
            {"start": 0, "length": 4, "score_by_name": {"fast-0": 1000}}]

    hosts, _ = both(build)
    assert set(hosts) == {"fast-0"}


def test_gangs_group_with_template_runs():
    """Gangs between template runs of the same requests: each gang is its
    own run (split at its span), grouped with the pure runs around it;
    one gang parks inside the grouped replay, the runs behind it are
    placed."""
    def build(T, CS):
        state = CS.build([node(T, f"n{i:02d}", cpu="2") for i in range(6)])
        backlog = [pod(T, f"a{i}", cpu="250m") for i in range(20)]
        gangs = [{"start": 20, "length": 30}]
        backlog += [pod(T, f"big{i}", cpu="250m", group="big")
                    for i in range(30)]
        backlog += [pod(T, f"b{i}", cpu="300m") for i in range(16)]
        gangs.append({"start": len(backlog), "length": 6})
        backlog += [pod(T, f"ok{i}", cpu="250m", group="ok")
                    for i in range(6)]
        return state, backlog, gangs

    hosts, tally = both(build)
    assert set(hosts[20:50]) == {None}
    assert None not in hosts[:20] + hosts[50:]
    assert tally.get("group_probe", 0) >= 1, tally


# -- the director -------------------------------------------------------------


def director_run(name, build, waves=1, clock=None, **kw):
    """build(T, CS) -> (state, wave, pod groups). Runs `waves` director
    cycles of the same wave on the same state (the clock advanced by
    `clock` seconds between them when given), in the package `name`. ->
    (each cycle's director_wave outcome, statuses, victim names, tally)."""
    T, CS, G, make, dkw = PACKAGES[name]
    state, wave, groups = build(T, CS)
    now = [0.0]
    statuses, evicted = [], []
    d = S.gang_director(G, groups, statuses, evicted,
                        clock=(lambda: now[0]), **dkw, **kw)
    algo = make(min_run=16)
    outs = []
    for w in range(waves):
        outs.append(S.director_wave(d, algo, wave, state))
        now[0] += clock or 0.0
    return (outs, statuses, [v.metadata.name for v in evicted],
            dispatch_shape(algo._wave.dispatches))


def director_both(build, **kw):
    got = director_run("port", build, **kw)
    assert got == director_run("jax", build, **kw)
    return got


def test_min_member_short_gang_parks_before_the_wave():
    def build(T, CS):
        return (CS.build([node(T, "n00")]),
                [pod(T, "s0"), pod(T, "g-0", group="g1"),
                 pod(T, "g-1", group="g1")],
                [S.pod_group(T, "g1", min_member=4)])

    (out,), statuses, victims, _ = director_both(build)
    assert out["backlog"] == ["s0"] and out["layout"] == []
    assert [n for n, _ in out["parked"]] == ["g-0", "g-1"]
    assert "have 2 of minMember 4" in out["parked"][0][1]
    assert statuses[-1][2]["phase"] == "Parked" and victims == []


def test_priority_orders_gangs_singletons_first():
    def build(T, CS):
        return (CS.build([node(T, "n00")]),
                [pod(T, f"lo-{i}", group="lo") for i in range(2)]
                + [pod(T, "s0")]
                + [pod(T, f"hi-{i}", group="hi") for i in range(2)],
                [S.pod_group(T, "lo", 1, 10), S.pod_group(T, "hi", 1, 100)])

    (out,), _statuses, _victims, _ = director_both(build)
    assert out["backlog"] == ["s0", "hi-0", "hi-1", "lo-0", "lo-1"]
    assert [(s, n) for s, n, _k, _p in out["layout"]] == [(1, 2), (3, 2)]
    assert out["parked"] == []


def test_wave_without_gangs_is_untouched():
    def build(T, CS):
        return CS.build([node(T, "n00")]), [pod(T, "a"), pod(T, "b")], []

    (out,), statuses, _v, _ = director_both(build)
    assert out["backlog"] == ["a", "b"] and out["layout"] == []
    assert statuses == []


def test_resource_park_backs_off_on_an_injected_clock():
    """A priority-0 gang that cannot fit parks for resources (no
    preemption), sits the next wave out inside its backoff window, and
    re-probes once the injected clock passes it."""
    def build(T, CS):
        return (CS.build([node(T, f"n{i:02d}", cpu="1") for i in range(2)]),
                [pod(T, f"g{i}", cpu="600m", group="g") for i in range(3)]
                + [pod(T, "s0", cpu="100m")],
                [S.pod_group(T, "g", 3, 0)])

    outs, statuses, victims, _ = director_both(build, waves=3, clock=1.5,
                                               backoff_initial=2.0)
    first, second, third = outs
    assert first["errors"] and "insufficient resources" in \
        first["errors"][1]
    assert second["layout"] == [] and "backing off" in second["parked"][0][1]
    assert third["layout"] != []  # 3.0 s > 2.0 s: re-probed
    assert victims == []
    assert [s[2]["phase"] for s in statuses] == ["Parked", "Parked"]


def test_preemption_round_then_gang_binds():
    """bound_cluster nodes full of priority-0 pods, a gang_wave with a
    high-priority gang that cannot fit: the director parks it, plans
    victims (the port's scorer on the CPU vs the JAX scorer: the same
    victims), and after the evictions the gang binds whole."""
    def build(T, CS):
        nodes, bound = S.bound_cluster(T, 24, per_node=6, cpu="500m")
        wave, groups = S.gang_wave(T, singles=20, gangs=8, members=4,
                                   big=6, big_cpu="2", short=2)
        return CS.build(nodes, assigned_pods=bound), wave, groups

    for name in ("port", "jax"):
        T, CS, G, make, dkw = PACKAGES[name]
        state, wave, groups = build(T, CS)
        statuses, evicted = [], []
        d = S.gang_director(G, groups, statuses, evicted, **dkw)
        algo = make(min_run=16)
        out = S.director_wave(d, algo, wave, state)
        victims = list(evicted)
        big = [p for p in wave
               if p.metadata.labels.get(T.POD_GROUP_LABEL) == "big"]
        out2 = S.director_wave(d, algo, big, S.evict(state, victims))
        result = (out, out2, statuses, [v.metadata.name for v in victims])
        if name == "port":
            port = result
        else:
            assert result == port
    out, out2, statuses, victims = port
    big_at = out["backlog"].index("big-000000")
    assert all(out["hosts"][i] is None for i in range(big_at, big_at + 6))
    assert "preempting" in out["errors"][big_at]
    assert victims and all(v.startswith("bound-") for v in victims)
    assert None not in out2["hosts"] and out2["errors"] == {}
    assert any(s[1] == "big" and s[2]["phase"] == "Scheduled"
               for s in statuses)
    # every other gang is placed whole or parked whole
    for start, length, _key, _prio in out["layout"]:
        span = out["hosts"][start:start + length]
        assert all(h is None for h in span) or None not in span
