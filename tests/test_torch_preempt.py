"""The port's victim scorer (ops/preempt.py, the plain version of the
CUDA kernel K6) against the JAX package's VictimScorer, on the CPU.

The same numpy inputs (harness/scenarios.victim_case, and a seeded fuzz
as tests/test_gang.py's) go through kubernetes_tpu's jitted
`_victim_score_fn` and the port's `victim_score_plain`; `needed`, `cost`
and `order` must be equal exactly, dtypes included. The kernel itself
runs only on the card (tests/test_torch_on_card.py, chip_smoke.py phase
3c)."""

import random

import numpy as np
import pytest
import torch

import kubernetes_tpu.api.types as JT
from kubernetes_tpu.ops.preempt import INVALID_PRIO as JAX_INVALID_PRIO
from kubernetes_tpu.ops.preempt import VictimScorer as JaxScorer
from kubernetes_tpu.ops.preempt import pack_candidates as jax_pack
from kubernetes_tpu.oracle import ClusterState as JaxState
from kubernetes_tpu.scheduler import gang as JG

import kubernetes_tpu_torch.api.types as TT
from kubernetes_tpu_torch.harness import scenarios as S
from kubernetes_tpu_torch.ops import preempt as P
from kubernetes_tpu_torch.ops import preempt_kernel as PK
from kubernetes_tpu_torch.oracle import ClusterState as PortState
from kubernetes_tpu_torch.scheduler import gang as PG

from tests.test_gang import _ref_victims_needed

#: the plain version's cases are cut to this many node rows on the CPU
MAX_N = 256


def scores(case, scorer):
    return scorer.score(case["prio"], case["ord"], case["res"],
                        case["free"], case["req"], case["gang_prio"])


def assert_same(got, want):
    for name, g, w in zip(("needed", "cost", "order"), got, want):
        assert g.dtype == w.dtype, name
        assert np.array_equal(g, w), name


@pytest.fixture(scope="module")
def jax_scorer():
    return JaxScorer()


@pytest.mark.parametrize("case", S.VICTIM_CASES,
                         ids=[c[0] for c in S.VICTIM_CASES])
def test_plain_matches_jax_on_edge_cases(case, jax_scorer):
    label, N, C, kind = case
    c = S.victim_case(min(N, MAX_N), C, 3, kind)
    got = scores(c, P.VictimScorer(device="cpu"))
    assert_same(got, scores(c, jax_scorer))
    needed = got[0]
    if kind == "all_invalid":
        # nothing is evictable: a node fits now or never
        assert set(np.unique(needed)) <= {-1, 0}
    elif kind == "fits_now":
        assert (needed == 0).all() and (got[1] == 0).all()
    elif kind == "evict_all":
        assert (needed == C).all()
    elif kind == "none_fit":
        assert (needed == -1).all() and (got[1] == 1 << 62).all()


def test_plain_fuzz_matches_jax_and_reference(jax_scorer):
    """tests/test_gang.py's fuzz (test_device_matches_numpy_reference_fuzz)
    at several widths: equal to the JAX scorer on every output, and the
    needed counts equal to the serial numpy reference."""
    rng = np.random.RandomState(99)
    scorer = P.VictimScorer(device="cpu")
    for trial in range(12):
        N, C = (8, 8) if trial < 6 else (64, 32)
        prio = rng.randint(0, 5, (N, C)).astype(np.int32)
        prio[rng.rand(N, C) < 0.3] = P.INVALID_PRIO
        ordn = rng.permutation(N * C).reshape(N, C).astype(np.int32)
        res = rng.randint(0, 4, (N, C, 4)).astype(np.int64) * 250
        free = rng.randint(0, 4, (N, 4)).astype(np.int64) * 250
        req = np.array([500, 250, 0, 1], np.int64)
        gang_prio = int(rng.randint(1, 6))
        got = scorer.score(prio, ordn, res, free, req, gang_prio)
        assert_same(got, jax_scorer.score(prio, ordn, res, free, req,
                                          gang_prio))
        assert np.array_equal(
            got[0].astype(np.int64),
            _ref_victims_needed(prio, ordn, res, free, req, gang_prio))


def test_newest_first_order_and_column_tiebreak():
    """One tier: the newest (highest ordinal) first; equal ordinals keep
    their column order, as jnp.argsort's stable sort does."""
    prio = np.ones((64, 8), np.int32)
    ordn = np.tile(np.array([5, 9, 5, 1, 9, 0, 5, 2], np.int32), (64, 1))
    res = np.ones((64, 8, 4), np.int64)
    free = np.zeros((64, 4), np.int64)
    req = np.array([3, 0, 0, 0], np.int64)
    _needed, _cost, order = P.VictimScorer(device="cpu").score(
        prio, ordn, res, free, req, 2)
    assert order[0].tolist() == [1, 4, 0, 2, 6, 7, 3, 5]


def test_no_candidate_at_or_above_gang_priority_counts():
    """The invariant lives in the scorer: slots at prio >= gang_prio never
    enter a usable prefix, so what they would free changes nothing, and
    every slot of a chosen prefix is strictly below the gang."""
    rng = np.random.RandomState(7)
    for trial in range(8):
        c = S.victim_case(64, 16, trial, "fuzz")
        c["prio"] = rng.randint(-3, 8, c["prio"].shape).astype(np.int32)
        t = {k: torch.as_tensor(v) for k, v in c.items() if k != "gang_prio"}
        gp = c["gang_prio"]
        needed, cost, order = P.victim_score_plain(
            t["prio"], t["ord"], t["res"], t["free"], t["req"], gp)
        for n in range(64):
            k = int(needed[n])
            picked = c["prio"][n, order[n, :max(k, 0)].numpy()]
            assert (picked < gp).all()
            assert int(cost[n]) == (int(picked.sum()) if k > 0 else
                                    (0 if k == 0 else 1 << 62))
        huge = t["res"].clone()
        huge[t["prio"] >= gp] = 1 << 40
        again = P.victim_score_plain(t["prio"], t["ord"], huge, t["free"],
                                     t["req"], gp)
        assert torch.equal(again[0], needed) and torch.equal(again[1], cost)


def test_negative_priorities_and_wraparound(jax_scorer):
    """Negative tiers below a negative gang priority, and ordinals at the
    int32 extremes (the int64 key's extremes), equal to the JAX scorer."""
    N, C = 64, 8
    rng = np.random.RandomState(5)
    prio = rng.randint(-2**31 + 1, -2**31 + 4, (N, C)).astype(np.int32)
    prio[:, ::3] = rng.randint(-5, 0, (N, 3)).astype(np.int32)
    ordn = rng.choice(np.array([-2**31, 2**31 - 1, 0, -1], np.int32),
                      (N, C))
    res = rng.randint(0, 3, (N, C, 4)).astype(np.int64) * 100
    free = rng.randint(-2, 2, (N, 4)).astype(np.int64) * 100
    req = np.array([100, 0, 0, 1], np.int64)
    for gp in (-2**31 + 2, -1, 0):
        assert_same(P.VictimScorer(device="cpu").score(
            prio, ordn, res, free, req, gp),
            jax_scorer.score(prio, ordn, res, free, req, gp))


def test_pack_candidates_matches_jax():
    rng = random.Random(11)
    names = [f"n{i:02d}" for i in range(70)]
    cands = [(rng.choice(names + ["gone"]), rng.randint(0, 9), i,
              (rng.randint(1, 900), rng.randint(1, 1 << 30), 0, 1))
             for i in range(400)]
    got = P.pack_candidates(names, cands)
    want = jax_pack(names, cands)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[3] == want[3]
    assert P.INVALID_PRIO == JAX_INVALID_PRIO


def test_wrapper_takes_plain_version_only_on_cpu():
    c = S.victim_case(64, 8, 1, "fuzz")
    t = {k: torch.as_tensor(v) for k, v in c.items() if k != "gang_prio"}
    args = (t["prio"], t["ord"], t["res"], t["free"], t["req"],
            c["gang_prio"])
    launches = PK.LAUNCHES
    for g, w in zip(PK.victim_score(*args), P.victim_score_plain(*args)):
        assert torch.equal(g, w)
    assert PK.LAUNCHES == launches
    with pytest.raises(ValueError, match="no kernel for device meta"):
        PK.victim_score(*(a.to("meta") for a in args[:5]), args[5])


@pytest.mark.parametrize("C", [2048, 12])
def test_kernel_refuses_a_candidate_axis_it_does_not_take(C):
    prio = torch.zeros((64, C), dtype=torch.int32)
    with pytest.raises(ValueError, match="power-of-two candidate axis"):
        PK._launch(prio, prio, torch.zeros((64, C, 4), dtype=torch.int64),
                   torch.zeros((64, 4), dtype=torch.int64),
                   torch.zeros(4, dtype=torch.int64), 1)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert P.VictimScorer().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            P.VictimScorer()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PG.GangDirector()


# -- the director's preemption plan, port against JAX -------------------------


def node(T, name, cpu="4"):
    return T.Node(
        metadata=T.ObjectMeta(name=name),
        status=T.NodeStatus(
            allocatable={"cpu": cpu, "memory": "32Gi", "pods": "110"},
            conditions=[T.NodeCondition("Ready", "True")]))


def gang_pod(T, name, cpu, group, ts=None):
    p = T.Pod(
        metadata=T.ObjectMeta(name=name, labels={
            T.POD_GROUP_LABEL: group, "app": group}),
        spec=T.PodSpec(containers=[T.Container(image="t",
                                               requests={"cpu": cpu})]))
    p.metadata.creation_timestamp = ts
    return p


def plan(T, CS, G, trial, **kw):
    """tests/test_gang.py test_invariant_no_equal_or_higher_priority_
    victims_fuzz, one trial, built in the package of T: -> (victim names,
    the victims' priorities, the gang's priority)."""
    rng = random.Random(1337 + trial)
    n_nodes = rng.randint(2, 5)
    nodes = [node(T, f"n{i:02d}") for i in range(n_nodes)]
    prios = [0, 10, 50, 100, 200]
    pgs = [S.pod_group(T, f"grp-{g}", 1, pr) for g, pr in enumerate(prios)]
    bound = []
    for i in range(rng.randint(2, 10)):
        g = rng.randrange(len(prios))
        b = gang_pod(T, f"b{trial}-{i}",
                     f"{rng.choice([500, 1000, 2000])}m", f"grp-{g}",
                     ts=f"2026-08-04T00:00:{i:02d}Z")
        b.spec.node_name = f"n{rng.randrange(n_nodes):02d}"
        bound.append(b)
    state = CS.build(nodes, assigned_pods=bound)
    gang_prio = rng.choice([10, 50, 100, 200])
    evicted = []
    d = G.GangDirector(pod_group_lister=lambda: pgs,
                       preemptor=evicted.extend, **kw)
    members = [gang_pod(T, f"m{trial}-{i}", "2000m", "grp-hi")
               for i in range(rng.randint(1, 4))]
    entry = {"start": 0, "length": len(members),
             "key": ("default", "grp-hi"),
             "group": S.pod_group(T, "grp-hi", 1, gang_prio),
             "priority": gang_prio, "score_by_name": None}
    d.after_wave(members, [None] * len(members), [entry], state)
    pg_map = {("default", p.metadata.name): p for p in pgs}
    return ([v.metadata.name for v in evicted],
            [d._priority_of(v, pg_map) for v in evicted], gang_prio)


@pytest.mark.parametrize("trial", range(6))
def test_director_victims_match_jax_and_keep_the_invariant(trial):
    got = plan(TT, PortState, PG, trial, device="cpu")
    assert got == plan(JT, JaxState, JG, trial)
    names, prios, gang_prio = got
    assert all(p < gang_prio for p in prios)


def test_director_newest_first_victim():
    """tests/test_gang.py test_newest_first_tiebreak in both packages."""
    def run(T, CS, G, **kw):
        old = gang_pod(T, "old", "900m", "low", "2026-08-04T00:00:01Z")
        new = gang_pod(T, "new", "900m", "low", "2026-08-04T00:00:59Z")
        old.spec.node_name = new.spec.node_name = "n00"
        state = CS.build([node(T, "n00", cpu="2")],
                         assigned_pods=[old, new])
        pgs = [S.pod_group(T, "low", 1, 0)]
        evicted = []
        d = G.GangDirector(pod_group_lister=lambda: pgs,
                           preemptor=evicted.extend, **kw)
        entry = {"start": 0, "length": 1, "key": ("default", "hi"),
                 "group": S.pod_group(T, "hi", 1, 100), "priority": 100,
                 "score_by_name": None}
        d.after_wave([gang_pod(T, "m0", "900m", "hi")], [None], [entry],
                     state)
        return [v.metadata.name for v in evicted]

    assert run(TT, PortState, PG, device="cpu") == ["new"]
    assert run(JT, JaxState, JG) == ["new"]
