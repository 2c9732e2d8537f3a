"""ServiceAffinity / ServiceAntiAffinity in the port against the JAX
package and the oracle, on the CPU: the four ops/services functions on
seeded tables, the probe's service rows, the serial scan (decisions and
final carry) and the wave driver (decisions and dispatch tally), on the
service scenarios of tests/test_wave.py and tests/test_conformance.py.

Every input is made from a seed and, for the scheduler, encoded once by
the JAX package's encoder and carried across; every output is an integer
or bool table or a node name, so the tolerance is exact equality."""

import dataclasses
import json
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.models import batch as JB
from kubernetes_tpu.models import probe as JP
from kubernetes_tpu.models.wave import WaveScheduler as JaxWave
from kubernetes_tpu.ops import services as JSV
from kubernetes_tpu.scheduler.tpu_algorithm import TPUScheduleAlgorithm
from kubernetes_tpu.snapshot.services import ORD_NONE

from kubernetes_tpu_torch.models import batch as TB
from kubernetes_tpu_torch.models import probe as TP
from kubernetes_tpu_torch.models.wave import WaveScheduler
from kubernetes_tpu_torch.ops import services as TSV
from kubernetes_tpu_torch.oracle import GenericScheduler as PortOracle
from kubernetes_tpu_torch.oracle import predicates as popreds
from kubernetes_tpu_torch.oracle import priorities as poprios
from kubernetes_tpu_torch.oracle.scheduler import PriorityConfig as PortPC
from kubernetes_tpu_torch.scheduler.algorithm import TorchScheduleAlgorithm
from kubernetes_tpu_torch.snapshot.carry import place, to_device

import tests.test_conformance as TC
import tests.test_wave as TW
from tests.test_torch_ops import CPU, assert_same, encode, port_state, to_port
from tests.test_torch_wave import dispatch_shape

NONE = int(ORD_NONE)


def port_config(cfg):
    """The JAX package's SchedulerConfig as the port's (same fields)."""
    return TB.SchedulerConfig(**{f.name: getattr(cfg, f.name)
                                 for f in dataclasses.fields(cfg)})


# -- the four ops on seeded tables ---------------------------------------------


def _sa_case(seed, G=3, L=3, N=12, label_rows=(0, 2), peer="some",
             fixed="some", group="some"):
    """Seeded ServiceAffinity inputs: -> dict of numpy tables + scalars.
    peer: "none" (ORD_NONE), "unknown" (its order index maps to no node
    row), "some"; fixed: "none", "all" (every label pinned by the pod's
    nodeSelector), "some"; group: "none" (-1), "some"."""
    rng = np.random.default_rng(seed)
    ORD = N + 2
    lbl_val = rng.integers(-1, 3, (L, N)).astype(np.int32)
    ord_node = np.concatenate([rng.permutation(N), [-1, -1]]).astype(np.int32)
    first_peer = rng.integers(0, N, G).astype(np.int32)
    g = int(rng.integers(0, G)) if G else 0
    if G:
        if peer == "none":
            first_peer[g] = NONE
        elif peer == "unknown":
            first_peer[g] = ORD - 1
    pod_fixed = rng.integers(-1, 3, L).astype(np.int32)
    if fixed == "none":
        pod_fixed[:] = -1
    elif fixed == "all":
        pod_fixed = rng.integers(0, 3, L).astype(np.int32)
    return dict(first_peer=first_peer, lbl_val=lbl_val, ord_node=ord_node,
                pod_group=(g if group == "some" else -1), pod_fixed=pod_fixed,
                label_rows=label_rows, num_nodes=N)


SA_CASES = [
    ("random", {}),
    ("no groups", {"G": 0}),
    ("no label rows", {"label_rows": ()}),
    ("unpinned group", {"peer": "none", "fixed": "none"}),
    ("peer on unknown node", {"peer": "unknown", "fixed": "none"}),
    ("peer on unknown node, all labels pinned", {"peer": "unknown",
                                                 "fixed": "all"}),
    ("all labels pinned", {"fixed": "all"}),
    ("pod in no group", {"group": "none"}),
]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("label,kw", SA_CASES, ids=[c[0] for c in SA_CASES])
def test_service_affinity_matches(label, kw, seed):
    c = _sa_case(seed, **kw)
    want = JSV.service_affinity(
        jnp.asarray(c["first_peer"]), jnp.asarray(c["lbl_val"]),
        jnp.asarray(c["ord_node"]), jnp.int32(c["pod_group"]),
        jnp.asarray(c["pod_fixed"]), c["label_rows"], c["num_nodes"])
    got = TSV.service_affinity(
        place(c["first_peer"], CPU), place(c["lbl_val"], CPU),
        place(c["ord_node"], CPU), torch.tensor(c["pod_group"]),
        place(c["pod_fixed"], CPU), c["label_rows"], c["num_nodes"])
    assert got.dtype == torch.bool
    assert_same(want, got, label)
    if label == "peer on unknown node":
        assert not got.any()  # the oracle's GetNodeInfo error branch


def _saa_case(seed, G=3, N=16, num_values=3, group="some", unlabeled=True):
    rng = np.random.default_rng(100 + seed)
    lbl = rng.integers(-1 if unlabeled else 0, max(num_values, 1), N)
    counts = rng.integers(0, 4, (G, N)).astype(np.int32)
    return dict(
        peer_node_count=counts,
        # a total above the per-node sum: peers on unfit or unlabeled
        # nodes and on None-nodes count toward it
        peer_total=(counts.sum(1) + rng.integers(0, 3, G)).astype(np.int32),
        lbl_val_row=lbl.astype(np.int32),
        pod_group=(int(rng.integers(0, G)) if G and group == "some" else -1),
        fit=rng.random(N) < 0.7, num_values=num_values, num_nodes=N)


SAA_CASES = [
    ("random", {}),
    ("no groups", {"G": 0}),
    ("no values", {"num_values": 0}),
    ("pod in no group", {"group": "none"}),
    ("every node labeled", {"unlabeled": False}),
]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("label,kw", SAA_CASES,
                         ids=[c[0] for c in SAA_CASES])
def test_service_anti_affinity_matches(label, kw, seed):
    c = _saa_case(seed, **kw)
    if label == "random" and seed == 0:
        c["peer_total"][:] = 0  # no peers yet: every labeled node scores 10
    want = JSV.service_anti_affinity(
        jnp.asarray(c["peer_node_count"]), jnp.asarray(c["peer_total"]),
        jnp.asarray(c["lbl_val_row"]), jnp.int32(c["pod_group"]),
        jnp.asarray(c["fit"]), c["num_values"], c["num_nodes"])
    got = TSV.service_anti_affinity(
        place(c["peer_node_count"], CPU), place(c["peer_total"], CPU),
        place(c["lbl_val_row"], CPU), torch.tensor(c["pod_group"]),
        place(c["fit"], CPU), c["num_values"], c["num_nodes"])
    assert got.dtype == torch.int64
    assert_same(want, got, label)
    assert not got[c["lbl_val_row"] < 0].any()  # unlabeled nodes score 0


@pytest.mark.parametrize("G", [0, 1, 4])
@pytest.mark.parametrize("seed", range(2))
def test_service_commits_match(G, seed):
    """service_commit (one pod, scheduled or not, on a node with or
    without an order index) and service_commit_bulk (a run's counts),
    folded in place, against the JAX package's pure functions."""
    rng = np.random.default_rng(200 + seed)
    N = 10
    node_ord = rng.permutation(N).astype(np.int32)
    node_ord[-1] = NONE  # a padded row
    state_j = (np.full(G, NONE, np.int32) if seed == 0
               else rng.integers(0, N, G).astype(np.int32),
               rng.integers(0, 3, (G, N)).astype(np.int32),
               rng.integers(0, 9, G).astype(np.int32))
    jstate = tuple(jnp.asarray(a) for a in state_j)
    tstate = tuple(place(a, CPU) for a in state_j)
    for step in range(6):
        member = rng.integers(0, 2, G).astype(np.int8)
        chosen = int(rng.integers(-1, N))
        scheduled = chosen >= 0 and step != 3
        jstate = JSV.service_commit(*jstate, jnp.asarray(node_ord),
                                    jnp.asarray(member), jnp.int32(chosen),
                                    jnp.bool_(scheduled))
        TSV.service_commit(*tstate, place(node_ord, CPU),
                           place(member, CPU), torch.tensor(chosen),
                           torch.tensor(scheduled))
        for a, b in zip(jstate, tstate):
            assert_same(a, b, f"commit step {step}")
        counts = rng.integers(0, 3, N) * (rng.random(N) < 0.4)
        if step == 2:
            counts[:] = 0  # a run that placed nothing
        jstate = JSV.service_commit_bulk(*jstate, jnp.asarray(node_ord),
                                         jnp.asarray(member),
                                         jnp.asarray(counts))
        TSV.service_commit_bulk(*tstate, place(node_ord, CPU),
                                place(member, CPU), place(counts, CPU))
        for a, b in zip(jstate, tstate):
            assert_same(a, b, f"bulk step {step}")


# -- the conformance scenarios: scan, probe rows, wave ------------------------


def _svc_configs(labels=("region",), anti_label=None):
    prios = [("LeastRequestedPriority", 1)]
    if anti_label:
        prios.append((("ServiceAntiAffinity", anti_label), 2))
    preds = ["GeneralPredicates"]
    if labels:
        preds.append(("ServiceAffinity", tuple(labels)))
    cfg = JB.SchedulerConfig(predicates=tuple(preds),
                             priorities=tuple(prios))
    return cfg, port_config(cfg)


def _port_oracle(labels=("region",), anti_label=None, saa_weight=2):
    """The port's oracle copy with the scenario's policy."""
    preds = [("GeneralPredicates", popreds.general_predicates)]
    if labels:
        preds.append(("ServiceAffinity", popreds.service_affinity_predicate(
            list(labels))))
    prios = [PortPC(poprios.least_requested_priority, 1,
                    "LeastRequestedPriority")]
    if anti_label:
        prios.append(PortPC(poprios.service_anti_affinity_priority(
            anti_label), saa_weight, "ServiceAntiAffinity"))
    return PortOracle(predicates=preds, priorities=prios)


def _conformance_scenario(name, seed=0):
    """The service scenarios of tests/test_conformance.py as (JAX state,
    pending, SA labels, SAA label)."""
    nodes, services = TC._svc_affinity_cluster()
    pod = TC._svc_pod
    if name == "first peer":
        state = TC.ClusterState.build(nodes, services=services, assigned_pods=[
            pod("web-0", {"app": "web"}, node="node-0")])
        return state, [pod("web-1", {"app": "web"}),
                       pod("web-2", {"app": "web"}),
                       pod("lone", {"app": "none"})], ("region",), None
    if name == "node selector pins":
        state = TC.ClusterState.build(nodes, services=services, assigned_pods=[
            pod("web-0", {"app": "web"}, node="node-0")])
        return state, [pod("web-pinned", {"app": "web"},
                           node_selector={"region": "r2"})], ("region",), None
    if name == "anti spreads":
        state = TC.ClusterState.build(nodes, services=services)
        return state, [pod(f"db-{i}", {"app": "db"}) for i in range(4)], \
            (), "region"
    if name == "bad peer, labels pinned":
        state = TC.ClusterState.build(nodes, services=services)
        state.assign(pod("ghost", {"app": "web"}, node="gone-node"))
        return state, [pod("unpinned", {"app": "web"}),
                       pod("pinned", {"app": "web"},
                           node_selector={"region": "r2"})], ("region",), None
    rng = random.Random(3000 + seed)
    existing = [pod(f"e{i}", rng.choice([{"app": "web"}, {"app": "db"},
                                         {"app": "x"}]),
                    node=f"node-{rng.randrange(9)}")
                for i in range(rng.randint(0, 6))]
    state = TC.ClusterState.build(nodes, services=services,
                                  assigned_pods=existing)
    pending = [pod(f"p{i}", rng.choice([{"app": "web"}, {"app": "db"},
                                        {"app": "x"}]),
                   node_selector=rng.choice(
                       [{}, {}, {"region": rng.choice(["r1", "r2"])}]))
               for i in range(10)]
    return state, pending, ("region", "rack"), "rack"


CONFORMANCE = ([(n, 0) for n in ("first peer", "node selector pins",
                                 "anti spreads", "bad peer, labels pinned")]
               + [("random", s) for s in range(6)])


@pytest.mark.parametrize("name,seed", CONFORMANCE,
                         ids=[f"{n}-{s}" for n, s in CONFORMANCE])
def test_scan_matches_jax_and_oracle(name, seed):
    """The serial scan: every pod's node and the whole final carry (the
    svc_* peer state included) equal to JAX's BatchScheduler, the names
    equal to the port's oracle copy."""
    state, pending, labels, anti = _conformance_scenario(name, seed)
    cfg, pcfg = _svc_configs(labels, anti)
    snap, batch, psnap, pbatch = encode(state, pending, config=cfg)
    chosen_j, carry_j = JB.BatchScheduler(cfg).schedule(snap, batch)
    sched = TB.BatchScheduler(pcfg, device="cpu")
    chosen, carry = sched.schedule(psnap, pbatch)
    assert_same(chosen_j, chosen, "chosen")
    for key, jv in zip(TB.CARRY_FIELDS, carry_j):
        assert_same(jv, carry[key], key)
    names = sched.schedule_names(psnap, pbatch)
    want = _port_oracle(labels, anti).schedule_backlog(
        to_port(pending), port_state(state))
    assert names == want
    assert JB.BatchScheduler(cfg).schedule_names(snap, batch) == want


@pytest.mark.parametrize("name,seed", CONFORMANCE,
                         ids=[f"{n}-{s}" for n, s in CONFORMANCE])
def test_debug_evaluate_matches_jax(name, seed):
    """Per-(pod, node) fit and score against the initial carry (the
    extender's filter and prioritize)."""
    state, pending, labels, anti = _conformance_scenario(name, seed)
    cfg, pcfg = _svc_configs(labels, anti)
    snap, batch, psnap, pbatch = encode(state, pending, config=cfg)
    fit_j, score_j = JB.BatchScheduler(cfg).debug_evaluate(snap, batch)
    fit, score = TB.BatchScheduler(pcfg, device="cpu").debug_evaluate(
        psnap, pbatch)
    assert fit.dtype == bool and score.dtype == np.int64
    assert_same(fit_j, fit, "fit")
    assert_same(score_j, score, "score")


def _jax_probe_inputs(snap, batch, i, config):
    static = {f: jnp.asarray(getattr(snap, f))
              for f in JB.BatchScheduler.STATIC_FIELDS}
    static.update(JB.BatchScheduler.config_static(config, snap))
    carry = JB.BatchScheduler(config).initial_carry(snap)
    pod = {f: jnp.asarray(np.asarray(getattr(batch, f))[i])
           for f in JB.BatchScheduler.POD_FIELDS}
    return static, carry, pod


@pytest.mark.parametrize("name,seed", CONFORMANCE[:4] + [("random", 1)],
                         ids=[f"{n}-{s}" for n, s in CONFORMANCE[:4]]
                         + ["random-1"])
def test_probe_service_rows_match_jax(name, seed):
    """The probe's header rows, the service-group rows (peer counts,
    total, first-peer pin) among them, for every pod of the scenario:
    pinned groups, unpinned groups, pods in no group."""
    state, pending, labels, anti = _conformance_scenario(name, seed)
    cfg, pcfg = _svc_configs(labels, anti)
    snap, batch, psnap, pbatch = encode(state, pending, config=cfg)
    nz, nv, J = TB.num_zones_of(psnap), int(snap.svc_num_values), 16
    sched = TB.BatchScheduler(pcfg, device="cpu")
    static = sched.place_static(psnap)
    carry = sched.initial_carry(psnap)
    pods = to_device(pbatch, CPU, TB.BatchScheduler.POD_FIELDS)
    pins = set()
    for i in range(batch.num_pods):
        jpacked = np.asarray(JP._probe_fn(
            cfg, nz, nv, J, *_jax_probe_inputs(snap, batch, i, cfg))["packed"])
        packed = TP._probe_fn(pcfg, nz, nv, J, static, carry,
                              {f: t[i] for f, t in pods.items()})["packed"]
        assert_same(jpacked[:TP.N_STK_ROWS], packed[:TP.N_STK_ROWS],
                    f"pod {i} header rows")
        pins.add(int(packed[10, 0]))
    if name == "first peer":
        assert NONE in pins and len(pins) == 2  # pinned group + no group


WAVE_SCENARIOS = ["first pick pins", "existing peer pins", "anti spreads",
                  "member and plain interleave", "unlabeled peer repins",
                  "unlabeled nodes unpinned"] + [f"random-{s}"
                                                 for s in range(10)]


def _wave_scenario(name):
    """The service scenarios of tests/test_wave.py (JAX objects): ->
    (state, pods, sa, saa, saa_weight)."""
    if name == "first pick pins":
        return (TW._member_state(TW._zone_nodes(9)), TW._members(40),
                True, False, 2)
    if name == "existing peer pins":
        peer = TW._members(1, name0=900)[0]
        peer.spec.node_name = "node-0004"
        return (TW._member_state(TW._zone_nodes(9), existing=[peer]),
                TW._members(30), True, False, 2)
    if name == "anti spreads":
        return (TW._member_state(TW._zone_nodes(9)), TW._members(60),
                False, True, 2)
    if name == "member and plain interleave":
        pods = TW._members(30) + TW.pause_pods(
            30, labels={"app": "y"}, requests={"cpu": "50m"})
        for i, p in enumerate(pods[30:]):
            p.metadata.name = f"plain-{i:05d}"
        return (TW._member_state(TW._zone_nodes(12, unlabeled=2)), pods,
                True, True, 2)
    if name == "unlabeled peer repins":
        nodes = TW._zone_nodes(9, unlabeled=9)
        for i, n in enumerate(nodes[:8]):
            n.metadata.labels["zone"] = ("za", "zb", "zc")[i % 3]
        peer = TW._members(1, name0=900)[0]
        peer.spec.node_name = "node-0008"
        return (TW._member_state(nodes, existing=[peer]), TW._members(30),
                True, False, 2)
    if name == "unlabeled nodes unpinned":
        return (TW._member_state(TW._zone_nodes(9, unlabeled=3)),
                TW._members(25), True, False, 2)
    seed = int(name.split("-")[1])
    rng = random.Random(3000 + seed)
    sa = rng.random() < 0.7
    saa = (not sa) or rng.random() < 0.7
    w = rng.choice([1, 2])
    nodes = TW._zone_nodes(rng.randint(4, 15),
                           zones=("za", "zb", "zc")[: rng.randint(1, 3)],
                           cap=str(rng.randint(3, 20)),
                           unlabeled=rng.choice([0, 0, 2]))
    existing = []
    if rng.random() < 0.5:
        peer = TW._members(1, name0=900)[0]
        peer.spec.node_name = nodes[rng.randrange(len(nodes))].metadata.name
        existing.append(peer)
    pods = TW._members(rng.randint(20, 70))
    if rng.random() < 0.6:
        pods += TW._members(rng.randint(16, 30), name0=500, cpu="200m")
    return TW._member_state(nodes, existing=existing), pods, sa, saa, w


@pytest.mark.parametrize("name", WAVE_SCENARIOS)
def test_wave_matches_jax_and_oracle(name):
    """TorchScheduleAlgorithm against TPUScheduleAlgorithm under the same
    resolved Policy: node names, the dispatch tally (single probes, the
    scan for re-pin hazards, folds) and the oracle."""
    state, pods, sa, saa, w = _wave_scenario(name)
    cfg = TW._svc_policy(sa=sa, saa=saa, saa_weight=w)
    jax_algo = TPUScheduleAlgorithm(config=cfg)
    want = jax_algo.schedule_backlog(pods, state)
    assert want == TW._svc_oracle(state, pods, sa=sa, saa=saa, saa_weight=w)
    port = TorchScheduleAlgorithm(device="cpu", config=port_config(cfg))
    got = port.schedule_backlog(to_port(pods), port_state(state))
    assert got == want
    assert dispatch_shape(port._wave.dispatches) == dispatch_shape(
        jax_algo._wave.dispatches)
    assert port._wave.dispatches.get("probe", 0) >= 1
    oracle = _port_oracle(("zone",) if sa else (), "zone" if saa else None,
                          saa_weight=w)
    assert got == oracle.schedule_backlog(to_port(pods), port_state(state))


@pytest.mark.parametrize("name,seed", CONFORMANCE,
                         ids=[f"{n}-{s}" for n, s in CONFORMANCE])
def test_wave_driver_on_conformance_scenarios(name, seed):
    """WaveScheduler on an encoded snapshot (runs at min_run=1): chosen
    ids, the final lastNodeIndex and the svc_* carry equal to JAX's
    WaveScheduler, the names to the oracle."""
    state, pending, labels, anti = _conformance_scenario(name, seed)
    cfg, pcfg = _svc_configs(labels, anti)
    snap, batch, psnap, pbatch = encode(state, pending, config=cfg)
    rep_idx = np.arange(batch.num_pods, dtype=np.int64)
    jw = JaxWave(cfg, min_run=1)
    want, carry_j, last_j = jw.schedule_backlog(snap, batch, rep_idx)
    ws = WaveScheduler(pcfg, min_run=1, device="cpu")
    got, carry, last = ws.schedule_backlog(psnap, pbatch, rep_idx)
    assert_same(want, got, "chosen")
    assert last == last_j
    assert dispatch_shape(ws.dispatches) == dispatch_shape(jw.dispatches)
    for k, jv in zip(TB.CARRY_FIELDS[-3:], carry_j[-3:]):
        assert_same(jv, carry[k], k)
    oracle = _port_oracle(labels, anti).schedule_backlog(
        to_port(pending), port_state(state))
    assert [snap.node_names[c] if c >= 0 else None for c in got] == oracle


def test_policy_json_forms_reach_the_scan():
    """A Policy JSON with both service entries, loaded and resolved by
    the port's own policy module, schedules a zoned member backlog equal
    to the JAX package's resolution of the same document."""
    from kubernetes_tpu.scheduler import policy as JPol

    from kubernetes_tpu_torch.scheduler import policy as TPol

    doc = json.dumps({"kind": "Policy", "predicates": [
        {"name": "GeneralPredicates"},
        {"name": "ZoneAffinity",
         "argument": {"serviceAffinity": {"labels": ["zone"]}}}],
        "priorities": [
        {"name": "LeastRequestedPriority", "weight": 1},
        {"name": "ZoneSpread", "weight": 2,
         "argument": {"serviceAntiAffinity": {"label": "zone"}}}]})
    cfg = JPol.resolve_policy_tpu(JPol.load_policy(doc))
    pcfg = TPol.resolve_policy_tpu(TPol.load_policy(doc))
    assert dataclasses.astuple(pcfg) == dataclasses.astuple(cfg)
    state = TW._member_state(TW._zone_nodes(9, unlabeled=1))
    pods = TW._members(20)
    snap, batch, psnap, pbatch = encode(state, pods, config=cfg)
    assert TB.BatchScheduler(pcfg, device="cpu").schedule_names(
        psnap, pbatch) == JB.BatchScheduler(cfg).schedule_names(snap, batch)


@pytest.mark.parametrize("n_nodes", [128, 120])
def test_padding_sends_unpinned_service_affinity_runs_to_the_scan(n_nodes):
    """An unpinned ServiceAffinity run takes the replay's first-pick pin
    only when every node row carries the label, and the rows that pad a
    snapshot to a power of two carry none: at 120 nodes (padded to 128)
    each run probes once and bails to the serial scan, at 128 nodes it
    replays. The JAX driver routes alike, and decisions are equal."""
    import kubernetes_tpu.api.types as JT
    from kubernetes_tpu.oracle import ClusterState as JState
    from kubernetes_tpu.scheduler import policy as JPol

    import kubernetes_tpu_torch.api.types as TT
    from kubernetes_tpu_torch.harness import scenarios as S
    from kubernetes_tpu_torch.oracle import ClusterState as TState
    from kubernetes_tpu_torch.scheduler.factory import create_from_config
    from kubernetes_tpu_torch.scheduler.policy import load_policy

    doc = json.dumps(S.POLICY_SERVICES)
    jsvcs, jpods = S.service_backlog(JT, 2, 32)
    jax_algo = TPUScheduleAlgorithm(
        config=JPol.resolve_policy_tpu(JPol.load_policy(doc)))
    want = jax_algo.schedule_backlog(jpods, JState.build(
        S.policy_nodes(JT, n_nodes), services=jsvcs))
    tsvcs, tpods = S.service_backlog(TT, 2, 32)
    port = create_from_config(load_policy(doc), device="cpu")
    got = port.schedule_backlog(tpods, TState.build(
        S.policy_nodes(TT, n_nodes), services=tsvcs))
    assert got == want and all(got)
    assert dispatch_shape(port._wave.dispatches) == dispatch_shape(
        jax_algo._wave.dispatches)
    assert port._wave.dispatches == (
        {"probe": 2, "apply": 1} if n_nodes == 128
        else {"probe": 2, "scan": 2, "scan_pods": 64})
