"""Parity of the PyTorch port's ops/ with the JAX package's, on the CPU.

Every input is made from a numpy seed (or a scenario built from a
random.Random seed and encoded once by the JAX package's encoder) and fed
to both packages; every output is an integer decision or an integer/bool
table, so the tolerance is exact equality.

The helpers at the top (encoding a scenario once and carrying it across
to the port, converting API objects between the packages) are shared by
the other tests/test_torch_*.py files.
"""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.api.labels as jax_labels
import kubernetes_tpu.api.resource as jax_resource
import kubernetes_tpu.api.types as jax_types
from kubernetes_tpu.models import batch as JB
from kubernetes_tpu.ops import bitset as JBS
from kubernetes_tpu.ops import interpod as JIP
from kubernetes_tpu.ops import priorities as JR
from kubernetes_tpu.ops import select as JS
from kubernetes_tpu.ops import volumes as JV
from kubernetes_tpu.snapshot.encode import SnapshotEncoder

import kubernetes_tpu_torch.api.labels as port_labels
import kubernetes_tpu_torch.api.resource as port_resource
import kubernetes_tpu_torch.api.types as port_types
from kubernetes_tpu_torch.models import batch as TB
from kubernetes_tpu_torch.oracle import ClusterState as PortClusterState
from kubernetes_tpu_torch.ops import bitset as TBS
from kubernetes_tpu_torch.ops import interpod as TIP
from kubernetes_tpu_torch.ops import priorities as TR
from kubernetes_tpu_torch.ops import select as TS
from kubernetes_tpu_torch.ops import volumes as TV
from kubernetes_tpu_torch.snapshot.carry import (
    batch_from_arrays,
    place,
    snapshot_from_arrays,
    to_device,
)

from tests.test_conformance import random_scenario

CPU = torch.device("cpu")


# -- shared helpers ------------------------------------------------------------


def fields_of(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def encode(state, pods, config=None):
    """One encoding by the JAX package's encoder -> (jax snap, jax batch,
    port snap, port batch)."""
    enc = SnapshotEncoder(state, pods, config=config)
    snap, batch = enc.encode_nodes(), enc.encode_pods()
    return (snap, batch, snapshot_from_arrays(fields_of(snap)),
            batch_from_arrays(fields_of(batch)))


_PORT_MODULES = (port_types, port_labels, port_resource)
_JAX_MODULES = (jax_types, jax_labels, jax_resource)


def to_port(obj):
    """Deep-convert JAX-package API objects into the port's classes of the
    same names (the port's api/ is a copy of the JAX package's)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = next(getattr(m, type(obj).__name__) for m in _PORT_MODULES
                   if hasattr(m, type(obj).__name__))
        init = {f.name: to_port(getattr(obj, f.name))
                for f in dataclasses.fields(obj) if f.init}
        out = cls(**init)
        for f in dataclasses.fields(obj):
            if not f.init:
                setattr(out, f.name, to_port(getattr(obj, f.name)))
        return out
    if isinstance(obj, list):
        return [to_port(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(to_port(v) for v in obj)
    if isinstance(obj, dict):
        return {k: to_port(v) for k, v in obj.items()}
    return obj


def port_state(state):
    """The port's ClusterState holding converted copies of a JAX-package
    ClusterState's nodes, assigned pods and listers."""
    return PortClusterState.build(
        to_port(state.nodes()),
        assigned_pods=to_port(state.all_assigned_pods()),
        services=to_port(state.services),
        controllers=to_port(state.controllers),
        replica_sets=to_port(state.replica_sets),
        pvs=to_port(list(state.pvs.values())),
        pvcs=to_port(list(state.pvcs.values())),
    )


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def assert_same(a, b, what=""):
    """Exact equality of a JAX and a port value (dtypes may differ: the
    port widens integer tables to int64)."""
    a, b = as_np(a), as_np(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        assert np.array_equal(a, b, equal_nan=True), what
    else:
        assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), what


def scenario(seed, interpod_p=0.3, volumes_p=0.3, **kw):
    rng = random.Random(seed)
    return random_scenario(rng, interpod_p=interpod_p, volumes_p=volumes_p,
                           **kw)


# -- bitset / select -----------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_bitset_matches(seed):
    rng = np.random.default_rng(seed)
    mask = rng.integers(0, 2**32, (17, 3), dtype=np.uint64).astype(np.uint32)
    other = rng.integers(0, 2**32, (17, 3), dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(-2, 96, (17,)).astype(np.int32)
    tm, to, ti = (place(a, CPU) for a in (mask, other, idx))
    assert_same(JBS.test_bit(jnp.asarray(mask), jnp.asarray(idx)),
                TBS.test_bit(tm, ti), "test_bit")
    assert_same(JBS.intersects(jnp.asarray(mask), jnp.asarray(other)),
                TBS.intersects(tm, to), "intersects")
    assert_same(JBS.popcount(jnp.asarray(mask)), TBS.popcount(tm),
                "popcount")
    # the complement of a widened word must still count 32-bit bits
    assert_same(JBS.popcount(jnp.asarray(~mask)),
                TBS.popcount(~tm & 0xFFFFFFFF), "popcount of complement")


@pytest.mark.parametrize("seed", range(4))
def test_select_host_matches(seed):
    rng = np.random.default_rng(seed)
    N = int(rng.integers(1, 40))
    scores = rng.integers(0, 4, N).astype(np.int64)
    if seed == 3:
        scores[rng.random(N) < 0.3] = -(2**63)  # the spread-NaN score
    fit = rng.random(N) < 0.7
    order = rng.permutation(N).astype(np.int32)
    for last in (0, 1, 7, 12345):
        jc, js = JS.select_host(jnp.asarray(scores), jnp.asarray(fit),
                                jnp.int64(last), jnp.asarray(order))
        tc, ts = TS.select_host(place(scores, CPU), place(fit, CPU),
                                torch.tensor(last), place(order, CPU))
        assert int(jc) == int(tc) and bool(js) == bool(ts)


# -- priorities ------------------------------------------------------------------


def test_resource_scores_edge_fractions():
    # zero allocations, requests above capacity, and fractions where
    # 10 - 10*|cpu - mem| lands on (or next to) an integer
    rng = np.random.default_rng(7)
    N = 512
    a_cpu = rng.choice([0, 1000, 3000], N).astype(np.int64)
    a_mem = rng.choice([0, 1000, 7000], N).astype(np.int64)
    nz_c = (10 * rng.integers(0, 120, N)).astype(np.int64)
    nz_m = (10 * rng.integers(0, 120, N)).astype(np.int64)
    for fn_j, fn_t in ((JR.least_requested, TR.least_requested),
                       (JR.balanced_resource_allocation,
                        TR.balanced_resource_allocation)):
        want = fn_j(jnp.int64(10), jnp.int64(20), jnp.asarray(nz_c),
                    jnp.asarray(nz_m), jnp.asarray(a_cpu),
                    jnp.asarray(a_mem))
        got = fn_t(torch.tensor(10), torch.tensor(20), place(nz_c, CPU),
                   place(nz_m, CPU), place(a_cpu, CPU), place(a_mem, CPU))
        assert_same(want, got, fn_j.__name__)


@pytest.mark.parametrize("seed", range(4))
def test_selector_spread_matches(seed):
    rng = np.random.default_rng(seed)
    N, C = 24, 5
    num_zones = 1 + seed  # seed 0: unzoned; else zone ids incl. 0
    class_count = rng.integers(0, 4, (N, C)).astype(np.int64)
    match = (rng.random(C) < 0.6).astype(np.int64)
    zone = rng.integers(0, num_zones, N).astype(np.int32)
    fit = rng.random(N) < 0.8
    if seed == 2:
        class_count[:] = 0  # maxZone == 0: the 0/0 NaN -> minInt64 path
    for has_sel in (True, False):
        want = JR.selector_spread(jnp.bool_(has_sel), jnp.asarray(match),
                                  jnp.asarray(class_count),
                                  jnp.asarray(zone), num_zones,
                                  jnp.asarray(fit))
        got = TR.selector_spread(torch.tensor(has_sel), place(match, CPU),
                                 place(class_count, CPU), place(zone, CPU),
                                 num_zones, place(fit, CPU))
        assert_same(want, got, "selector_spread")


def test_normalizers_and_image_locality():
    rng = np.random.default_rng(11)
    counts = rng.integers(0, 9, 33).astype(np.int64)
    for mx in (0, 3, 8):
        assert_same(JR.normalize_counts_up(jnp.asarray(counts),
                                           jnp.int64(mx)),
                    TR.normalize_counts_up(place(counts, CPU),
                                           torch.tensor(mx)), "up")
        assert_same(JR.normalize_counts_down(jnp.asarray(counts),
                                             jnp.int64(mx)),
                    TR.normalize_counts_down(place(counts, CPU),
                                             torch.tensor(mx)), "down")
    img = rng.choice([0, 10, 300, 900], (33, 4)).astype(np.int64) * 2**20
    cnt = rng.integers(0, 3, 4).astype(np.int64)
    assert_same(JR.image_locality(jnp.asarray(img), jnp.asarray(cnt)),
                TR.image_locality(place(img, CPU), place(cnt, CPU)),
                "image_locality")
    taint = rng.integers(0, 3, (33, 6)).astype(np.int32)
    pref = rng.integers(0, 2, 6).astype(np.int32)
    assert_same(JR.taint_intolerable_counts(jnp.asarray(taint),
                                            jnp.asarray(pref)),
                TR.taint_intolerable_counts(place(taint, CPU),
                                            place(pref, CPU)), "taints")


# -- volumes -------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_volumes_match(seed):
    rng = np.random.default_rng(seed)
    N, W = 19, 2

    def words(*shape):
        return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(
            np.uint32) & rng.integers(0, 2**32, shape, dtype=np.uint64
                                      ).astype(np.uint32)

    pod, node, node_any = words(W), words(N, W), words(N, W)
    bad = rng.random(N) < 0.2
    for pod_bad, has_new in ((False, True), (True, True), (False, False)):
        assert_same(
            JV.max_pd_count(jnp.asarray(pod), jnp.bool_(pod_bad),
                            jnp.bool_(has_new), jnp.asarray(node),
                            jnp.asarray(bad), 40),
            TV.max_pd_count(place(pod, CPU), torch.tensor(pod_bad),
                            torch.tensor(has_new), place(node, CPU),
                            place(bad, CPU), 40), "max_pd_count")
    assert_same(
        JV.no_disk_conflict(jnp.asarray(pod), jnp.asarray(pod),
                            jnp.asarray(node_any), jnp.asarray(node)),
        TV.no_disk_conflict(place(pod, CPU), place(pod, CPU),
                            place(node_any, CPU), place(node, CPU)),
        "no_disk_conflict")
    zone = rng.integers(-1, 3, N).astype(np.int32)
    has = rng.random(N) < 0.7
    for pz, pr, fail in ((-1, -1, False), (1, -1, False), (2, 0, True)):
        assert_same(
            JV.volume_zone(jnp.int32(pz), jnp.int32(pr), jnp.bool_(fail),
                           jnp.asarray(zone), jnp.asarray(zone),
                           jnp.asarray(has)),
            TV.volume_zone(torch.tensor(pz), torch.tensor(pr),
                           torch.tensor(fail), place(zone, CPU),
                           place(zone, CPU), place(has, CPU)),
            "volume_zone")


# -- every predicate and priority, through a real encoded scenario -------------


@pytest.mark.parametrize("seed", range(4))
def test_evaluate_pod_matches(seed):
    """Fit mask and weighted score of every pod against the initial carry
    (JAX's debug_evaluate) — covers predicates, priorities, interpod and
    volumes on the encoder's real layouts."""
    state, pending = scenario(seed)
    snap, batch, psnap, pbatch = encode(state, pending)
    fit_j, score_j = JB.BatchScheduler().debug_evaluate(snap, batch)
    sched = TB.BatchScheduler(device="cpu")
    static = sched.place_static(psnap)
    carry = sched.initial_carry(psnap)
    pods = to_device(pbatch, CPU, TB.BatchScheduler.POD_FIELDS)
    nz = TB.num_zones_of(psnap)
    for i in range(pbatch.num_pods):
        pod = {f: t[i] for f, t in pods.items()}
        fit, score = TB.evaluate_pod(sched.config, nz, 0, static, carry, pod)
        assert_same(fit_j[i], fit.expand(psnap.num_nodes), f"fit pod {i}")
        assert_same(score_j[i], score, f"score pod {i}")


@pytest.mark.parametrize("seed", range(3))
def test_interpod_commit_matches(seed):
    """One scheduled commit folded into the affinity tables by both."""
    state, pending = scenario(100 + seed, interpod_p=0.9, volumes_p=0.0)
    snap, batch, psnap, pbatch = encode(state, pending)
    if not snap.ip_u_topo.size:
        pytest.skip("scenario compiled no inter-pod terms")
    jcarry = JB.BatchScheduler().initial_carry(snap)
    sched = TB.BatchScheduler(device="cpu")
    static = sched.place_static(psnap)
    tcarry = sched.initial_carry(psnap)
    for i in range(batch.num_pods):
        node = i % snap.num_nodes
        jpod = {f: jnp.asarray(np.asarray(getattr(batch, f))[i])
                for f in JB.BatchScheduler.POD_FIELDS}
        out_j = JIP.interpod_commit(
            *jcarry[4:10], jnp.asarray(snap.ip_topo_dom),
            jnp.asarray(snap.ip_u_topo), jnp.asarray(snap.ip_u_spec),
            jnp.asarray(snap.ip_lt_u), jpod["ip_match_spec"],
            jpod["ip_own_hard"], jpod["ip_own_pref"],
            jpod["ip_own_anti_hard"], jpod["ip_own_anti_pref"],
            jnp.int32(node), jnp.bool_(True))
        jcarry = jcarry[:4] + tuple(out_j) + jcarry[10:]
        tpod = {f: place(np.asarray(getattr(pbatch, f))[i], CPU)
                for f in TB.BatchScheduler.POD_FIELDS}
        TIP.interpod_commit(
            *(tcarry[k] for k in TB.CARRY_FIELDS[4:10]),
            static["ip_topo_dom"], static["ip_u_topo"], static["ip_u_spec"],
            static["ip_lt_u"], tpod["ip_match_spec"], tpod["ip_own_hard"],
            tpod["ip_own_pref"], tpod["ip_own_anti_hard"],
            tpod["ip_own_anti_pref"], torch.tensor(node), torch.tensor(True))
    for k, jv in zip(TB.CARRY_FIELDS[4:10], jcarry[4:10]):
        assert_same(jv, tcarry[k], k)


def test_carry_helpers_copy_and_widen():
    state, pending = scenario(5, interpod_p=0.0, volumes_p=0.0)
    snap, batch, psnap, pbatch = encode(state, pending)
    assert psnap.port_mask is not snap.port_mask
    assert np.array_equal(psnap.port_mask, snap.port_mask)
    placed = to_device(psnap, CPU)
    assert placed["port_mask"].dtype == torch.int64  # uint32 widened
    assert placed["numval"].dtype == torch.float64
    assert placed["mem_pressure"].dtype == torch.bool
    placed["alloc_mcpu"] += 1  # a placed table is a copy
    assert np.array_equal(psnap.alloc_mcpu, snap.alloc_mcpu)
    assert to_device(pbatch, CPU)["req_mcpu"].shape == (pbatch.num_pods,)


def test_to_port_converts_objects():
    state, pending = scenario(3)
    ported = to_port(pending)
    assert type(ported[0]) is port_types.Pod
    assert repr(ported) == repr(pending)
    assert port_state(state).nodes()[0].name == state.nodes()[0].name
