"""The port's mesh drivers (parallel/mesh, parallel/shard) against the
JAX package's mesh on its 8 CPU devices and the oracle, on the CPU.

The port's mesh repeats torch's one CPU device (DeviceMesh(["cpu"] * k))
at 1, 2 and 8 shards, so the shard offsets, the collectives and the
replicated folds all run; the JAX mesh runs once per scenario at 8
devices (tests/conftest.py forces them). Every decision, dispatch tally
and resident statistic is an integer or a name: the tolerance is exact
equality. The counterparts of tests/test_parallel.py and of
tests/test_wave.py test_wave_grouped_mesh_matches_oracle."""

import dataclasses
import logging
import random

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import kubernetes_tpu.api.types as JT
from kubernetes_tpu.models.batch import BatchScheduler as JaxBatch
from kubernetes_tpu.models.batch import SchedulerConfig as JaxConfig
from kubernetes_tpu.oracle import ClusterState as JaxState
from kubernetes_tpu.parallel.mesh import MeshBatchScheduler as JaxMeshBatch
from kubernetes_tpu.parallel.mesh import MeshWaveScheduler as JaxMeshWave
from kubernetes_tpu.scheduler.tpu_algorithm import TPUScheduleAlgorithm

import kubernetes_tpu_torch.api.types as TT
from kubernetes_tpu_torch.harness import scenarios as S
from kubernetes_tpu_torch.models import batch as TB
from kubernetes_tpu_torch.oracle import ClusterState as PortState
from kubernetes_tpu_torch.oracle import GenericScheduler as PortOracle
from kubernetes_tpu_torch.parallel.mesh import (
    MeshBatchScheduler,
    MeshWaveScheduler,
)
from kubernetes_tpu_torch.parallel.shard import (
    DeviceMesh,
    all_gather,
    pmax,
    psum,
    shard_slice,
)
from kubernetes_tpu_torch.scheduler import algorithmprovider as AP
from kubernetes_tpu_torch.scheduler.algorithm import TorchScheduleAlgorithm
from kubernetes_tpu_torch.snapshot.encode import pod_feature_key

from tests.test_conformance import random_scenario, run_both
from tests.test_torch_ops import encode, port_state, to_port

SHARDS = (1, 2, 8)
_JAX: dict = {}


def jax_mesh():
    devices = jax.devices()
    assert len(devices) == 8, "conftest must force 8 CPU devices"
    return Mesh(np.array(devices), ("nodes",))


def port_mesh(k):
    return DeviceMesh(["cpu"] * k)


def jax_once(key, fn):
    """A JAX result computed once per scenario (the port runs it at
    every shard count)."""
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


def port_config(cfg):
    """A JAX-package SchedulerConfig as the port's."""
    return TB.SchedulerConfig(**{f.name: getattr(cfg, f.name)
                                 for f in dataclasses.fields(cfg)})


def mesh_scan_names(k, psnap, pbatch, config=None):
    return MeshBatchScheduler(port_mesh(k), config=config).schedule_names(
        psnap, pbatch)


# -- the collectives and the mesh -------------------------------------------


def test_collectives_reduce_across_shards():
    rng = np.random.default_rng(0)
    parts = [torch.from_numpy(rng.integers(-50, 50, 6)) for _ in range(3)]
    want = np.stack([p.numpy() for p in parts])
    for got in pmax(parts):
        assert np.array_equal(got.numpy(), want.max(0))
    for got in psum(parts):
        assert np.array_equal(got.numpy(), want.sum(0))
    for got in all_gather(parts):
        assert np.array_equal(got.numpy(), want.reshape(-1))
    i32 = [p.to(torch.int32) for p in parts]
    assert pmax(i32)[0].dtype == torch.int32
    assert psum(i32)[0].dtype == torch.int32


def test_device_mesh_repeats_a_device():
    mesh = DeviceMesh(["cpu"] * 4)
    assert mesh.size == 4 and mesh.axis_names == ("nodes",)
    assert mesh.distinct_devices() == (torch.device("cpu"),)
    assert mesh.first_shard_of() == (0,)
    assert shard_slice(2, 16) == slice(32, 48)
    with pytest.raises(ValueError):
        DeviceMesh([])


def test_spread_blend_matches_the_jax_body_and_the_oracle_weight():
    """_spread_sharded on a witness where the JAX body's float32 weight
    1 - fl32(2/3) (2**-25 below the oracle's fl32(1/3)) would truncate
    f * w + fl32(2/3) * z to 3 (f = 8.8, z = 1.6: node counts 6 of a
    maximum 50, zone counts 42 of a maximum 50): the port takes the
    oracle's weight and gives 4, as its single-device selector_spread and
    the JAX body under jit on one device do."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from kubernetes_tpu.parallel.compat import shard_map
    from kubernetes_tpu.parallel.mesh import _spread_sharded as jax_spread

    from kubernetes_tpu_torch.ops.priorities import selector_spread
    from kubernetes_tpu_torch.parallel.mesh import _spread_sharded

    cc = np.array([[6], [36], [50], [0]], np.int64)  # zones 1, 1, 2, none
    zone = np.array([1, 1, 2, 0], np.int64)
    fit = np.array([True, True, True, False])
    sm = np.array([1], np.int64)
    one = Mesh(np.array(jax.devices()[:1]), ("nodes",))
    body = shard_map(
        lambda c, z, f: jax_spread(jnp.bool_(True), jnp.asarray(sm), c, z,
                                   3, f),
        mesh=one, in_specs=(JP("nodes"),) * 3, out_specs=JP("nodes"))
    want = np.asarray(jax.jit(body)(cc, zone, fit))
    t = torch.from_numpy
    single = selector_spread(torch.tensor(True), t(sm), t(cc), t(zone), 3,
                             t(fit)).numpy()
    for k in (1, 2, 4):
        n = 4 // k
        got = _spread_sharded(
            [torch.tensor(True)] * k, [t(sm)] * k,
            [t(cc[s * n:(s + 1) * n]) for s in range(k)],
            [t(zone[s * n:(s + 1) * n]) for s in range(k)], 3,
            [t(fit[s * n:(s + 1) * n]) for s in range(k)])
        assert np.array_equal(np.concatenate([g.numpy() for g in got]),
                              want)
    assert np.array_equal(single, want) and want[0] == 4


# -- the serial scan (tests/test_parallel.py) -------------------------------


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("seed", [1, 4])
def test_mesh_matches_single_device(seed, k):
    rng = random.Random(seed)
    # 13 nodes: not divisible by 2 or 8 -> exercises dummy-node padding
    state, pending = random_scenario(rng, n_nodes=13, n_existing=10,
                                     n_pending=18)
    snap, batch, psnap, pbatch = encode(state, pending)
    single = jax_once(("single", seed), lambda: JaxBatch(
        JaxConfig()).schedule_names(snap, batch))
    jmesh = jax_once(("mesh", seed), lambda: JaxMeshBatch(
        jax_mesh()).schedule_names(snap, batch))
    got = mesh_scan_names(k, psnap, pbatch)
    assert got == single == jmesh


@pytest.mark.parametrize("k", SHARDS)
def test_mesh_matches_oracle(k):
    rng = random.Random(7)
    state, pending = random_scenario(rng, n_nodes=16, n_existing=8,
                                     n_pending=12)
    want = jax_once(("oracle", 7), lambda: run_both(state, pending)[0])
    _s, _b, psnap, pbatch = encode(state, pending)
    assert mesh_scan_names(k, psnap, pbatch) == want


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("seed", [2, 9])
def test_mesh_interpod_affinity_matches_oracle(seed, k):
    """The interpod path: the shards' domain windows, the all_gather'd
    min/max normalization, the replicated table commits folded once a
    device (the mesh repeats one device here), ip_topo_dom padding."""
    rng = random.Random(seed)
    state, pending = random_scenario(rng, n_nodes=13, n_existing=10,
                                     n_pending=14, interpod_p=0.7)

    def ref():
        want, single = run_both(state, pending)
        assert single == want
        snap, batch, _ps, _pb = encode(state, pending)
        assert JaxMeshBatch(jax_mesh()).schedule_names(snap, batch) == want
        return want

    want = jax_once(("interpod", seed), ref)
    _s, _b, psnap, pbatch = encode(state, pending)
    assert mesh_scan_names(k, psnap, pbatch) == want


@pytest.mark.parametrize("k", SHARDS)
def test_mesh_volumes_match_oracle(k):
    rng = random.Random(3)
    state, pending = random_scenario(rng, n_nodes=13, n_existing=12,
                                     n_pending=14, volumes_p=0.7)

    def ref():
        want, single = run_both(state, pending)
        assert single == want
        snap, batch, _ps, _pb = encode(state, pending)
        assert JaxMeshBatch(jax_mesh()).schedule_names(snap, batch) == want
        return want

    want = jax_once("volumes", ref)
    _s, _b, psnap, pbatch = encode(state, pending)
    assert mesh_scan_names(k, psnap, pbatch) == want


def _svc_case(anti: bool):
    from tests.test_conformance import (
        _run_both_svc,
        _svc_affinity_cluster,
        _svc_pod,
    )

    nodes, services = _svc_affinity_cluster()
    if anti:
        assigned = [_svc_pod("web-0", {"app": "web"}, node="node-0"),
                    _svc_pod("web-1", {"app": "web"}, node="node-1")]
        pending = [_svc_pod(f"web-{i}", {"app": "web"})
                   for i in range(2, 8)] + [_svc_pod("db-1",
                                                     {"app": "db"})]
        cfg = JaxConfig(
            predicates=("GeneralPredicates",
                        ("ServiceAffinity", ("region",))),
            priorities=(("LeastRequestedPriority", 1),
                        (("ServiceAntiAffinity", "rack"), 2)))
        kw = {"labels": ("region",), "anti_label": "rack"}
    else:
        assigned = [_svc_pod("web-0", {"app": "web"}, node="node-0")]
        pending = [_svc_pod("web-1", {"app": "web"}),
                   _svc_pod("db-1", {"app": "db"}),
                   _svc_pod("web-2", {"app": "web"}),
                   _svc_pod("lone", {"app": "none"}),
                   _svc_pod("db-2", {"app": "db"})]
        cfg = JaxConfig(
            predicates=("GeneralPredicates",
                        ("ServiceAffinity", ("region",))),
            priorities=(("LeastRequestedPriority", 1),))
        kw = {}
    state = JaxState.build(nodes, services=services, assigned_pods=assigned)

    def ref():
        want, single = _run_both_svc(state, pending, **kw)
        assert single == want
        snap, batch, _ps, _pb = encode(state, pending, config=cfg)
        assert JaxMeshBatch(jax_mesh(), config=cfg).schedule_names(
            snap, batch) == want
        return want

    want = jax_once(("svc", anti), ref)
    return state, pending, cfg, want


@pytest.mark.parametrize("k", SHARDS)
@pytest.mark.parametrize("anti", [False, True],
                         ids=["ServiceAffinity", "ServiceAntiAffinity"])
def test_mesh_service_policies_match_oracle(anti, k):
    """ServiceAffinity (replicated svc tables, the global-axis predicate
    sliced per shard) and ServiceAntiAffinity (the per-value normalizer
    over the all_gather'd fit mask), 9 -> 16 node padding."""
    state, pending, cfg, want = _svc_case(anti)
    _s, _b, psnap, pbatch = encode(state, pending, config=cfg)
    assert mesh_scan_names(k, psnap, pbatch, port_config(cfg)) == want


@pytest.mark.parametrize("k", SHARDS)
def test_mesh_image_locality_and_node_label_match_oracle(k):
    from kubernetes_tpu.oracle import GenericScheduler
    from kubernetes_tpu.oracle import predicates as opreds
    from kubernetes_tpu.oracle import priorities as oprios
    from kubernetes_tpu.oracle.scheduler import PriorityConfig

    rng = random.Random(11)
    mb = 1024 * 1024
    nodes = []
    for i in range(13):  # non-divisible: pads to 16
        labels = {"kubernetes.io/hostname": f"node-{i:02d}"}
        if i % 3 != 0:
            labels["disktype"] = "ssd"
        images = []
        if i % 2:
            images.append(JT.ContainerImage(
                names=("registry/app:v1",), size_bytes=(40 + i * 13) * mb))
        if i % 5 == 0:
            images.append(JT.ContainerImage(names=("registry/db:v2",),
                                            size_bytes=300 * mb))
        nodes.append(JT.Node(
            metadata=JT.ObjectMeta(name=f"node-{i:02d}", labels=labels),
            status=JT.NodeStatus(
                allocatable={"cpu": "8", "memory": "32Gi", "pods": "110"},
                images=images,
                conditions=[JT.NodeCondition("Ready", "True")]),
        ))
    pending = [
        JT.Pod(metadata=JT.ObjectMeta(name=f"p{i:02d}"),
               spec=JT.PodSpec(containers=[JT.Container(
                   image=rng.choice(["registry/app:v1", "registry/db:v2",
                                     "registry/other:v9"]),
                   requests={"cpu": "200m"})]))
        for i in range(10)
    ]
    state = JaxState.build(nodes)
    cfg = JaxConfig(
        predicates=("GeneralPredicates",
                    ("CheckNodeLabelPresence", ("disktype",), True)),
        priorities=(("ImageLocalityPriority", 2),
                    (("NodeLabelPriority", "disktype", True), 1),
                    ("LeastRequestedPriority", 1)))

    def ref():
        oracle = GenericScheduler(
            predicates=[
                ("GeneralPredicates", opreds.general_predicates),
                ("RequireSSD",
                 opreds.node_label_predicate(["disktype"], True)),
            ],
            priorities=[
                PriorityConfig(oprios.image_locality_priority, 2,
                               "ImageLocalityPriority"),
                PriorityConfig(oprios.node_label_priority("disktype", True),
                               1, "NodeLabelPriority"),
                PriorityConfig(oprios.least_requested_priority, 1,
                               "LeastRequestedPriority"),
            ])
        want = oracle.schedule_backlog(pending, state.clone())
        snap, batch, _ps, _pb = encode(state, pending, config=cfg)
        assert JaxMeshBatch(jax_mesh(), config=cfg).schedule_names(
            snap, batch) == want
        return want

    want = jax_once("image", ref)
    _s, _b, psnap, pbatch = encode(state, pending, config=cfg)
    assert mesh_scan_names(k, psnap, pbatch, port_config(cfg)) == want


@pytest.mark.parametrize("k", [2, 8])
def test_mesh_scale_1k_nodes_matches_single_device(k):
    """~1k zoned nodes (1000 -> 1024 padded, 128 a shard at 8) with the
    full default provider: the port's mesh scan equals the JAX package's
    single-device scan."""
    rng = random.Random(12)
    nodes = []
    for i in range(1000):
        nodes.append(JT.Node(
            metadata=JT.ObjectMeta(name=f"node-{i:04d}", labels={
                "kubernetes.io/hostname": f"node-{i:04d}",
                "failure-domain.beta.kubernetes.io/zone": "abc"[i % 3]}),
            status=JT.NodeStatus(
                allocatable={"cpu": "4", "memory": "32Gi", "pods": "110"},
                conditions=[JT.NodeCondition("Ready", "True")]),
        ))
    existing = [
        JT.Pod(metadata=JT.ObjectMeta(
            name=f"run-{i:04d}", labels={"app": rng.choice(["web", "db"])}),
            spec=JT.PodSpec(node_name=f"node-{rng.randrange(1000):04d}",
                            containers=[JT.Container(requests={
                                "cpu": f"{rng.choice([100, 500])}m",
                                "memory": "500Mi"})]))
        for i in range(300)
    ]
    pending = [
        JT.Pod(metadata=JT.ObjectMeta(name=f"p-{i:03d}",
                                      labels={"app": "web"}),
               spec=JT.PodSpec(containers=[JT.Container(requests={
                   "cpu": "100m", "memory": "500Mi"})]))
        for i in range(24)
    ]
    state = JaxState.build(nodes, assigned_pods=existing)
    snap, batch, psnap, pbatch = encode(state, pending)
    single = jax_once("1k", lambda: JaxBatch(JaxConfig()).schedule_names(
        snap, batch))
    got = mesh_scan_names(k, psnap, pbatch)
    assert got == single
    assert all(s is not None for s in got)


# -- the wave driver (tests/test_parallel.py, tests/test_wave.py) -----------


def run_wave_both(key, build, k, config=None, min_run=16):
    """build(types, ClusterState) -> (state, pods). The port's mesh
    algorithm at k shards against the JAX mesh algorithm (8 devices) and
    the port's oracle: names, the dispatch tally and the resident stats
    equal. -> (names, port algorithm)."""
    def ref():
        jstate, jpods = build(JT, JaxState)
        jalgo = TPUScheduleAlgorithm(mesh=jax_mesh(), config=config,
                                     min_run=min_run)
        got = jalgo.schedule_backlog(jpods, jstate.clone())
        ms = jalgo._mesh_sched
        return got, dict(ms.dispatches), dict(ms.resident.stats)

    jgot, jdisp, jstats = jax_once(("wave", key), ref)
    pstate, ppods = build(TT, PortState)
    algo = TorchScheduleAlgorithm(
        device="cpu", mesh=port_mesh(k), min_run=min_run,
        config=None if config is None else port_config(config))
    got = algo.schedule_backlog(ppods, pstate.clone())
    assert got == jgot
    assert algo._mesh_sched.dispatches == jdisp
    assert algo._mesh_sched.resident.stats == jstats
    return got, algo, pstate, ppods


def _spread(T, CS, nodes):
    return CS.build(nodes, services=[
        S.service(T, "svc", {"name": "sched-perf"})])


@pytest.mark.parametrize("k", SHARDS)
def test_mesh_wave_matches_single_device_and_oracle(k):
    """Three template runs (the grouped header probe + fold) and
    heterogeneous stragglers (the sharded scan with the same carry)."""
    def build(T, CS):
        pods = S.pause_pods(T, 120)
        pods += S.pause_pods(T, 40, name0=1000,
                             requests={"cpu": "200m", "memory": "1Gi"})
        for j in range(10):  # distinct requests: never a run
            pods += S.pause_pods(T, 1, name0=2000 + j,
                                 requests={"cpu": f"{50 + j}m"})
        for i, p in enumerate(pods):
            p.metadata.name = f"pod-{i:06d}"
        return _spread(T, CS, S.density_nodes(T, 40, pods_cap="12")), pods

    got, algo, pstate, ppods = run_wave_both("mixed", build, k)
    assert got == PortOracle().schedule_backlog(ppods, pstate.clone())
    assert got == TorchScheduleAlgorithm(device="cpu").schedule_backlog(
        ppods, pstate.clone())
    assert algo._mesh_sched.dispatches["scan"] == 1


@pytest.mark.parametrize("k", SHARDS)
def test_mesh_wave_zoned_and_self_anti(k):
    """Zoned selector spread (replayed on the host on the mesh) and
    hostname self-anti-affinity runs."""
    got, _a, pstate, ppods = run_wave_both(
        "zoned", lambda T, CS: (
            _spread(T, CS, S.zoned_density_nodes(T, 18)),
            S.pause_pods(T, 90)), k)
    assert got == PortOracle().schedule_backlog(ppods, pstate.clone())
    got2, _a, pstate2, ppods2 = run_wave_both(
        "anti", lambda T, CS: (CS.build(S.hostname_nodes(T, 12)),
                               S.anti_pods(T, 20, {"app": "excl"})), k)
    assert got2 == PortOracle().schedule_backlog(ppods2, pstate2.clone())
    placed = [h for h in got2 if h]
    assert len(placed) == len(set(placed)) == 12


@pytest.mark.parametrize("k", SHARDS)
def test_mesh_wave_scale_2k_nodes(k):
    """2k nodes / 6.5k template pods: deep fill with capacity exhaustion,
    equal to the single-device wave and the JAX mesh."""
    def build(T, CS):
        pods = S.pause_pods(T, 6500)  # 6000 slots: a 500-pod tail
        return _spread(T, CS, S.density_nodes(T, 2000, pods_cap="3")), pods

    got, _a, pstate, ppods = run_wave_both("2k", build, k)
    assert got.count(None) == 500
    assert got == TorchScheduleAlgorithm(device="cpu").schedule_backlog(
        ppods, pstate.clone())


@pytest.mark.parametrize("k", SHARDS)
def test_mesh_wave_service_member_runs(k):
    """Service-member runs (the SA pin and the SAA renormalization) on
    the mesh wave path: svc rows ride the sharded probe, the fold of the
    replicated tables runs once a device."""
    from tests.test_wave import _member_state, _members, _svc_oracle
    from tests.test_wave import _svc_policy, _zone_nodes

    cfg = _svc_policy(sa=True, saa=True)
    state = _member_state(_zone_nodes(9))
    pods = _members(40)

    def ref():
        jalgo = TPUScheduleAlgorithm(mesh=jax_mesh(), config=cfg)
        got = jalgo.schedule_backlog(pods, state.clone())
        assert got == _svc_oracle(state, pods, sa=True, saa=True)
        return got, dict(jalgo._mesh_sched.dispatches)

    want, jdisp = jax_once("members", ref)
    algo = TorchScheduleAlgorithm(device="cpu", mesh=port_mesh(k),
                                  config=port_config(cfg))
    assert algo.schedule_backlog(to_port(pods), port_state(state)) == want
    assert algo._mesh_sched.dispatches == jdisp


@pytest.mark.parametrize("k", SHARDS)
def test_wave_grouped_mesh_matches_oracle(k):
    """The grouped path through MeshWaveScheduler directly (the sharded
    header probe, the shared host replay, the sharded grouped fold), 13
    nodes (padding live), seven templates (tests/test_wave.py
    test_wave_grouped_mesh_matches_oracle)."""
    pstate = _spread(TT, PortState, S.density_nodes(TT, 13))
    pods = S.template_pods(TT, 7, 9)
    want = PortOracle().schedule_backlog(pods, pstate.clone())
    reps, uniq, rep_idx = {}, [], []
    for i, p in enumerate(pods):
        key = pod_feature_key(p)
        if key not in reps:
            reps[key] = len(uniq)
            uniq.append(p)
        rep_idx.append(reps[key])
    from kubernetes_tpu_torch.snapshot.encode import SnapshotEncoder

    enc = SnapshotEncoder(pstate, uniq)
    snap, batch = enc.encode_nodes(), enc.encode_pods()
    ws = MeshWaveScheduler(port_mesh(k), min_run=1)
    chosen, _c, _l = ws.schedule_backlog(snap, batch,
                                         np.asarray(rep_idx, np.int64))
    got = [snap.node_names[c] if 0 <= c < 13 else None for c in chosen]
    assert got == want
    def ref():
        from kubernetes_tpu.snapshot.encode import SnapshotEncoder as JEnc
        from kubernetes_tpu.snapshot.encode import pod_feature_key as jkey

        jstate = _spread(JT, JaxState, S.density_nodes(JT, 13))
        seen, juniq = set(), []
        for p in S.template_pods(JT, 7, 9):
            if jkey(p) not in seen:
                seen.add(jkey(p))
                juniq.append(p)
        jenc = JEnc(jstate, juniq)
        jws = JaxMeshWave(jax_mesh(), min_run=1)
        jws.schedule_backlog(jenc.encode_nodes(), jenc.encode_pods(),
                             np.asarray(rep_idx, np.int64))
        return dict(jws.dispatches)

    jdisp = jax_once("grouped", ref)
    assert ws.dispatches == jdisp
    assert ws.dispatches.get("group_probe", 0) >= 1


# -- the algorithm and the daemon -------------------------------------------


def test_optimizing_profile_falls_back_to_greedy_on_the_mesh(caplog):
    pstate = PortState.build(S.density_nodes(TT, 8))
    pods = S.pause_pods(TT, 40)
    with caplog.at_level(logging.WARNING):
        algo = TorchScheduleAlgorithm(device="cpu", mesh=port_mesh(2),
                                      profile="optimizing")
    assert algo._profile == "greedy" and algo._opt is None
    assert any("not supported on the mesh" in r.getMessage()
               for r in caplog.records)
    got = algo.schedule_backlog(pods, pstate.clone())
    assert got == PortOracle().schedule_backlog(pods, pstate.clone())


def test_build_mesh_follows_the_env(monkeypatch):
    monkeypatch.setattr(AP, "_visible_devices",
                        lambda: [torch.device("cpu")])
    for mode in ("auto", "off"):
        monkeypatch.setenv("KUBERNETES_TPU_MESH", mode)
        assert AP._build_mesh() is None
    monkeypatch.setenv("KUBERNETES_TPU_MESH", "force")
    with pytest.raises(RuntimeError, match="force"):
        AP._build_mesh()
    monkeypatch.setattr(AP, "_visible_devices",
                        lambda: [torch.device("cpu")] * 8)
    for mode in ("auto", "force"):
        monkeypatch.setenv("KUBERNETES_TPU_MESH", mode)
        mesh = AP._build_mesh()
        assert isinstance(mesh, DeviceMesh) and mesh.size == 8
    monkeypatch.setenv("KUBERNETES_TPU_MESH", "off")
    assert AP._build_mesh() is None


def test_daemon_selects_mesh_when_multi_device(monkeypatch):
    """The device provider's daemon on a host with several devices (the
    device list monkeypatched to 8 CPU shards) builds the mesh driver,
    warms it up and binds through it end to end (tests/test_parallel.py
    test_daemon_selects_mesh_when_multichip)."""
    import time

    from kubernetes_tpu_torch.apiserver.server import APIServer
    from kubernetes_tpu_torch.client import LocalTransport, RESTClient
    from kubernetes_tpu_torch.scheduler.server import (
        SchedulerServer,
        SchedulerServerOptions,
    )

    monkeypatch.setenv("KUBERNETES_TPU_MESH", "force")
    monkeypatch.setattr(AP, "_visible_devices",
                        lambda: [torch.device("cpu")] * 8)
    server = APIServer()
    client = RESTClient(LocalTransport(server))
    for i in range(5):
        client.nodes().create(TT.Node(
            metadata=TT.ObjectMeta(name=f"m{i}", namespace=""),
            status=TT.NodeStatus(
                allocatable={"cpu": "4", "memory": "32Gi", "pods": "110"},
                conditions=[TT.NodeCondition("Ready", "True")]),
        ))
    sched = SchedulerServer(client, SchedulerServerOptions(
        algorithm_provider="CUDAProvider", device="cpu")).start()
    try:
        algo = sched.scheduler.config.algorithm
        assert algo._mesh_sched is not None, "no mesh driver selected"
        assert algo._mesh_sched.mesh.size == 8
        for i in range(10):
            client.pods().create(TT.Pod(
                metadata=TT.ObjectMeta(name=f"mp{i}"),
                spec=TT.PodSpec(containers=[TT.Container(
                    requests={"cpu": "100m", "memory": "200Mi"})]),
            ))
        deadline = time.time() + 60
        while time.time() < deadline:
            pods, _ = client.pods().list()
            if all(p.spec.node_name for p in pods):
                break
            time.sleep(0.2)
        pods, _ = client.pods().list()
        assert all(p.spec.node_name for p in pods)
        # identical pods spread across nodes (round-robin tie-break)
        assert len({p.spec.node_name for p in pods}) == 5
    finally:
        sched.stop()
