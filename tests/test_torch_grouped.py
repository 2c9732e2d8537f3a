"""The grouped dispatch paths of the port's wave driver (the grouped
header probe with host replay, the grouped device replay) against the
JAX driver and the oracle, on the scenarios of tests/test_wave.py's
grouped section, on the CPU. Decisions must be identical (node names per
pod, exactly), and so must the two drivers' dispatch tallies."""

import random

import numpy as np
import pytest
import torch

import kubernetes_tpu.api.types as JT
from kubernetes_tpu.models import pack as JPK
from kubernetes_tpu.models import wave as JW
from kubernetes_tpu.models.batch import SchedulerConfig as JaxConfig
from kubernetes_tpu.oracle import ClusterState as JaxState
from kubernetes_tpu.oracle import GenericScheduler as JaxOracle
from kubernetes_tpu.parallel.mesh import _pad_snapshot
from kubernetes_tpu.scheduler.tpu_algorithm import TPUScheduleAlgorithm
from kubernetes_tpu.snapshot.encode import SnapshotEncoder

import kubernetes_tpu_torch.api.types as TT
from kubernetes_tpu_torch.harness import scenarios as S
from kubernetes_tpu_torch.models import pack as TPK
from kubernetes_tpu_torch.models import wave as TW
from kubernetes_tpu_torch.models.batch import BatchScheduler
from kubernetes_tpu_torch.models.batch import SchedulerConfig
from kubernetes_tpu_torch.oracle import ClusterState as PortState
from kubernetes_tpu_torch.oracle import GenericScheduler as PortOracle
from kubernetes_tpu_torch.oracle import predicates as opreds
from kubernetes_tpu_torch.oracle import priorities as oprios
from kubernetes_tpu_torch.oracle.scheduler import PriorityConfig
from kubernetes_tpu_torch.scheduler.algorithm import TorchScheduleAlgorithm
from kubernetes_tpu_torch.snapshot.carry import (
    batch_from_arrays,
    snapshot_from_arrays,
)
from kubernetes_tpu_torch.snapshot.encode import pod_feature_key
from kubernetes_tpu_torch.snapshot.pad import next_pow2

from tests.test_torch_ops import fields_of
from tests.test_torch_wave import dispatch_shape, run_all, spread_state


def test_grouped_heterogeneous_spread_coupling():
    # 12 templates selected by ONE service: every run's commits move
    # every later run's spread counts (the host class-count adjustment)
    run_all(lambda T, CS: (spread_state(T, CS, S.density_nodes(T, 15)),
                           S.template_pods(T, 12, 10)))


def test_grouped_resource_coupling_fills_nodes():
    # earlier runs exhaust nodes mid-group: the host-rebuilt res_fit and
    # LR/BA tables must see the accumulated usage; the tail goes
    # unschedulable
    got = run_all(lambda T, CS: (
        CS.build(S.density_nodes(T, 4, cpu="2", mem="4Gi")),
        S.template_pods(T, 8, 15, cpu0=200, mem_step=100)))
    assert None in got


def test_grouped_port_conflicts_across_runs():
    # three templates sharing a host port: a node taken by run A's copy
    # rejects runs B and C; a fourth portless template is unaffected
    def build(T, CS):
        pods = []
        for t in range(3):
            pods += [T.Pod(
                metadata=T.ObjectMeta(name=f"pp{t}-{i}", labels={"app": "p"}),
                spec=T.PodSpec(containers=[T.Container(
                    requests={"cpu": f"{100 + t * 50}m"},
                    ports=[T.ContainerPort(host_port=8080)])]))
                for i in range(4)]
        pods += S.template_pods(T, 1, 5, labels={"app": "free"}, cpu0=75,
                                name0="free-")
        return CS.build(S.density_nodes(T, 6)), pods

    got = run_all(build)
    port_hosts = [h for h in got[:12] if h]
    assert len(port_hosts) == len(set(port_hosts)) == 6


def test_grouped_zoned_multi_template():
    # selector templates on a zoned cluster: the grouped device replay
    run_all(lambda T, CS: (
        spread_state(T, CS, S.zoned_density_nodes(T, 12)),
        S.template_pods(T, 6, 15)))


def test_grouped_zoned_capacity_tail():
    got = run_all(lambda T, CS: (
        spread_state(T, CS, S.zoned_density_nodes(T, 6, pods_cap="8")),
        S.template_pods(T, 5, 14)))
    assert got[-1] is None


def test_grouped_impure_run_breaks_group():
    # pure templates around an anti-affinity template (own terms: impure)
    # take the per-run path, and its fold is visible to later pure runs
    def build(T, CS):
        pods = S.template_pods(T, 3, 8, labels={"g": "a"})
        pods += S.anti_pods(T, 8, {"g": "a"}, name0=500,
                            requests={"cpu": "300m"})
        pods += S.template_pods(T, 3, 8, labels={"g": "a"}, cpu0=400,
                                name0="post-")
        return CS.build(S.hostname_nodes(T, 10)), pods

    run_all(build)


@pytest.mark.parametrize("seed", range(3))
def test_grouped_random_templates(seed):
    # random multi-template backlogs: varying template counts, run
    # lengths, capacities, zones, services, host ports — grouped (host
    # and device), single and scan paths interleave
    def build(T, CS):
        rng = random.Random(4000 + seed)
        zones = ("a", "b", "c")[: rng.randint(1, 3)]
        if rng.random() < 0.5:
            nodes = S.zoned_density_nodes(
                T, rng.randint(5, 20), zones=zones,
                unzoned_every=rng.choice([0, 3]),
                pods_cap=str(rng.randint(4, 30)))
        else:
            nodes = S.density_nodes(T, rng.randint(5, 20),
                                    pods_cap=str(rng.randint(4, 30)))
        state = (spread_state(T, CS, nodes) if rng.random() < 0.6
                 else CS.build(nodes))
        pods = []
        for t in range(rng.randint(3, 14)):
            lbl = ({"name": "sched-perf"} if rng.random() < 0.7
                   else {"app": f"x{t % 3}"})
            port = 7000 + t % 2 if rng.random() < 0.15 else None
            pods += S.template_pods(T, 1, rng.randint(1, 18), labels=lbl,
                                    cpu0=40 + t * 7, mem_step=30 + t,
                                    name0=f"s{t:02d}-", host_port=port)
        return state, pods

    run_all(build)


def test_grouped_probe_count_is_o1():
    # 100 distinct templates: no per-template probe, one grouped header
    # probe (and its fold) for the whole backlog
    def build(T, CS):
        return (CS.build(S.density_nodes(T, 50)),
                S.template_pods(T, 100, 8, cpu0=20, mem_step=13))

    prio = (("LeastRequestedPriority", 1), ("BalancedResourceAllocation", 1))
    state, pods = build(TT, PortState)
    algo = TorchScheduleAlgorithm(device="cpu", min_run=1,
                                  config=SchedulerConfig(
                                      predicates=("PodFitsResources",),
                                      priorities=prio))
    got = algo.schedule_backlog(pods, state)
    d = dict(algo._wave.dispatches)
    assert d.get("probe", 0) == 0 and d.get("group_probe", 0) <= 1, d
    assert sum(d.values()) <= 3, d
    jstate, jpods = build(JT, JaxState)
    jalgo = TPUScheduleAlgorithm(min_run=1, config=JaxConfig(
        predicates=("PodFitsResources",), priorities=prio))
    assert jalgo.schedule_backlog(jpods, jstate) == got
    assert dispatch_shape(d) == dispatch_shape(jalgo._wave.dispatches)
    oracle = PortOracle(
        predicates=[("PodFitsResources", opreds.pod_fits_resources)],
        priorities=[
            PriorityConfig(oprios.least_requested_priority, 1, "LR"),
            PriorityConfig(oprios.balanced_resource_allocation, 1, "BA"),
        ])
    assert got == oracle.schedule_backlog(pods, state.clone())


def _wave_direct(build, max_j):
    """Both drivers directly (dedup + pad like the algorithm shells) with
    a clamped table horizon, on one JAX-package encoding carried across.
    -> (port names, port dispatches, JAX dispatches, oracle names)."""
    state, pods = build(JT, JaxState)
    uniq, rep_of, rep_idx = [], {}, []
    for p in pods:
        k = pod_feature_key(p)
        if k not in rep_of:
            rep_of[k] = len(uniq)
            uniq.append(p)
        rep_idx.append(rep_of[k])
    rep_idx = np.asarray(rep_idx, np.int64)
    enc = SnapshotEncoder(state, uniq)
    snap, batch = enc.encode_nodes(), enc.encode_pods()
    snap_p = _pad_snapshot(snap, next_pow2(snap.num_nodes, 4))
    jw = JW.WaveScheduler(min_run=1, max_j=max_j)
    want, _, want_last = jw.schedule_backlog(snap_p, batch, rep_idx)
    tw = TW.WaveScheduler(min_run=1, max_j=max_j, device="cpu")
    got, carry, last = tw.schedule_backlog(
        snapshot_from_arrays(fields_of(snap_p)),
        batch_from_arrays(fields_of(batch)), rep_idx)
    assert np.array_equal(got, want) and last == want_last
    assert int(carry["last_idx"]) == last
    names = [snap.node_names[c] if 0 <= c < snap.num_nodes else None
             for c in got]
    assert names == JaxOracle().schedule_backlog(pods, state.clone())
    assert dispatch_shape(tw.dispatches) == dispatch_shape(jw.dispatches)
    return tw.dispatches


def test_grouped_host_horizon_resume():
    # a clamped 128-row horizon inside a HOST group: the group aborts,
    # the partial run resumes on the single path, the rest regroup
    d = _wave_direct(lambda T, CS: (
        CS.build(S.density_nodes(T, 2, pods_cap="1000")),
        S.template_pods(T, 3, 300, cpu0=1, mem_step=0)), max_j=128)
    assert d.get("probe", 0) >= 1 and d.get("group_probe", 0) >= 1, d


def test_grouped_device_horizon_resume():
    # the same horizon abort through the grouped DEVICE replay: later
    # runs of the group schedule nothing, the host resumes from the bail
    d = _wave_direct(lambda T, CS: (
        spread_state(T, CS, S.zoned_density_nodes(T, 2, pods_cap="1000")),
        S.template_pods(T, 3, 300, cpu0=1, mem_step=0)), max_j=128)
    assert d.get("zreplay", 0) >= 1 and d.get("zreplay_group", 0) >= 1, d


def test_group_buffer_rows_match_the_packed_buffer():
    """group_buffer is the JAX contract: one packed uint8 buffer of the
    group's rows, padded to the same pow2 bucket by repeating the last
    representative. The port's layout and bytes equal the JAX package's,
    and the port's device unpack gives the JAX unpack's rows field by
    field (widened to int64 by the port's placement rule)."""
    state = JaxState.build(S.density_nodes(JT, 4))
    pods = S.template_pods(JT, 5, 1)
    enc = SnapshotEncoder(state, pods)
    batch = enc.encode_pods()
    reps = [3, 0, 4]
    G, layout, buf = JW.group_buffer(batch, reps)
    jrows = JPK.unpack(layout, buf)
    G2, tlayout, tbuf = TW.group_buffer(
        batch_from_arrays(fields_of(batch)), reps)
    assert G2 == G == 8
    assert tlayout == layout and np.array_equal(tbuf, buf)
    trows = TPK.unpack(tlayout, torch.from_numpy(tbuf))
    for f in BatchScheduler.POD_FIELDS:
        assert np.array_equal(np.asarray(jrows[f]).astype(np.int64),
                              trows[f].numpy().astype(np.int64)), f
    assert torch.equal(trows["req_mcpu"][3:], trows["req_mcpu"][2:3]
                       .expand(5))