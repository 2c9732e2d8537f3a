"""The double-buffered run pipeline of the port's wave driver
(KUBERNETES_TPU_PIPELINE) against its serial loop, the JAX driver and
the oracle, on the CPU: the counterparts of tests/test_kernel.py's
pipeline tests and of its overlap attribution test.

Pipelined, a single-run probe splits into dispatch and collect and the
next single run's pod row is packed and shipped in the gap ("stage");
decisions and the rest of the dispatch tally do not change."""

import time

import numpy as np
import pytest
import torch

import kubernetes_tpu.api.types as JT
from kubernetes_tpu.models.wave import WaveScheduler as JaxWave
from kubernetes_tpu.oracle import ClusterState as JaxState
from kubernetes_tpu.parallel.mesh import _pad_snapshot
from kubernetes_tpu.scheduler.tpu_algorithm import TPUScheduleAlgorithm
from kubernetes_tpu.snapshot.encode import SnapshotEncoder, pod_feature_key
from kubernetes_tpu.snapshot.pad import next_pow2

import kubernetes_tpu_torch.api.types as TT
from kubernetes_tpu_torch.harness import scenarios as S
from kubernetes_tpu_torch.models import wave as TW
from kubernetes_tpu_torch.oracle import ClusterState as PortState
from kubernetes_tpu_torch.oracle import GenericScheduler
from kubernetes_tpu_torch.scheduler.algorithm import TorchScheduleAlgorithm
from kubernetes_tpu_torch.snapshot.carry import (
    batch_from_arrays,
    snapshot_from_arrays,
)
from kubernetes_tpu_torch.trace import profile as tp
from kubernetes_tpu_torch.trace import spans as trace_span

from tests.test_kernel import _staged_backlog
from tests.test_torch_ops import fields_of, port_state, to_port
from tests.test_torch_wave import dispatch_shape


def _encoded(state, pods):
    """The JAX encoding of a backlog, one row per distinct template, the
    node axis padded as the JAX test pads it -> (jax snap, jax batch,
    port snap, port batch, rep_idx)."""
    uniq, rep_of, rep_list = [], {}, []
    for p in pods:
        k = pod_feature_key(p)
        if k not in rep_of:
            rep_of[k] = len(uniq)
            uniq.append(p)
        rep_list.append(rep_of[k])
    enc = SnapshotEncoder(state, uniq)
    snap = enc.encode_nodes()
    batch = enc.encode_pods()
    snap = _pad_snapshot(snap, next_pow2(snap.num_nodes, 4))
    return (snap, batch, snapshot_from_arrays(fields_of(snap)),
            batch_from_arrays(fields_of(batch)),
            np.asarray(rep_list, np.int64))


@pytest.mark.parametrize("quant_mode", ["int", "off"])
def test_pipeline_decisions_identical_to_serial(quant_mode):
    """The port pipelined == the port serial == the JAX driver pipelined
    (chosen, round-robin counter, the final carry), staging > 0 in the
    pipelined run only, and the pipelined tally equal to the JAX
    driver's, stage included."""
    jsnap, jbatch, snap, batch, rep_idx = _encoded(*_staged_backlog())
    serial = TW.WaveScheduler(device="cpu", min_run=1, pipeline=False,
                              quant_mode=quant_mode)
    piped = TW.WaveScheduler(device="cpu", min_run=1, pipeline=True,
                             quant_mode=quant_mode)
    s_chosen, s_carry, s_last = serial.schedule_backlog(snap, batch,
                                                        rep_idx)
    p_chosen, p_carry, p_last = piped.schedule_backlog(snap, batch, rep_idx)
    assert np.array_equal(s_chosen, p_chosen)
    assert s_last == p_last
    for k in s_carry:
        assert s_carry[k].tolist() == p_carry[k].tolist(), k
    assert piped.dispatches.get("stage", 0) > 0
    assert serial.dispatches.get("stage", 0) == 0
    jax = JaxWave(min_run=1, pipeline=True, quant_mode=quant_mode)
    j_chosen, _jc, j_last = jax.schedule_backlog(jsnap, jbatch, rep_idx)
    assert np.array_equal(np.asarray(j_chosen), p_chosen)
    assert int(j_last) == p_last
    assert dispatch_shape(piped.dispatches) == dispatch_shape(
        jax.dispatches)
    without_stage = dict(piped.dispatches)
    del without_stage["stage"]
    assert without_stage == serial.dispatches


def test_pipeline_env_gate(monkeypatch):
    monkeypatch.delenv(TW.ENV_PIPELINE, raising=False)
    assert TW.WaveScheduler(device="cpu").pipeline is False
    for on in ("1", "true", "on", "yes", " YES "):
        monkeypatch.setenv(TW.ENV_PIPELINE, on)
        assert TW.WaveScheduler(device="cpu").pipeline is True
    monkeypatch.setenv(TW.ENV_PIPELINE, "0")
    assert TW.WaveScheduler(device="cpu").pipeline is False
    monkeypatch.setenv(TW.ENV_PIPELINE, "1")
    assert TW.WaveScheduler(device="cpu", pipeline=False).pipeline is False
    assert TorchScheduleAlgorithm(device="cpu")._wave.pipeline is True


def test_full_stack_matches_oracle_end_to_end(monkeypatch):
    """quant int + pipeline on, through TorchScheduleAlgorithm: equal to
    the oracle and to the JAX package under the same switches."""
    state, pods = _staged_backlog(num_nodes=12, num_pods=90,
                                  templates=3, block=10)
    pstate, ppods = port_state(state), to_port(pods)
    want = GenericScheduler().schedule_backlog(ppods, pstate.clone())
    monkeypatch.setenv("KUBERNETES_TPU_QUANT", "int")
    monkeypatch.setenv(TW.ENV_PIPELINE, "1")
    # min_run 1: the 10-pod runs take the run machinery, and stage
    algo = TorchScheduleAlgorithm(device="cpu", min_run=1)
    got = algo.schedule_backlog(ppods, pstate)
    jax_algo = TPUScheduleAlgorithm(min_run=1)
    assert got == want == jax_algo.schedule_backlog(pods, state)
    assert algo._wave.dispatches.get("stage", 0) > 0
    assert dispatch_shape(algo._wave.dispatches) == dispatch_shape(
        jax_algo._wave.dispatches)


@pytest.mark.parametrize("seed", range(2))
def test_pipeline_on_a_mixed_backlog(monkeypatch, seed):
    """Grouped probes, device replays, scans and single runs in one
    pipelined wave: equal to the oracle and the JAX driver, tallies
    equal."""
    monkeypatch.setenv(TW.ENV_PIPELINE, "1")
    nodes, services = S.mixed_cluster(TT, 48, seed=seed)
    pstate = PortState.build(nodes, services=services)
    ppods = S.mixed_backlog(TT, seed=seed)
    jnodes, jservices = S.mixed_cluster(JT, 48, seed=seed)
    jstate = JaxState.build(jnodes, services=jservices)
    jpods = S.mixed_backlog(JT, seed=seed)
    want = GenericScheduler().schedule_backlog(ppods, pstate.clone())
    algo = TorchScheduleAlgorithm(device="cpu", min_run=1)
    got = algo.schedule_backlog(ppods, pstate)
    jax_algo = TPUScheduleAlgorithm(min_run=1)
    assert got == want == jax_algo.schedule_backlog(jpods, jstate)
    assert dispatch_shape(algo._wave.dispatches) == dispatch_shape(
        jax_algo._wave.dispatches)


def test_overlap_totals_attributes_nested_encode():
    """The port's trace accountant (a verbatim copy) attributes a nested
    encode timer inside a probe window as probe overlap, as JAX
    tests/test_kernel.py expects of its own."""
    if not trace_span.enabled():
        pytest.skip("tracing force-disabled in this environment")
    pt0, ov0 = tp.phase_totals(), tp.overlap_totals()
    with tp.phase_timer("probe"):
        with tp.phase_timer("encode"):  # staged pack inside the window
            time.sleep(0.03)
        time.sleep(0.01)
    pt1, ov1 = tp.phase_totals(), tp.overlap_totals()
    assert pt1["probe"] - pt0["probe"] >= 0.035
    assert ov1["probe"] - ov0["probe"] >= 0.02


def test_pipelined_wave_stages_inside_the_probe_window():
    """A pipelined wave's staging runs under the probe's timer: its encode
    seconds show up as probe overlap (overlap_totals)."""
    if not trace_span.enabled():
        pytest.skip("tracing force-disabled in this environment")
    _js, _jb, snap, batch, rep_idx = _encoded(*_staged_backlog())
    wave = TW.WaveScheduler(device="cpu", min_run=1, pipeline=True)
    ov0, pt0 = tp.overlap_totals(), tp.phase_totals()
    wave.schedule_backlog(snap, batch, rep_idx)
    ov1, pt1 = tp.overlap_totals(), tp.phase_totals()
    assert wave.dispatches["stage"] > 0
    assert pt1["encode"] - pt0["encode"] > 0
    assert ov1["probe"] - ov0["probe"] > 0


def test_multi_template_backlog_is_the_bench_backlog(monkeypatch):
    """scenarios.multi_template_backlog (chip_smoke.py's kernel-path
    profiles backlog) builds the JAX package's bench.py build_multi
    objects, and the port schedules them pipelined as the JAX package
    does, every run through the per-run probe, staging between them."""
    import bench

    state, pods = bench.build_multi(16, 96, templates=4, block=12)
    nodes, services, mpods = S.multi_template_backlog(JT, 16, 96,
                                                      templates=4, block=12)
    assert mpods == pods
    assert nodes == state.nodes()
    assert services == state.services
    monkeypatch.setenv(TW.ENV_PIPELINE, "1")
    pstate, ppods = port_state(state), to_port(pods)
    algo = TorchScheduleAlgorithm(device="cpu", min_run=4)
    got = algo.schedule_backlog(ppods, pstate)
    jax_algo = TPUScheduleAlgorithm(min_run=4)
    assert got == jax_algo.schedule_backlog(pods, state)
    assert got == GenericScheduler().schedule_backlog(ppods, pstate.clone())
    assert algo._wave.dispatches["probe"] == 8
    assert algo._wave.dispatches["stage"] == 7
    assert dispatch_shape(algo._wave.dispatches) == dispatch_shape(
        jax_algo._wave.dispatches)


def test_probe_dispatch_then_collect_equals_probe_fused():
    """The pipeline's split probe gives the serial probe's tables and the
    same folded carry: dispatch (fold + probe + the product's copy)
    followed by collect equals probe_fused, and probe on the folded
    carry."""
    from kubernetes_tpu_torch.models.batch import BatchScheduler

    _js, _jb, snap, batch, rep_idx = _encoded(*_staged_backlog())
    wave = TW.WaveScheduler(device="cpu", min_run=1)
    static, carry, nz, nv = wave._wave_setup(snap, frozenset(), "full", 0)
    pods = wave._packer.ship({f: np.asarray(getattr(batch, f))
                              for f in BatchScheduler.POD_FIELDS})
    prev = {f: t[0] for f, t in pods.items()}
    nxt = {f: t[1] for f, t in pods.items()}
    counts = np.zeros(snap.num_nodes, np.int64)
    counts[:3] = [2, 1, 1]
    kw = dict(has_selectors=True, zone_id=None)
    runs = []
    for split in (True, False):
        c = {k: v.clone() for k, v in carry.items()}
        if split:
            c, raw = wave.probe.probe_fused_dispatch(
                static, c, prev, counts, nxt, nz, nv, 128, wave._apply_fn)
            tables = wave.probe.probe_fused_collect(raw, nz, 128, 40, **kw)
        else:
            c, tables = wave.probe.probe_fused(
                static, c, prev, counts, nxt, nz, nv, 128, 40,
                wave._apply_fn, **kw)
        runs.append((c, tables))
    (c1, t1), (c2, t2) = runs
    for k in c1:
        assert torch.equal(c1[k], c2[k]), k
    t3 = wave.probe.probe(static, c1, nxt, nz, nv, 128, 40, **kw)
    for t in (t2, t3):
        assert np.array_equal(t1.tab, t.tab)
        assert np.array_equal(t1.res_fit, t.res_fit)
        assert np.array_equal(t1.fit_static, t.fit_static)
        assert np.array_equal(t1.static_add, t.static_add)
