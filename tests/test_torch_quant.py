"""Quantized table placement and the bf16 profile of the port
(parallel/quant, the wave driver's narrowed resident tables, the shadow
gate of TorchScheduleAlgorithm) against the JAX package's, on the CPU.

The counterparts of tests/test_kernel.py's quant units, placement,
decision fuzz and ShadowGate tests. Every identity is exact: narrowing
is lossless, and the bf16 profile is shadow-checked to full width.
"""

import random
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.models.wave import WaveScheduler as JaxWave
from kubernetes_tpu.parallel import quant as JQ
from kubernetes_tpu.scheduler.tpu_algorithm import TPUScheduleAlgorithm

from kubernetes_tpu_torch.models.wave import WaveScheduler
from kubernetes_tpu_torch.oracle import GenericScheduler
from kubernetes_tpu_torch.ops import priorities as TR
from kubernetes_tpu_torch.ops import volumes as TV
from kubernetes_tpu_torch.parallel import quant as Q
from kubernetes_tpu_torch.scheduler.algorithm import TorchScheduleAlgorithm

from kubernetes_tpu.ops import volumes as JV
from tests.test_conformance import random_scenario
from tests.test_kernel import _staged_backlog
from tests.test_torch_ops import port_state, to_port

# -- parallel/quant units -------------------------------------------------------


@pytest.mark.parametrize("raw", ["", "1", "on", "int", "default", " INT ",
                                 "0", "off", "wide", "none", "bf16",
                                 "bfloat16", None])
def test_mode_reads_the_env_as_the_jax_package_does(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv(Q.ENV, raising=False)
    else:
        monkeypatch.setenv(Q.ENV, raw)
    m = Q.mode()
    assert m == JQ.mode()
    assert Q.narrow_enabled() == JQ.narrow_enabled()
    assert Q.score_mode() == JQ.score_mode()
    assert m == {"": "int", None: "int", "0": "off", "off": "off",
                 "wide": "off", "none": "off", "bf16": "bf16",
                 "bfloat16": "bf16"}.get(raw, "int")


def test_mode_rejects_an_unknown_profile(monkeypatch):
    monkeypatch.setenv(Q.ENV, "fp8")
    with pytest.raises(ValueError):
        Q.mode()


def test_narrow_dtype_boundaries():
    def dt(vals, dtype=np.int32, name="zone_id"):
        a = np.asarray(vals, dtype)
        got = Q.narrow_dtype(name, a)
        assert got == JQ.narrow_dtype(name, a)
        return got

    assert dt([0, 127]) == np.int8
    assert dt([0, 128]) == np.int16
    assert dt([-128, 0]) == np.int8
    assert dt([-129, 0]) == np.int16
    assert dt([0, 32767]) == np.int16
    # past int16: keep the original width (no int32 "narrowing" step)
    assert dt([0, 32768]) == np.int32
    assert dt([0, 32768], np.int64) == np.int64
    # empty tables place at the narrowest width and rebuild on growth
    assert dt([]) == np.int8


def test_narrow_dtype_scope():
    big = np.arange(4, dtype=np.int64)
    assert Q.narrow_dtype("alloc_cpu", big) == np.int64
    assert Q.narrow_dtype("label_kv", np.zeros(4, np.uint32)) == np.uint32
    assert Q.narrow_dtype("zone_id", np.zeros(4, np.float32)) == np.float32
    assert Q.narrow_dtype("zone_id", np.zeros(4, np.int16)) == np.int16
    assert Q.NARROWABLE == JQ.NARROWABLE
    for name in Q.NARROWABLE:
        a = np.arange(-3, 90, dtype=np.int32)
        assert Q.narrow(name, a).dtype == np.int8
        assert Q.narrow(name, a, "off") is a


def test_narrow_eq_out_of_range_guard():
    table = np.array([1, 2, 3, 127, -128, 44], np.int8)
    t = torch.from_numpy(table)
    for v in (3, 127, -128, 44, 300, -300, 128, -129, 0):
        got = Q.narrow_eq(t, torch.tensor(v, dtype=torch.int64))
        want = np.asarray(JQ.narrow_eq(jnp.asarray(table), jnp.asarray(v)))
        assert got.numpy().tolist() == want.tolist() == \
            (table.astype(np.int64) == v).tolist(), v
    # an out-of-vocab wide comparand never aliases into the narrow range
    # (300 % 256 = 44 is a valid int8)
    assert not Q.narrow_eq(t, torch.tensor(300)).any()
    # a same-dtype comparand is a plain compare
    wide = torch.tensor([5, 6], dtype=torch.int64)
    assert Q.narrow_eq(wide, torch.tensor(6)).tolist() == [False, True]


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int64])
def test_narrow_matvec_matches_wide(dtype):
    rng = np.random.default_rng(7)
    table = rng.integers(0, 100, (32, 8)).astype(dtype)
    vec = rng.integers(0, 2, 8).astype(np.int32)  # 0/1 indicator
    got = Q.narrow_matvec(torch.from_numpy(table), torch.from_numpy(vec),
                          torch.int64)
    want = table.astype(np.int64) @ vec
    # the JAX contraction accumulates at least as wide as its table
    ref = np.asarray(JQ.narrow_matvec(
        jnp.asarray(table), jnp.asarray(vec),
        np.int64 if dtype == np.int64 else np.int32))
    assert got.dtype == torch.int64
    assert got.numpy().tolist() == want.tolist() == ref.tolist()


def test_shadow_gate_stride_and_fallback():
    ports, jaxes = Q.ShadowGate(stride=4), JQ.ShadowGate(stride=4)
    checks = [(g.should_check(), h.should_check())
              for g, h in [(ports, jaxes)] * 9]
    assert [c for c, _ in checks] == [c for _, c in checks] == [
        True, False, False, False, True, False, False, False, True]
    for g in (ports, jaxes):
        g.record(True)
        assert not g.fallen_back and g.divergence == 0
        g.record(False)
        assert g.fallen_back and g.divergence == 1
        assert not g.should_check()
    assert ports.stats() == jaxes.stats()
    assert Q.ShadowGate(stride=0).should_check() is False


def test_shadow_gate_stride_from_env(monkeypatch):
    monkeypatch.setenv(Q.SHADOW_ENV, "3")
    assert Q.ShadowGate().stride == JQ.ShadowGate().stride == 3
    monkeypatch.delenv(Q.SHADOW_ENV)
    assert Q.ShadowGate().stride == JQ.ShadowGate().stride == 16


# -- the ops on narrowed tables --------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_ops_on_narrowed_tables_equal_the_wide_ones(seed):
    """volume_zone, the taint counts and selector_spread on an int8 and
    an int16 placement equal the int64 placement and the JAX package's
    narrowed volume_zone, out-of-vocab pod values included."""
    rng = np.random.default_rng(seed)
    N, Z = 64, 5
    zone = rng.integers(0, Z, N).astype(np.int32)
    region = rng.integers(-1, 3, N).astype(np.int32)
    has = rng.random(N) < 0.8
    taints = rng.integers(0, 4, (N, 3)).astype(np.int32)
    prefer = rng.integers(0, 2, 3).astype(np.int64)
    cls = rng.integers(0, 6, (N, 4)).astype(np.int64)
    match = rng.integers(0, 2, 4).astype(np.int64)
    fit = torch.from_numpy(rng.random(N) < 0.7)
    wide = {k: torch.from_numpy(v.astype(np.int64))
            for k, v in (("zone", zone), ("region", region),
                         ("taints", taints))}
    for dt in (torch.int8, torch.int16):
        narrow = {k: v.to(dt) for k, v in wide.items()}
        for pz, pr in ((2, -1), (300, 1), (-300, 0), (4, 2), (-1, -1)):
            args = (torch.tensor(pz), torch.tensor(pr), torch.tensor(False))
            got = TV.volume_zone(*args, narrow["zone"], narrow["region"],
                                 torch.from_numpy(has))
            want = TV.volume_zone(*args, wide["zone"], wide["region"],
                                  torch.from_numpy(has))
            ref = JV.volume_zone(jnp.int64(pz), jnp.int64(pr), False,
                                 jnp.asarray(zone.astype(np.int8)),
                                 jnp.asarray(region.astype(np.int8)),
                                 jnp.asarray(has))
            assert got.tolist() == want.tolist() == np.asarray(ref).tolist()
        assert TR.taint_intolerable_counts(
            narrow["taints"], torch.from_numpy(prefer)).tolist() == \
            (taints.astype(np.int64) @ prefer).tolist()
        for sel in (True, False):
            args = (torch.tensor(sel), torch.from_numpy(match),
                    torch.from_numpy(cls))
            got = TR.selector_spread(*args, narrow["zone"], Z, fit)
            want = TR.selector_spread(*args, wide["zone"], Z, fit)
            assert got.tolist() == want.tolist()


# -- quantized placement: device dtype + boundary rebuild -----------------------


def test_to_dev_many_narrow_placement_and_boundary_rebuild():
    """The JAX test's steps on both drivers: equal ship counts, and the
    port's placement dtypes int8 -> int16 -> int64 (an int32 table the
    port widens) where the JAX driver's are int8 -> int16 -> int32; the
    mirror keeps full width."""
    ws = WaveScheduler(device="cpu", quant_mode="int")
    js = JaxWave(quant_mode="int")
    zid = (np.arange(24) % 3).astype(np.int32)
    snap = types.SimpleNamespace(zone_id=zid)

    def step(want_port, want_jax):
        got = ws._to_dev_many(snap, ["zone_id"], keep=frozenset())
        ref = js._to_dev_many(snap, ["zone_id"], keep=frozenset())
        assert got["zone_id"].dtype == want_port
        assert ref["zone_id"].dtype == want_jax
        assert got["zone_id"].tolist() == snap.zone_id.tolist()
        for k in ("table_ships", "table_reuses", "table_scatters"):
            assert ws.stats[k] == js.stats[k], k

    step(torch.int8, np.int8)
    assert ws._dev["zone_id"][3].dtype == np.int32  # mirror full width
    ships0 = ws.stats["table_ships"]
    step(torch.int8, np.int8)  # unchanged content: reuse, no bytes
    assert ws.stats["table_ships"] == ships0
    assert ws.stats["table_bytes_reused"] > 0
    # vocab growth past int8: the placement dtype is part of the cache
    # check, so the first sync after an out-of-range value rebuilds wider
    snap.zone_id = zid.copy()
    snap.zone_id[5] = 200
    step(torch.int16, np.int16)
    assert ws.stats["table_ships"] == ships0 + 1
    snap.zone_id = zid.copy()
    snap.zone_id[5] = 40000
    step(torch.int64, np.int32)
    # a single changed row inside the narrow range is a row update at the
    # placement dtype
    snap.zone_id = zid.copy()
    step(torch.int8, np.int8)
    snap.zone_id = zid.copy()
    snap.zone_id[7] = 100
    step(torch.int8, np.int8)
    assert ws.stats["table_scatters"] == 1


def test_to_dev_many_wide_mode_off():
    ws = WaveScheduler(device="cpu", quant_mode="off")
    snap = types.SimpleNamespace(zone_id=(np.arange(8) % 3)
                                 .astype(np.int32))
    out = ws._to_dev_many(snap, ["zone_id"], keep=frozenset())
    assert out["zone_id"].dtype == torch.int64


def test_default_mode_places_narrow_tables(monkeypatch):
    """KUBERNETES_TPU_QUANT unset: the port narrows, as the JAX package
    does, and the cold wave's table bytes shrink against quant off."""
    monkeypatch.delenv(Q.ENV, raising=False)
    state, pods = _staged_backlog(num_nodes=12, num_pods=40)
    pstate, ppods = port_state(state), to_port(pods)
    bytes_by_mode = {}
    for m in ("default", "off"):
        if m == "off":
            monkeypatch.setenv(Q.ENV, "off")
        algo = TorchScheduleAlgorithm(device="cpu", min_run=4)
        algo.schedule_backlog(ppods, pstate.clone())
        dev = algo._wave._dev
        narrow = m == "default"
        assert (dev["zone_id"][2].dtype == torch.int8) is narrow
        assert (dev["taint_count"][2].dtype == torch.int8) is narrow
        bytes_by_mode[m] = algo._wave.stats["table_bytes_total"]
    assert bytes_by_mode["default"] < bytes_by_mode["off"]


# -- end-to-end decision identity -----------------------------------------------


@pytest.mark.parametrize("seed", [11, 23])
def test_quant_decision_identity_fuzz(monkeypatch, seed):
    """Port int == port off == JAX int == the oracle (the port's copy)."""
    rng = random.Random(seed)
    state, pending = random_scenario(
        rng, n_nodes=10, n_existing=12, n_pending=30,
        interpod_p=0.2, volumes_p=0.3)
    pstate, ppending = port_state(state), to_port(pending)
    want = GenericScheduler().schedule_backlog(ppending, pstate.clone())
    got = {}
    for m in ("int", "off"):
        monkeypatch.setenv(Q.ENV, m)
        got[m] = TorchScheduleAlgorithm(device="cpu").schedule_backlog(
            ppending, pstate.clone())
    monkeypatch.setenv(Q.ENV, "int")
    jax_int = TPUScheduleAlgorithm().schedule_backlog(pending,
                                                      state.clone())
    assert got["int"] == got["off"] == jax_int == want


# -- the bf16 profile's shadow gate ---------------------------------------------


def test_bf16_profile_builds_shadow_and_matches(monkeypatch):
    monkeypatch.setenv(Q.ENV, "bf16")
    monkeypatch.setenv(Q.SHADOW_ENV, "1")
    state, pods = _staged_backlog(num_nodes=10, num_pods=60,
                                  templates=2, block=10)
    pstate, ppods = port_state(state), to_port(pods)
    algo = TorchScheduleAlgorithm(device="cpu")
    assert algo._shadow_gate is not None
    assert algo._wave.probe.score_mode == "bf16"
    assert algo._shadow_wave._quant_mode == "off"
    assert algo._shadow_wave.probe.score_mode == "i64"
    got = algo.schedule_backlog(ppods, pstate.clone())
    assert algo._shadow_gate.checked >= 1
    assert algo._shadow_gate.divergence == 0
    jax_algo = TPUScheduleAlgorithm()
    jax_got = jax_algo.schedule_backlog(pods, state.clone())
    assert algo._shadow_gate.stats() == jax_algo._shadow_gate.stats()
    monkeypatch.setenv(Q.ENV, "off")
    wide = TorchScheduleAlgorithm(device="cpu").schedule_backlog(
        ppods, pstate.clone())
    assert TorchScheduleAlgorithm(device="cpu")._shadow_gate is None
    assert got == wide == jax_got
    assert got == GenericScheduler().schedule_backlog(ppods, pstate.clone())


def test_bf16_shadow_divergence_falls_back(monkeypatch):
    from kubernetes_tpu_torch.metrics import (
        scheduler_quant_shadow_divergence_total,
    )

    monkeypatch.setenv(Q.ENV, "bf16")
    monkeypatch.setenv(Q.SHADOW_ENV, "1")
    state, pods = _staged_backlog(num_nodes=8, num_pods=40,
                                  templates=2, block=10)
    pstate, ppods = port_state(state), to_port(pods)
    algo = TorchScheduleAlgorithm(device="cpu")
    shadow = algo._shadow_wave
    real_fn = shadow.schedule_backlog

    def lying_shadow(*a, **kw):
        chosen, carry, last = real_fn(*a, **kw)
        bad = np.asarray(chosen).copy()
        bad[0] = -1 if bad[0] != -1 else 0
        return bad, carry, last

    shadow.schedule_backlog = lying_shadow
    before = scheduler_quant_shadow_divergence_total.get()
    got = algo.schedule_backlog(ppods, pstate.clone())
    assert scheduler_quant_shadow_divergence_total.get() == before + 1
    assert algo._shadow_gate.fallen_back
    # the shadow's picks were taken: its lie shows in the result
    assert got[0] is None
    # after the trip the full-width shadow IS the driver; without the lie
    # the next backlog schedules as full width does, and no wave samples
    shadow.schedule_backlog = real_fn
    checked = algo._shadow_gate.checked
    got = algo.schedule_backlog(ppods, pstate.clone())
    assert algo._shadow_gate.checked == checked
    # a full-width algorithm's second wave (the lie changed no counter)
    monkeypatch.setenv(Q.ENV, "off")
    wide = TorchScheduleAlgorithm(device="cpu")
    wide.schedule_backlog(ppods, pstate.clone())
    assert got == wide.schedule_backlog(ppods, pstate.clone())
