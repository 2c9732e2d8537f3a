"""The zoned device replay: K3's plain version against the JAX scan and
the host spec replay, and the port's zreplay path against the JAX
driver and the oracle, on the CPU (the kernel itself is held against its
plain version on the card by tests/test_torch_on_card.py and
chip_smoke.py).

The pick loop's inputs are made from a numpy seed
(harness/scenarios.zreplay_case) and fed to three implementations:
ops/zreplay_kernel.replay_picks (the port's plain version on CPU
tensors), the JAX package's models/zreplay._replay_run (its probe
replaced by the same inputs) and the port's copy of the host spec replay
(models/replay.replay_spec, numpy, which rounds every float operation
once). Every output is an integer: exact equality.
"""

import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.api.types as JT
import kubernetes_tpu.models.zreplay as JZ
from kubernetes_tpu.models import batch as JB
from kubernetes_tpu.models.replay import replay_spec as jax_replay_spec
from kubernetes_tpu.oracle import ClusterState as JaxState
from kubernetes_tpu.scheduler.tpu_algorithm import TPUScheduleAlgorithm

import kubernetes_tpu_torch.api.types as TT
from kubernetes_tpu_torch.harness import scenarios as S
from kubernetes_tpu_torch.models import hosttab as TH
from kubernetes_tpu_torch.models.probe import RunTables
from kubernetes_tpu_torch.models.replay import replay_spec
from kubernetes_tpu_torch.oracle import ClusterState as PortState
from kubernetes_tpu_torch.oracle import GenericScheduler as PortOracle
from kubernetes_tpu_torch.ops import zreplay_kernel as ZK
from kubernetes_tpu_torch.scheduler.algorithm import TorchScheduleAlgorithm

from tests.test_torch_wave import dispatch_shape, run_all, spread_state


def _cpu_size(N, K, opts):
    """A case at a CPU-friendly size: N at most 512 (a ragged N stays
    ragged), K at most 1,024."""
    opts = dict(opts)
    n = min(N, 509 if N % 1024 else 512)
    k = min(K, 1024)
    if "k_real" in opts:
        opts["k_real"] = min(opts["k_real"], k - 1 if k < K else k)
    return n, k, opts


CASES = [(label,) + _cpu_size(N, K, opts)
         for label, N, K, opts in S.ZREPLAY_CASES]

_NAMES = (("w_lr", JB.LEAST_REQUESTED), ("w_ba", JB.BALANCED_ALLOCATION),
          ("w_spread", JB.SELECTOR_SPREAD), ("w_na", JB.NODE_AFFINITY),
          ("w_tt", JB.TAINT_TOLERATION), ("w_ip", JB.INTER_POD_AFFINITY))


def _vetoed(case):
    fr = case["nodes"]["frontier"]
    return np.where(case["veto"], np.minimum(fr, 1), fr)


def _port(case):
    nodes = {k: torch.from_numpy(v.copy()) for k, v in case["nodes"].items()}
    nodes["frontier"] = torch.from_numpy(_vetoed(case))
    sc = case["scalars"]
    scalars = torch.tensor([sc["nz_mcpu"], sc["nz_mem"], sc["selfmatch"],
                            sc["L0"], 1])
    chosen, j, state = ZK.replay_picks(
        nodes, scalars, case["weights"], K=case["K"], k_real=case["k_real"],
        rows_dyn=case["rows_dyn"], num_zones=case["num_zones"],
        has_selectors=case["has_selectors"])
    L, n_done, bailed = state.tolist()
    return chosen.numpy(), j.numpy(), L, n_done, bailed


def _jax(case, monkeypatch):
    """The JAX package's _replay_run, its probe replaced by the case's
    rows (node order == permuted order: the identity permutation)."""
    nd, sc = case["nodes"], case["scalars"]
    N = len(nd["frontier"])
    zero = np.zeros(N, np.int64)
    stk = jnp.asarray(np.stack([
        nd["fit_static"].astype(np.int64), nd["frontier"], nd["static_add"],
        nd["spread_base"], np.full(N, sc["selfmatch"]), nd["na_counts"],
        nd["tt_counts"], nd["ip_totals"], zero, zero, zero]))
    monkeypatch.setattr(JZ, "_probe_rows", lambda *a: (stk, None))
    config = JB.SchedulerConfig(priorities=tuple(
        (name, case["weights"][w]) for w, name in _NAMES
        if case["weights"][w]))
    static = {"name_desc_order": jnp.arange(N, dtype=jnp.int32),
              "alloc_mcpu": jnp.asarray(nd["alloc_cpu"]),
              "alloc_mem": jnp.asarray(nd["alloc_mem"])}
    res = jnp.asarray(np.stack([zero, zero, zero, nd["nz_cpu0"],
                                nd["nz_mem0"], zero]))
    pod = {"nz_mcpu": jnp.int64(sc["nz_mcpu"]),
           "nz_mem": jnp.int64(sc["nz_mem"])}
    j, chosen, L, n_done, stopped = JZ._replay_run(
        config, case["num_zones"], 0, 1, case["K"], static, (res,), pod,
        jnp.asarray(nd["zone_id"]), jnp.asarray(case["veto"]),
        jnp.bool_(case["has_selectors"]), jnp.int64(case["rows_dyn"]),
        jnp.int32(case["k_real"]), sc["L0"], jnp.bool_(True))
    return (np.asarray(chosen), np.asarray(j), int(L), int(n_done),
            int(bool(stopped)))


def _spec(case):
    """The host spec replay on RunTables built from the case."""
    nd, sc, w = case["nodes"], case["scalars"], case["weights"]
    rows = case["rows_dyn"]
    jj = np.arange(rows, dtype=np.int64)[:, None]
    args = (sc["nz_mcpu"], sc["nz_mem"], nd["nz_cpu0"] + jj * sc["nz_mcpu"],
            nd["nz_mem0"] + jj * sc["nz_mem"], nd["alloc_cpu"],
            nd["alloc_mem"])
    tab = (w["w_lr"] * TH.least_requested(*args)
           + w["w_ba"] * TH.balanced_resource_allocation(*args))
    zoned = w["w_spread"] and np.any(nd["zone_id"] > 0)
    t = RunTables(
        fit_static=nd["fit_static"].astype(bool),
        res_fit=jj < _vetoed(case)[None, :],
        tab=tab.astype(np.int64),
        static_add=nd["static_add"],
        w_spread=w["w_spread"],
        spread_base=nd["spread_base"] if w["w_spread"] else None,
        spread_selfmatch=bool(sc["selfmatch"]),
        has_selectors=case["has_selectors"],
        w_na=w["w_na"], na_counts=nd["na_counts"] if w["w_na"] else None,
        w_tt=w["w_tt"], tt_counts=nd["tt_counts"] if w["w_tt"] else None,
        w_ip=w["w_ip"], ip_totals=nd["ip_totals"] if w["w_ip"] else None,
        zone_id=nd["zone_id"] if zoned else None,
        num_zones=case["num_zones"],
    )
    r = replay_spec(t, case["k_real"], sc["L0"])
    return r.chosen, r.counts, r.last_node_index, r.n_done


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_spec_and_jax_scan(case, monkeypatch):
    """Exactly the host spec replay; exactly the JAX scan (which agrees
    with the spec on every case: no disagreement cell has been seen)."""
    label, N, K, opts = case
    c = S.zreplay_case(N, 7, K=K, **opts)
    launches = ZK.LAUNCHES
    chosen, j, L, n_done, bailed = _port(c)
    assert ZK.LAUNCHES == launches  # CPU tensors take the plain version
    s_chosen, s_j, s_L, s_n = _spec(c)
    assert n_done == s_n and L == s_L, label
    assert np.array_equal(chosen[:n_done], s_chosen), label
    assert (chosen[n_done:] == -1).all(), label
    assert np.array_equal(j, s_j), label
    assert bailed == int(n_done < c["k_real"]), label
    jx = _jax(c, monkeypatch)
    assert np.array_equal(jx[0], chosen), label
    assert np.array_equal(jx[1], j), label
    assert jx[2:] == (L, n_done, bailed), label


def _case(label):
    return next(c for c in CASES if c[0] == label)


def test_edge_cases_reach_their_inputs():
    """Each edge case drives what it is named for."""
    def run(label, seed=7):
        _, N, K, opts = _case(label)
        c = S.zreplay_case(N, seed, K=K, **opts)
        return c, _port(c)

    c, (chosen, j, L, n_done, bailed) = run("edge bail at rows_dyn")
    assert bailed and n_done < c["k_real"] and j.max() == c["rows_dyn"]
    c, (chosen, j, L, n_done, bailed) = run("edge steps with no fit")
    assert not bailed and (chosen[:c["k_real"]] == -1).any()
    c, (chosen, *_rest) = run("edge k_real < K_bucket")
    assert c["k_real"] < c["K"] and (chosen[c["k_real"]:] == -1).all()
    c, (chosen, j, *_rest) = run("edge veto")
    assert (j[c["veto"]] <= 1).all() and j[c["veto"]].any()
    # max_zone == 0: every zoned node scores INT64_MIN, so the unzoned
    # nodes take the picks while they fit
    c, (chosen, *_rest) = run("edge max_zone == 0 (NaN)")
    zone = c["nodes"]["zone_id"]
    assert (zone[chosen[:10]] == 0).all()
    c = S.zreplay_case(64, 1, **_case("edge TaintToleration mx=20 c=18")[3])
    assert set(np.unique(c["nodes"]["tt_counts"])) == {18, 20}
    assert any(N % 1024 for _, N, _, _ in S.ZREPLAY_CASES)


def test_wrapper_has_no_fallback():
    """A device other than the CPU never reaches the plain version: the
    wrapper raises, and it has no try/except that could swallow a failed
    launch or build."""
    meta = torch.empty((), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        ZK.replay_picks({}, meta, {}, K=1, k_real=1, rows_dyn=1,
                        num_zones=1, has_selectors=True)
    tree = ast.parse(inspect.getsource(ZK))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


def test_aborted_run_schedules_nothing():
    c = S.zreplay_case(64, 3, K=32)
    nodes = {k: torch.from_numpy(v) for k, v in c["nodes"].items()}
    scalars = torch.tensor([100, 500 * 2**20, 1, 17, 0])
    chosen, j, state = ZK.replay_picks(
        nodes, scalars, c["weights"], K=32, k_real=20, rows_dyn=5,
        num_zones=4, has_selectors=True)
    assert (chosen == -1).all() and (j == 0).all()
    assert state.tolist() == [17, 20, 0]


# -- the driver: zoned runs through the device replay -------------------------


def test_zoned_device_replay_equals_host_spec():
    """tests/test_wave.py test_wave_zoned_device_replay_equals_host_spec:
    the device replay and the host spec replay (the replay= seam) agree
    with each other, the JAX driver and the oracle, including a
    capacity-exhausted tail and an unzoned-node mix."""
    def build(T, CS):
        nodes = S.zoned_density_nodes(T, 14, zones=("a", "b"),
                                      unzoned_every=4, pods_cap="7")
        return spread_state(T, CS, nodes), S.pause_pods(T, 120)

    got = run_all(build)
    assert got.count(None) == 120 - 98
    state, pods = build(TT, PortState)
    host = TorchScheduleAlgorithm(device="cpu", replay=replay_spec)
    assert host.schedule_backlog(pods, state) == got
    assert "zreplay" not in host._wave.dispatches
    assert "zreplay_group" not in host._wave.dispatches
    jstate, jpods = build(JT, JaxState)
    jhost = TPUScheduleAlgorithm(replay=jax_replay_spec)
    jhost.schedule_backlog(jpods, jstate)
    assert dispatch_shape(host._wave.dispatches) == dispatch_shape(
        jhost._wave.dispatches)


def _tainted(T, CS):
    """tests/test_wave.py test_wave_zoned_tainted_device_replay_matches_
    host: escalating PreferNoSchedule taint counts on a zoned cluster, so
    TaintToleration's float64 normalizer is live at every pick."""
    import json

    nodes = S.zoned_density_nodes(T, 8, zones=("a", "b"), pods_cap="40")
    for i, node in enumerate(nodes):
        node.metadata.annotations = {T.TAINTS_ANNOTATION: json.dumps([
            {"key": f"t{k}", "value": "v", "effect": "PreferNoSchedule"}
            for k in range(13 + i)])}
    pods = S.pause_pods(T, 90)
    for p in pods:
        p.spec.tolerations = [T.Toleration(key="t0", operator="Equal",
                                           value="v",
                                           effect="PreferNoSchedule")]
    return spread_state(T, CS, nodes), pods


def test_zoned_tainted_device_replay_matches_host():
    got = run_all(_tainted, min_run=16)
    state, pods = _tainted(TT, PortState)
    host = TorchScheduleAlgorithm(device="cpu", replay=replay_spec)
    assert host.schedule_backlog(pods, state) == got
    assert got == PortOracle().schedule_backlog(pods, state.clone())


def test_replay_seam_keeps_zoned_runs_on_the_host():
    """WaveScheduler(replay=...) takes no zreplay dispatch and decides as
    the default (device) driver does."""
    def build(T, CS):
        return (spread_state(T, CS, S.zoned_density_nodes(T, 9)),
                S.template_pods(T, 3, 20))

    dev = TorchScheduleAlgorithm(device="cpu", min_run=1)
    host = TorchScheduleAlgorithm(device="cpu", min_run=1,
                                  replay=replay_spec)
    state, pods = build(TT, PortState)
    got = dev.schedule_backlog(pods, state.clone())
    assert host.schedule_backlog(pods, state.clone()) == got
    assert dev._wave.dispatches.get("zreplay_group", 0) == 1
    assert not {"zreplay", "zreplay_group"} & set(host._wave.dispatches)
    assert got == PortOracle().schedule_backlog(pods, state.clone())
