"""The probe kernel's plain version and the port's probe against the JAX
package's, on the CPU (the kernel itself is held against its plain
version on the card by tests/test_torch_on_card.py and chip_smoke.py).

The JAX references run as the JAX package's own tests run them on the
CPU: the Pallas kernel in interpret mode (tests/test_kernel.py) and the
lax build of models/probe._probe_rows. Every output is an integer/bool
table: exact equality.
"""

import ast
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.models import batch as JB
from kubernetes_tpu.models import hosttab as JH
from kubernetes_tpu.models import probe as JP
from kubernetes_tpu.ops import pallas_probe as JPL
from kubernetes_tpu.ops import predicates as JPR
from kubernetes_tpu.ops import priorities as JR

from kubernetes_tpu_torch.harness import scenarios as S
from kubernetes_tpu_torch.models import batch as TB
from kubernetes_tpu_torch.models import probe as TP
from kubernetes_tpu_torch.ops import probe_kernel as PK
from kubernetes_tpu_torch.snapshot.carry import to_device

from tests.test_torch_ops import CPU, assert_same, encode, scenario

TERMS = (("lr", 1), ("ba", 1))
# every kernel case, at a CPU-friendly node count
CASES = [(label, J, min(N, 256), opts) for label, J, N, opts in S.PROBE_CASES]


def _lax_probe(J, alloc, usage, pod, wants_res):
    """The resource section of the JAX probe's lax build (models/probe
    _probe_rows with kernel="lax")."""
    a_cpu, a_mem, a_gpu, a_pods = alloc
    u_cpu, u_mem, u_gpu, u_nzc, u_nzm, u_cnt = usage
    j = jnp.arange(J, dtype=jnp.int64)[:, None]
    if wants_res:
        res_fit = JPR.pod_fits_resources(
            pod["req_mcpu"], pod["req_mem"], pod["req_gpu"],
            pod["zero_req"] != 0, a_cpu, a_mem, a_gpu, a_pods,
            u_cpu[None, :] + j * pod["commit_mcpu"],
            u_mem[None, :] + j * pod["commit_mem"],
            u_gpu[None, :] + j * pod["commit_gpu"], u_cnt[None, :] + j)
    else:
        res_fit = jnp.ones((J, a_cpu.shape[0]), bool)
    nzj_c = u_nzc[None, :] + j * pod["nz_mcpu"]
    nzj_m = u_nzm[None, :] + j * pod["nz_mem"]
    tab = jnp.zeros(res_fit.shape, jnp.int64)
    for fn in (JR.least_requested, JR.balanced_resource_allocation):
        tab = tab + fn(pod["nz_mcpu"], pod["nz_mem"], nzj_c, nzj_m,
                       a_cpu, a_mem)
    return res_fit.sum(0, dtype=jnp.int64), tab


def _mirror_probe(J, alloc, usage, pod, wants_res):
    """The same sweep in the JAX package's numpy mirror
    (models/hosttab), which rounds 10 - 10*|diff| twice, as the oracle
    does."""
    j = np.arange(J, dtype=np.int64)[:, None]
    names = ("alloc_mcpu", "alloc_mem", "alloc_gpu", "alloc_pods")
    if wants_res:
        fit = JH.pod_fits_resources(pod, dict(zip(names, alloc)),
                                    np.stack(usage), j)
    else:
        fit = np.ones((J, alloc[0].shape[0]), bool)
    nzj_c = usage[3][None, :] + j * pod["nz_mcpu"]
    nzj_m = usage[4][None, :] + j * pod["nz_mem"]
    tab = sum(fn(pod["nz_mcpu"], pod["nz_mem"], nzj_c, nzj_m, alloc[0],
                 alloc[1])
              for fn in (JH.least_requested,
                         JH.balanced_resource_allocation))
    return fit.sum(0, dtype=np.int64), tab


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_pallas_and_lax(case):
    """Exactly the lax build and the numpy mirror. Exactly the Pallas
    build in interpret mode wherever that build agrees with the mirror:
    XLA:CPU can contract BalancedAllocation's 10 - diff*10 into a fused
    multiply-add inside it (ROADMAP queue 3; seen on the LR quotient
    bounds case), and there the Pallas build is one below the mirror."""
    label, J, N, opts = case
    opts = dict(opts)
    wants_res = opts.pop("wants_res", True)
    alloc, usage, pod = S.probe_case(N, 1, **opts)
    jalloc = tuple(jnp.asarray(a) for a in alloc)
    jusage = tuple(jnp.asarray(a) for a in usage)
    jpod = {k: jnp.int64(v) for k, v in pod.items()}
    fr_pl, tab_pl = JPL.resource_probe(J, jalloc, jusage, jpod, TERMS,
                                       wants_res=wants_res)
    fr_lax, tab_lax = _lax_probe(J, jalloc, jusage, jpod, wants_res)
    fr_mir, tab_mir = _mirror_probe(J, alloc, usage, pod, wants_res)
    launches = PK.LAUNCHES
    fr, tab = PK.resource_probe(
        J, tuple(torch.from_numpy(a) for a in alloc),
        tuple(torch.from_numpy(a) for a in usage),
        {k: torch.tensor(v) for k, v in pod.items()}, TERMS,
        wants_res=wants_res)
    assert PK.LAUNCHES == launches  # CPU tensors take the plain version
    for want_fr, want_tab in ((fr_lax, tab_lax), (fr_mir, tab_mir)):
        assert_same(want_fr, fr, label + " frontier")
        assert_same(want_tab, tab, label + " tab")
    assert_same(fr_pl, fr, label + " Pallas frontier")
    tab_pl = np.asarray(tab_pl)
    agree = tab_pl == tab_mir
    assert np.array_equal(tab_pl[agree], tab.numpy()[agree]), label
    assert (tab_pl[~agree] == tab_mir[~agree] - 1).all(), label


def _case(label):
    opts = dict(next(c[3] for c in S.PROBE_CASES if c[0] == label))
    opts.pop("wants_res", None)
    return opts


def test_lr_bound_case_hits_every_quotient_boundary():
    """For every cap and k in 0..10, cpu and mem each reach a depth where
    (cap - total)*10 == k*cap and one where it is k*cap - 10 (the next
    multiple of 10 below); some totals pass their cap."""
    alloc, usage, pod = S.probe_case(256, 1, **_case("edge LR quotient bounds"))
    j = np.arange(16)[:, None]
    for cap, nz, step in ((alloc[0], usage[3], pod["nz_mcpu"]),
                          (alloc[1], usage[4], pod["nz_mem"])):
        total = nz[None, :] + (j + 1) * step
        num = (cap[None, :] - total) * 10
        assert (total > cap).any() and (total >= 0).all()
        for m in S.LR_BOUND_TENTHS:
            mine = num[:, cap == 10 * m]
            for k in range(11):
                assert (mine == k * 10 * m).any(), (m, k)
                assert (mine == k * 10 * m - 10).any(), (m, k)


def test_edge_cases_reach_their_inputs():
    J = 128
    alloc, usage, pod = S.probe_case(256, 1, **_case("edge zero commit"))
    fr, _ = PK.resource_probe(
        J, tuple(torch.from_numpy(a) for a in alloc),
        tuple(torch.from_numpy(a) for a in usage),
        {k: torch.tensor(v) for k, v in pod.items()}, TERMS)
    assert set(fr.tolist()) == {0, J}
    alloc, _, _ = S.probe_case(256, 1, **_case("edge mem 2^40"))
    assert alloc[1].min() >= 2**40
    alloc, _, _ = S.probe_case(256, 1, **_case("edge cap > 2^59"))
    assert (alloc[0] > 2**59).any() and (alloc[1] > 2**59).any()
    assert any(N % 32 for _, _, N, _ in S.PROBE_CASES)
    assert {16, 200} <= {J for _, J, _, _ in S.PROBE_CASES}


def test_term_weights_sum_per_kind():
    assert PK.term_weights((("lr", 2), ("ba", 1), ("lr", 3))) == (5, 1)
    assert PK.term_weights(()) == (0, 0)


def test_wrapper_has_no_fallback():
    """A device other than the CPU never reaches the plain version: the
    wrapper raises, and it has no try/except that could swallow a failed
    launch or build."""
    meta = torch.empty(8, dtype=torch.int64, device="meta")
    pod = {k: torch.empty((), dtype=torch.int64, device="meta")
           for k in PK.POD_SCALARS}
    with pytest.raises(ValueError):
        PK.resource_probe(16, (meta,) * 4, (meta,) * 6, pod, TERMS)
    tree = ast.parse(inspect.getsource(PK))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


def _jax_probe_inputs(snap, batch, i, config):
    static = {f: jnp.asarray(getattr(snap, f))
              for f in JB.BatchScheduler.STATIC_FIELDS}
    carry = JB.BatchScheduler(config).initial_carry(snap)
    pod = {f: jnp.asarray(np.asarray(getattr(batch, f))[i])
           for f in JB.BatchScheduler.POD_FIELDS}
    return static, carry, pod


@pytest.mark.parametrize("seed", range(3))
def test_probe_rows_match_pallas_build(seed):
    """The port's probe against the JAX probe built with kernel="pallas":
    all 11 header rows exactly; the j-table exactly against the JAX
    package's numpy mirror of it (models/hosttab.resource_tables, which
    rounds 10 - 10*|diff| twice, as the oracle does) and against the
    Pallas build wherever that build agrees with the mirror. On the CPU
    backend XLA may contract the BalancedAllocation multiply-subtract of
    the Pallas build into a fused multiply-add (seen at cpu fraction 0.8,
    mem fraction 0: 1 where the oracle gives 2); the port rounds twice.
    Finally the packed product unpacks to the same tables."""
    state, pending = scenario(200 + seed, interpod_p=0.3, volumes_p=0.0)
    snap, batch, psnap, pbatch = encode(state, pending)
    config = JB.SchedulerConfig()
    nz = max(int(snap.zone_id.max()) + 1, 1)
    J = 16
    sched = TB.BatchScheduler(device="cpu")
    static = sched.place_static(psnap)
    carry = sched.initial_carry(psnap)
    pods = to_device(pbatch, CPU, TB.BatchScheduler.POD_FIELDS)
    rows_fn = jax.jit(functools.partial(JP._probe_rows, config, nz, 0, J,
                                        kernel="pallas"))
    alloc = {f: np.asarray(getattr(snap, f)).astype(np.int64)
             for f in ("alloc_mcpu", "alloc_mem", "alloc_gpu", "alloc_pods")}
    usage = np.stack([np.asarray(getattr(snap, f)) for f in JH.RES_ROWS])
    for i in range(batch.num_pods):
        jstatic, jcarry, jpod = _jax_probe_inputs(snap, batch, i, config)
        stk_j, tab_j = rows_fn(jstatic, jcarry, jpod)
        pod = {f: t[i] for f, t in pods.items()}
        stk, tab = TP._probe_rows(TB.SchedulerConfig(), nz, 0, J, static,
                                  carry, pod)
        assert stk.shape[0] == TP.N_STK_ROWS
        for r in range(TP.N_STK_ROWS):
            assert_same(stk_j[r], stk[r], f"pod {i} row {r}")
        host_pod = {f: np.asarray(getattr(batch, f))[i]
                    for f in JB.BatchScheduler.POD_FIELDS}
        _fit, tab_host = JH.resource_tables(config, host_pod, alloc, usage, J)
        assert_same(tab_host, tab, f"pod {i} tab vs the numpy mirror")
        agree = np.asarray(tab_j) == tab_host
        assert np.array_equal(np.asarray(tab_j)[agree], tab.numpy()[agree])
        packed = TP._probe_fn(TB.SchedulerConfig(), nz, 0, J, static, carry,
                              pod)["packed"].numpy()
        t = TP.tables_from_packed(TB.SchedulerConfig(), packed, nz, J, J,
                                  has_selectors=True)
        assert np.array_equal(t.tab, tab.numpy())
        assert np.array_equal(t.res_fit.sum(0), stk[1].numpy().clip(max=J))
