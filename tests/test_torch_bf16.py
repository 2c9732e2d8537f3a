"""K1's bf16 mode (the KUBERNETES_TPU_QUANT=bf16 j-table profile) on the
CPU: the plain version against the JAX package's Pallas kernel in
interpret mode (bf16=True), the JAX lax build (WaveProbe's
score_mode="bf16") and an independent bfloat16 reference, on the default
weights (where bf16 equals int64 bit for bit) and on weights past 256
(where bf16 rounds). Exact equality: the port follows the declared order
of pallas_probe.py:95-104, each term rounded to bfloat16 and added in
bfloat16 in declaration order.

The one known difference is the JAX package's, not the port's: XLA:CPU
contracts BalancedAllocation's 10 - diff*10 into a fused multiply-add
inside its builds (ROADMAP queue 3), so a JAX build's BA is one below
the oracle's at a few cells. There the JAX bf16 result equals the
bfloat16 sum of that build's own LR and BA terms."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.models import batch as JB
from kubernetes_tpu.models import hosttab as JH
from kubernetes_tpu.models import probe as JP
from kubernetes_tpu.ops import pallas_probe as JPL

from kubernetes_tpu_torch.harness import scenarios as S
from kubernetes_tpu_torch.models import batch as TB
from kubernetes_tpu_torch.models import probe as TP
from kubernetes_tpu_torch.ops import probe_kernel as PK
from kubernetes_tpu_torch.snapshot.carry import to_device

from tests.test_torch_ops import CPU, encode, scenario
from tests.test_torch_probe_kernel import CASES, _jax_probe_inputs

#: the default profile (bound 20: bf16 is exact) and two term lists whose
#: summed |weight|*10 bound passes 256, in both declaration orders
TERM_LISTS = {
    "default": (("lr", 1), ("ba", 1)),
    "LR 30 + BA 1": (("lr", 30), ("ba", 1)),
    "BA 7 + LR 40": (("ba", 7), ("lr", 40)),
}
BF16 = jnp.bfloat16  # numpy's bfloat16 (ml_dtypes): one rounding per op


def bf16_sum(terms, lr, ba) -> np.ndarray:
    """The declared bf16 accumulation in numpy's bfloat16, independent of
    torch and of XLA: each weighted term rounded to bfloat16, added into
    a bfloat16 accumulator from 0, then int32 -> int64."""
    acc = np.zeros(np.shape(lr), BF16)
    for kind, w in terms:
        term = np.int64(w) * np.asarray(lr if kind == "lr" else ba,
                                        np.int64)
        acc = (acc + term.astype(np.float32).astype(BF16)).astype(BF16)
    return acc.astype(np.float32).astype(np.int32).astype(np.int64)


def _inputs(case):
    label, J, N, opts = case
    opts = dict(opts)
    wants_res = opts.pop("wants_res", True)
    alloc, usage, pod = S.probe_case(N, 1, **opts)
    return J, alloc, usage, pod, wants_res


def _mirror_terms(J, alloc, usage, pod):
    """LeastRequested and BalancedAllocation over the j axis in the JAX
    package's numpy mirror (models/hosttab, two roundings as the
    oracle)."""
    j = np.arange(J, dtype=np.int64)[:, None]
    nzj_c = usage[3][None, :] + j * pod["nz_mcpu"]
    nzj_m = usage[4][None, :] + j * pod["nz_mem"]
    args = (pod["nz_mcpu"], pod["nz_mem"], nzj_c, nzj_m, alloc[0], alloc[1])
    return (JH.least_requested(*args),
            JH.balanced_resource_allocation(*args))


def _port(J, alloc, usage, pod, terms, wants_res, bf16):
    return PK.resource_probe(
        J, tuple(torch.from_numpy(a) for a in alloc),
        tuple(torch.from_numpy(a) for a in usage),
        {k: torch.tensor(v) for k, v in pod.items()}, terms,
        wants_res=wants_res, bf16=bf16)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_bf16_matches_the_pallas_build(case):
    """Every term list: the plain bf16 version equals the bfloat16
    reference on the oracle's terms and the JAX Pallas build (interpret
    mode, bf16=True) at every cell where that build's own LR and BA terms
    equal the oracle's; where its BA is the FMA-contracted one below, the
    Pallas bf16 result is the bfloat16 sum of its own terms. The
    frontier equals the int64 mode's."""
    J, alloc, usage, pod, wants_res = _inputs(case)
    jalloc = tuple(jnp.asarray(a) for a in alloc)
    jusage = tuple(jnp.asarray(a) for a in usage)
    jpod = {k: jnp.int64(v) for k, v in pod.items()}
    lr_m, ba_m = _mirror_terms(J, alloc, usage, pod)
    lr_pl = np.asarray(JPL.resource_probe(J, jalloc, jusage, jpod,
                                          (("lr", 1),),
                                          wants_res=wants_res)[1])
    ba_pl = np.asarray(JPL.resource_probe(J, jalloc, jusage, jpod,
                                          (("ba", 1),),
                                          wants_res=wants_res)[1])
    assert np.array_equal(lr_pl, lr_m)
    fma = ba_pl != ba_m
    assert (ba_pl[fma] == ba_m[fma] - 1).all()
    launches = PK.LAUNCHES
    fr64, _tab64 = _port(J, alloc, usage, pod, TERM_LISTS["default"],
                         wants_res, False)
    for name, terms in TERM_LISTS.items():
        fr_pl, tab_pl = JPL.resource_probe(J, jalloc, jusage, jpod, terms,
                                           wants_res=wants_res, bf16=True)
        fr, tab = _port(J, alloc, usage, pod, terms, wants_res, True)
        tab, tab_pl = tab.numpy(), np.asarray(tab_pl)
        assert np.array_equal(tab, bf16_sum(terms, lr_m, ba_m)), name
        assert np.array_equal(tab_pl, bf16_sum(terms, lr_pl, ba_pl)), name
        assert np.array_equal(tab[~fma], tab_pl[~fma]), name
        assert torch.equal(fr, fr64) and np.array_equal(fr.numpy(),
                                                        np.asarray(fr_pl))
    assert PK.LAUNCHES == launches  # CPU tensors take the plain version


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_bf16_equals_i64_on_the_default_profile(case):
    """The default profile's bound (10 * (1 + 1) = 20) lies inside
    bfloat16's exact integers: bf16 equals int64 bit for bit."""
    J, alloc, usage, pod, wants_res = _inputs(case)
    a = _port(J, alloc, usage, pod, TERM_LISTS["default"], wants_res, True)
    b = _port(J, alloc, usage, pod, TERM_LISTS["default"], wants_res, False)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_bf16_rounds_past_256():
    """Weights past bfloat16's exact range round: the j-table differs
    from int64 on the main case, by at most bfloat16's spacing there."""
    J, alloc, usage, pod, wants_res = _inputs(CASES[0])
    for name in ("LR 30 + BA 1", "BA 7 + LR 40"):
        terms = TERM_LISTS[name]
        b16 = _port(J, alloc, usage, pod, terms, wants_res, True)[1]
        i64 = _port(J, alloc, usage, pod, terms, wants_res, False)[1]
        diff = (b16 - i64).abs()
        assert int(diff.max()) > 0, name
        assert bool((diff <= 2).all()), name  # spacing 2 in [256, 512)


def _config(lr_weight):
    base = JB.SchedulerConfig()
    prios = tuple((n, lr_weight if n == JB.LEAST_REQUESTED else w)
                  for n, w in base.priorities)
    return (dataclasses.replace(base, priorities=prios),
            dataclasses.replace(TB.SchedulerConfig(), priorities=prios))


@pytest.mark.parametrize("lr_weight", [1, 30])
@pytest.mark.parametrize("seed", range(2))
def test_bf16_probe_matches_the_lax_build(seed, lr_weight):
    """The port's single-run probe with score_mode="bf16" against the JAX
    probe's lax build with score_mode="bf16" (WaveProbe's default kernel):
    the 11 header rows and the j-table exactly, at every cell where the
    lax build's own int64 j-table equals the oracle's mirror; the packed
    products unpack to the same tables there. At LR weight 30 the
    bound is 10 * (30 + 1) = 310, past 256."""
    state, pending = scenario(200 + seed, interpod_p=0.3, volumes_p=0.0)
    snap, batch, psnap, pbatch = encode(state, pending)
    jconfig, tconfig = _config(lr_weight)
    nz = max(int(snap.zone_id.max()) + 1, 1)
    J = 16
    sched = TB.BatchScheduler(tconfig, device="cpu")
    static = sched.place_static(psnap)
    carry = sched.initial_carry(psnap)
    pods = to_device(pbatch, CPU, TB.BatchScheduler.POD_FIELDS)
    lax = {m: jax.jit(functools.partial(JP._probe_rows, jconfig, nz, 0, J,
                                        score_mode=m))
           for m in ("i64", "bf16")}
    alloc = {f: np.asarray(getattr(snap, f)).astype(np.int64)
             for f in ("alloc_mcpu", "alloc_mem", "alloc_gpu", "alloc_pods")}
    usage = np.stack([np.asarray(getattr(snap, f)) for f in JH.RES_ROWS])
    terms = tuple(("lr" if n == JB.LEAST_REQUESTED else "ba", int(w))
                  for n, w in jconfig.priorities
                  if n in (JB.LEAST_REQUESTED, JB.BALANCED_ALLOCATION))
    for i in range(batch.num_pods):
        jin = _jax_probe_inputs(snap, batch, i, jconfig)
        stk_j, tab_j = lax["bf16"](*jin)
        _stk, tab_j64 = lax["i64"](*jin)
        pod = {f: t[i] for f, t in pods.items()}
        stk, tab = TP._probe_rows(tconfig, nz, 0, J, static, carry, pod,
                                  score_mode="bf16")
        assert np.array_equal(np.asarray(stk_j), stk.numpy()), i
        host_pod = {f: np.asarray(getattr(batch, f))[i]
                    for f in JB.BatchScheduler.POD_FIELDS}
        _fit, tab_host = JH.resource_tables(jconfig, host_pod, alloc,
                                            usage, J)
        agree = np.asarray(tab_j64) == tab_host
        assert np.array_equal(np.asarray(tab_j)[agree], tab.numpy()[agree])
        lr_m, ba_m = _mirror_terms(J, [alloc["alloc_mcpu"],
                                       alloc["alloc_mem"]],
                                   usage, host_pod)
        assert np.array_equal(tab.numpy(), bf16_sum(terms, lr_m, ba_m))
        packed = TP._probe_fn(tconfig, nz, 0, J, static, carry, pod,
                              score_mode="bf16")["packed"].numpy()
        t = TP.tables_from_packed(tconfig, packed, nz, J, J,
                                  has_selectors=True)
        assert np.array_equal(t.tab, tab.numpy())


def test_wave_probe_score_mode_defaults_from_the_profile(monkeypatch):
    monkeypatch.delenv("KUBERNETES_TPU_QUANT", raising=False)
    assert TP.WaveProbe().score_mode == JP.WaveProbe().score_mode == "i64"
    monkeypatch.setenv("KUBERNETES_TPU_QUANT", "bf16")
    assert TP.WaveProbe().score_mode == JP.WaveProbe().score_mode == "bf16"
    # an explicit mode beats the env (the shadow driver's seam)
    assert TP.WaveProbe(score_mode="i64").score_mode == "i64"


def test_bf16_wrapper_has_no_fallback_and_bounds_its_terms():
    """A device other than the CPU never reaches the plain version in the
    bf16 mode either; the kernel's term list has MAX_TERMS slots, and a
    longer list raises before anything launches."""
    meta = torch.empty(8, dtype=torch.int64, device="meta")
    pod = {k: torch.empty((), dtype=torch.int64, device="meta")
           for k in PK.POD_SCALARS}
    with pytest.raises(ValueError):
        PK.resource_probe(16, (meta,) * 4, (meta,) * 6, pod,
                          TERM_LISTS["default"], bf16=True)
    cpu = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="at most"):
        PK._launch_bf16(16, (cpu,) * 4, (cpu,) * 6,
                        torch.zeros(len(PK.POD_SCALARS), dtype=torch.int64),
                        (("lr", 1),) * (PK.MAX_TERMS + 1), True)
