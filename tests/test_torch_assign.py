"""The joint-assignment solve K7 on the CPU: the port's plain auction and
beam (scheduler/optimizer/ops/assign.py) against the JAX package's
AssignSolver on the owner arrays, exactly; and a numpy re-enactment of
the CUDA kernel's algorithm (csrc/assign_kernel.cu: the auction's bid
with its lane scan and butterfly, the max-claim by atomicMax, the
min-claim by atomicMin and the update, with the early stop; the beam's
per-thread candidate lists, block argmaxes and thread 0's successor
selection), with the kernel's wrapping int64 arithmetic, held against
the plain versions, since this sandbox has no compiler for the kernel
itself. The inputs are made with numpy from a seed; the solver fuzz
follows tests/test_optimizer.py."""

import numpy as np
import pytest
import torch

from kubernetes_tpu.scheduler.optimizer.ops.assign import (
    AssignSolver as JaxSolver,
)
from kubernetes_tpu.scheduler.optimizer.ops.assign import (
    auction_rounds as jax_auction_rounds,
)

from kubernetes_tpu_torch.harness import scenarios as S
from kubernetes_tpu_torch.scheduler.optimizer.ops import assign as A
from kubernetes_tpu_torch.scheduler.optimizer.ops import assign_kernel as AK

FIELDS = ("fit", "score", "req", "commit", "check", "cap", "prio", "order")


def solve_both(case, n_real):
    """-> (JAX owner, JAX solver name, port owner, port solver name)."""
    args = [case[k] for k in FIELDS]
    jo, jn = JaxSolver().solve(*args, n_real)
    po, pn = A.AssignSolver(device="cpu").solve(*args, n_real)
    return jo, jn, po, pn


def assert_same_owner(case, n_real, solver=None):
    jo, jn, po, pn = solve_both(case, n_real)
    assert pn == jn
    if solver is not None:
        assert pn == solver
    assert po.dtype == np.int32 and jo.dtype == np.int32
    assert np.array_equal(po, jo), (po, jo)
    return po


def check_solution(owner, fit, req, check, cap):
    """tests/test_optimizer.py _check_solution: every assignment inside
    the fit mask, cumulative per-node usage inside capacity."""
    used = np.zeros_like(cap)
    for s, n in enumerate(owner):
        n = int(n)
        if n < 0:
            continue
        assert fit[s, n]
        assert (((used[n] + req[s]) <= cap[n]) | ~check[s]).all()
        used[n] += req[s]


def fuzz_case(seed):
    """tests/test_optimizer.py test_solver_fuzz_respects_fit_and_capacity's
    inputs for `seed`."""
    rng = np.random.RandomState(seed)
    P = int(rng.choice([8, 24, 48]))
    N = int(rng.choice([8, 16]))
    fit = rng.rand(P, N) > 0.2
    score = rng.randint(0, 40, size=(P, N)).astype(np.int64)
    req = np.zeros((P, 4), np.int64)
    req[:, 0] = rng.choice([500, 1000, 2000, 3000], size=P)
    req[:, 1] = rng.choice([1, 2, 3], size=P) * (1 << 30)
    req[:, 3] = 1
    check = np.ones((P, 4), bool)
    zero = rng.rand(P) < 0.1
    check[zero, :3] = False
    req[zero, :3] = 0
    cap = np.zeros((N, 4), np.int64)
    cap[:, 0] = rng.choice([2000, 4000, 8000], size=N)
    cap[:, 1] = rng.choice([4, 8, 32], size=N) * (1 << 30)
    cap[:, 3] = rng.choice([2, 5, 110], size=N)
    return {"fit": fit, "score": score, "req": req, "commit": req.copy(),
            "check": check, "cap": cap, "prio": np.zeros(P, np.int32),
            "order": np.arange(P, dtype=np.int32)}


# -- the plain versions against the JAX solver ---------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_solver_fuzz_matches_jax(seed):
    case = fuzz_case(seed)
    P = case["fit"].shape[0]
    owner = assert_same_owner(case, P)
    check_solution(owner, case["fit"], case["req"], case["check"],
                   case["cap"])


@pytest.mark.parametrize("seed", range(6))
def test_solver_fuzz_beam_matches_jax(seed):
    """The same fuzz through the beam (a real wave of at most 32 slots)."""
    case = fuzz_case(seed)
    P = case["fit"].shape[0]
    assert_same_owner(case, min(P, A.AssignSolver.BEAM_MAX_SLOTS), "beam")


def test_beam_packs_small_wave_optimally():
    fit = np.ones((4, 2), bool)
    req = np.zeros((4, 4), np.int64)
    req[:, 0] = [3000, 3000, 1000, 1000]
    req[:, 3] = 1
    cap = np.zeros((2, 4), np.int64)
    cap[:, 0] = 4000
    cap[:, 3] = 110
    case = {"fit": fit, "score": np.zeros((4, 2), np.int64), "req": req,
            "commit": req.copy(), "check": np.ones((4, 4), bool),
            "cap": cap, "prio": np.zeros(4, np.int32),
            "order": np.arange(4, dtype=np.int32)}
    owner = assert_same_owner(case, 4, "beam")
    assert (owner >= 0).all()


def test_auction_rounds_match_jax():
    for P, N in ((16, 1024), (2048, 64), (4096, 4096), (256, 16), (1, 1),
                 (2048, 1024), (4096, 8192), (100, 37)):
        assert A.auction_rounds(P, N) == jax_auction_rounds(P, N)
    assert A.auction_rounds(2048, 64) == 2048 // 64 * 8


def test_auction_long_run_past_64_rounds_matches_jax():
    P, N = 256, 16
    assert A.auction_rounds(P, N) > 64
    case = S.assign_case(P, N, 0, "long")
    owner = assert_same_owner(case, P, "auction")
    assert (owner >= 0).all()


@pytest.mark.parametrize("label,P,N,kind,live,solver", [
    c for c in S.ASSIGN_CASES if c[1] * c[2] <= 1 << 16],
    ids=[c[0] for c in S.ASSIGN_CASES if c[1] * c[2] <= 1 << 16])
def test_assign_cases_match_jax(label, P, N, kind, live, solver):
    """Every small scenarios.ASSIGN_CASES entry: all-equal scores,
    repeated FIFO ranks with priority tiers, P and N not powers of two,
    padded slots; the solver the case names."""
    case = S.assign_case(P, N, 7, kind, live)
    n_real = P if solver == "auction" else min(P, 32)
    owner = assert_same_owner(case, n_real, solver)
    check_solution(owner, case["fit"], case["req"], case["check"],
                   case["cap"])
    assert (owner[case["fit"].sum(axis=1) == 0] == -1).all()


def test_auction_eps0_is_the_jax_host_arithmetic():
    score = np.array([[3, 90], [-7, 5]], np.int64)
    span = 90 - (-7)
    assert A.auction_eps0(score, 2) == max(1, (span * 2) // 8)
    assert A.auction_eps0(np.zeros((2, 2), np.int64), 2) == 1


def test_wrapper_takes_the_plain_version_on_cpu_and_counts_nothing():
    case = {k: torch.as_tensor(v) for k, v in fuzz_case(1).items()}
    tabs = [case[k] for k in FIELDS[:6]]
    before = AK.LAUNCHES
    P, N = case["fit"].shape
    got = AK.auction_assign(*tabs, case["prio"].to(torch.int32),
                            case["order"].to(torch.int32), 5,
                            A.auction_rounds(P, N))
    want = A._auction_assign_fn(A.auction_rounds(P, N), *tabs,
                                case["prio"], case["order"], 5)
    assert torch.equal(got, want) and got.dtype == torch.int32
    assert torch.equal(AK.beam_assign(*tabs),
                       A._beam_assign_fn(4, 4, *tabs))
    assert AK.LAUNCHES == before


def test_wrapper_refuses_other_devices():
    t = torch.zeros((2, 2), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        AK.beam_assign(t, t, t, t, t, t)
    with pytest.raises(ValueError):
        AK.auction_assign(t, t, t, t, t, t, t, t, 1, 1)


# -- the kernel's algorithm, re-enacted ---------------------------------------

NEG = np.int64(A._NEG)
EMPTY = np.iinfo(np.int64).min
NO_INDEX = 0x7FFFFFFF
LANES = 32


def _fits(used, req, cap, check):
    """used + req <= cap on every checked row (broadcast over [..., 4]),
    the sum wrapping as the kernel's u64 add does."""
    with np.errstate(over="ignore"):
        return np.where(check, used + req <= cap, True).all(axis=-1)


def _merge(v1, i1, v2, bv1, bi1, bv2):
    """The kernel's top2_merge, elementwise."""
    lead = (bv1 > v1) | ((bv1 == v1) & (bi1 < i1))
    loser = np.where(lead, v1, bv1)
    return (np.where(lead, bv1, v1), np.where(lead, bi1, i1),
            np.maximum(np.maximum(v2, bv2), loser))


def emulate_auction(c, eps0, rounds):
    """csrc/assign_kernel.cu assign_auction_kernel, phase by phase: the
    bid's lanes (lane l scans columns l, l + 32, ...) and its xor
    butterfly, win_key by max, win_p by min over the slots holding the
    winning key, the update, and the stop after a round without bids.
    -> (owner i32[P], rounds run)."""
    fit, score, req, commit = c["fit"], c["score"], c["req"], c["commit"]
    check, cap = c["check"], c["cap"]
    P, N = score.shape
    prio = c["prio"].astype(np.int64)
    order = c["order"].astype(np.int64)
    price = np.zeros(N, np.int64)
    used = np.zeros((N, 4), np.int64)
    owner = np.full(P, -1, np.int32)
    lane = np.arange(LANES)
    ran = 0
    with np.errstate(over="ignore"):
        for t in range(rounds):
            eps = max(np.int64(1), np.int64(eps0) >> np.int64(min(t, 62)))
            v1 = np.full((P, LANES), EMPTY, np.int64)
            i1 = np.full((P, LANES), NO_INDEX, np.int64)
            v2 = np.full((P, LANES), NEG, np.int64)
            for k in range(-(-N // LANES)):
                n = k * LANES + lane
                live = n < N
                nn = np.minimum(n, N - 1)
                feas = (fit[:, nn] & _fits(used[nn][None], req[:, None],
                                           cap[nn][None],
                                           check[:, None]))
                rot = ((np.arange(P) % N)[:, None] + nn[None]) % N
                u = np.where(feas, score[:, nn] * np.int64(N) + rot
                             - price[nn][None], NEG)
                u = np.where(live[None], u, EMPTY)  # a lane past N: no column
                up = (u > v1) & live[None]
                v2 = np.where(live[None], np.where(up, np.maximum(v2, v1),
                                                   np.maximum(v2, u)), v2)
                v1 = np.where(up, u, v1)
                i1 = np.where(up, nn[None], i1)
            for off in (16, 8, 4, 2, 1):
                part = lane ^ off
                v1, i1, v2 = _merge(v1, i1, v2, v1[:, part], i1[:, part],
                                    v2[:, part])
            v1, i1, v2 = v1[:, 0], i1[:, 0], v2[:, 0]
            bidding = owner < 0
            valid = bidding & (v1 > NEG)
            bid = np.where(v2 > NEG, v1 - v2, 0) + eps
            key = (np.clip(prio, 0, (1 << 14) - 1) << 48) \
                + (np.clip(bid, 0, (1 << 31) - 1) << 16) \
                + np.clip(P - order, 0, (1 << 16) - 1)
            ran = t + 1
            if not valid.any():
                break
            win_key = np.full(N, NEG, np.int64)
            np.maximum.at(win_key, i1[valid], key[valid])  # atomicMax
            claim = valid & (key == win_key[np.where(valid, i1, 0)])
            win_p = np.full(N, NO_INDEX, np.int64)
            np.minimum.at(win_p, i1[claim], np.flatnonzero(claim))  # atomicMin
            for n in np.flatnonzero(win_key > NEG):
                w = win_p[n]
                owner[w] = n
                used[n] += commit[w]
                price[n] += max(bid[w], np.int64(1))
    return owner, ran


def _block_argmax(v, i, threads):
    """The beam kernel's block argmax over each beam's thread heads v, i
    [K, threads] by (value desc, index asc): a butterfly in each warp,
    the warps' winners through shared memory, a butterfly in warp 0."""
    def better(av, ai, bv, bi):
        take = (bv > av) | ((bv == av) & (bi < ai))
        return np.where(take, bv, av), np.where(take, bi, ai)

    K = v.shape[0]
    W = threads // LANES
    v = v.reshape(K, W, LANES)
    i = i.reshape(K, W, LANES)
    lane = np.arange(LANES)
    for off in (16, 8, 4, 2, 1):
        v, i = better(v, i, v[:, :, lane ^ off], i[:, :, lane ^ off])
    wv = np.full((K, LANES), EMPTY, np.int64)
    wi = np.full((K, LANES), NO_INDEX, np.int64)
    wv[:, :W], wi[:, :W] = v[:, :, 0], i[:, :, 0]
    for off in (16, 8, 4, 2, 1):
        wv, wi = better(wv, wi, wv[:, lane ^ off], wi[:, lane ^ off])
    return wv[:, 0], wi[:, 0]


def emulate_beam(c, threads=64, K=4, C=4):
    """csrc/assign_kernel.cu assign_beam_kernel (at `threads` threads;
    the kernel runs 512, and the order it computes does not depend on
    the count): each thread's sorted top C of its nodes (n = tid, tid +
    threads, ...) per beam, C_eff block argmaxes with pops, thread 0's
    successors and their top K, the parents' used rebuilt. -> owner."""
    fit, score, req, commit = c["fit"], c["score"], c["req"], c["commit"]
    check, cap = c["check"], c["cap"]
    P, N = score.shape
    c_eff = min(C, N)
    used = np.zeros((K, N, 4), np.int64)
    choice = np.full((K, P), -1, np.int32)
    acc = np.array([0] + [-(1 << 59)] * (K - 1), np.int64)
    tid = np.arange(threads)
    with np.errstate(over="ignore"):
        for p in range(P):
            lv = np.full((K, threads, C), EMPTY, np.int64)
            li = np.full((K, threads, C), NO_INDEX, np.int64)
            for j in range(-(-N // threads)):
                n = j * threads + tid
                live = n < N
                nn = np.minimum(n, N - 1)
                feas = fit[p, nn][None] & _fits(used[:, nn], req[p], cap[nn],
                                                check[p])
                u = np.where(feas, score[p, nn][None], NEG)
                enter = (u > lv[:, :, C - 1]) & live[None]
                lv[:, :, C - 1] = np.where(enter, u, lv[:, :, C - 1])
                li[:, :, C - 1] = np.where(enter, nn[None], li[:, :, C - 1])
                for q in range(C - 1, 0, -1):
                    sw = lv[:, :, q] > lv[:, :, q - 1]
                    a_v, a_i = lv[:, :, q].copy(), li[:, :, q].copy()
                    lv[:, :, q] = np.where(sw, lv[:, :, q - 1], a_v)
                    li[:, :, q] = np.where(sw, li[:, :, q - 1], a_i)
                    lv[:, :, q - 1] = np.where(sw, a_v, lv[:, :, q - 1])
                    li[:, :, q - 1] = np.where(sw, a_i, li[:, :, q - 1])
            cand_v = np.zeros((K, C), np.int64)
            cand_n = np.zeros((K, C), np.int64)
            for q in range(c_eff):
                wv, wi = _block_argmax(lv[:, :, 0], li[:, :, 0], threads)
                cand_v[:, q], cand_n[:, q] = wv, wi
                pop = (li[:, :, 0] == wi[:, None]) & (lv[:, :, 0]
                                                      == wv[:, None])
                lv = np.where(pop[:, :, None], np.concatenate(
                    [lv[:, :, 1:], np.full((K, threads, 1), EMPTY)], 2), lv)
                li = np.where(pop[:, :, None], np.concatenate(
                    [li[:, :, 1:], np.full((K, threads, 1), NO_INDEX)], 2),
                    li)
            succ = []
            for k in range(K):
                for q in range(c_eff + 1):
                    succ.append(acc[k] + (cand_v[k, q] if cand_v[k, q] > NEG
                                          else np.int64(-(1 << 58)))
                                if q < c_eff else acc[k] - (1 << 40))
            taken, parent, node, top_v = set(), [], [], []
            for _ in range(K):
                best = -1
                for j2, s in enumerate(succ):
                    if j2 not in taken and (best < 0 or s > succ[best]):
                        best = j2
                taken.add(best)
                top_v.append(succ[best])
                par, slot = divmod(best, c_eff + 1)
                sc = min(slot, c_eff - 1)
                pick = slot < c_eff and cand_v[par, sc] > NEG
                parent.append(par)
                node.append(int(cand_n[par, sc]) if pick else -1)
            used = used[parent].copy()
            for k, n in enumerate(node):
                if n >= 0:
                    used[k, n] += commit[p]
            choice = choice[parent].copy()
            choice[:, p] = node
            acc = np.array(top_v, np.int64)
    best = 0
    for k in range(1, K):
        if acc[k] > acc[best]:
            best = k
    return choice[best]


def plain(case, solver, eps0=None, rounds=None):
    t = {k: torch.as_tensor(v) for k, v in case.items()}
    tabs = [t[k] for k in FIELDS[:6]]
    if solver == "beam":
        return A._beam_assign_fn(4, 4, *tabs).numpy()
    return A._auction_assign_fn(rounds, *tabs, t["prio"], t["order"],
                                eps0).numpy()


EMULATED = [c for c in S.ASSIGN_CASES if c[1] * c[2] <= 4096]


@pytest.mark.parametrize("label,P,N,kind,live,solver", EMULATED,
                         ids=[c[0] for c in EMULATED])
def test_kernel_algorithm_matches_plain(label, P, N, kind, live, solver):
    case = S.assign_case(P, N, 11, kind, live)
    if solver == "beam":
        got = emulate_beam(case)
        want = plain(case, "beam")
    else:
        eps0 = A.auction_eps0(case["score"], N)
        rounds = A.auction_rounds(P, N)
        got, ran = emulate_auction(case, eps0, rounds)
        want = plain(case, "auction", eps0, rounds)
        assert ran <= rounds
    assert np.array_equal(got, want), (got, want)


@pytest.mark.parametrize("seed", range(6))
def test_kernel_algorithm_matches_plain_on_the_fuzz(seed):
    case = fuzz_case(seed)
    P, N = case["fit"].shape
    eps0 = A.auction_eps0(case["score"], N)
    rounds = A.auction_rounds(P, N)
    got, _ran = emulate_auction(case, eps0, rounds)
    assert np.array_equal(got, plain(case, "auction", eps0, rounds))
    assert np.array_equal(emulate_beam(case), plain(case, "beam"))


def test_kernel_stops_after_a_round_without_bids():
    """A round in which no slot bids leaves price, used and owner as they
    were, so the emulated kernel's early stop gives the plain version's
    owner over all its rounds."""
    case = S.assign_case(96, 24, 3, "ranks")
    eps0 = A.auction_eps0(case["score"], 24)
    got, ran = emulate_auction(case, eps0, 96)
    assert ran < 96
    assert np.array_equal(got, plain(case, "auction", eps0, 96))


def test_claim_takes_the_lowest_slot_of_a_shared_key():
    """Two slots with equal keys on one node (repeated FIFO ranks, equal
    priorities and bids): the min-claim seats the lower slot, as the
    reference's argmax does."""
    P, N = 4, 1
    case = {"fit": np.ones((P, N), bool), "score": np.zeros((P, N), np.int64),
            "req": np.array([[1, 0, 0, 1]] * P, np.int64),
            "check": np.ones((P, 4), bool),
            "cap": np.array([[1, 0, 0, 110]], np.int64),
            "prio": np.zeros(P, np.int32),
            "order": np.array([0, 0, 1, 2], np.int32)}
    case["commit"] = case["req"].copy()
    got, _ran = emulate_auction(case, 1, 4)
    want = plain(case, "auction", 1, 4)
    jax_owner, _ = JaxSolver().solve(*[case[k] for k in FIELDS], 33)
    assert np.array_equal(got, want) and np.array_equal(want, jax_owner)
    assert list(want) == [0, -1, -1, -1]
