"""The joint-assignment solve K7 on the CPU: the port's plain auction and
beam (scheduler/optimizer/ops/assign.py) against the JAX package's
AssignSolver on the owner arrays, exactly; and a numpy re-enactment of
the CUDA kernels' algorithms (csrc/assign_kernel.cu: the auction's rank
bitmap, its rounds over a compacted list of slots cut into (row,
segment) items over node tiles, each segment's lane walk and butterfly,
the partials' merge, the unique-key seat and the general path's
min-claim, with the early stop; the beam's per-slot sorted lists by
warp argmax rounds and its chain of touched-node tables, one warp a
beam), with the kernels' wrapping int64 arithmetic, held against the
plain versions and the JAX solver, since this sandbox has no compiler
for the kernels themselves. The inputs are made with numpy from a seed;
the solver fuzz follows tests/test_optimizer.py."""

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


def check_solution(owner, fit, req, check, cap, commit=None):
    """tests/test_optimizer.py _check_solution: every assignment inside
    the fit mask, cumulative per-node usage inside capacity; the usage is
    the slots' commits, in slot order, where they differ from the
    requests (the beam places in slot order)."""
    commit = req if commit is None else commit
    used = np.zeros_like(cap)
    for s, n in enumerate(owner):
        n = int(n)
        if n < 0:
            continue
        assert fit[s, n]
        assert (((used[n] + req[s]) <= cap[n]) | ~check[s]).all()
        used[n] += commit[s]


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
    # the auction seats in rounds, and where used + req wraps ("wide") a
    # seat's feasibility depends on that order, not on slot order
    if not (kind == "wide" and solver == "auction"):
        check_solution(owner, case["fit"], case["req"], case["check"],
                       case["cap"], case["commit"])
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
# csrc/assign_kernel.cu's constants
AUCTION_WARPS = 16
TILE_MAX = 2048
SEG_MAX = 32
STEP = 64
SMS = 132  # the H100's SMs: the auction's grid there
BEAM_WARPS = 16
BEAM_E = 16
BEAM_C = 4
BEAM_K = 4


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


def _butterfly_top2(v1, i1, v2):
    """warp_top2: the xor butterfly of top2_merge over the last axis (32
    lanes) -> lane 0's (v1, i1, v2)."""
    lane = np.arange(LANES)
    for off in (16, 8, 4, 2, 1):
        part = lane ^ off
        v1, i1, v2 = _merge(v1, i1, v2, v1[..., part], i1[..., part],
                            v2[..., part])
    return v1[..., 0], i1[..., 0], v2[..., 0]


def tiles_of(N, tile_max=TILE_MAX):
    """The kernel's tiles_of: -> (T tiles, tile columns, a multiple of
    64)."""
    T = -(-N // tile_max)
    per = -(-N // T)
    return T, -(-per // STEP) * STEP


def auction_plan(P, N, tile_max=TILE_MAX, warps=AUCTION_WARPS, sms=SMS):
    """The kernel's auction_plan at one block an SM: tiles of at most
    tile_max columns while they fit the sms co-resident blocks, else one
    tile a block (its node state in device memory, slab); the grid a
    multiple of the tiles, a warp a slot in round 0 where that takes
    fewer blocks. -> (T, tile, blocks, slab)."""
    T, tile = tiles_of(N, tile_max)
    slab = T > sms
    if slab:
        tile = -(-(-(-N // sms)) // STEP) * STEP
        T = -(-N // tile)
    return T, tile, min(max(-(-P // warps), 1) * T, sms // T * T), slab


def rank_keys(P, order):
    return np.clip(np.int64(P) - order.astype(np.int64), 0, (1 << 16) - 1)


def keys_unique(P, order):
    """The auction's prologue: atomicOr of a bit per clip(P - order) into
    a 2^16-bit map; a bit found set sends the launch to the general
    path. -> True when no bit was set twice."""
    seen = np.zeros(1 << 11, np.uint32)
    unique = True
    for rk in rank_keys(P, order):
        bit = np.uint32(1) << np.uint32(rk & 31)
        old = seen[rk >> 5]
        seen[rk >> 5] = old | bit
        unique &= not (old & bit)
    return unique


def segment_top2(util, fit, c0, c1):
    """One warp's walk over columns [c0, c1) of each row of util: lane l
    takes the pairs c0 + 2l + 64j and the next column in increasing
    order (the first of equals stays v1), then the butterfly. -> (v1, i1,
    v2, any fit column) per row."""
    R = util.shape[0]
    n = max(c1 - c0, 0)
    J = -(-n // STEP)
    if J == 0:
        return (np.full(R, EMPTY), np.full(R, NO_INDEX),
                np.full(R, NEG), np.zeros(R, bool))
    vals = np.full((R, J * STEP), EMPTY, np.int64)
    vals[:, :n] = util[:, c0:c1]
    cols = np.full(J * STEP, NO_INDEX, np.int64)
    cols[:n] = np.arange(c0, c1)
    vals = vals.reshape(R, J, LANES, 2).transpose(0, 2, 1, 3).reshape(
        R, LANES, 2 * J)
    cols = cols.reshape(J, LANES, 2).transpose(1, 0, 2).reshape(LANES, 2 * J)
    at = vals.argmax(axis=2)
    v1 = np.take_along_axis(vals, at[..., None], 2)[..., 0]
    i1 = np.where(v1 == EMPTY, NO_INDEX, cols[np.arange(LANES)[None], at])
    rest = vals.copy()
    np.put_along_axis(rest, at[..., None], EMPTY, 2)
    v2 = np.maximum(NEG, rest.max(axis=2))
    v1, i1, v2 = _butterfly_top2(v1, i1, v2)
    return v1, i1, v2, fit[:, c0:c1].any(axis=1)


def merge_partials(parts):
    """The last segment's warp: lane l folds the partials of segments l,
    l + 32, ... in turn into (EMPTY, NO_INDEX, NEG) by top2_merge (lanes
    past the segments hold nothing), then the butterfly. parts: [(v1,
    i1, v2, any)] in column order -> the row's (v1, i1, v2, any)."""
    R = parts[0][0].shape[0]
    v1 = np.full((R, LANES), EMPTY, np.int64)
    i1 = np.full((R, LANES), NO_INDEX, np.int64)
    v2 = np.full((R, LANES), NEG, np.int64)
    for k, (a, b, c, _any) in enumerate(parts):
        lane = k % LANES
        v1[:, lane], i1[:, lane], v2[:, lane] = _merge(
            v1[:, lane], i1[:, lane], v2[:, lane], a, b, c)
    v1, i1, v2 = _butterfly_top2(v1, i1, v2)
    return v1, i1, v2, np.any([x[3] for x in parts], axis=0)


def emulate_auction(c, eps0, rounds, tile_max=TILE_MAX, blocks=None,
                    warps=AUCTION_WARPS, seed=0, sms=SMS):
    """csrc/assign_kernel.cu assign_auction_kernel, phase by phase: the
    prologue's rank bitmap; each round's list of slots (round 0 all, then
    the last round's slots with a fit column, in the order the atomics
    set, shuffled here), cut into (row, segment) items over a tile
    group's warps (in one tile a power of two of segments a row) with
    the size of the list, the last round's winners skipped; each segment
    walked lane by lane from the tile's node state, a row's segments
    merged by lane; the bid; win_key by max; on the unique path the slot
    whose key equals it seats, on the general path the lowest slot
    holding the key (atomicMin), into the next round's node state; the
    stop after a round without bids. The tiles and the grid are the
    kernel's on a card of `sms` co-resident blocks (the H100's 132) unless
    `blocks` (and `warps` a block) are given. -> (owner i32[P], rounds
    run, stats: "general", "slab" (the node state in device memory), the
    segments a row took by round, rows of a round merged from several
    segments, rows whose maximum sits in two tiles, slots dropped for
    having no fit column)."""
    fit, score, req, commit = c["fit"], c["score"], c["req"], c["commit"]
    check, cap = c["check"], c["cap"]
    P, N = score.shape
    T, tile, grid, slab = auction_plan(P, N, tile_max, warps, sms)
    if blocks is None:
        blocks = grid
    assert blocks % T == 0 and blocks >= T
    WG = blocks // T * warps
    s_max = min(SEG_MAX // T, tile // STEP)
    prio = c["prio"].astype(np.int64)
    rk = rank_keys(P, c["order"])
    general = not keys_unique(P, c["order"])
    price = np.zeros(N, np.int64)
    used = np.zeros((N, 4), np.int64)
    owner = np.full(P, -1, np.int32)
    rows = np.arange(P)
    won_last = np.zeros(0, np.int64)
    rng = np.random.RandomState(seed)
    stats = {"general": general, "slab": slab, "segments": [],
             "merged_rows": 0,
             "tile_ties": 0, "dropped": 0}
    ran = 0
    with np.errstate(over="ignore"):
        for t in range(rounds):
            ran = t + 1
            eps = max(np.int64(1), np.int64(eps0) >> np.int64(min(t, 62)))
            L = len(rows)  # the list as the kernel spreads it
            s = max(1, min(WG // max(L, 1), s_max))
            if T == 1:  # a power of two, a row's segments in one block
                s = 1 << (min(s, AUCTION_WARPS).bit_length() - 1)
            sub = -(-(-(-tile // s)) // STEP) * STEP
            if T > 1:
                s = -(-tile // sub)
            S = T * s
            stats["segments"].append(S)
            r = rows[~np.isin(rows, won_last)]  # last round's winners skip
            L = len(r)
            feas = fit[r] & _fits(used[None], req[r][:, None], cap[None],
                                  check[r][:, None])
            rot = ((r % N)[:, None] + np.arange(N)[None]) % N
            util = np.where(feas, score[r] * np.int64(N) + rot - price[None],
                            NEG)
            parts = []
            for g in range(T):
                t0, t1 = g * tile, min(g * tile + tile, N)
                for j in range(s):
                    c0 = t0 + j * sub
                    parts.append(segment_top2(util, fit[r], c0,
                                              min(c0 + sub, t1)))
            if S == 1:
                v1, i1, v2, anyfit = parts[0]
            else:
                v1, i1, v2, anyfit = merge_partials(parts)
                stats["merged_rows"] += L
                tops = np.stack([p[0] for p in parts], 1) == v1[:, None]
                by_tile = tops.reshape(L, T, s).any(axis=2)
                stats["tile_ties"] += int(((by_tile.sum(1) > 1)
                                           & (v1 > NEG)).sum())
            valid = v1 > NEG
            bid = np.where(v2 > NEG, v1 - v2, 0) + eps
            key = (np.clip(prio[r], 0, (1 << 14) - 1) << 48) \
                + (np.clip(bid, 0, (1 << 31) - 1) << 16) + rk[r]
            n1 = np.where(valid, i1, -1)
            if not valid.any():
                break
            win_key = np.full(N, NEG, np.int64)
            np.maximum.at(win_key, n1[valid], key[valid])  # atomicMax
            at = np.where(valid, n1, 0)
            if general:
                claim = valid & (key == win_key[at])
                win_p = np.full(N, NO_INDEX, np.int64)
                np.minimum.at(win_p, n1[claim], r[claim])  # atomicMin
                won = valid & (win_p[at] == r)
            else:
                won = valid & (key == win_key[at])
            assert len(set(n1[won].tolist())) == int(won.sum())
            owner[r[won]] = n1[won]
            np.add.at(used, n1[won], commit[r[won]])
            np.add.at(price, n1[won], np.maximum(bid[won], 1))
            stats["dropped"] += int((~anyfit).sum())
            rows = r[anyfit]  # the next list: every slot with a fit column
            rng.shuffle(rows)
            won_last = r[won]
    return owner, ran, stats


def _u0(c):
    """u0 = fit && req <= cap on every checked row ? score : NEG, the
    utility of a node no beam has placed on."""
    return np.where(c["fit"] & _fits(np.zeros((1, 1, 4), np.int64),
                                     c["req"][:, None], c["cap"][None],
                                     c["check"][:, None]), c["score"], NEG)


def beam_lists(c, K=BEAM_K, C=BEAM_C, passes=None):
    """The beam's phase A, block by block (a slot p a block): WA warps,
    thread t holding columns tE .. tE + E - 1 of each chunk of WA * 32 *
    E; pass by pass, the entries equal to the current level m are
    counted, ranked in node order by the block's exclusive prefix sum and
    the first Lp = min(N, C + p) written, and the next level is the
    maximum below m (the first pass only finds the maximum). passes, a
    list, gets each block's pass count. -> [P] lists of (value, node)."""
    P, N = c["score"].shape
    u0 = _u0(c)
    WA = min(max(-(-N // (LANES * BEAM_E)), BEAM_K), BEAM_WARPS)
    E = min(-(-N // (WA * LANES)), BEAM_E)
    chunk = WA * LANES * E
    chunks = -(-N // chunk)
    threads = WA * LANES
    out = []
    for p in range(P):
        Lp = min(N, C + p)
        lst = [None] * Lp
        m, taken, npass = None, 0, 0
        while True:
            listed, nx = 0, None
            for ch in range(chunks):
                cols = ch * chunk + np.arange(threads)[:, None] * E \
                    + np.arange(E)[None]
                live = cols < N
                val = np.where(live, u0[p, np.minimum(cols, N - 1)], 0)
                eq = live & (val == m) if m is not None else np.zeros_like(
                    live)
                below = live & ((val < m) if m is not None else True)
                if below.any():
                    top = val[below].max()
                    nx = top if nx is None else max(nx, top)
                cnt = eq.sum(axis=1)
                excl = np.concatenate([[0], np.cumsum(cnt)[:-1]])
                npass += 1
                for t in np.flatnonzero(cnt):
                    r = taken + listed + excl[t]
                    for n in cols[t][eq[t]]:
                        if r < Lp:
                            lst[r] = (np.int64(m), int(n))
                        r += 1
                listed += int(cnt.sum())
            taken = min(Lp, taken + listed)
            if taken >= Lp or nx is None:
                break
            m = nx
        out.append(lst)
        if passes is not None:
            passes.append(npass)
    return out


def _warp_first(vals, idx):
    """warp_first over the lanes: the maximum of the values' high words,
    then of the low words among those, then the least index where the
    value is that maximum. -> (value, index)."""
    vals = np.asarray(vals, np.int64)
    idx = np.asarray(idx, np.int64)
    hi = vals >> 32
    mh = hi.max()
    lo = (vals & 0xFFFFFFFF).astype(np.uint64)
    ml = np.where(hi == mh, lo, 0).max()
    m = np.int64((int(mh) << 32) | int(ml))
    return m, int(idx[vals == m].min())


def _warp_rounds(lanes, rounds):
    """`rounds` rounds of _warp_first over the lanes' heads, each lane's
    entries sorted by `before`; the lane holding the winner moves up its
    next. -> the winners in order."""
    lanes = [sorted(x, key=lambda e: (-int(e[0]), int(e[1]))) for x in lanes]
    out = []
    for _ in range(rounds):
        heads = [x[0] if x else (EMPTY, NO_INDEX) for x in lanes]
        w = _warp_first([h[0] for h in heads], [h[1] for h in heads])
        out.append(w)
        for x in lanes:
            if x and (x[0][0], x[0][1]) == w:
                x.pop(0)
    return out


def emulate_beam(c, K=BEAM_K, C=BEAM_C, stats=None):
    """csrc/assign_kernel.cu assign_beam_kernel: phase A's lists
    (beam_lists), then phase B, one warp a beam: at step p the first C
    entries of slot p's list that the beam has not placed on, and its
    placed nodes (the table: node, used) with their utility recomputed;
    lane l holds touched entries l and l + 32 and the l-th list entry,
    sorted, and C_eff rounds of the warp's first (warp reductions on the
    words of the value, then the index) give the top C; K such rounds
    over the K * (C_eff + 1) successors give the top K, round k the
    warp's child, which copies its parent's table and choices
    and adds the pick; owner the choices of the first maximum of acc.
    stats, a dict, counts "regained": picks of a touched node that slot's
    u0 ruled out. -> owner."""
    fit, score, req, commit = c["fit"], c["score"], c["req"], c["commit"]
    check, cap = c["check"], c["cap"]
    P, N = score.shape
    assert P <= 64
    c_eff = min(C, N)
    lists = beam_lists(c, K, C)
    nodes = [[] for _ in range(K)]   # the touched tables
    useds = [[] for _ in range(K)]
    choice = np.full((K, P), -1, np.int32)
    acc = [np.int64(0)] + [np.int64(-(1 << 59))] * (K - 1)
    with np.errstate(over="ignore"):
        for p in range(P):
            Lp = min(N, C + p)
            lst = lists[p][:Lp]
            cands = []
            for k in range(K):
                heads = [e for e in lst if e[1] not in nodes[k]][:C]
                lanes = [[] for _ in range(LANES)]
                for e, (n, u) in enumerate(zip(nodes[k], useds[k])):
                    ok = fit[p, n] and bool(_fits(u, req[p], cap[n],
                                                  check[p]))
                    lanes[e % LANES].append((score[p, n] if ok else NEG, n))
                for i, e in enumerate(heads):
                    lanes[i].append(e)
                cands.append(_warp_rounds(lanes, c_eff))
            succ = []
            for k in range(K):
                for q in range(c_eff):
                    v = cands[k][q][0]
                    succ.append(acc[k] + (v if v > NEG
                                          else np.int64(-(1 << 58))))
                succ.append(acc[k] - np.int64(1 << 40))
            order = [j for _v, j in _warp_rounds([[(v, i)] for i, v in
                                                  enumerate(succ)], K)]
            new_nodes, new_used, new_choice, new_acc = [], [], [], []
            for kk in range(K):
                j = order[kk]
                par, slot = divmod(j, c_eff + 1)
                sc = min(slot, c_eff - 1)
                pick = slot < c_eff and cands[par][sc][0] > NEG
                node = cands[par][sc][1] if pick else -1
                tn, tu = list(nodes[par]), [u.copy() for u in useds[par]]
                if node >= 0:
                    if node in tn:
                        if stats is not None and not (fit[p, node] and _fits(
                                np.zeros(4, np.int64), req[p], cap[node],
                                check[p])):
                            stats["regained"] = stats.get("regained", 0) + 1
                        tu[tn.index(node)] = tu[tn.index(node)] + commit[p]
                    else:
                        tn.append(node)
                        tu.append(np.zeros(4, np.int64) + commit[p])
                ch = choice[par].copy()
                ch[p] = node
                new_nodes.append(tn)
                new_used.append(tu)
                new_choice.append(ch)
                new_acc.append(succ[j])
            nodes, useds, acc = new_nodes, new_used, new_acc
            choice = np.array(new_choice, np.int32)
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
        got, ran, _stats = emulate_auction(case, eps0, rounds)
        want = plain(case, "auction", eps0, rounds)
        assert ran <= rounds
    assert np.array_equal(got, want), (got, want)


@pytest.mark.parametrize("seed", range(6))
def test_kernel_algorithm_matches_plain_on_the_fuzz(seed):
    case = fuzz_case(seed)
    P, N = case["fit"].shape
    eps0 = A.auction_eps0(case["score"], N)
    rounds = A.auction_rounds(P, N)
    got, _ran, _stats = emulate_auction(case, eps0, rounds)
    assert np.array_equal(got, plain(case, "auction", eps0, rounds))
    assert np.array_equal(emulate_beam(case), plain(case, "beam"))


def test_kernel_stops_after_a_round_without_bids():
    """A round in which no slot bids leaves price, used and owner as they
    were, so the emulated kernel's early stop gives the plain version's
    owner over all its rounds."""
    case = S.assign_case(96, 24, 3, "ranks")
    eps0 = A.auction_eps0(case["score"], 24)
    got, ran, _stats = emulate_auction(case, eps0, 96)
    assert ran < 96
    assert np.array_equal(got, plain(case, "auction", eps0, 96))


def test_claim_takes_the_lowest_slot_of_a_shared_key():
    """Two slots with equal keys on one node (repeated FIFO ranks, equal
    priorities and bids): the general path's min-claim seats the lower
    slot, as the reference's argmax does."""
    P, N = 4, 1
    case = {"fit": np.ones((P, N), bool), "score": np.zeros((P, N), np.int64),
            "req": np.array([[1, 0, 0, 1]] * P, np.int64),
            "check": np.ones((P, 4), bool),
            "cap": np.array([[1, 0, 0, 110]], np.int64),
            "prio": np.zeros(P, np.int32),
            "order": np.array([0, 0, 1, 2], np.int32)}
    case["commit"] = case["req"].copy()
    got, _ran, stats = emulate_auction(case, 1, 4)
    assert stats["general"]
    want = plain(case, "auction", 1, 4)
    jax_owner, _ = JaxSolver().solve(*[case[k] for k in FIELDS], 33)
    assert np.array_equal(got, want) and np.array_equal(want, jax_owner)
    assert list(want) == [0, -1, -1, -1]


# -- the redesign's pieces, one by one -----------------------------------------


def test_prologue_finds_repeated_ranks():
    """The rank bitmap's answer equals 'clip(P - order, 0, 2^16 - 1) is
    distinct across slots', including clipping at 2^16 - 1 and at 0."""
    rng = np.random.RandomState(0)
    orders = [np.arange(48), rng.permutation(48), np.arange(48) // 2,
              np.array([-70000, -80000, 0]), np.array([-70000, 0, 1]),
              np.array([5, 6, 7]), np.array([3, 9, 2]),
              np.array([-65533, -65534, 0]), np.array([-65532, -65533, 0])]
    for order in orders:
        order = np.asarray(order, np.int32)
        P = 3 if order.size == 3 else order.size
        want = len(set(rank_keys(P, order).tolist())) == P
        assert keys_unique(P, order) == want, order
    assert keys_unique(48, np.arange(48, dtype=np.int32))
    assert not keys_unique(3, np.array([-70000, -80000, 0], np.int32))
    assert not keys_unique(3, np.array([5, 6, 7], np.int32))  # P - order <= 0


def test_tile_partial_merge_keeps_the_first_column():
    """Two segments on either side of a tile edge whose maxima are equal:
    the merge keeps the lower column, and the loser's v1 becomes v2,
    whatever the segments' order among the lanes."""
    one = np.ones(1, np.int64)
    left = (7 * one, 1087 * one, 3 * one, np.ones(1, bool))
    right = (7 * one, 1088 * one, 5 * one, np.ones(1, bool))
    low = (2 * one, 40 * one, NEG * one, np.zeros(1, bool))
    for parts in ([left, right], [low, left, right], [left, low, right]):
        v1, i1, v2, anyfit = merge_partials(parts)
        assert (v1[0], i1[0], v2[0], anyfit[0]) == (7, 1087, 7, True)
    # a segment's walk: equal maxima in two lanes and in one lane
    util = np.full((1, 128), NEG, np.int64)
    util[0, [70, 3, 66]] = 9
    v1, i1, v2, _ = segment_top2(util, np.ones((1, 128), bool), 0, 128)
    assert (v1[0], i1[0], v2[0]) == (9, 3, 9)


@pytest.mark.parametrize("seed", range(8))
def test_tiles_and_split_rows_match_plain(seed):
    """The auction over small tiles (64 columns, so N = 100-300 makes 2-5
    tiles and every round merges partials across tile edges) and over
    grids of a few warps (rows split into segments when the list is
    short): equal to the plain version, on both paths."""
    rng = np.random.RandomState(seed)
    P = int(rng.choice([24, 40, 64]))
    N = int(rng.choice([100, 130, 300]))
    kind = ("ties", "fuzz", "ranks", "clip")[seed % 4]
    case = S.assign_case(P, N, seed, kind)
    eps0 = A.auction_eps0(case["score"], N)
    rounds = A.auction_rounds(P, N)
    want = plain(case, "auction", eps0, rounds)
    T, _ = tiles_of(N, 64)
    for tile_max, blocks, warps in ((64, T, 1), (64, 4 * T, 2),
                                    (128, None, AUCTION_WARPS),
                                    (TILE_MAX, 1, 4), (TILE_MAX, 8, 16)):
        got, _ran, stats = emulate_auction(case, eps0, rounds, tile_max,
                                           blocks, warps, seed=seed)
        assert np.array_equal(got, want), (tile_max, blocks, warps)
        assert stats["general"] == (kind in ("ranks", "clip"))


@pytest.mark.parametrize("seed", range(3))
def test_ties_straddle_tile_edges(seed):
    """Equal scores over tiles of 64 columns: some rounds' maxima sit in
    two tiles at once (the merge keeps the lower column), and the owners
    equal the plain version's and the JAX solver's."""
    case = S.assign_case(256, 128, seed, "ties")
    eps0 = A.auction_eps0(case["score"], 128)
    rounds = A.auction_rounds(256, 128)
    got, _ran, stats = emulate_auction(case, eps0, rounds, 64, 6, 4)
    assert stats["tile_ties"] > 0
    assert np.array_equal(got, plain(case, "auction", eps0, rounds))
    assert_same_owner(case, 256, "auction")


def test_two_tile_case_matches_plain_and_jax():
    """scenarios' auction at N = 2,049 (two tiles of the kernel; slot 2's
    best two nodes tie in round 1 on either side of the edge, and the
    lower column takes the seat) with the kernel's own constants and
    grid on the H100."""
    label, P, N, kind, live, solver = next(
        c for c in S.ASSIGN_CASES if c[0] == "edge P=40 N=2049")
    case = S.assign_case(P, N, 11, kind, live)
    assert tiles_of(N) == (2, 1088)
    eps0 = A.auction_eps0(case["score"], N)
    rounds = A.auction_rounds(P, N)
    got, _ran, stats = emulate_auction(case, eps0, rounds)
    assert max(stats["segments"]) > 2 and stats["merged_rows"] > 0
    assert stats["tile_ties"] > 0
    assert got[2] == 1087
    assert np.array_equal(got, plain(case, "auction", eps0, rounds))
    assert_same_owner(case, P, "auction")


def test_row_partials_fold_past_32_tiles():
    """Tiles of 64 columns over N = 2,560 make 40 tiles, more partials a
    row than a warp has lanes: lanes fold two partials each before the
    shuffles. Equal scores put each slot's best node (the rotation's
    N - 1 - p) in the last tiles, past lane 31; equal to the plain
    version."""
    P, N = 48, 2560
    case = S.assign_case(P, N, 4, "ties")
    eps0 = A.auction_eps0(case["score"], N)
    rounds = A.auction_rounds(P, N)
    assert auction_plan(P, N, 64)[:2] == (40, 64)
    got, _ran, stats = emulate_auction(case, eps0, rounds, 64)
    assert min(stats["segments"]) == 40 and not stats["slab"]
    assert np.array_equal(got, plain(case, "auction", eps0, rounds))


def test_node_state_moves_to_device_memory_past_the_resident_tiles():
    """The kernel's plan: on the H100 (132 blocks of one 2,048-node tile
    each in shared memory) N = 270,336 keeps every tile in shared memory
    and one node more takes one tile a block in device memory, 129 tiles
    of 2,112. The same plan on a card of 3 co-resident blocks, tiles of
    64: N = 300 makes 3 tiles of 128 columns, equal to the plain
    version."""
    assert auction_plan(64, 270336) == (132, 2048, 132, False)
    assert auction_plan(64, 270337) == (129, 2112, 129, True)
    for kind, seed in (("fuzz", 0), ("ties", 1), ("ranks", 2)):
        case = S.assign_case(40, 300, seed, kind)
        eps0 = A.auction_eps0(case["score"], 300)
        rounds = A.auction_rounds(40, 300)
        assert auction_plan(40, 300, 64, sms=3) == (3, 128, 3, True)
        got, _ran, stats = emulate_auction(case, eps0, rounds, 64, sms=3)
        assert stats["slab"] and min(stats["segments"]) == 3
        assert np.array_equal(got, plain(case, "auction", eps0, rounds))


def test_compacted_list_spreads_late_rounds():
    """A pack solve (256 slots, 1,024 nodes, the tie funnel): round 0
    takes a warp a row; later rounds' shorter lists split rows into up to
    16 segments; slots without a fit column drop out; equal to the plain
    version."""
    case = S.assign_case(256, 1024, 0, "pack", 1000)
    case["fit"][-8:] = False  # padded slots
    eps0 = A.auction_eps0(case["score"], 1024)
    rounds = A.auction_rounds(256, 1024)
    got, _ran, stats = emulate_auction(case, eps0, rounds)
    assert stats["segments"][0] == 1 and max(stats["segments"]) == 16
    assert stats["dropped"] == 8 and not stats["general"]
    assert np.array_equal(got, plain(case, "auction", eps0, rounds))


def test_general_path_on_clipped_ranks_matches_jax():
    """Slots whose P - order clips at 2^16 - 1 share the key's low bits:
    the prologue sends the launch to the claim path, whose owners equal
    the plain version's and the JAX solver's."""
    case = S.assign_case(48, 16, 2, "clip")
    eps0 = A.auction_eps0(case["score"], 16)
    rounds = A.auction_rounds(48, 16)
    got, _ran, stats = emulate_auction(case, eps0, rounds)
    assert stats["general"]
    assert np.array_equal(got, plain(case, "auction", eps0, rounds))
    assert_same_owner(case, 48, "auction")


@pytest.mark.parametrize("P,N", [(8, 8), (24, 16), (32, 1024), (16, 3000),
                                 (64, 40), (5, 2), (3, 9000)])
def test_beam_lists_are_the_sorted_prefix(P, N):
    """Phase A's list of each slot is the first min(N, C + p) entries of
    u0 sorted by (value desc, node asc), NEG entries included, the level
    passes one more than the levels listed (N = 9,000 takes two chunks
    of columns)."""
    case = S.assign_case(P, N, P + N, "fuzz")
    passes = []
    lists = beam_lists(case, passes=passes)
    u0 = _u0(case)
    assert max(passes) <= min(N, BEAM_C + P - 1) + 1
    for p, lst in enumerate(lists):
        order = np.lexsort((np.arange(N), -u0[p]))[:min(N, BEAM_C + p)]
        assert [n for _v, n in lst] == order.tolist()
        assert [v for v, _n in lst] == u0[p, order].tolist()


@pytest.mark.parametrize("kind,P,N", [("negcommit", 24, 16),
                                      ("negcommit", 32, 8),
                                      ("onenode", 32, 64),
                                      ("onenode", 16, 8)])
def test_beam_touched_nodes_match_plain_and_jax(kind, P, N):
    """Negative commits (a placement makes a node feasible that u0 ruled
    out: the touched node's recomputed utility) and one node taking every
    step (a table of one entry): equal to the plain version and to the
    JAX solver."""
    case = S.assign_case(P, N, 4, kind)
    stats = {}
    got = emulate_beam(case, stats=stats)
    want = plain(case, "beam")
    assert np.array_equal(got, want), (got, want)
    assert_same_owner(case, min(P, 32), "beam")
    if kind == "negcommit" and (P, N) == (24, 16):
        assert stats.get("regained", 0) > 0
    if kind == "onenode":
        assert (want == N // 3).all()
