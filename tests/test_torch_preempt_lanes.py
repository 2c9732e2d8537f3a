"""The victim scorer K6's lane network (csrc/preempt_kernel.cu), emulated
lane by lane on the CPU, against the plain version and the JAX package.

A CUDA kernel cannot run here, so this file re-enacts what each lane of
the kernel does, with the kernel's own u64 wrap arithmetic, in numpy:

- the segment path (C <= 32): rows in W-lane warp segments, 256 / W rows
  a block, lanes past the last row kept in the network; the all-pad
  shortcut of a warp with no candidate; the XOR bitonic network on
  (key, column) by shuffles inside the segment; the gather of the sorted
  column's resources and priority from its lane; the segmented
  shuffle-up scan; the ballots of sorted valid slots and of fits, and
  the first set bit;
- the block path (C >= 64): a block a row; sort stages with j < 32 by
  shuffles inside the warp, wider ones through shared memory (one
  barrier each); the sorted priority from the shared copy, the
  resources read at the sorted column; the warp scan plus the totals of
  the warps before; the warps' ballots for the first invalid position
  and the first fitting prefix.

Every output must equal victim_score_plain's and the JAX
`_victim_score_fn`'s, dtype and value, on every scenarios.VICTIM_CASES
entry and on the row tails (scenarios.VICTIM_TAILS)."""

import numpy as np
import pytest
import torch

from kubernetes_tpu.ops.preempt import VictimScorer as JaxScorer

from kubernetes_tpu_torch.harness import scenarios as S
from kubernetes_tpu_torch.ops import preempt as P
from kubernetes_tpu_torch.ops import preempt_kernel as PK

U64 = np.uint64
SENTINEL = np.int64(1 << 62)
FULL = (1 << 32) - 1


def evict_key(p, o):
    """The kernel's evict_key: p * 2^32 + (2^32 - 1 - o), built in u64."""
    k = (p.astype(np.int64).astype(U64) * U64(1 << 32)
         + (U64(FULL) - o.astype(np.int64).astype(U64)))
    return k.view(np.int64)


def ballot(pred):
    """__ballot_sync over each warp: pred [..., 32] -> bits [...] (int)."""
    return (pred.astype(np.int64) << np.arange(32)).sum(axis=-1)


def ffs(bits):
    """__ffs: 1 + the lowest set bit, 0 for none."""
    bits = np.asarray(bits, np.int64)
    low = bits & -bits
    return np.where(bits == 0, 0,
                    np.log2(np.maximum(low, 1)).astype(np.int64) + 1)


def exchange(key, col, ok, oc, keep_min):
    """The kernel's compare-exchange: take the partner's pair where it is
    the smaller and this lane keeps the minimum, or the larger."""
    other_less = (ok < key) | ((ok == key) & (oc < col))
    take = other_less == keep_min
    return np.where(take, ok, key), np.where(take, oc, col)


def fits_after(free_row, req, x_r):
    """free + cum >= req on every row, the add wrapping as int64."""
    total = (free_row.astype(U64) + x_r).view(np.int64)
    return (total >= req).all(axis=-1)


def write_result(now, any_fit, first, cprio):
    need = np.where(now, 0, np.where(any_fit, first + 1, -1)).astype(np.int32)
    cost = np.where(need > 0, cprio.view(np.int64),
                    np.where(need == 0, np.int64(0), SENTINEL))
    return need, cost.astype(np.int64)


def emulate_segment(prio, ord_, res, free, req, gp):
    """The segment path, C = W <= 32. -> (needed, cost, order, stats)."""
    N, W = prio.shape
    lay = PK.layout(W)
    assert lay == {"path": "segment", "threads": 256, "rows": 256 // W}
    blocks = -(-N * W // lay["threads"])
    tid = np.arange(blocks * lay["threads"]).reshape(-1, 32)
    lane = np.arange(32)[None, :]
    s = lane & (W - 1)
    base = lane - s
    row = tid // W
    live = row < N
    slot = np.where(live, row * W + s, 0)
    flat_res = res.reshape(-1, 4)

    p = np.where(live, prio.reshape(-1)[slot], 0)
    valid = live & (p < gp)
    key = np.where(valid, evict_key(p, ord_.reshape(-1)[slot]), SENTINEL)
    r = np.where(valid[..., None], flat_res[slot].astype(U64), U64(0))
    free_row = free[np.minimum(row, N - 1)]
    now = (free_row >= req).all(axis=-1)
    vbits = ballot(valid)
    pad_warp = (vbits == 0)[:, None]

    def shfl(v, src):
        return np.take_along_axis(v, np.broadcast_to(src, v.shape[:2]),
                                  axis=1) if v.ndim == 2 else \
            np.take_along_axis(v, np.broadcast_to(src, v.shape[:2])[..., None],
                               axis=1)

    # the XOR network: partners stay inside the segment
    col = np.broadcast_to(s, key.shape).copy()
    stages = 0
    k = 2
    while k <= W:
        j = k >> 1
        while j > 0:
            partner = lane ^ j
            assert ((partner - (partner & (W - 1))) == base).all()
            ok, oc = shfl(key, partner), shfl(col, partner)
            key, col = exchange(key, col, ok, oc,
                                ((s & j) == 0) == ((s & k) == 0))
            stages += 1
            j >>= 1
        k <<= 1

    # the gather from the sorted column's lane
    src = base + col
    sv = ((vbits[:, None] >> src) & 1).astype(bool)
    x_r = shfl(r, src)
    x_p = shfl(np.where(valid, p.astype(np.int64), 0).astype(U64), src)

    # the segmented inclusive scan (__shfl_up_sync, width W)
    d = 1
    while d < W:
        up = np.where(s >= d, lane - d, lane)
        y_r, y_p = shfl(x_r, up), shfl(x_p, up)
        x_r = np.where((s >= d)[..., None], x_r + y_r, x_r)
        x_p = np.where(s >= d, x_p + y_p, x_p)
        d <<= 1

    seg_mask = (1 << W) - 1
    seg_valid = (ballot(sv)[:, None] >> base) & seg_mask
    low = (2 << s) - 1  # (2u << 31) - 1 is FULL in the kernel's u32
    prefix_ok = (~seg_valid & low & FULL) == 0
    fit = live & prefix_ok & fits_after(free_row, req, x_r)
    seg_fit = (ballot(fit)[:, None] >> base) & seg_mask
    first = np.where(seg_fit != 0, ffs(seg_fit) - 1, 0)
    cprio = shfl(x_p, base + first)

    need, cost = write_result(now, seg_fit != 0, first, cprio)
    # the all-pad shortcut: columns in order, fits now or never
    pad_need, pad_cost = write_result(now, np.zeros_like(now), 0,
                                      np.zeros_like(x_p))
    col = np.where(pad_warp, s, col)
    need = np.where(pad_warp, pad_need, need)
    cost = np.where(pad_warp, pad_cost, cost)

    order = np.empty(N * W, np.int32)
    order[slot[live]] = col[live]
    head = live & (s == 0)
    needed = np.empty(N, np.int32)
    costs = np.empty(N, np.int64)
    needed[row[head]] = need[head]
    costs[row[head]] = cost[head]
    return needed, costs, order.reshape(N, W), {
        "shuffle_stages": stages, "smem_stages": 0,
        "pad_warps": int(pad_warp.sum())}


def emulate_block(prio, ord_, res, free, req, gp):
    """The block path, 64 <= C <= 1,024. -> (needed, cost, order,
    stats)."""
    N, C = prio.shape
    assert PK.layout(C) == {"path": "block", "threads": C, "rows": 1}
    NW = C // 32
    t = np.arange(C)[None, :]
    w = t >> 5
    p = prio
    valid = p < gp
    key = np.where(valid, evict_key(p, ord_), SENTINEL)
    sprio = p.copy()                       # the shared copy of the row
    now = (free >= req).all(axis=-1)
    pad_row = ~valid.any(axis=1)           # __syncthreads_or(valid) == 0

    col = np.broadcast_to(t, key.shape).copy()
    shuffles = smem = 0
    k = 2
    while k <= C:
        j = k >> 1
        while j > 0:
            partner = t ^ j
            if j >= 32:
                assert ((partner >> 5) != w).all()
                smem += 1                  # write, barrier, read
            else:
                assert ((partner >> 5) == w).all()
                shuffles += 1
            ok = np.take_along_axis(key, np.broadcast_to(partner, key.shape),
                                    axis=1)
            oc = np.take_along_axis(col, np.broadcast_to(partner, key.shape),
                                    axis=1)
            key, col = exchange(key, col, ok, oc,
                                ((t & j) == 0) == ((t & k) == 0))
            j >>= 1
        k <<= 1

    pc = np.take_along_axis(sprio, col, axis=1)
    sv = pc < gp
    x_r = np.where(sv[..., None],
                   np.take_along_axis(res, col[..., None], axis=1).astype(U64),
                   U64(0))
    x_p = np.where(sv, pc.astype(np.int64), 0).astype(U64)

    # the warp scan (shuffle-up inside each warp)
    wr = x_r.reshape(N, NW, 32, 4)
    wp = x_p.reshape(N, NW, 32)
    ln = np.arange(32)
    d = 1
    while d < 32:
        up = np.where(ln >= d, ln - d, ln)
        wr = np.where((ln >= d)[:, None], wr + wr[:, :, up], wr)
        wp = np.where(ln >= d, wp + wp[:, :, up], wp)
        d <<= 1
    # plus the totals of the warps before (shared memory, one barrier)
    tot_r, tot_p = wr[:, :, 31], wp[:, :, 31]
    before_r = np.cumsum(tot_r, axis=1, dtype=U64) - tot_r
    before_p = np.cumsum(tot_p, axis=1, dtype=U64) - tot_p
    x_r = (wr + before_r[:, :, None]).reshape(N, C, 4)
    x_p = (wp + before_p[:, :, None]).reshape(N, C)
    bad = ~ballot(sv.reshape(N, NW, 32)) & FULL
    wbad = np.where(bad != 0, np.arange(NW) * 32 + ffs(bad) - 1, C)
    first_bad = wbad.min(axis=1)

    fit = (t < first_bad[:, None]) & fits_after(free[:, None, :], req, x_r)
    fb = ballot(fit.reshape(N, NW, 32))
    wfit = np.where(fb != 0, np.arange(NW) * 32 + ffs(fb) - 1, C)
    first = wfit.min(axis=1)
    any_fit = first < C
    writer = np.where(any_fit, first, 0)
    cprio = x_p[np.arange(N), writer]
    need, cost = write_result(now, any_fit, writer, cprio)

    pad_need, pad_cost = write_result(now, np.zeros_like(now), 0,
                                      np.zeros(N, U64))
    order = np.where(pad_row[:, None], t, col).astype(np.int32)
    need = np.where(pad_row, pad_need, need)
    cost = np.where(pad_row, pad_cost, cost)
    return need, cost, order, {"shuffle_stages": shuffles,
                               "smem_stages": smem,
                               "pad_rows": int(pad_row.sum())}


def emulate(c):
    args = [c[k] for k in ("prio", "ord", "res", "free", "req")]
    fn = (emulate_segment if c["prio"].shape[1] <= PK.SEG_MAX_C
          else emulate_block)
    return fn(*args, c["gang_prio"])


@pytest.fixture(scope="module")
def jax_scorer():
    return JaxScorer()


def check(c, jax_scorer):
    needed, cost, order, stats = emulate(c)
    plain = P.victim_score_plain(
        *(torch.as_tensor(c[k]) for k in ("prio", "ord", "res", "free",
                                          "req")), c["gang_prio"])
    jax = jax_scorer.score(c["prio"], c["ord"], c["res"], c["free"],
                           c["req"], c["gang_prio"])
    for name, got, want, ref in zip(("needed", "cost", "order"),
                                    (needed, cost, order), plain, jax):
        want = want.numpy()
        assert got.dtype == want.dtype == ref.dtype, name
        assert np.array_equal(got, want), name
        assert np.array_equal(got, ref), name
    return stats


@pytest.mark.parametrize("case", S.VICTIM_CASES,
                         ids=[c[0] for c in S.VICTIM_CASES])
def test_lanes_match_plain_and_jax(case, jax_scorer):
    label, N, C, kind = case
    check(S.victim_case(N, C, 5, kind), jax_scorer)


@pytest.mark.parametrize("N,C", S.VICTIM_TAILS,
                         ids=[f"N={n} C={c}" for n, c in S.VICTIM_TAILS])
def test_row_tails_match(N, C, jax_scorer):
    """Rows that end inside a warp: the lanes past the last row stay in
    the shuffles and write nothing."""
    assert N % (32 // C)
    check(S.victim_case(N, C, 11, "fuzz"), jax_scorer)


@pytest.mark.parametrize("C", (1, 2, 4))
def test_narrow_segments_match(C, jax_scorer):
    """C below pack_candidates' floor of 8 takes the segment path too."""
    check(S.victim_case(37, C, 13, "fuzz"), jax_scorer)


@pytest.mark.parametrize("kind", ("fuzz", "density", "all_invalid"))
def test_all_pad_shortcut(kind, jax_scorer):
    """Pad rows (no candidate) skip the sort: a warp of the segment path
    whose rows hold none, and a row of the block path, keep the columns
    in order; mixed warps run the network."""
    c = S.victim_case(200, 8, 17, kind)
    c["prio"][120:] = P.INVALID_PRIO
    stats = check(c, jax_scorer)
    assert stats["pad_warps"] >= (200 - 124) // 4
    c = S.victim_case(24, 64, 17, kind)
    c["prio"][::3] = P.INVALID_PRIO
    assert check(c, jax_scorer)["pad_rows"] >= 8


@pytest.mark.parametrize("C", (64, 128, 256, 512, 1024))
def test_block_path_stage_split(C, jax_scorer):
    """Only the sort stages with j >= 32 cross warps (shared memory, one
    barrier each): 3 at C = 128, 15 at C = 1,024; the rest shuffle."""
    stats = check(S.victim_case(4, C, 19, "fuzz"), jax_scorer)
    log = C.bit_length() - 1
    total = log * (log + 1) // 2
    assert stats["smem_stages"] == sum(k - 5 for k in range(6, log + 1))
    assert stats["shuffle_stages"] == total - stats["smem_stages"]


@pytest.mark.parametrize("C", (8, 16, 32))
def test_segment_path_shuffles_every_stage(C, jax_scorer):
    """All log2(C) (log2(C) + 1) / 2 sort stages by shuffles inside the
    segment, none through shared memory."""
    stats = check(S.victim_case(70, C, 23, "ties"), jax_scorer)
    log = C.bit_length() - 1
    assert stats["shuffle_stages"] == log * (log + 1) // 2
    assert stats["smem_stages"] == 0
