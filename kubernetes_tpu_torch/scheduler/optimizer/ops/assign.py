"""Device joint-assignment solver: the wave as a [pods x nodes] tensor.

PyTorch counterpart of kubernetes_tpu/scheduler/optimizer/ops/assign.py.
The greedy wave driver decides pods one at a time (bit-identical to the
serial oracle). The optimizing profile instead treats a whole wave's
optimizer-eligible slots as ONE assignment problem over the same
feasibility and score tables the probe already produces:

  * ``fit`` bool[P, N] — the probe's static fit mask per slot (every
    configured predicate except resources, which the solver enforces
    itself from the request/commit vectors),
  * ``score`` i64[P, N] — the probed j=0 priority score per slot,
  * ``req``/``commit`` i64[P, 4] and ``cap`` i64[N, 4] — the exact
    integer resource math of ops/predicates.pod_fits_resources
    (mcpu, mem bytes, devices, pod slots; ``check`` masks the rows a
    zero-request pod skips, preserving the predicate's order quirk).

Two solvers, each ONE device dispatch per wave:

``auction``: Bertsekas-style auction rounds. Per round every unassigned
slot bids its top-utility node (price-adjusted score; epsilon scaling
halves the increment each round down to 1), the highest composite bid
per node wins a seat, prices rise by the winning bid. Priority tiers
occupy the high bits of the bid key, so a contested node always goes to
the higher tier first; a deterministic (slot + node) % N tie rotation
spreads equal-score bids across nodes.

``beam``: top-K beam over slots in solve order (small waves): each step
expands every beam by its top-C feasible nodes plus an explicit skip
branch and keeps the K best partial assignments by accumulated score,
with a large per-skip penalty, so the beam maximizes placements first
and score second.

The plain versions below (_auction_assign_fn, _beam_assign_fn) compute
the JAX programs' functions in torch ops, int64 throughout with the
owner int32, on any device; the JAX package's argmaxes take the first
maximum (torch.argmax does too) and its lax.top_k puts the lower index
first among equal values, which a stable descending torch.sort gives
(torch.topk does not promise it). On the card the solve is the CUDA
kernel K7 (ops/assign_kernel.py, csrc/assign_kernel.cu): AssignSolver
ships the solve's tables in one transfer and launches it; on the CPU it
runs the plain versions. Neither solver is trusted for validity: the
host re-validates every proposed placement against the serial
predicates before commit (scheduler/optimizer/profile.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

I32 = torch.int32
I64 = torch.int64

#: resource rows of the req/commit/cap tables, in order
RES_ROWS = 4  # mcpu, mem bytes, devices, pod slots

#: "no utility" sentinel; far below any real price-adjusted score
_NEG = np.int64(-1) << 60

#: beam skip penalty: one skipped slot outweighs any score difference,
#: so the beam maximizes placement count before score
_SKIP_PENALTY = np.int64(1) << 40


def _fits_res(used, req, cap, check):
    """used + req <= cap on every checked resource row, over the trailing
    axis (broadcast shapes [..., 4]) -> bool[...]."""
    return torch.where(check, used + req <= cap, True).all(dim=-1)


def _auction_assign_fn(rounds, fit, score, req, commit, check, cap,
                       prio, order, eps0):
    """fit bool[P, N], score i64[P, N], req/commit i64[P, 4],
    check bool[P, 4], cap i64[N, 4] (free capacity at wave start),
    prio i32[P], order i32[P] (FIFO rank, tiebreak), eps0 int
    -> owner i32[P] (node id per slot, -1 unassigned). The plain
    version of kubernetes_tpu/scheduler/optimizer/ops/assign.py
    _auction_assign_fn: its lax.scan as a loop of `rounds` rounds."""
    P, N = score.shape
    dev = score.device
    neg = int(_NEG)
    # order-preserving tie rotation: equal scores resolve to distinct
    # nodes per slot, so a template's slots fan out in one round
    rot = (torch.arange(P, dtype=I64, device=dev)[:, None]
           + torch.arange(N, dtype=I64, device=dev)[None, :]) % max(N, 1)
    score_tb = score * N + rot
    n_ids = torch.arange(N, dtype=I64, device=dev)
    p_ids = torch.arange(P, dtype=I64, device=dev)
    prio_key = prio.to(I64).clamp(0, (1 << 14) - 1) * (1 << 48)
    rank_key = (P - order.to(I64)).clamp(0, (1 << 16) - 1)
    price = torch.zeros((N,), dtype=I64, device=dev)
    owner = torch.full((P,), -1, dtype=I32, device=dev)
    used = torch.zeros((N, RES_ROWS), dtype=I64, device=dev)
    for t in range(rounds):
        unassigned = owner < 0
        # exact resource feasibility at the CURRENT tentative usage
        fits_res = _fits_res(used[None, :, :], req[:, None, :],
                             cap[None, :, :], check[:, None, :])  # [P, N]
        feas = fit & fits_res & unassigned[:, None]
        util = torch.where(feas, score_tb - price[None, :], neg)
        v1 = util.max(dim=1).values
        n1 = util.argmax(dim=1)  # the slot's bid target (first maximum)
        mask1 = n_ids[None, :] == n1[:, None]
        v2 = torch.where(mask1, neg, util).max(dim=1).values
        # epsilon scaling; the shift amount clamps at 62
        eps = max(1, int(eps0) >> min(t, 62))
        bid = torch.where(v2 > neg, v1 - v2, 0) + eps
        valid = v1 > neg
        # composite winner key: priority tier, then bid, then FIFO rank
        key = prio_key + bid.clamp(0, (1 << 31) - 1) * (1 << 16) + rank_key
        key = torch.where(valid, key, neg)
        # per-node winner via one-hot max: a slot bids on exactly one
        # node, so it can win at most one seat per round
        keyed = torch.where(mask1 & valid[:, None], key[:, None], neg)
        win_key = keyed.max(dim=0).values  # [N]
        win_p = keyed.argmax(dim=0)  # [N], the first maximum
        win_valid = win_key > neg
        won = win_valid[n1] & (win_p[n1] == p_ids)
        owner = torch.where(won & unassigned, n1.to(I32), owner)
        used = used + torch.where(win_valid[:, None], commit[win_p], 0)
        price = price + torch.where(win_valid, bid[win_p].clamp(min=1), 0)
    return owner


def _top_desc(x, k):
    """lax.top_k over the last axis: the k largest values in descending
    order, the lower index first among equal values -> (values,
    indices)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _beam_assign_fn(K, C, fit, score, req, commit, check, cap):
    """Top-K beam over slots in solve order (arrays arrive pre-permuted
    by priority/demand): -> owner i32[P]. The plain version of
    kubernetes_tpu/scheduler/optimizer/ops/assign.py _beam_assign_fn:
    its lax.scan over the P steps as a loop; each step expands K beams
    by their top-C feasible nodes plus a skip branch and keeps the K
    best by accumulated score."""
    P, N = score.shape
    dev = score.device
    neg = int(_NEG)
    C_eff = min(C, N)
    used = torch.zeros((K, N, RES_ROWS), dtype=I64, device=dev)
    # beam 0 starts live; the clones start at -inf so step 1's top-K
    # picks distinct successors instead of K copies of one path
    acc = torch.where(torch.arange(K, device=dev) == 0,
                      torch.zeros((), dtype=I64, device=dev),
                      torch.full((), -(1 << 59), dtype=I64, device=dev))
    choice = torch.full((K, P), -1, dtype=I32, device=dev)
    n_ids = torch.arange(N, device=dev)
    for p in range(P):
        fits_res = _fits_res(used, req[p][None, None, :], cap[None, :, :],
                             check[p][None, None, :])  # [K, N]
        feas = fit[p][None, :] & fits_res
        util = torch.where(feas, score[p][None, :], neg)
        cand_v, cand_n = _top_desc(util, C_eff)  # [K, C]
        assign_scores = acc[:, None] + torch.where(cand_v > neg, cand_v,
                                                   -(1 << 58))
        skip_scores = (acc - int(_SKIP_PENALTY))[:, None]
        succ = torch.cat([assign_scores, skip_scores], dim=1)
        top_v, top_i = _top_desc(succ.reshape(K * (C_eff + 1)), K)
        parent = top_i // (C_eff + 1)
        slot = top_i % (C_eff + 1)
        is_assign = slot < C_eff
        slot_c = slot.clamp(max=C_eff - 1)
        picked_v = cand_v[parent, slot_c]
        feas_pick = is_assign & (picked_v > neg)
        node = torch.where(feas_pick, cand_n[parent, slot_c], -1)
        add = torch.where(
            feas_pick[:, None, None]
            & (n_ids[None, :, None] == node[:, None, None]),
            commit[p][None, None, :], 0)
        used = used[parent] + add
        choice = choice[parent].clone()
        choice[:, p] = node.to(I32)
        acc = top_v
    return choice[int(torch.argmax(acc))]


def auction_rounds(P: int, N: int) -> int:
    """Static scan length: each round seats at most one slot per node,
    so ~P/N rounds clear an uncontended wave; the 8x headroom plus the
    16-round floor covers contention. Slots still unassigned after the
    horizon fall back to the greedy scan (the profile's safety net)."""
    import math

    return int(min(max(P, 1),
                   max(16, 8 * math.ceil(P / max(N, 1)))))


def auction_eps0(score: np.ndarray, N: int) -> int:
    """The auction's first epsilon, from the score span (the JAX solve's
    host arithmetic, as Python ints)."""
    score_span = int(max(int(score.max(initial=0))
                         - int(score.min(initial=0)), 1))
    return max(1, (score_span * N) // 8)


class AssignSolver:
    """Dispatcher for the assignment solvers on `device`.

    Slot and node axes arrive pow2-bucketed (padded slots carry an
    all-False fit row and can never be assigned). On a CUDA device a
    solve ships its tables in one packed transfer (models/pack.Packer)
    and launches K7 (ops/assign_kernel.py) once; on the CPU it runs the
    plain versions. The JAX solver caches one compiled program per
    shape; the port compiles nothing per shape."""

    #: waves at or under this many slots take the beam (sequential but
    #: near-exhaustive); larger waves take the auction
    BEAM_MAX_SLOTS = 32

    def __init__(self, device="cuda"):
        from kubernetes_tpu_torch.models.pack import Packer

        self.device = torch.device(device)
        self._packer = Packer(self.device)

    def solve(self, fit: np.ndarray, score: np.ndarray, req: np.ndarray,
              commit: np.ndarray, check: np.ndarray, cap: np.ndarray,
              prio: np.ndarray, order: np.ndarray,
              n_real_slots: int) -> Tuple[np.ndarray, str]:
        """-> (owner i32[P] in slot order, solver name). ONE device
        dispatch. ``n_real_slots`` picks beam vs auction by the real
        (unpadded) wave size."""
        from kubernetes_tpu_torch.scheduler.optimizer.ops import (
            assign_kernel as AK,
        )

        P, N = fit.shape
        t = self._packer.ship({
            "fit": fit, "score": score, "req": req, "commit": commit,
            "check": check, "cap": cap, "prio": prio, "order": order})
        if n_real_slots <= self.BEAM_MAX_SLOTS:
            owner = AK.beam_assign(t["fit"], t["score"], t["req"],
                                   t["commit"], t["check"], t["cap"])
            return owner.cpu().numpy(), "beam"
        owner = AK.auction_assign(
            t["fit"], t["score"], t["req"], t["commit"], t["check"],
            t["cap"], t["prio"].to(I32), t["order"].to(I32),
            auction_eps0(score, N), auction_rounds(P, N))
        return owner.cpu().numpy(), "auction"
