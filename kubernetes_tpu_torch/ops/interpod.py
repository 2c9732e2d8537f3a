"""Inter-pod (anti-)affinity on tensors.

PyTorch counterpart of kubernetes_tpu/ops/interpod.py. Counts live in
small (term-class, domain) tables threaded through the scan's carry;
queries gather each node's domain id and expand logical terms by
inclusion-exclusion (snapshot/interpod.py compiles them). Everything is
integer arithmetic, bit-identical to the oracle (predicates.go:754-947,
interpod_affinity.go:86-216). Zero-width tables (no affinity anywhere in
the workload) short-circuit to zeros.
"""

from __future__ import annotations

import torch

I64 = torch.int64


def _arange(n, like):
    return torch.arange(n, device=like.device)


def gather_counts(table, u_topo, topo_dom):
    """table (U, D) -> per-node counts (U, N): table[u, topo_dom[q(u), n]],
    0 where the node has no valid domain for the combo."""
    U = table.shape[0]
    N = topo_dom.shape[1] if topo_dom.dim() == 2 else 0
    if U == 0:
        return torch.zeros((0, N), dtype=table.dtype, device=table.device)
    dom = topo_dom[u_topo]  # (U, N)
    safe = dom.clamp(0, table.shape[1] - 1)
    vals = table[_arange(U, table)[:, None], safe]
    return torch.where(dom >= 0, vals, 0)


def expand_lt(cnt_u, lt_u, lt_sign, num_nodes):
    """(U, N) counts -> (LT, N) signed logical-term counts."""
    LT = lt_u.shape[0]
    if LT == 0 or cnt_u.shape[0] == 0:
        return torch.zeros((LT, num_nodes), dtype=cnt_u.dtype,
                           device=cnt_u.device)
    picked = cnt_u[lt_u.clamp(0, cnt_u.shape[0] - 1)]  # (LT, E, N)
    signed = picked * lt_sign[:, :, None].to(picked.dtype)
    return torch.where((lt_u >= 0)[:, :, None], signed, 0).sum(dim=1)


def gather_lt(table, u_topo, topo_dom, lt_u, lt_sign):
    """Owned-term table (LT, E, D) -> (LT, N) signed per-node sums.

    Slot e of logical term lt holds counts/weights of owners at their
    node's domain under combo q = u_topo[lt_u[lt, e]]; the query reads the
    candidate node's domain column and applies the inclusion-exclusion
    sign."""
    LT, E = lt_u.shape
    N = topo_dom.shape[1] if topo_dom.dim() == 2 else 0
    if LT == 0 or u_topo.shape[0] == 0:
        return torch.zeros((LT, N), dtype=table.dtype, device=table.device)
    q = u_topo[lt_u.clamp(0, u_topo.shape[0] - 1)]  # (LT, E)
    dom = topo_dom[q]  # (LT, E, N)
    safe = dom.clamp(0, table.shape[2] - 1)
    vals = torch.gather(table, 2, safe)  # (LT, E, N)
    valid = (lt_u >= 0)[:, :, None] & (dom >= 0)
    signed = vals * lt_sign[:, :, None].to(vals.dtype)
    return torch.where(valid, signed, 0).sum(dim=1)


def match_interpod(
    cnt_lt,  # (LT, N) from term_count
    own_lt,  # (LT, N) from own_anti
    spec_total,  # (S,) carry
    lt_spec,  # (LT,)
    pod_match_spec,  # (S,) this pod's spec-match bits
    pod_ha_lt,  # (TA,)
    pod_ha_self,  # (TA,)
    pod_hq_lt,  # (TQ,)
    pod_has_affinity,  # 0-d bool
    pod_has_anti,
    pod_sym_reject,
    num_nodes,
):
    """MatchInterPodAffinity (predicates.go:769) -> bool (N,)."""
    LT = lt_spec.shape[0]
    ones = torch.ones((num_nodes,), dtype=torch.bool, device=cnt_lt.device)
    # hard affinity: every term needs a co-located match, OR the
    # first-pod-of-collection escape (predicates.go:819-843)
    if LT and pod_ha_lt.shape[0]:
        valid = pod_ha_lt >= 0  # (TA,)
        idx = pod_ha_lt.clamp(0, LT - 1)
        cnt = cnt_lt[idx]  # (TA, N)
        none_anywhere = spec_total[lt_spec[idx]] == 0  # (TA,)
        ok = (cnt > 0) | (pod_ha_self & none_anywhere)[:, None]
        aff_ok = (ok | ~valid[:, None]).all(dim=0)
    else:
        aff_ok = ones
    # own hard anti-affinity: no co-located match allowed
    if LT and pod_hq_lt.shape[0]:
        valid = pod_hq_lt >= 0
        cnt = cnt_lt[pod_hq_lt.clamp(0, LT - 1)]
        anti_ok = ~((cnt > 0) & valid[:, None]).any(dim=0)
    else:
        anti_ok = ones
    # symmetric: an assigned pod owns a hard anti term matching this pod
    # and is co-located (predicates.go:858-921)
    if LT:
        pend = pod_match_spec[lt_spec] > 0  # (LT,)
        sym_ok = ~((own_lt > 0) & pend[:, None]).any(dim=0)
    else:
        sym_ok = ones
    fit = aff_ok | ~pod_has_affinity
    return fit & ((anti_ok & sym_ok & ~pod_sym_reject) | ~pod_has_anti)


def interpod_priority(
    cnt_lt,  # (LT, N) from term_count
    rev_hard_lt,  # (LT, N)
    rev_pref_lt,  # (LT, N) i64
    rev_anti_lt,  # (LT, N) i64
    lt_spec,
    pod_match_spec,
    pod_fwd_lt,  # (TF,)
    pod_fwd_w,  # (TF,) signed i64
    hard_weight,  # python int (config)
    fit,
    num_nodes,
):
    """InterPodAffinityPriority (interpod_affinity.go:86-216) -> i64 (N,):
    the totals normalized 10*(t-min)/(max-min) over the FIT nodes with
    min<=0<=max pinned (Go's ints start at 0), truncated toward zero."""
    total = interpod_totals(
        cnt_lt, rev_hard_lt, rev_pref_lt, rev_anti_lt, lt_spec,
        pod_match_spec, pod_fwd_lt, pod_fwd_w, hard_weight, num_nodes,
    )
    mx, mn = interpod_minmax(total, fit)
    return interpod_normalize(total, fit, mx, mn)


def interpod_totals(
    cnt_lt,
    rev_hard_lt,
    rev_pref_lt,
    rev_anti_lt,
    lt_spec,
    pod_match_spec,
    pod_fwd_lt,
    pod_fwd_w,
    hard_weight,
    num_nodes,
):
    LT = lt_spec.shape[0]
    total = torch.zeros((num_nodes,), dtype=I64, device=cnt_lt.device)
    if LT and pod_fwd_lt.shape[0]:
        valid = pod_fwd_lt >= 0
        cnt = cnt_lt[pod_fwd_lt.clamp(0, LT - 1)].to(I64)
        total = total + ((pod_fwd_w * valid)[:, None] * cnt).sum(dim=0)
    if LT:
        pend = (pod_match_spec[lt_spec] > 0)[:, None]  # (LT, 1)
        total = total + int(hard_weight) * torch.where(
            pend, rev_hard_lt.to(I64), 0).sum(dim=0)
        total = total + torch.where(pend, rev_pref_lt, 0).sum(dim=0)
        total = total - torch.where(pend, rev_anti_lt, 0).sum(dim=0)
    return total


def interpod_minmax(total, fit):
    """Go's max/min ints start at 0 (interpod_affinity.go:96-97)."""
    big = 2**62
    mx = torch.where(fit, total, -big).max().clamp(min=0)
    mn = torch.where(fit, total, big).min().clamp(max=0)
    return mx, mn


def interpod_normalize(total, fit, mx, mn):
    rng = mx - mn
    f = torch.where(
        rng > 0,
        10.0 * ((total - mn).to(torch.float64) / rng.to(torch.float64)),
        0.0,
    )
    return torch.where(fit, f.to(I64), 0)


def interpod_commit(
    term_count,
    own_anti,
    rev_hard,
    rev_pref,
    rev_anti,
    spec_total,
    topo_dom,
    u_topo,
    u_spec,
    lt_u,
    pod_match_spec,
    pod_own_hard,
    pod_own_pref,
    pod_own_anti_hard,
    pod_own_anti_pref,
    chosen,
    scheduled,
):
    """Fold a committed pod into the counting tables in place (the
    AssumePod analogue for affinity state). Every scatter writes each
    index once, so accumulate=True is exact."""
    U = u_topo.shape[0]
    safe_n = chosen.clamp(min=0)
    inc = scheduled.to(I64)
    if U:
        dom = topo_dom[u_topo, safe_n]  # (U,)
        valid = (dom >= 0).to(I64) * inc
        sd = dom.clamp(0, term_count.shape[1] - 1)
        mu = pod_match_spec[u_spec].to(I64)
        term_count.index_put_((_arange(U, sd), sd), mu * valid,
                              accumulate=True)
    LT, E = lt_u.shape
    if LT and U:
        q = u_topo[lt_u.clamp(0, U - 1)]  # (LT, E)
        domq = topo_dom[q, safe_n]  # (LT, E)
        validq = ((lt_u >= 0) & (domq >= 0)).to(I64) * inc
        sdq = domq.clamp(0, own_anti.shape[2] - 1)
        index = (_arange(LT, sdq)[:, None].expand(LT, E),
                 _arange(E, sdq)[None, :].expand(LT, E), sdq)
        own_anti.index_put_(index, pod_own_anti_hard[:, None] * validq,
                            accumulate=True)
        rev_hard.index_put_(index, pod_own_hard[:, None] * validq,
                            accumulate=True)
        rev_pref.index_put_(index, pod_own_pref[:, None] * validq,
                            accumulate=True)
        rev_anti.index_put_(index, pod_own_anti_pref[:, None] * validq,
                            accumulate=True)
    if spec_total.shape[0]:
        spec_total += pod_match_spec.to(I64) * inc
