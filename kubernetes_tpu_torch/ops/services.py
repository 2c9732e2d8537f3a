"""ServiceAffinity / ServiceAntiAffinity on tensors (see
snapshot/services.py for the compilation).

PyTorch counterpart of kubernetes_tpu/ops/services.py: the same four
functions, one pending pod against all N nodes, on whatever device the
tensors lie. The service tables arrive widened to int64 (snapshot/
carry.place); the per-value histogram of ServiceAntiAffinity is taken in
int32, as the reference takes it, and its score in float32 operation by
operation, then truncated. The commits update the carry in place, as
ops/interpod.interpod_commit does; integer scatter-adds are exact in any
order, so they are deterministic on CUDA.
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch.snapshot.services import ORD_NONE

MAX_PRIORITY = 10
I64 = torch.int64
F32 = torch.float32


def service_affinity(
    first_peer,  # (G,) carry
    lbl_val,  # (L, N) static
    ord_node,  # (ORD,) static
    pod_group,  # 0-d
    pod_fixed,  # (L,)
    label_rows,  # tuple of row indices into lbl_val for this predicate
    num_nodes,
):
    """predicates.go:596 ServiceAffinity -> bool (N,).

    For each config label: a value pinned by the pod's nodeSelector wins;
    otherwise the first peer's node supplies it (when that node carries
    the label); otherwise the label is unconstrained. A first peer on an
    unknown/None node fails every candidate (the oracle's GetNodeInfo
    error branch), but only when some label is unresolved (the oracle's
    'if unresolved:' gate)."""
    ok = torch.ones((num_nodes,), dtype=torch.bool, device=lbl_val.device)
    G = first_peer.shape[0]
    if G == 0 or not label_rows:
        # no groups compiled: only nodeSelector-pinned labels constrain
        for li in label_rows:
            fixed = pod_fixed[li]
            ok = ok & ((fixed < 0) | (lbl_val[li] == fixed))
        return ok
    has_group = pod_group >= 0
    peer_ord = first_peer[pod_group.clamp(0, G - 1)]
    has_peer = has_group & (peer_ord != int(ORD_NONE))
    peer_row = ord_node[peer_ord.clamp(0, ord_node.shape[0] - 1)]
    safe_row = peer_row.clamp(0, num_nodes - 1)
    any_unresolved = torch.zeros((), dtype=torch.bool, device=ok.device)
    for li in label_rows:
        fixed = pod_fixed[li]
        any_unresolved = any_unresolved | (fixed < 0)
        peer_val = lbl_val[li, safe_row]
        req = torch.where(
            fixed >= 0,
            fixed,
            torch.where(has_peer & (peer_row >= 0) & (peer_val >= 0),
                        peer_val, -1),
        )
        ok = ok & ((req < 0) | (lbl_val[li] == req))
    peer_bad = has_peer & (peer_row < 0) & any_unresolved
    return ok & ~peer_bad


def service_anti_affinity(
    peer_node_count,  # (G, N) carry
    peer_total,  # (G,) carry
    lbl_val_row,  # (N,) static: value ids under the config label
    pod_group,  # 0-d
    fit,  # (N,) bool
    num_values: int,
    num_nodes: int,
):
    """selector_spreading.go:244 ServiceAntiAffinity -> i64 (N,).

    Spread the pod's service peers across values of a node label:
    labeled nodes score 10*(total - peers_at_their_value)/total (float32
    then truncate, matching Go), unlabeled nodes score 0. Peers are
    counted only on labeled FIT nodes (the reference builds labeledNodes
    from the filtered node list)."""
    G = peer_node_count.shape[0]
    labeled = lbl_val_row >= 0
    if G == 0 or num_values == 0:
        return torch.where(labeled, MAX_PRIORITY, 0).to(I64)
    g = pod_group.clamp(0, G - 1)
    has_group = pod_group >= 0
    counts_row = torch.where(has_group, peer_node_count[g], 0)  # (N,)
    total = torch.where(has_group, peer_total[g], 0)
    eligible = fit & labeled
    vidx = lbl_val_row.clamp(0, num_values - 1)
    by_value = torch.zeros((num_values,), dtype=torch.int32,
                           device=lbl_val_row.device)
    by_value.index_add_(0, vidx,
                        torch.where(eligible, counts_row, 0).to(torch.int32))
    at_node = by_value[vidx].to(I64)
    ten = torch.full((), float(MAX_PRIORITY), dtype=F32,
                     device=by_value.device)
    f = torch.where(
        total > 0,
        ten * ((total - at_node).to(F32) / total.to(F32)),
        ten,
    )
    return torch.where(labeled, f.to(I64), 0)


def service_commit(first_peer, peer_node_count, peer_total, node_ord,
                   pod_member, chosen, scheduled):
    """Fold a committed pod into the peer state, in place.
    -> (first_peer, peer_node_count, peer_total)."""
    G = first_peer.shape[0]
    if G == 0:
        return first_peer, peer_node_count, peer_total
    safe = chosen.clamp(min=0).view(1)
    inc = ((pod_member > 0) & scheduled).to(I64)  # (G,)
    peer_node_count.index_add_(1, safe, inc[:, None])
    peer_total += inc
    this_ord = node_ord[safe[0]]
    torch.minimum(first_peer,
                  torch.where(inc > 0, this_ord, int(ORD_NONE)),
                  out=first_peer)
    return first_peer, peer_node_count, peer_total


def service_commit_bulk(first_peer, peer_node_count, peer_total, node_ord,
                        pod_member, counts):
    """service_commit folded over a run's per-node commit COUNTS (the
    wave apply form), in place: peers land per node, totals grow by the
    commit sum, and the group's first peer is the MIN order index over
    committed nodes. -> (first_peer, peer_node_count, peer_total)."""
    G = first_peer.shape[0]
    if G == 0:
        return first_peer, peer_node_count, peer_total
    inc = (pod_member > 0).to(I64)  # (G,)
    peer_node_count += inc[:, None] * counts[None, :]
    peer_total += inc * counts.sum()
    min_ord = torch.where(counts > 0, node_ord, int(ORD_NONE)).min()
    torch.minimum(first_peer,
                  torch.where(inc > 0, min_ord, int(ORD_NONE)),
                  out=first_peer)
    return first_peer, peer_node_count, peer_total
