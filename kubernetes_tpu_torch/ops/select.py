"""Deterministic host selection.

PyTorch counterpart of kubernetes_tpu/ops/select.py.
generic_scheduler.go:119 selectHost: sort by (score desc, host-name desc)
then pick index lastNodeIndex % numTies among the max-score prefix. No
sort: the precomputed name-descending permutation and a masked
cumulative count find the (r+1)-th tied node in name-desc order. O(N).
"""

from __future__ import annotations

import torch

MIN_INT64 = -(2**63)


def select_host(scores, fit_mask, last_node_index, name_desc_order):
    """Returns (chosen node index or -1, scheduled: bool), both 0-d
    tensors on the scores' device (no host sync).

    scores: i64[N] combined weighted score
    fit_mask: bool[N]
    last_node_index: i64 0-d tensor (the round-robin counter)
    name_desc_order: i64[N] node indices sorted by name descending
    """
    max_score = torch.where(fit_mask, scores, MIN_INT64).max()
    any_fit = fit_mask.any()
    # `fit &` keeps a real minInt64 score (the spread-NaN case) selectable
    # while still excluding filtered-out nodes.
    ties = fit_mask & (scores == max_score)
    num_ties = ties.sum()
    r = torch.remainder(last_node_index, num_ties.clamp(min=1))
    ties_by_name = ties[name_desc_order]  # name-desc positions
    cum = torch.cumsum(ties_by_name.to(torch.int64), dim=0)
    # argmax of an integer mask (CUDA argmax takes no bool); exactly one
    # position is set when any node fits
    pick_pos = torch.argmax((ties_by_name & (cum == r + 1)).to(torch.int32))
    # take, not [pick_pos]: indexing by a 0-d device tensor reads it on
    # the host (a sync per step)
    chosen = torch.take(name_desc_order, pick_pos)
    return torch.where(any_fit, chosen, -1), any_fit
