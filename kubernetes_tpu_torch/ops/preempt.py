"""Victim selection for gang priority preemption, on tensors.

PyTorch counterpart of kubernetes_tpu/ops/preempt.py. When a
high-priority gang parks, the director (scheduler/gang.py) scores
eviction victims among STRICTLY lower-priority bound pods, per node:

  1. the node's candidates sort by the eviction key (priority
     ascending, creation ordinal descending: the lowest tier first, the
     newest pod first within a tier),
  2. freed resources prefix-sum along the sorted axis,
  3. ``victims_needed[n]`` = the shortest prefix whose freed capacity
     fits one gang member on node n (0 = fits already, -1 = impossible
     even evicting every candidate), and
  4. ``cost[n]`` = the summed victim priorities of that prefix.

- victim_score_plain: the JAX package's `_victim_score_fn` in plain
  torch ops (a stable argsort, cumsums, an argmax of the first fitting
  prefix), the same three outputs with the same dtypes. The CPU tests
  hold it against the JAX function; chip_smoke.py holds the kernel
  against it.
- ops/preempt_kernel.victim_score: the wrapper of the CUDA kernel K6
  (csrc/preempt_kernel.cu), which takes this plain version only for CPU
  tensors.
- VictimScorer(device): the director's dispatcher, numpy in and out as
  the JAX package's VictimScorer.
- INVALID_PRIO, RES_ROWS and pack_candidates are copies of the JAX
  module's (pack_candidates imports next_pow2 from this package).

Integer-only math: the composite key prio * 2^32 + (2^32 - 1 - ord) is
int64 (it reaches 2^63 - 1 at INVALID_PRIO), the invalid-key and
impossible-cost sentinels are 1 << 62, and every sum wraps as int64.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

I32 = torch.int32
I64 = torch.int64

#: priority slot marking an unused candidate column (pad); any real
#: priority is below it, so padded slots sort last and never count
INVALID_PRIO = (1 << 31) - 1

#: resource rows of the candidate/free tables, in order
RES_ROWS = 4  # mcpu, mem bytes, devices, pod slots

#: the sort key of an invalid slot and the cost of an impossible node
SENTINEL = 1 << 62


def victim_score_plain(prio, ord_, res, free, req, gang_prio):
    """prio i32[N, C], ord i32[N, C], res i64[N, C, 4] (freed per
    candidate), free i64[N, 4], req i64[4], gang_prio int ->
    (victims_needed i32[N], cost i64[N], order i32[N, C]), on the
    tensors' device."""
    N, C = prio.shape
    device = prio.device
    # the invariant lives HERE: only strictly-lower-priority candidates
    # are ever sortable into a usable prefix
    valid = prio < int(gang_prio)
    key = prio.to(I64) * (1 << 32) + ((1 << 32) - 1 - ord_.to(I64))
    key = torch.where(valid, key, SENTINEL)
    # jnp.argsort is stable: equal keys keep their column order
    order = torch.argsort(key, dim=1, stable=True)
    sorted_valid = torch.gather(valid, 1, order)
    sorted_res = torch.gather(
        res, 1, order[:, :, None].expand(N, C, res.shape[2]))
    sorted_res = torch.where(sorted_valid[:, :, None], sorted_res, 0)
    sorted_prio = torch.gather(prio, 1, order)
    cum = torch.cumsum(sorted_res, dim=1)  # freed after c+1 evictions
    # a prefix is usable only while every slot in it is a real victim
    prefix_ok = torch.cumsum(sorted_valid.to(I32), dim=1) == torch.arange(
        1, C + 1, dtype=I64, device=device)[None, :]
    fits_after = torch.all(
        free[:, None, :] + cum >= req[None, None, :], dim=2) & prefix_ok
    fits_now = torch.all(free >= req[None, :], dim=1)
    any_fit = torch.any(fits_after, dim=1)
    # jnp.argmax of a bool row: the first True, or 0 when there is none
    first = torch.argmax(fits_after.to(I32), dim=1)
    victims_needed = torch.where(
        fits_now, 0, torch.where(any_fit, first + 1, -1)).to(I32)
    cum_prio = torch.cumsum(
        torch.where(sorted_valid, sorted_prio.to(I64), 0), dim=1)
    prefix_cost = torch.gather(cum_prio, 1, first[:, None])[:, 0]
    cost = torch.where(
        victims_needed > 0, prefix_cost,
        torch.where(victims_needed == 0, 0, SENTINEL).to(I64))
    return victims_needed, cost, order.to(I32)


class VictimScorer:
    """The director's victim-scoring dispatcher: numpy tables in, numpy
    (needed, cost, order) out, as kubernetes_tpu/ops/preempt.py
    VictimScorer. The tables are placed on `device` (the card unless the
    caller passes "cpu") and scored there by ops/preempt_kernel.
    victim_score: K6 on the card, its plain version on the CPU."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "VictimScorer: CUDA is not available; pass device='cpu' to "
                "score on the CPU")

    def score(self, prio: np.ndarray, ord_: np.ndarray, res: np.ndarray,
              free: np.ndarray, req: np.ndarray, gang_prio: int):
        from kubernetes_tpu_torch.ops.preempt_kernel import victim_score

        def put(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a)).to(
                device=self.device, dtype=dtype)

        needed, cost, order = victim_score(
            put(prio, I32), put(ord_, I32), put(res, I64), put(free, I64),
            put(req, I64), int(gang_prio))
        return (needed.cpu().numpy(), cost.cpu().numpy(),
                order.cpu().numpy())


def pack_candidates(node_names, candidates, floor_nodes: int = 64,
                    floor_cands: int = 8):
    """Host-side table build (the encode step): group victim candidates
    by node into padded [N, C] arrays.

    candidates: [(node_name, priority, ordinal, (mcpu, mem, dev, 1))].
    Returns (prio i32[N, C], ord i32[N, C], res i64[N, C, 4],
    node_index {name: row}) with both axes pow2-bucketed so repeated
    preemption rounds reuse one compiled program."""
    from kubernetes_tpu_torch.snapshot.pad import next_pow2

    node_index = {nm: i for i, nm in enumerate(node_names)}
    per_node: Dict[int, list] = {}
    for nm, pr, od, res in candidates:
        i = node_index.get(nm)
        if i is not None:
            per_node.setdefault(i, []).append((pr, od, res))
    N = next_pow2(max(len(node_names), 1), floor=floor_nodes)
    C = next_pow2(
        max(max((len(v) for v in per_node.values()), default=1), 1),
        floor=floor_cands,
    )
    prio = np.full((N, C), INVALID_PRIO, np.int32)
    ordn = np.zeros((N, C), np.int32)
    res = np.zeros((N, C, RES_ROWS), np.int64)
    for i, cands in per_node.items():
        for c, (pr, od, rr) in enumerate(cands[:C]):
            prio[i, c] = pr
            ordn[i, c] = od
            res[i, c] = rr
    return prio, ordn, res, node_index
