"""Device replay: a zoned run's pick sequence without a host round trip
per pick.

PyTorch counterpart of kubernetes_tpu/models/zreplay.py. The host
replays (models/replay.py's C engine and numpy spec) assume scores
decompose into per-node functions of that node's commit count. The
zone-blended SelectorSpread breaks that: every commit re-weights a whole
zone, so the C engine can't bucket and the numpy spec replay rescores
every node per pick. Here the whole pick sequence runs on the device:
the probe (models/probe._probe_rows, its resource section through K1),
the K-step pick loop as the hand-written CUDA kernel K3
(ops/zreplay_kernel.replay_picks) and the commit fold, with one
device-to-host copy per run (or per group) for the picks.

Two entry points share the same probe + pick-loop body:

  * ZReplay.run — one run;
  * ZReplay.run_group — G runs, the carry threaded run to run on the
    device: each run's probe sees the earlier runs' commits, the
    round-robin counter L and the abort flag stay in device memory, so
    no host sync happens inside a group. A run that trips its table
    horizon aborts the rest (they schedule nothing and report
    n_done == 0), and the host driver resumes from there.

Spans (trace/spans): `wave.replay.launch` around a dispatch (the enqueue
of the folds, the probe with K1, and K3; attribute k3: the pick loops it
enqueues, one K3 launch each on the card; a group's also picks, the sum
of its runs' real picks, and k_bucket, each loop's steps, so the loops'
waste is k3 * k_bucket - picks), inside a group's one `wave.replay.run`
per run around that run's enqueue (probe, K3, fold; attribute k: its
real picks), and `wave.replay.wait` around its collect, the host blocked
until the device has finished and the picks have been copied back.

Scope, as in the JAX package: runs whose only cross-node coupling is
the zone blend. (The port rejects ServiceAffinity/ServiceAntiAffinity
configs, so no service dynamics reach this module.)
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_tpu_torch.models.batch import (
    BALANCED_ALLOCATION,
    INTER_POD_AFFINITY,
    LEAST_REQUESTED,
    NODE_AFFINITY,
    SELECTOR_SPREAD,
    TAINT_TOLERATION,
    SchedulerConfig,
)
from kubernetes_tpu_torch.models.probe import _probe_rows
from kubernetes_tpu_torch.ops import zreplay_kernel as ZK
from kubernetes_tpu_torch.trace.spans import span

I64 = torch.int64


def _weights(config: SchedulerConfig) -> dict:
    """The pick loop's weights (ops/zreplay_kernel.WEIGHTS): LR and BA
    summed over their entries, the rest by name."""
    w = {n if isinstance(n, str) else n[0]: wt
         for n, wt in config.priorities}
    return {
        "w_lr": sum(int(wt) for n, wt in config.priorities
                    if n == LEAST_REQUESTED),
        "w_ba": sum(int(wt) for n, wt in config.priorities
                    if n == BALANCED_ALLOCATION),
        "w_spread": int(w.get(SELECTOR_SPREAD, 0)),
        "w_na": int(w.get(NODE_AFFINITY, 0)),
        "w_tt": int(w.get(TAINT_TOLERATION, 0)),
        "w_ip": int(w.get(INTER_POD_AFFINITY, 0)),
    }


def _replay_run(config, num_zones, num_values, J, K, static, carry, pod,
                zone_id, veto, has_selectors, rows_dyn, k_real, L0,
                active0):
    """Probe `pod` against the live carry, then K3's K pick steps.

    zone_id (i32[N]) and veto (bool[N]) are permuted to name-desc order
    already; L0 (i64) and active0 (bool) are 0-d device tensors, so a
    group chains runs without a host sync. Returns (j i64[N] permuted-
    space commit counts, chosen i32[K] permuted-space ids, L, n_done,
    bailed), the last three 0-d device tensors."""
    stk, _tab = _probe_rows(config, num_zones, num_values, J, static,
                            carry, pod)
    perm = static["name_desc_order"]
    stk = stk[:, perm]
    res = carry["res"]
    nodes = {
        "fit_static": (stk[0] != 0).to(torch.uint8),
        # the veto (hostname self-anti): one committed copy per node
        "frontier": torch.where(veto, stk[1].clamp(max=1), stk[1]),
        "static_add": stk[2],
        "spread_base": stk[3],
        "na_counts": stk[5],
        "tt_counts": stk[6],
        "ip_totals": stk[7],
        "nz_cpu0": res[3][perm],
        "nz_mem0": res[4][perm],
        "alloc_cpu": static["alloc_mcpu"][perm],
        "alloc_mem": static["alloc_mem"][perm],
        "zone_id": zone_id,
    }
    scalars = torch.stack([pod["nz_mcpu"].to(I64), pod["nz_mem"].to(I64),
                           stk[4][0], L0.to(I64), active0.to(I64)])
    chosen, j, state = ZK.replay_picks(
        nodes, scalars, _weights(config), K=K, k_real=int(k_real),
        rows_dyn=int(rows_dyn), num_zones=num_zones,
        has_selectors=bool(has_selectors))
    return j, chosen, state[0], state[1], state[2]


def _node_counts(j, perm):
    """Permuted-space commit counts -> node order."""
    return torch.zeros_like(j).index_put_((perm,), j)


class ZReplay:
    """The fused probe + pick loop + fold of zoned runs."""

    def __init__(self, config: SchedulerConfig, apply_fn, apply_group_fn):
        self.config = config
        self.apply_fn = apply_fn
        self.apply_group_fn = apply_group_fn

    def run(self, static, carry, prev_pod, prev_counts, pod, num_zones,
            num_values, J, K_bucket, zone_id_perm, veto_perm,
            has_selectors, rows, k_real, L0):
        """One run: fold the deferred single-run fold (prev_pod, when
        not None), probe + pick loop, fold this run's commits.
        -> (carry', chosen i32[K_bucket] permuted-space ids, L', n_done),
        host values after ONE device-to-host copy."""
        with span("wave.replay.launch", k3=1):
            carry, chosen, _counts, L, n_done = self.dispatch(
                static, carry, prev_pod, prev_counts, pod, num_zones,
                num_values, J, K_bucket, zone_id_perm, veto_perm,
                has_selectors, rows, k_real, L0)
        with span("wave.replay.wait"):
            out = self.collect(chosen, L, n_done)
        return (carry, out[:K_bucket].astype(np.int32), int(out[K_bucket]),
                int(out[K_bucket + 1]))

    def dispatch(self, static, carry, prev_pod, prev_counts, pod, num_zones,
                 num_values, J, K_bucket, zone_id_perm, veto_perm,
                 has_selectors, rows, k_real, L0):
        """run's device half, no host sync: -> (carry', chosen
        i32[K_bucket], counts i64[N] node-order commits (folded), L',
        n_done), the last four on the device."""
        if prev_pod is not None:
            carry = self.apply_fn(static, carry, prev_pod, prev_counts)
        dev = carry["res"].device
        j, chosen, L, n_done, _bailed = _replay_run(
            self.config, num_zones, num_values, J, K_bucket, static, carry,
            pod, zone_id_perm, veto_perm, has_selectors, rows, k_real,
            torch.full((), int(L0), dtype=I64, device=dev),
            torch.ones((), dtype=torch.bool, device=dev))
        counts = _node_counts(j, static["name_desc_order"])
        carry = self.apply_fn(static, carry, pod, counts)
        return carry, chosen, counts, L, n_done

    @staticmethod
    def collect(*parts) -> np.ndarray:
        """The device results of a dispatch -> one int64 host vector, in
        ONE device-to-host copy."""
        return torch.cat([p.to(I64).reshape(-1) for p in parts]).cpu() \
            .numpy()

    def run_group(self, static, carry, prev, pods, G, num_zones,
                  num_values, J, K_bucket, zone_id_perm, vetos_perm,
                  has_sels, rows_arr, k_reals, L0):
        """G runs (the first G rows of `pods`, each field with a leading
        run axis), probe + pick loop + fold each, the carry, L and the
        abort flag threaded on the device. `prev` is the deferred fold
        riding this call: None or (kind, pod(s), counts).
        -> (carry', chosen i32[G, K_bucket] permuted-space ids,
        n_done i64[G], L'), host values after ONE device-to-host copy."""
        with span("wave.replay.launch", k3=G, picks=sum(k_reals),
                  k_bucket=K_bucket):
            carry, chosen, n_done, L = self.dispatch_group(
                static, carry, prev, pods, G, num_zones, num_values, J,
                K_bucket, zone_id_perm, vetos_perm, has_sels, rows_arr,
                k_reals, L0)
        with span("wave.replay.wait"):
            out = self.collect(chosen, n_done, L)
        GK = G * K_bucket
        return (carry, out[:GK].reshape(G, K_bucket).astype(np.int32),
                out[GK:GK + G], int(out[GK + G]))

    def dispatch_group(self, static, carry, prev, pods, G, num_zones,
                       num_values, J, K_bucket, zone_id_perm, vetos_perm,
                       has_sels, rows_arr, k_reals, L0):
        """run_group's device half, no host sync: -> (carry', chosen
        i64[G, K_bucket], n_done i64[G], L'), the last three on the
        device."""
        if prev is not None:
            kind, ppod, pcounts = prev
            fold = self.apply_fn if kind == "single" else self.apply_group_fn
            carry = fold(static, carry, ppod, pcounts)
        dev = carry["res"].device
        perm = static["name_desc_order"]
        L = torch.full((), int(L0), dtype=I64, device=dev)
        active = torch.ones((), dtype=torch.bool, device=dev)
        chosen_rows, done_rows = [], []
        for g in range(G):
            with span("wave.replay.run", k=k_reals[g]):
                pod = {f: t[g] for f, t in pods.items()}
                j, chosen, L2, n_done, bailed = _replay_run(
                    self.config, num_zones, num_values, J, K_bucket, static,
                    carry, pod, zone_id_perm, vetos_perm[g], has_sels[g],
                    rows_arr[g], k_reals[g], L, active)
                # an aborted run committed nothing: its fold adds zeros
                carry = self.apply_fn(static, carry, pod,
                                      _node_counts(j, perm))
                chosen_rows.append(chosen.to(I64))
                done_rows.append(torch.where(active, n_done, 0))
                L = L2
                active = active & (bailed == 0)
        return (carry, torch.stack(chosen_rows), torch.stack(done_rows),
                L.view(1))
