"""Wave backlog driver: runs of identical pods bypass the serial scan.

PyTorch counterpart of kubernetes_tpu/models/wave.py, greedy profile,
one device. The driver splits the FIFO backlog into maximal runs of
consecutive identical pods (equal snapshot/encode.pod_feature_key, what
an RC/RS/Job template emits), and for each eligible run:

  1. probes the carry once on the device (models/probe.WaveProbe, whose
     resource section is the hand-written CUDA kernel),
  2. replays the pick sequence on the host (models/replay.replay_fast,
     the C engine native/replay.c), reproducing selectHost's exact
     round-robin tie rule, then
  3. folds the run's commits into the carry (_apply_fn), deferred so
     the fold rides the next probe.

Ineligible pods fall back to the serial scan (models/batch), threading
the same carry, so the output is bit-identical to scanning the whole
backlog and to the oracle.

Left to later slices, none of which changes a decision: the grouped
header probe (models/hosttab), the zoned device replay (models/zreplay;
zoned runs take the host replay here), the pipeline, quantized and resident tables, gangs, the
mesh. The run/eligibility helpers below are verbatim copies of the JAX
driver's host code.
"""

from __future__ import annotations

from dataclasses import replace as dc_replace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.models.batch import (
    BALANCED_ALLOCATION,
    EQUAL,
    IMAGE_LOCALITY,
    INTER_POD_AFFINITY,
    LEAST_REQUESTED,
    NODE_AFFINITY,
    NODE_LABEL_PRIORITY,
    SELECTOR_SPREAD,
    SERVICE_ANTI_AFFINITY,
    TAINT_TOLERATION,
    BatchScheduler,
    SchedulerConfig,
    num_zones_of,
    wants_resources,
)
from kubernetes_tpu_torch.models.probe import RunTables, WaveProbe
from kubernetes_tpu_torch.models.replay import ReplayResult, replay_fast
from kubernetes_tpu_torch.snapshot.carry import place, to_device
from kubernetes_tpu_torch.snapshot.encode import ClusterSnapshot, PodBatch
from kubernetes_tpu_torch.snapshot.pad import next_pow2

I64 = torch.int64

_WAVE_PRIORITIES = {
    LEAST_REQUESTED,
    BALANCED_ALLOCATION,
    SELECTOR_SPREAD,
    NODE_AFFINITY,
    TAINT_TOLERATION,
    INTER_POD_AFFINITY,
    EQUAL,
    IMAGE_LOCALITY,
}

def config_eligible(config: SchedulerConfig) -> bool:
    total_w = 0
    n_saa = 0
    for name, w in config.priorities:
        if isinstance(name, tuple):
            if name[0] == SERVICE_ANTI_AFFINITY:
                # per-pick renormalization handled by the spec replay;
                # the tables carry ONE term's counts
                n_saa += 1
                if n_saa > 1:
                    return False
            elif name[0] != NODE_LABEL_PRIORITY:
                return False
        elif name not in _WAVE_PRIORITIES:
            return False
        total_w += abs(w)
    # replay score range guard (C engine buckets by score value)
    return total_w * 10 < (1 << 20)


def _lt_pernode_dom(snap: ClusterSnapshot, lt: int):
    """For logical term lt: the per-node domain row when the term has
    exactly one expansion entry (an explicit topology key) AND distinct
    nodes never share a domain (each valid node is its own domain —
    hostname-like). Returns i32[N] (-1 where the key is missing) or
    None when the term's domains couple nodes."""
    lt_u = np.asarray(snap.ip_lt_u)
    if lt_u.ndim != 2 or not lt_u.size:
        return None
    entries = lt_u[lt]
    valid = entries[entries >= 0]
    if len(valid) != 1:
        return None  # empty-key OR expansion: zone/region coupling
    q = int(np.asarray(snap.ip_u_topo)[valid[0]])
    dom = np.asarray(snap.ip_topo_dom)[q]
    live = dom[dom >= 0]
    if len(np.unique(live)) != len(live):
        return None  # two nodes share a domain: commits couple them
    return dom


def run_eligible(config: SchedulerConfig, batch: PodBatch, i: int,
                 snap: ClusterSnapshot, *, config_ok: bool = None):
    """-> (eligible, self_anti_veto) for pod row i's run. Eligible means
    its commits don't feed back into its own fit/score except through
    the channels the tables model (resources, ports-self, spread
    counts, and — via the returned veto — hostname-topology hard
    anti-affinity against itself, the one-per-node pattern:
    self_anti_veto is then bool[N] marking nodes where one committed
    copy excludes every further copy).
    config_ok is a hoistable per-backlog invariant."""
    if config_ok is None:
        config_ok = config_eligible(config)
    if not config_ok:
        return False, None
    b = batch
    # own inter-pod terms: the run stays eligible as long as none of
    # them feed back into the run's OWN fit/score in a way the tables
    # can't express. A term whose spec doesn't match the pod's own
    # labels never reacts to the run's commits (the carry fold in
    # _apply_fn records it exactly for later pods). A hard ANTI term
    # that DOES self-match is expressible when its topology is
    # hostname-like: each commit kills only its own node's fit
    # (generalizing the host-port self-conflict row of res_fit).
    if b.ip_ha_lt.size and np.any(b.ip_ha_lt[i] >= 0):
        # own hard AFFINITY: the first-pod bootstrap + domain growth
        # feedback (predicates.go:819-843) is not table-expressible
        return False, None
    lt_spec = np.asarray(snap.ip_lt_spec) if snap.ip_lt_spec is not None \
        else np.zeros(0, np.int32)
    ms = b.ip_match_spec[i] if b.ip_match_spec.size else None

    def self_match(lt: int) -> bool:
        return bool(ms is not None and ms[lt_spec[lt]])

    if b.ip_fwd_lt.size:
        for lt in b.ip_fwd_lt[i]:
            if lt >= 0 and self_match(int(lt)):
                # preferred term scoring its own copies: the slope in j
                # isn't in the tables (yet)
                return False, None
    veto = None
    if b.ip_hq_lt.size:
        for lt in b.ip_hq_lt[i]:
            if lt < 0 or not self_match(int(lt)):
                continue
            dom = _lt_pernode_dom(snap, int(lt))
            if dom is None:
                return False, None  # zone-coupled self anti-affinity
            v = dom >= 0  # nodes where the term can ever co-locate
            veto = v if veto is None else (veto | v)
    # volume commits conflict with the run's own copies
    if np.any(b.vp_vol_rw[i]) or np.any(b.vp_vol_ro[i]):
        return False, None
    if np.any(b.vp_ebs[i]) or np.any(b.vp_gce[i]):
        return False, None
    if b.vp_has_ebs[i] or b.vp_has_gce[i] or b.vp_ebs_bad[i] or b.vp_gce_bad[i]:
        return False, None
    # (service-member runs stay eligible: the replay models the
    # ServiceAffinity first-pick pin and the per-pick ServiceAntiAffinity
    # renormalization from the probe's svc rows; the apply fold records
    # the commits for later pods. Zoned selector-spread runs likewise:
    # the probe carries the node->zone map and the replay recomputes the
    # 2/3 blend per pick — the coupling is linear in per-zone counts,
    # exactly table shape.)
    return True, veto


def pick_j(config: SchedulerConfig, max_j: int, snap: ClusterSnapshot,
           batch: PodBatch, rep: int, K: int) -> Tuple[int, int]:
    """-> (J, rows). J is the compiled table depth (pow2-bucketed
    for compile reuse); rows <= J is the replay's table horizon —
    the capacity bound +2, so the most capacious node's fit
    observably goes False inside the table instead of tripping the
    horizon bail (which would force a full re-probe of the
    remaining run). The probe ships the full packed J-table in one
    transfer and clips to `rows` host-side (transfer is latency-
    bound, not bandwidth-bound); `rows` exists to bound the replay
    and keep the host tables small. Computed from the run-start
    snapshot only — commits monotonically shrink every node's
    remaining capacity, so this stays an upper bound for the whole
    backlog (no device sync). Shared by the single-chip and mesh
    wave drivers."""
    alloc_pods = np.asarray(snap.alloc_pods)
    if not alloc_pods.size:
        return 16, 16
    if not wants_resources(config):
        # no PodFitsResources: nothing enforces the capacity bound,
        # res_fit never goes False, and clipping rows below J would
        # horizon-bail (and re-probe) every `rows` picks
        J = next_pow2(min(K + 1, max_j), floor=128)
        return J, J
    cap = np.maximum(alloc_pods - np.asarray(snap.pod_count), 0)
    # the commit vector shrinks cpu/mem headroom too (a fit at j
    # implies j*commit + request <= alloc); use whichever bound is
    # tightest so the table stays small
    for commit, alloc, used in (
        (int(batch.commit_mcpu[rep]), snap.alloc_mcpu, snap.req_mcpu),
        (int(batch.commit_mem[rep]), snap.alloc_mem, snap.req_mem),
    ):
        if commit > 0:
            room = np.maximum(np.asarray(alloc) - np.asarray(used), 0)
            cap = np.minimum(cap, room // commit + 1)
    depth = min(K, int(cap.max()) + 1) + 1
    # floor 128: one probe program serves every wave size (a small
    # K would otherwise compile J=16/32/64 variants for nothing)
    J = next_pow2(min(depth, max_j), floor=128)
    return J, min(depth, J)


def split_runs(rep_idx: np.ndarray,
               boundaries: Sequence[int] = ()) -> List[Tuple[int, int, int]]:
    """Maximal runs of consecutive equal representative rows:
    -> [(rep, start, length)]. Shared by the single-chip and mesh
    drivers. `boundaries` forces additional run breaks at those
    backlog positions — a gang span must be ITS OWN run even when the
    neighbouring pods share its template, so the all-or-nothing commit
    decision covers exactly the gang's members."""
    runs: List[Tuple[int, int, int]] = []
    cuts = frozenset(boundaries)
    i, P = 0, len(rep_idx)
    while i < P:
        r = rep_idx[i]
        s = i
        while i < P and rep_idx[i] == r and (i == s or i not in cuts):
            i += 1
        runs.append((int(r), s, i - s))
    return runs


def classify_runs(config: SchedulerConfig, snap: ClusterSnapshot,
                  batch: PodBatch, runs, min_run: int) -> List[dict]:
    """Classify every run once: eligibility and the self-anti veto
    (kubernetes_tpu/models/wave.classify_runs without the grouped,
    device-replay, gang and service fields this slice has no use for)."""
    config_ok = config_eligible(config)
    infos: List[dict] = []
    for rep, start, length in runs:
        eligible, veto = (False, None)
        if length >= min_run:
            eligible, veto = run_eligible(
                config, batch, rep, snap, config_ok=config_ok,
            )
        infos.append({
            "rep": rep, "start": start, "length": length,
            "eligible": eligible, "veto": veto,
        })
    return infos


def gather_batch(batch: PodBatch, rows: np.ndarray) -> PodBatch:
    """Materialize per-position rows from the unique-representative
    batch (fancy-index every pod-axis array)."""
    import dataclasses

    fields = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        if f.name == "pod_keys":
            fields[f.name] = [v[r] for r in rows]
        elif isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == batch.num_pods:
            fields[f.name] = v[rows]
        else:
            fields[f.name] = v
    return dc_replace(batch, **fields)


def _permute_tables(t: RunTables, perm: np.ndarray) -> RunTables:
    def p1(a):
        return None if a is None else a[perm]

    return RunTables(
        fit_static=t.fit_static[perm],
        res_fit=t.res_fit[:, perm],
        tab=t.tab[:, perm],
        static_add=t.static_add[perm],
        w_spread=t.w_spread,
        spread_base=p1(t.spread_base),
        spread_selfmatch=t.spread_selfmatch,
        has_selectors=t.has_selectors,
        zone_id=p1(t.zone_id),
        num_zones=t.num_zones,
        w_na=t.w_na,
        na_counts=p1(t.na_counts),
        w_tt=t.w_tt,
        tt_counts=p1(t.tt_counts),
        w_ip=t.w_ip,
        ip_totals=p1(t.ip_totals),
        w_saa=t.w_saa,
        saa_counts=p1(t.saa_counts),
        saa_total=t.saa_total,
        saa_lbl_val=p1(t.saa_lbl_val),
        saa_num_values=t.saa_num_values,
        saa_member=t.saa_member,
        sa_refine_rows=(None if t.sa_refine_rows is None
                        else t.sa_refine_rows[:, perm]),
        sa_bail=t.sa_bail,
    )


class WaveScheduler:
    """Schedules an encoded backlog (unique rows + per-position rep
    index) bit-identically to the serial scan, fast-pathing runs, on
    `device`."""

    def __init__(self, config: Optional[SchedulerConfig] = None,
                 min_run: int = 16, max_j: int = 1024, device="cuda"):
        self.config = config or SchedulerConfig()
        self.device = torch.device(device)
        self.scan = BatchScheduler(self.config, device=self.device)
        self.probe = WaveProbe(self.config)
        self.min_run = min_run
        self.max_j = max_j
        # per-wave tally: "probe" (probe dispatches), "scan" (flushes to
        # the serial scan), "scan_pods" (pods the scan decided)
        self.dispatches: dict = {}

    def _count(self, key: str, n: int = 1) -> None:
        self.dispatches[key] = self.dispatches.get(key, 0) + n

    # -- carry commit of a whole run -----------------------------------------

    def _apply_fn(self, static, carry, pod, counts):
        """Fold j identical commits per node into the carry, in place —
        the exact sum of the scan's per-step commit section over the
        run. counts: i64[N] host array of commits per node. The
        scatter-adds repeat indices (nodes sharing a domain); integer
        adds are exact in any order."""
        counts = place(counts, self.device)
        k = counts.sum()
        commit = torch.stack([
            pod["commit_mcpu"], pod["commit_mem"], pod["commit_gpu"],
            pod["nz_mcpu"], pod["nz_mem"], torch.ones_like(k),
        ])
        carry["res"] += commit[:, None] * counts[None, :]
        carry["port_mask"] |= torch.where(
            (counts > 0)[:, None], pod["port_mask"][None, :], 0)
        carry["class_count"].index_add_(1, pod["class_id"].view(1),
                                        counts[:, None])
        carry["last_idx"] += k
        u_topo = static["ip_u_topo"]
        U = u_topo.shape[0]
        term_count = carry["ip_term_count"]
        if U and term_count.shape[1]:
            # term_count[u, dom(u, n)] += match_spec[spec(u)] * counts[n]
            dom = static["ip_topo_dom"][u_topo]  # (U, N)
            mu = pod["ip_match_spec"][static["ip_u_spec"]].to(I64)  # (U,)
            add = torch.where(dom >= 0, mu[:, None] * counts[None, :], 0)
            rows = torch.arange(U, device=dom.device)[:, None].expand_as(dom)
            term_count.index_put_(
                (rows, dom.clamp(0, term_count.shape[1] - 1)), add,
                accumulate=True)
        lt_u = static["ip_lt_u"]
        LT = lt_u.shape[0]
        E = lt_u.shape[1] if LT else 0
        own_anti = carry["ip_own_anti"]
        if U and LT and E and own_anti.shape[2]:
            # the run's OWN terms, folded per node with multiplicity
            # counts[n] — ops/interpod.interpod_commit vectorized over N
            q = u_topo[lt_u.clamp(0, U - 1)]
            domq = static["ip_topo_dom"][q]  # (LT, E, N)
            validq = (lt_u >= 0)[:, :, None] & (domq >= 0)
            sdq = domq.clamp(0, own_anti.shape[2] - 1)
            dev = sdq.device
            index = (
                torch.arange(LT, device=dev)[:, None, None].expand_as(sdq),
                torch.arange(E, device=dev)[None, :, None].expand_as(sdq),
                sdq,
            )
            c = torch.where(validq, counts[None, None, :], 0)
            for key, own in (("ip_own_anti", "ip_own_anti_hard"),
                             ("ip_rev_hard", "ip_own_hard"),
                             ("ip_rev_pref", "ip_own_pref"),
                             ("ip_rev_anti", "ip_own_anti_pref")):
                carry[key].index_put_(index, pod[own][:, None, None] * c,
                                      accumulate=True)
        if carry["ip_spec_total"].shape[0]:
            carry["ip_spec_total"] += pod["ip_match_spec"].to(I64) * k
        return carry

    # -- backlog -------------------------------------------------------------

    def _wave_setup(self, snap: ClusterSnapshot, last_node_index: int):
        """Place the wave's tables on the device once:
        -> (static, carry, num_zones, num_values)."""
        self.dispatches = {}
        return (self.scan.place_static(snap),
                self.scan.initial_carry(snap, last_node_index),
                num_zones_of(snap), int(snap.svc_num_values))

    def schedule_backlog(
        self,
        snap: ClusterSnapshot,
        batch: PodBatch,
        rep_idx: np.ndarray,
        last_node_index: int = 0,
    ) -> Tuple[np.ndarray, dict, int]:
        """-> (chosen i32[P] node ids with -1 == unschedulable, final
        carry, final lastNodeIndex). snap may be node-padded; batch holds
        one row per unique pod; rep_idx maps backlog position -> row."""
        static, carry, num_zones, num_values = self._wave_setup(
            snap, last_node_index)
        pods_dev = to_device(batch, self.device, BatchScheduler.POD_FIELDS)
        P = len(rep_idx)
        out = np.full(P, -1, np.int32)
        perm = np.asarray(snap.name_desc_order).astype(np.int64)
        N = snap.num_nodes
        zone_id = (np.asarray(snap.zone_id)
                   if np.any(np.asarray(snap.zone_id) > 0) else None)

        def pod_row(rep):
            return {f: t[rep] for f, t in pods_dev.items()}

        pending: List[int] = []
        # lastNodeIndex is tracked host-side (the replay computes it
        # exactly) so the fast path never reads the device carry
        L_host = int(last_node_index)
        # deferred commit fold (pod row, counts[N]): a run's fold rides
        # the next probe
        fold: list = []

        def settle(carry):
            if fold:
                pod, counts = fold.pop()
                carry = self._apply_fn(static, carry, pod, counts)
            return carry

        def flush(carry):
            nonlocal L_host
            if not pending:
                return carry
            carry = settle(carry)
            rows = np.asarray(pending, np.int64)
            pods = to_device(gather_batch(batch, rep_idx[rows]), self.device,
                             BatchScheduler.POD_FIELDS)
            self._count("scan")
            self._count("scan_pods", len(rows))
            chosen = self.scan.run(static, carry, pods, num_zones,
                                   num_values)
            out[rows] = chosen.cpu().numpy()
            L_host = int(carry["last_idx"])
            pending.clear()
            return carry

        def run_single(carry, info):
            """probe (fused with the pending fold) + host replay +
            deferred fold, re-probing past the table horizon."""
            nonlocal L_host
            rep, start, length = info["rep"], info["start"], info["length"]
            pod = pod_row(rep)
            done = 0
            while done < length:
                K = length - done
                J, rows = pick_j(self.config, self.max_j, snap, batch, rep,
                                 K)
                prev_pod, prev_counts = fold.pop() if fold else (None, None)
                self._count("probe")
                carry, tables = self.probe.probe_fused(
                    static, carry, prev_pod, prev_counts, pod, num_zones,
                    num_values, J, rows, self._apply_fn,
                    has_selectors=bool(batch.has_selectors[rep]),
                    zone_id=zone_id, self_anti_veto=info["veto"],
                )
                res: ReplayResult = replay_fast(
                    _permute_tables(tables, perm), K, L_host)
                if res.n_done == 0:
                    # no progress possible through tables; scan the rest
                    pending.extend(range(start + done, start + length))
                    break
                ids = np.where(res.chosen >= 0, perm[res.chosen], -1)
                out[start + done:start + done + res.n_done] = ids.astype(
                    np.int32)
                counts = np.zeros(N, np.int64)
                counts[perm] = res.counts
                fold.append((pod, counts))
                L_host = res.last_node_index
                done += res.n_done
            return carry

        runs = split_runs(rep_idx)
        for info in classify_runs(self.config, snap, batch, runs,
                                  self.min_run):
            if not info["eligible"]:
                pending.extend(range(info["start"],
                                     info["start"] + info["length"]))
                continue
            carry = flush(carry)
            carry = run_single(carry, info)
        carry = settle(carry)
        carry = flush(carry)
        return out, carry, L_host
