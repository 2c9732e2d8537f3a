"""Wave probe: one device pass that tabulates everything a run of
identical pods needs, so the host replay can reproduce the serial pick
sequence without one device step per pod.

PyTorch counterpart of kubernetes_tpu/models/probe.py (see its docstring
for the run/table model). For a run of identical pending pods every
scheduling-relevant quantity is static during the run, a per-node
function of j = how many of the run's pods have been committed to that
node, or a normalization over the live fit set that the replay
recomputes when it changes. The probe evaluates the static parts with
the scan's own functions (models/batch.fit_mask and ops/*) and the
resource j-tables with the hand-written CUDA kernel
(ops/probe_kernel.resource_probe; its plain torch version on the CPU),
as the JAX package's kernel="pallas" build does. Under the
KUBERNETES_TPU_QUANT=bf16 profile (WaveProbe's score_mode, from
parallel/quant.score_mode) the single-run probe's j-table takes K1's
bf16 mode: each weighted LR/BA term rounded to bfloat16 and summed in
bfloat16 in declaration order, then truncated through int32.

Its product crosses to the host as ONE int64 array: the 11 header rows,
then the [J, N] j-table in the narrowest safe dtype, packed into int64
words along j — the same layout as the JAX package, which the host half
(tables_from_packed / tables_from_stk / RunTables, numpy code copied
verbatim from kubernetes_tpu/models/probe.py) unpacks. The grouped
probe (WaveProbe.probe_group) ships only the header rows of a group of
runs, probed at J=1, plus the live resource block, also in one copy.

probe_fused_dispatch / probe_fused_collect split a single-run probe for
the wave driver's pipeline: dispatch enqueues the fold and the probe and
starts the product's device-to-host copy into pinned memory (a
non_blocking copy into pageable memory would be synchronous), then
records a CUDA event; collect waits on that event and unpacks. On the
CPU dispatch computes the product and collect unpacks it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

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
    SchedulerConfig,
    fit_mask,
    interpod_carry_tables,
    wants_interpod,
    wants_ports,
    wants_resources,
)
from kubernetes_tpu_torch.ops import interpod as IP
from kubernetes_tpu_torch.ops import priorities as R
from kubernetes_tpu_torch.ops import probe_kernel as PK
from kubernetes_tpu_torch.parallel import quant
from kubernetes_tpu_torch.snapshot.services import ORD_NONE

I64 = torch.int64
_TORCH_DTYPE = {np.dtype(np.int8): torch.int8,
                np.dtype(np.int16): torch.int16,
                np.dtype(np.int32): torch.int32}


@dataclass
class RunTables:
    """Host-side tables for one run (all numpy; see models/replay.py)."""

    fit_static: np.ndarray  # bool[N]
    res_fit: np.ndarray  # bool[J, N]
    tab: np.ndarray  # i64[J, N] weighted LeastRequested+Balanced
    static_add: np.ndarray  # i64[N] Equal/ImageLocality/NodeLabel sum
    # SelectorSpread (None when not configured)
    w_spread: int
    spread_base: Optional[np.ndarray]  # i64[N]
    spread_selfmatch: bool
    has_selectors: bool
    # NodeAffinity preferred (unnormalized weight counts)
    w_na: int
    na_counts: Optional[np.ndarray]  # i64[N]
    # TaintToleration (unnormalized intolerable counts)
    w_tt: int
    tt_counts: Optional[np.ndarray]  # i64[N]
    # InterPodAffinity (unnormalized totals; static because the pod owns
    # no terms — the eligibility gate guarantees it)
    w_ip: int
    ip_totals: Optional[np.ndarray]  # i64[N]
    # zone blend (selector_spreading.go:221-228): zone ids are static
    # per run, so they ride host-side; the replay recomputes the
    # per-zone aggregation over the live fit set per pick. zone_id is
    # None on unzoned clusters (the plain float32 branch).
    zone_id: Optional[np.ndarray] = None  # i32[N]; 0 == no zone
    num_zones: int = 1
    # ServiceAntiAffinity (policy configs): per-pick renormalized spread
    # over values of a node label; counts/total grow with the run's own
    # member commits. None when not configured / run not a member.
    w_saa: int = 0
    saa_counts: Optional[np.ndarray] = None  # i64[N] base peer counts
    saa_total: int = 0  # base peer total (pre-run)
    saa_lbl_val: Optional[np.ndarray] = None  # i32[N]; -1 unlabeled
    saa_num_values: int = 0
    saa_member: bool = False  # run pods are peers of their own group
    # ServiceAffinity first-pick pin: when the run's group had NO first
    # peer at probe time, the first commit pins the unresolved config
    # labels to the picked node's values; rows are lbl_val per
    # unresolved label. None = no refinement (pinned already / fixed /
    # no group / predicate absent).
    sa_refine_rows: Optional[np.ndarray] = None  # i32[R, N]
    # the run's SA dynamics exceed what the tables model (a label left
    # unresolved by BOTH svc_fixed and the current first peer's node
    # can re-pin mid-run via the min-ord rule): route to the scan
    sa_bail: bool = False

def _gather_lt(static, table):
    return IP.gather_lt(table, static["ip_u_topo"], static["ip_topo_dom"],
                        static["ip_lt_u"], static["ip_lt_sign"])


def _probe_rows(config: SchedulerConfig, num_zones: int, num_values: int,
                J: int, static, carry, pod, *, score_mode: str = "i64"):
    """The probe body: -> (stk i64[N_STK_ROWS, N] header rows,
    tab i64[J, N] weighted LR+BA j-table). The resource section (fit
    frontier + LR/BA j-table) always goes through the probe kernel, in
    its bf16 mode when score_mode == "bf16"."""
    res = carry["res"]
    N = res.shape[1]
    dev = res.device

    cnt_lt = None
    if wants_interpod(config):
        cnt_lt = interpod_carry_tables(static, carry["ip_term_count"], N)

    fit_static = fit_mask(config, static, carry, pod, cnt_lt,
                          include_resources=False).expand(N)

    terms = tuple(
        ("lr" if n == LEAST_REQUESTED else "ba", int(w))
        for n, w in config.priorities
        if n in (LEAST_REQUESTED, BALANCED_ALLOCATION)
    )
    frontier, tab = PK.resource_probe(
        J,
        (static["alloc_mcpu"], static["alloc_mem"], static["alloc_gpu"],
         static["alloc_pods"]),
        tuple(res[k] for k in range(6)), pod, terms,
        wants_res=wants_resources(config), bf16=score_mode == "bf16",
    )
    if wants_ports(config):
        # host-port self-conflict (predicates.go:574) applied to the
        # frontier directly: res_fit is monotone in j, so killing every
        # j>0 row caps the frontier at 1
        has_ports = (pod["port_mask"] != 0).any()
        frontier = torch.where(has_ports, frontier.clamp(max=1), frontier)

    static_add = torch.zeros((N,), dtype=I64, device=dev)
    zeros = torch.zeros((N,), dtype=I64, device=dev)
    stk_rows = {"spread_base": zeros, "spread_selfmatch": zeros,
                "na_counts": zeros, "tt_counts": zeros, "ip_totals": zeros}
    for name, weight in config.priorities:
        if name in (LEAST_REQUESTED, BALANCED_ALLOCATION):
            continue  # the kernel already accumulated this term
        elif name == SELECTOR_SPREAD:
            # unmasked base counts; the replay applies the fit mask and
            # maxCount normalization per pick
            stk_rows["spread_base"] = R._matvec(carry["class_count"],
                                                pod["spread_match"])
            stk_rows["spread_selfmatch"] = (
                torch.take(pod["spread_match"], pod["class_id"]) > 0
            ).to(I64).expand(N)
        elif name == NODE_AFFINITY:
            stk_rows["na_counts"] = R.node_affinity_counts(
                pod["pref_valid"], pod["pref_weight"], pod["pref_ops"],
                pod["pref_key"], pod["pref_set"], pod["pref_numkey"],
                pod["pref_num"], static["label_kv"], static["label_key"],
                static["numval"], static["set_table"],
            )
        elif name == TAINT_TOLERATION:
            stk_rows["tt_counts"] = R.taint_intolerable_counts(
                static["taint_count"], pod["intolerable_prefer"]
            )
        elif name == INTER_POD_AFFINITY:
            stk_rows["ip_totals"] = IP.interpod_totals(
                cnt_lt,
                _gather_lt(static, carry["ip_rev_hard"]),
                _gather_lt(static, carry["ip_rev_pref"]),
                _gather_lt(static, carry["ip_rev_anti"]),
                static["ip_lt_spec"], pod["ip_match_spec"],
                pod["ip_fwd_lt"], pod["ip_fwd_w"],
                config.hard_pod_affinity_weight, N,
            )
        elif name == EQUAL:
            static_add = static_add + int(weight) * R.equal(N, device=dev)
        elif name == IMAGE_LOCALITY:
            static_add = static_add + int(weight) * R.image_locality(
                static["img_size"], pod["img_count"]
            )
        elif isinstance(name, tuple) and name[0] == NODE_LABEL_PRIORITY:
            static_add = static_add + int(weight) * R.node_label(
                static[f"nl_prio_{name[1]}"], name[2]
            )
        elif isinstance(name, tuple) and name[0] == SERVICE_ANTI_AFFINITY:
            pass  # per-pick renormalization: the replay consumes the
            # svc rows below (base counts/total + host lbl_val)
        else:
            raise ValueError(f"unknown priority {name!r}")
    # service-group state rows (zero when no SA/SAA config: G == 0).
    # row svc_counts: the run's group's per-node peer counts;
    # row svc_total: its peer total (broadcast);
    # row svc_pin: the group's first-peer order index (broadcast;
    # ORD_NONE means the run's first commit will pin)
    first_peer = carry["svc_first_peer"]
    G = first_peer.shape[0]
    if G:
        g = pod["svc_group"].clamp(0, G - 1)
        has_group = pod["svc_group"] >= 0
        svc_counts = torch.where(has_group, carry["svc_peer_node_count"][g],
                                 0)
        svc_total = torch.where(has_group, carry["svc_peer_total"][g],
                                0).expand(N)
        svc_pin = torch.where(has_group, first_peer[g],
                              int(ORD_NONE)).expand(N)
    else:
        svc_counts = svc_total = zeros
        svc_pin = torch.full((N,), int(ORD_NONE), dtype=I64, device=dev)
    stk = torch.stack([
        fit_static.to(I64),
        frontier,
        static_add,
        stk_rows["spread_base"],
        stk_rows["spread_selfmatch"],
        stk_rows["na_counts"],
        stk_rows["tt_counts"],
        stk_rows["ip_totals"],
        svc_counts,
        svc_total,
        svc_pin,
    ])
    return stk, tab


def _probe_fn(config: SchedulerConfig, num_zones: int, num_values: int,
              J: int, static, carry, pod, *, score_mode: str = "i64"):
    """-> {"packed": i64[N_STK_ROWS + J // k, N]}: the header rows, then
    the j-table in _tab_dtype bit-packed k to an int64 word along j (J
    is a power of two >= 16 on the probe path, so k divides it)."""
    stk, tab = _probe_rows(config, num_zones, num_values, J, static, carry,
                           pod, score_mode=score_mode)
    N = stk.shape[1]
    dt = np.dtype(_tab_dtype(config))
    k = 8 // dt.itemsize
    tabp = tab.to(_TORCH_DTYPE[dt]).reshape(J // k, k, N).transpose(1, 2)
    # flattened first: at N == 1 contiguous() may keep the size-1 axis's
    # stride, which a dtype view refuses
    tabw = tabp.contiguous().view(-1).view(I64).reshape(J // k, N)
    return {"packed": torch.cat([stk, tabw], dim=0)}


def _group_probe_fn(config: SchedulerConfig, num_zones: int,
                    num_values: int, G: int, static, carry, pods):
    """Header-row probe for a group of run representatives: pods holds
    the group's pod rows on a leading run axis (G_bucket of them, the
    last G_bucket - G repeating the last representative, see
    wave.group_buffer). Each of the G runs is probed at J=1 (one K1
    launch each; the host rebuilds the resource j-axis itself from the
    shipped resource block, see models/hosttab), and the padded slots
    repeat the last header. -> ONE tensor i64[G_bucket*N_STK_ROWS + 6, N]
    so the whole product crosses to the host in one copy: the per-run
    headers, then the carry's live resource block (the base the host
    j-tables start from)."""
    G_bucket = pods["req_mcpu"].shape[0]
    stks = [
        _probe_rows(config, num_zones, num_values, 1, static, carry,
                    {f: t[g] for f, t in pods.items()})[0]
        for g in range(G)
    ]
    stks += [stks[-1]] * (G_bucket - G)
    return torch.cat(stks + [carry["res"]], dim=0)


N_STK_ROWS = 11  # header rows before the packed j-table words


def _tab_dtype(config: SchedulerConfig):
    """Narrowest dtype holding every possible j-table score: each
    configured LR/BA priority contributes weight * [0, 10]."""
    bound = 10 * sum(
        abs(w) for n, w in config.priorities
        if n in (LEAST_REQUESTED, BALANCED_ALLOCATION)
    )
    return (np.int8 if bound <= 127
            else np.int16 if bound <= 32767 else np.int32)

class WaveProbe:
    """Runs the probe for a run and unpacks its product into RunTables.

    score_mode: "i64" or "bf16" (the single-run probe's j-table
    accumulation); None reads the KUBERNETES_TPU_QUANT profile
    (parallel/quant.score_mode), as the JAX package's WaveProbe does.
    Per instance, so a shadow driver can force the full-width build."""

    def __init__(self, config: Optional[SchedulerConfig] = None, *,
                 score_mode: Optional[str] = None):
        self.config = config or SchedulerConfig()
        self.score_mode = score_mode or quant.score_mode()

    def _packed(self, static, carry, pod, num_zones, num_values, J):
        return _probe_fn(self.config, num_zones, num_values, J, static,
                         carry, pod, score_mode=self.score_mode)["packed"]

    def probe(self, static, carry, pod, num_zones: int, num_values: int,
              J: int, rows: Optional[int] = None,
              has_selectors: Optional[bool] = None,
              zone_id: Optional[np.ndarray] = None,
              self_anti_veto: Optional[np.ndarray] = None,
              svc_ctx: Optional[dict] = None) -> "RunTables":
        """rows (<= J) bounds the j-depth the replay can need (the
        capacity bound from wave.pick_j); the whole packed product
        crosses to the host in ONE transfer and the clip to `rows`
        happens there."""
        if rows is None:
            rows = J
        rows = max(1, min(rows, J))
        packed = self._packed(static, carry, pod, num_zones, num_values, J)
        arr = np.ascontiguousarray(packed.cpu().numpy())
        return tables_from_packed(
            self.config, arr, num_zones, J, rows,
            has_selectors=(bool(pod["has_selectors"])
                           if has_selectors is None else has_selectors),
            zone_id=zone_id, self_anti_veto=self_anti_veto, svc_ctx=svc_ctx,
        )

    def probe_fused_dispatch(self, static, carry, prev_pod, counts,
                             next_pod, num_zones: int, num_values: int,
                             J: int, apply_fn):
        """Fold the previous run's commits (`counts` of `prev_pod`, via
        apply_fn; nothing when prev_pod is None) into the carry, launch
        the probe of `next_pod` against it, and start the product's
        device-to-host copy without waiting for it: -> (carry, raw). On
        CUDA raw holds a pinned host tensor that the copy fills and the
        event recorded after it; the caller stages host work, then calls
        probe_fused_collect. Nothing in the computation differs from
        probe_fused, so decisions are identical."""
        if prev_pod is not None:
            carry = apply_fn(static, carry, prev_pod, counts)
        packed = self._packed(static, carry, next_pod, num_zones,
                              num_values, J)
        if packed.device.type != "cuda":
            return carry, (packed, None)
        host = torch.empty(packed.shape, dtype=packed.dtype,
                           pin_memory=True)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return carry, (host, done)

    def probe_fused_collect(self, raw, num_zones: int, J: int,
                            rows: Optional[int], has_selectors: bool,
                            zone_id: Optional[np.ndarray] = None,
                            self_anti_veto: Optional[np.ndarray] = None,
                            svc_ctx: Optional[dict] = None) -> "RunTables":
        """Wait for a probe_fused_dispatch product's copy and unpack it
        into RunTables."""
        if rows is None:
            rows = J
        rows = max(1, min(rows, J))
        host, done = raw
        if done is not None:
            done.synchronize()
        arr = np.ascontiguousarray(host.numpy())
        return tables_from_packed(
            self.config, arr, num_zones, J, rows,
            has_selectors=has_selectors, zone_id=zone_id,
            self_anti_veto=self_anti_veto, svc_ctx=svc_ctx,
        )

    def probe_fused(self, static, carry, prev_pod, counts, next_pod,
                    num_zones: int, num_values: int, J: int,
                    rows: Optional[int], apply_fn, has_selectors: bool,
                    zone_id: Optional[np.ndarray] = None,
                    self_anti_veto: Optional[np.ndarray] = None,
                    svc_ctx: Optional[dict] = None):
        """-> (carry, RunTables). Folds the previous run's commits
        (`counts` of `prev_pod`, via apply_fn) into the carry, then probes
        `next_pod` against the updated carry: the serial form,
        probe_fused_dispatch immediately followed by probe_fused_collect.
        The JAX package compiles three programs for the fold + probe:
        "first" (prev_pod None: nothing to fold yet), "same" (a run
        re-probing itself past the table horizon: prev_pod is next_pod)
        and "prev"; run eagerly they are one method."""
        carry, raw = self.probe_fused_dispatch(
            static, carry, prev_pod, counts, next_pod, num_zones,
            num_values, J, apply_fn)
        return carry, self.probe_fused_collect(
            raw, num_zones, J, rows, has_selectors=has_selectors,
            zone_id=zone_id, self_anti_veto=self_anti_veto,
            svc_ctx=svc_ctx,
        )

    def probe_group(self, static, carry, prev, pods, G: int,
                    num_zones: int, num_values: int, apply_fn,
                    apply_group_fn):
        """-> (carry', headers i64[G_bucket, N_STK_ROWS, N], usage
        i64[6, N]). `prev` is the deferred fold this probe carries: None
        or ("single", pod, counts) / ("group", pods, counts), folded
        into the carry first (apply_fn / apply_group_fn). `usage` is the
        carry's resource block at probe time, the host j-table base
        (models/hosttab). One device-to-host copy."""
        if prev is not None:
            kind, ppod, pcounts = prev
            fold = apply_fn if kind == "single" else apply_group_fn
            carry = fold(static, carry, ppod, pcounts)
        out = _group_probe_fn(self.config, num_zones, num_values, G,
                              static, carry, pods)
        arr = np.ascontiguousarray(out.cpu().numpy())
        G_bucket = pods["req_mcpu"].shape[0]
        N = arr.shape[1]
        headers = arr[:G_bucket * N_STK_ROWS].reshape(G_bucket, N_STK_ROWS,
                                                     N)
        return carry, headers, arr[G_bucket * N_STK_ROWS:]


def tables_from_packed(config: SchedulerConfig, arr: np.ndarray,
                       num_zones: int, J: int, rows: int,
                       has_selectors: bool,
                       zone_id: Optional[np.ndarray] = None,
                       self_anti_veto: Optional[np.ndarray] = None,
                       svc_ctx: Optional[dict] = None) -> RunTables:
    """Unpack the probe's packed product into RunTables (shared by the
    single-chip probe and the mesh probe, whose shard outputs
    concatenate into the identical global array).

    svc_ctx (SA/SAA policy configs; None otherwise) carries the
    host-side service context for the run:
      lbl_val_row i32[N], num_values, member (bool), sa_rows
      (i32[R, N] or None — candidate pin rows for unresolved SA
      labels), ord_node i32[ORD] (order index -> node row), w_saa."""
    stk = arr[:N_STK_ROWS]
    dt = _tab_dtype(config)
    k = 8 // np.dtype(dt).itemsize
    N = arr.shape[1]
    tab = (
        arr[N_STK_ROWS:].view(dt).reshape(J // k, N, k)
        .transpose(0, 2, 1).reshape(J, N)[:rows]
    )
    frontier = stk[1]
    res_fit = np.arange(rows, dtype=np.int64)[:, None] < frontier[None, :]
    return tables_from_stk(
        config, stk, res_fit, np.asarray(tab).astype(np.int64), num_zones,
        has_selectors=has_selectors, zone_id=zone_id,
        self_anti_veto=self_anti_veto, svc_ctx=svc_ctx,
    )


def tables_from_stk(config: SchedulerConfig, stk: np.ndarray,
                    res_fit: np.ndarray, tab: np.ndarray, num_zones: int,
                    has_selectors: bool,
                    zone_id: Optional[np.ndarray] = None,
                    self_anti_veto: Optional[np.ndarray] = None,
                    svc_ctx: Optional[dict] = None) -> RunTables:
    """Assemble RunTables from the probe's header rows plus a resource
    j-axis (res_fit + weighted LR/BA tab) supplied by the caller —
    either reconstructed from the packed single-run product
    (tables_from_packed) or rebuilt host-side from the live resource
    block by the grouped multi-run path (models/hosttab)."""
    N = stk.shape[1]
    rows = res_fit.shape[0]
    fit_static = stk[0].astype(bool)
    if self_anti_veto is not None and rows > 1:
        # hostname-topology hard anti-affinity against the run's own
        # labels: one committed copy excludes every further copy on
        # that node (wave.run_eligible computed where the term's
        # domain exists) — the same res_fit row shape as the
        # host-port self-conflict
        res_fit[1:, self_anti_veto] = False
    weights = {n if isinstance(n, str) else n[0]: w
               for n, w in config.priorities}
    w_spread = int(weights.get(SELECTOR_SPREAD, 0))
    w_na = int(weights.get(NODE_AFFINITY, 0))
    w_tt = int(weights.get(TAINT_TOLERATION, 0))
    w_ip = int(weights.get(INTER_POD_AFFINITY, 0))
    zid = None
    if (w_spread and zone_id is not None
            and np.any(np.asarray(zone_id) > 0)):
        zid = np.ascontiguousarray(zone_id, np.int32)
    w_saa = 0
    saa_counts = saa_lbl = sa_rows = None
    saa_total = saa_nv = 0
    saa_member = False
    sa_bail = False
    if svc_ctx is not None:
        from kubernetes_tpu_torch.snapshot.services import ORD_NONE

        w_saa = int(svc_ctx.get("w_saa", 0))
        if w_saa:
            saa_counts = stk[8].astype(np.int64)
            saa_total = int(stk[9][0])
            saa_lbl = np.ascontiguousarray(
                svc_ctx["lbl_val_row"], np.int32
            )
            saa_nv = int(svc_ctx["num_values"])
            saa_member = bool(svc_ctx.get("member", False))
        pin_ord = int(stk[10][0])
        raw_rows = svc_ctx.get("sa_rows")
        if raw_rows is not None:
            raw_rows = np.ascontiguousarray(raw_rows, np.int32)
            if pin_ord == int(ORD_NONE):
                # unpinned: the first pick pins. Exact ONLY when every
                # node carries every unresolved label — then the pick
                # resolves them all and any later lower-ord commit must
                # carry identical values (the fit forces it), so the
                # min-ord re-pin can never change the requirement.
                if np.all(raw_rows >= 0):
                    sa_rows = raw_rows
                else:
                    sa_bail = True
            else:
                # pinned: static iff the peer's node resolves every
                # unresolved label (same fit-forces-match argument).
                # A peer on an unknown node (row < 0) fails every
                # candidate statically — no dynamics. A peer whose node
                # LACKS a label leaves it unresolved: a lower-ord
                # commit could re-pin it mid-run -> scan.
                ord_node = np.asarray(svc_ctx["ord_node"])
                peer_row = (int(ord_node[pin_ord])
                            if pin_ord < len(ord_node) else -1)
                if peer_row >= 0 and np.any(raw_rows[:, peer_row] < 0):
                    sa_bail = True
    return RunTables(
        zone_id=zid,
        num_zones=num_zones,
        w_saa=w_saa,
        saa_counts=saa_counts,
        saa_total=saa_total,
        saa_lbl_val=saa_lbl,
        saa_num_values=saa_nv,
        saa_member=saa_member,
        sa_refine_rows=sa_rows,
        sa_bail=sa_bail,
        fit_static=fit_static,
        res_fit=res_fit,
        tab=np.asarray(tab).astype(np.int64),
        static_add=stk[2],
        w_spread=w_spread,
        spread_base=stk[3] if w_spread else None,
        spread_selfmatch=bool(stk[4][0]) if w_spread else False,
        has_selectors=has_selectors,
        w_na=w_na,
        na_counts=stk[5] if w_na else None,
        w_tt=w_tt,
        tt_counts=stk[6] if w_tt else None,
        w_ip=w_ip,
        ip_totals=stk[7] if w_ip else None,
    )
