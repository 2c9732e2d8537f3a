"""Mesh implementation of the batch and wave schedulers: the node axis
sharded over a DeviceMesh, against the resident sharded state.

PyTorch counterpart of kubernetes_tpu/parallel/mesh.py, with the same
function names. Node-axis tables are split shard by shard
(parallel/shard, parallel/resident); pod rows are replicated, once a
distinct device. Each shard_map body of the JAX package becomes a
function over the mesh's per-shard tables: every shard computes its
partial, the collective the JAX body has there runs (parallel/shard
pmax, psum, all_gather), and every shard continues. Results are
bit-identical to the single-device drivers: every reduction computes the
same integers, distributed. Values the JAX body casts to int32 before a
pmax are cast the same way here.

- _shard_fit: a shard's predicates, its global offset and its interpod
  topology window.
- _mesh_scan_fn: one scan step: up to five collectives between the
  predicates and the selection (the NodeAffinity and TaintToleration
  maxima, the interpod totals and fits, the ServiceAntiAffinity fit, the
  global selection), then a commit into the owning shard. The
  replicated interpod and service tables take the identical global fold
  once a distinct device.
- _spread_sharded: SelectorSpread with its maximum and zone counts made
  mesh-global (pmax, two psums).
- _mesh_probe_rows: the probe body of one shard; its resource section
  (fit frontier + LR/BA j-table) launches K1 on the shard's node slice
  (ops/probe_kernel.resource_probe), as models/probe does on one device.
- _mesh_probe_fn / _mesh_group_probe_fn / _mesh_apply_fn /
  _mesh_apply_group_fn: the wave probe, the grouped header probe, and
  the commit folds in scatter form.
- MeshBatchScheduler: the serial scan over the mesh. MeshWaveScheduler:
  the wave driver over the mesh and the resident state; its host replay
  and run machinery are the port's models/wave helpers.

Deviation from kubernetes_tpu/parallel/mesh.py <module>: nothing is
compiled per shape and nothing is donated. The folds, the scan's commits
and the row scatter update the resident tensors in place, so there are
no pjit programs (_pjit_program, _probe_program, ...), no
CARRY_SPECS/_ns_tree shardings, and no runtime_donation() or
KUBERNETES_TPU_MESH_DONATE; _pad_snapshot is snapshot/pad.pad_snapshot.
The mesh ignores KUBERNETES_TPU_QUANT=bf16's score mode (K1 runs int64),
as the JAX mesh does. _opaque_blocks, _sparse_counts and
_sparse_group_counts are verbatim copies (tests/test_torch_isolation.py
FUNCTION_COPIES).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from kubernetes_tpu_torch.models.batch import (
    BALANCED_ALLOCATION,
    CHECK_NODE_MEMORY_PRESSURE,
    EQUAL,
    IMAGE_LOCALITY,
    INTER_POD_AFFINITY,
    LEAST_REQUESTED,
    MATCH_INTER_POD_AFFINITY,
    MAX_EBS_VOLUME_COUNT,
    MAX_GCE_PD_VOLUME_COUNT,
    NODE_AFFINITY,
    NO_DISK_CONFLICT,
    NO_VOLUME_ZONE_CONFLICT,
    POD_TOLERATES_NODE_TAINTS,
    SELECTOR_SPREAD,
    TAINT_TOLERATION,
    BatchScheduler,
    SchedulerConfig,
    wants_host,
    wants_ports,
    wants_resources,
    wants_selector,
)
from kubernetes_tpu_torch.models.pack import pack_arrays, unpack
from kubernetes_tpu_torch.ops import interpod as IP
from kubernetes_tpu_torch.ops import predicates as P
from kubernetes_tpu_torch.ops import priorities as R
from kubernetes_tpu_torch.ops import probe_kernel as PK
from kubernetes_tpu_torch.ops import select as S
from kubernetes_tpu_torch.ops import services as SV
from kubernetes_tpu_torch.ops import volumes as V
from kubernetes_tpu_torch.parallel.resident import (
    ResidentClusterState,
    host_carry,
    host_static,
    place_tables,
    upload,
)
from kubernetes_tpu_torch.parallel.shard import (
    DeviceMesh,
    all_gather,
    pmax,
    psum,
)
from kubernetes_tpu_torch.snapshot.carry import place
from kubernetes_tpu_torch.snapshot.encode import (
    ClusterSnapshot,
    PodBatch,
    service_config_labels,
)
from kubernetes_tpu_torch.snapshot.pad import pad_snapshot

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32


def _default_mesh() -> DeviceMesh:
    """Every visible card, one shard each (the JAX default mesh of
    jax.devices()). Raises without a card: pass a mesh to run on the
    CPU."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("mesh: CUDA is not available; pass a "
                           "DeviceMesh of CPU devices to run on the CPU")
    return DeviceMesh([f"cuda:{i}" for i in range(n)])


def _masked_max_i32(counts, fit):
    """counts.max(where=fit, initial=0).astype(int32), the value the JAX
    body hands its pmax."""
    return torch.where(fit, counts, 0).max().clamp(min=0).to(I32)


def _shard_fit(config, n_per_shard, n_global, s, static, carry, pod,
               include_resources=True):
    """Shard s's fit mask (the predicate section of the scan body,
    shared with the mesh wave probe). Returns (fit bool[n_per_shard],
    cnt_lt, topo_local, offset); cnt_lt/topo_local are None unless
    interpod is configured."""
    res = carry["res"]
    dev = res.device
    offset = s * n_per_shard

    # interpod count tables are replicated (small); queries use this
    # shard's node columns of the (replicated) topology-domain table
    want_ip_pred = MATCH_INTER_POD_AFFINITY in config.predicates
    want_ip_prio = any(n == INTER_POD_AFFINITY for n, _ in config.priorities)
    cnt_lt = topo_local = None
    if want_ip_pred or want_ip_prio:
        dom_tab = static["ip_topo_dom"]
        if dom_tab.numel():
            topo_local = dom_tab[:, offset:offset + n_per_shard]
        else:
            # no interpod terms in the cluster: the incremental encoder
            # emits a (0, 0) domain table (the full encoder (0, N)); the
            # empty per-shard window is exact
            topo_local = torch.zeros((dom_tab.shape[0], n_per_shard),
                                     dtype=dom_tab.dtype, device=dev)
        cnt_lt = IP.expand_lt(
            IP.gather_counts(carry["ip_term_count"], static["ip_u_topo"],
                             topo_local),
            static["ip_lt_u"], static["ip_lt_sign"], n_per_shard,
        )

    fit = ~pod["unschedulable"]
    if want_ip_prio:
        fit = fit & ~pod["ip_poison"]
    if NO_DISK_CONFLICT in config.predicates:
        fit = fit & V.no_disk_conflict(
            pod["vp_vol_rw"], pod["vp_vol_ro"], carry["vol_any"],
            carry["vol_rw"],
        )
    if NO_VOLUME_ZONE_CONFLICT in config.predicates:
        fit = fit & V.volume_zone(
            pod["vp_vz_zone"], pod["vp_vz_region"], pod["vp_vz_fail"],
            static["vz_zone"], static["vz_region"], static["vz_has"],
        )
    if MAX_EBS_VOLUME_COUNT in config.predicates:
        fit = fit & V.max_pd_count(
            pod["vp_ebs"], pod["vp_ebs_bad"], pod["vp_has_ebs"],
            carry["ebs_mask"], static["ebs_bad"], config.max_ebs_volumes,
        )
    if MAX_GCE_PD_VOLUME_COUNT in config.predicates:
        fit = fit & V.max_pd_count(
            pod["vp_gce"], pod["vp_gce_bad"], pod["vp_has_gce"],
            carry["gce_mask"], static["gce_bad"],
            config.max_gce_pd_volumes,
        )
    if include_resources and wants_resources(config):
        fit = fit & P.pod_fits_resources(
            pod["req_mcpu"], pod["req_mem"], pod["req_gpu"],
            pod["zero_req"],
            static["alloc_mcpu"], static["alloc_mem"],
            static["alloc_gpu"], static["alloc_pods"],
            res[0], res[1], res[2], res[5],
        )
    # host check against GLOBAL node ids
    if wants_host(config):
        local_ids = offset + torch.arange(n_per_shard, device=dev)
        fit = fit & torch.where(pod["host_req"] < 0, pod["host_req"] == -1,
                                local_ids == pod["host_req"])
    if wants_ports(config):
        fit = fit & P.pod_fits_host_ports(pod["port_mask"],
                                          carry["port_mask"])
    if wants_selector(config):
        fit = fit & P.match_node_selector(
            pod["ns_ops"], pod["ns_key"], pod["ns_set"], pod["ns_numkey"],
            pod["ns_num"], pod["aff_has_req"], pod["aff_term_valid"],
            pod["aff_ops"], pod["aff_key"], pod["aff_set"],
            pod["aff_numkey"], pod["aff_num"],
            static["label_kv"], static["label_key"], static["numval"],
            static["set_table"],
        )
    if POD_TOLERATES_NODE_TAINTS in config.predicates:
        fit = fit & P.pod_tolerates_node_taints(
            pod["tol_mask"], pod["has_tolerations"], static["taint_mask"],
            static["has_taints"], static["taint_bad"],
            static["noschedule_taints"],
        )
    if CHECK_NODE_MEMORY_PRESSURE in config.predicates:
        fit = fit & P.check_node_memory_pressure(pod["best_effort"],
                                                 static["mem_pressure"])
    svc_labels = service_config_labels(config)
    for entry in config.predicates:
        if isinstance(entry, tuple) and entry[0] == "CheckNodeLabelPresence":
            for lbl in entry[1]:
                has = static[f"nl_pred_{lbl}"]
                fit = fit & (has if entry[2] else ~has)
        elif isinstance(entry, tuple) and entry[0] == "ServiceAffinity":
            # svc tables are replicated (small: groups x labels); evaluate
            # over the GLOBAL node axis and slice this shard's window
            ok_g = SV.service_affinity(
                carry["svc_first_peer"], static["svc_lbl_val"],
                static["svc_ord_node"], pod["svc_group"], pod["svc_fixed"],
                tuple(svc_labels.index(lb) for lb in entry[1]), n_global,
            )
            fit = fit & ok_g[offset:offset + n_per_shard]
    if want_ip_pred:
        own_lt = IP.gather_lt(
            carry["ip_own_anti"], static["ip_u_topo"], topo_local,
            static["ip_lt_u"], static["ip_lt_sign"],
        )
        fit = fit & IP.match_interpod(
            cnt_lt, own_lt, carry["ip_spec_total"], static["ip_lt_spec"],
            pod["ip_match_spec"], pod["ip_ha_lt"], pod["ip_ha_self"],
            pod["ip_hq_lt"], pod["ip_has_affinity"], pod["ip_has_anti"],
            pod["ip_sym_reject"], n_per_shard,
        )
    return fit.expand(n_per_shard), cnt_lt, topo_local, offset


def _gather_lt(static, table, topo_local):
    return IP.gather_lt(table, static["ip_u_topo"], topo_local,
                        static["ip_lt_u"], static["ip_lt_sign"])


def _mesh_scan_fn(config, num_zones, n_per_shard, n_global, num_values,
                  mesh, statics, carries, pods):
    """One scan step over every shard, in place: `statics`/`carries`
    hold each shard's tables, `pods` each shard's copy of the pod row.
    Mirrors models/batch._scan_fn with the normalization maxima and the
    selection made global via collectives. -> chosen (0-d, global node
    id or -1) on the first shard's device."""
    S_ = mesh.size
    svc_labels = service_config_labels(config)
    want_ip_pred = MATCH_INTER_POD_AFFINITY in config.predicates
    want_ip_prio = any(n == INTER_POD_AFFINITY for n, _ in config.priorities)

    fits, ctx = [], []
    for s in range(S_):
        fit, cnt_lt, topo_local, offset = _shard_fit(
            config, n_per_shard, n_global, s, statics[s], carries[s],
            pods[s])
        fits.append(fit)
        ctx.append((cnt_lt, topo_local, offset))
    scores = [torch.zeros((n_per_shard,), dtype=I64,
                          device=carries[s]["res"].device)
              for s in range(S_)]

    def add(parts, weight):
        for s in range(S_):
            scores[s] = scores[s] + int(weight) * parts[s]

    for name, weight in config.priorities:
        if name == LEAST_REQUESTED:
            add([R.least_requested(
                pods[s]["nz_mcpu"], pods[s]["nz_mem"], carries[s]["res"][3],
                carries[s]["res"][4], statics[s]["alloc_mcpu"],
                statics[s]["alloc_mem"]) for s in range(S_)], weight)
        elif name == BALANCED_ALLOCATION:
            add([R.balanced_resource_allocation(
                pods[s]["nz_mcpu"], pods[s]["nz_mem"], carries[s]["res"][3],
                carries[s]["res"][4], statics[s]["alloc_mcpu"],
                statics[s]["alloc_mem"]) for s in range(S_)], weight)
        elif name == SELECTOR_SPREAD:
            add(_spread_sharded(
                [p["has_selectors"] for p in pods],
                [p["spread_match"] for p in pods],
                [c["class_count"] for c in carries],
                [st["zone_id"] for st in statics], num_zones, fits),
                weight)
        elif name == NODE_AFFINITY:
            counts = [R.node_affinity_counts(
                pods[s]["pref_valid"], pods[s]["pref_weight"],
                pods[s]["pref_ops"], pods[s]["pref_key"],
                pods[s]["pref_set"], pods[s]["pref_numkey"],
                pods[s]["pref_num"], statics[s]["label_kv"],
                statics[s]["label_key"], statics[s]["numval"],
                statics[s]["set_table"]) for s in range(S_)]
            # int32 for the collective, as the JAX body casts it
            mx = pmax([_masked_max_i32(counts[s], fits[s])
                       for s in range(S_)])
            add([R.normalize_counts_up(counts[s], mx[s].to(I64))
                 for s in range(S_)], weight)
        elif name == TAINT_TOLERATION:
            counts = [R.taint_intolerable_counts(
                statics[s]["taint_count"], pods[s]["intolerable_prefer"])
                for s in range(S_)]
            mx = pmax([_masked_max_i32(counts[s], fits[s])
                       for s in range(S_)])
            add([R.normalize_counts_down(counts[s], mx[s].to(I64))
                 for s in range(S_)], weight)
        elif name == INTER_POD_AFFINITY:
            totals = []
            for s in range(S_):
                cnt_lt, topo_local, _off = ctx[s]
                st, cr = statics[s], carries[s]
                totals.append(IP.interpod_totals(
                    cnt_lt,
                    _gather_lt(st, cr["ip_rev_hard"], topo_local),
                    _gather_lt(st, cr["ip_rev_pref"], topo_local),
                    _gather_lt(st, cr["ip_rev_anti"], topo_local),
                    st["ip_lt_spec"], pods[s]["ip_match_spec"],
                    pods[s]["ip_fwd_lt"], pods[s]["ip_fwd_w"],
                    config.hard_pod_affinity_weight, n_per_shard,
                ))
            # global min/max over fit nodes: gather the small vectors
            totals_g = all_gather(totals)
            fitp_g = all_gather(fits)
            parts = []
            for s in range(S_):
                mx, mn = IP.interpod_minmax(totals_g[s], fitp_g[s])
                parts.append(IP.interpod_normalize(totals[s], fits[s], mx,
                                                   mn))
            add(parts, weight)
        elif name == EQUAL:
            add([R.equal(n_per_shard, device=sc.device) for sc in scores],
                weight)
        elif name == IMAGE_LOCALITY:
            # unnormalized: shards score their local nodes independently
            add([R.image_locality(statics[s]["img_size"],
                                  pods[s]["img_count"])
                 for s in range(S_)], weight)
        elif isinstance(name, tuple) and name[0] == "NodeLabelPriority":
            add([R.node_label(statics[s][f"nl_prio_{name[1]}"], name[2])
                 for s in range(S_)], weight)
        elif isinstance(name, tuple) and name[0] == "ServiceAntiAffinity":
            # the spread normalizer counts peers on the global filtered
            # node list: gather fit, score globally, slice local window
            fit_g = all_gather(fits)
            parts = []
            for s in range(S_):
                s_g = SV.service_anti_affinity(
                    carries[s]["svc_peer_node_count"],
                    carries[s]["svc_peer_total"],
                    statics[s]["svc_lbl_val"][svc_labels.index(name[1])],
                    pods[s]["svc_group"], fit_g[s], num_values, n_global,
                )
                off = ctx[s][2]
                parts.append(s_g[off:off + n_per_shard])
            add(parts, weight)
        else:
            raise ValueError(name)

    # --- global selection: gather the small per-node vectors, pick once
    # a distinct device (every shard of the JAX body picks the same node)
    score_g = all_gather(scores)
    fit_g = all_gather(fits)
    picks = {}
    for t in mesh.first_shard_of():
        picks[mesh.devices[t]] = S.select_host(
            score_g[t], fit_g[t], carries[t]["last_idx"],
            statics[t]["name_desc_order_global"])

    # --- commit into the shard that owns the chosen node
    want_vol = any(k in config.predicates for k in (
        NO_DISK_CONFLICT, MAX_EBS_VOLUME_COUNT, MAX_GCE_PD_VOLUME_COUNT))
    for s in range(S_):
        chosen, scheduled = picks[mesh.devices[s]]
        pod, cr = pods[s], carries[s]
        local = chosen - ctx[s][2]
        mine = scheduled & (local >= 0) & (local < n_per_shard)
        safe = local.clamp(0, n_per_shard - 1).view(1)
        inc = mine.to(I64)
        commit = torch.stack([
            pod["commit_mcpu"], pod["commit_mem"], pod["commit_gpu"],
            pod["nz_mcpu"], pod["nz_mem"], torch.ones_like(inc),
        ]) * inc
        cr["res"].index_add_(1, safe, commit[:, None])
        pm = cr["port_mask"]
        pm.index_copy_(0, safe, pm.index_select(0, safe)
                       | (pod["port_mask"] * inc)[None, :])
        cr["class_count"].index_put_(
            (safe, pod["class_id"].view(1)), inc.view(1), accumulate=True)
        if want_vol:
            sel = inc * 0xFFFFFFFF
            for key, bits in (
                ("vol_any", pod["vp_vol_rw"] | pod["vp_vol_ro"]),
                ("vol_rw", pod["vp_vol_rw"]),
                ("ebs_mask", pod["vp_ebs"]),
                ("gce_mask", pod["vp_gce"]),
            ):
                t = cr[key]
                t.index_copy_(0, safe, t.index_select(0, safe)
                              | (bits & sel)[None, :])
    # the replicated tables: the identical GLOBAL fold, once a device
    for t in mesh.first_shard_of():
        chosen, scheduled = picks[mesh.devices[t]]
        pod, cr, st = pods[t], carries[t], statics[t]
        cr["last_idx"] += scheduled.to(I64)  # global counter
        if want_ip_pred or want_ip_prio:
            IP.interpod_commit(
                cr["ip_term_count"], cr["ip_own_anti"], cr["ip_rev_hard"],
                cr["ip_rev_pref"], cr["ip_rev_anti"], cr["ip_spec_total"],
                st["ip_topo_dom"], st["ip_u_topo"], st["ip_u_spec"],
                st["ip_lt_u"], pod["ip_match_spec"], pod["ip_own_hard"],
                pod["ip_own_pref"], pod["ip_own_anti_hard"],
                pod["ip_own_anti_pref"], chosen, scheduled,
            )
        if svc_labels:
            SV.service_commit(
                cr["svc_first_peer"], cr["svc_peer_node_count"],
                cr["svc_peer_total"], st["svc_node_ord"],
                pod["svc_member"], chosen, scheduled,
            )
    return picks[mesh.devices[0]][0]


def _spread_sharded(pod_has_selectors, pod_spread_match, class_count,
                    zone_id, num_zones, fit_mask):
    """selector_spread with the max/zone reductions made mesh-global:
    every argument is a list over the shards. -> the shards' scores.

    The blend takes the oracle's float32 weights, f * fl32(1/3) +
    fl32(2/3) * zone, as ops/priorities.selector_spread does; the JAX
    body (mesh.py:531) weights f by 1 - fl32(2/3) computed in float32,
    2**-25 below fl32(1/3) (ROADMAP.md queue 3)."""
    S_ = len(fit_mask)
    counts, zone_idx = [], []
    for s in range(S_):
        c = R._matvec(class_count[s], pod_spread_match[s])
        counts.append(torch.where(fit_mask[s], c, 0))
        zone_idx.append(zone_id[s].to(I64))
    max_count = pmax([_masked_max_i32(counts[s], fit_mask[s])
                      for s in range(S_)])
    zc, zs = [], []
    for s in range(S_):
        dev = counts[s].device
        zc.append(torch.zeros((num_zones,), dtype=I32, device=dev)
                  .index_add_(0, zone_idx[s],
                              torch.where(fit_mask[s], counts[s], 0)
                              .to(I32)))
        zs.append(torch.zeros((num_zones,), dtype=I32, device=dev)
                  .index_add_(0, zone_idx[s],
                              (fit_mask[s] & (zone_id[s] > 0)).to(I32)))
    zcounts = psum(zc)
    zone_seen = psum(zs)
    out = []
    for s in range(S_):
        dev = counts[s].device
        mc = max_count[s].to(I64)
        zcs = zcounts[s].to(I64)
        have_zones = (zone_seen[s] > 0).any()
        max_zone = torch.where(torch.arange(num_zones, device=dev) > 0,
                               zcs, 0).max().clamp(min=0)
        ten = torch.full((), float(R.MAX_PRIORITY), dtype=F32, device=dev)
        f = torch.where(mc > 0,
                        ten * ((mc - counts[s]).to(F32) / mc.to(F32)), ten)
        node_zcount = zcs[zone_idx[s]]
        zone_score = ten * ((max_zone - node_zcount).to(F32)
                            / max_zone.to(F32))
        third = torch.full((), 1.0 / 3.0, dtype=F32, device=dev)
        two_thirds = torch.full((), 2.0 / 3.0, dtype=F32, device=dev)
        blended = f * third + two_thirds * zone_score
        f = torch.where(have_zones & (zone_id[s] > 0), blended, f)
        f = torch.where(pod_has_selectors[s], f, ten)
        nan = torch.isnan(f)
        out.append(torch.where(nan, -(2**63),
                               torch.where(nan, 0.0, f).to(I64)))
    return out


def _mesh_probe_rows(config, num_zones, num_values, J, n_per_shard,
                     n_global, s, static, carry, pod):
    """Shard s's probe body (models/probe._probe_rows, sharded): ->
    (stk i64[N_STK_ROWS, n_per_shard], tab i64[J, n_per_shard]). The
    resource section launches K1 on the shard's node slice."""
    res = carry["res"]
    dev = res.device
    N = n_per_shard

    fit_static, cnt_lt, topo_local, offset = _shard_fit(
        config, n_per_shard, n_global, s, static, carry, pod,
        include_resources=False,
    )
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
        wants_res=wants_resources(config),
    )
    if wants_ports(config):
        # host-port self-conflict: res_fit is monotone in j, so killing
        # every j>0 row caps the frontier at 1
        has_ports = (pod["port_mask"] != 0).any()
        frontier = torch.where(has_ports, frontier.clamp(max=1), frontier)

    static_add = torch.zeros((N,), dtype=I64, device=dev)
    zeros = torch.zeros((N,), dtype=I64, device=dev)
    stk_rows = {"spread_base": zeros, "spread_selfmatch": zeros,
                "na_counts": zeros, "tt_counts": zeros, "ip_totals": zeros}
    for name, weight in config.priorities:
        if name in (LEAST_REQUESTED, BALANCED_ALLOCATION):
            continue  # K1 already accumulated this term
        elif name == SELECTOR_SPREAD:
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
                _gather_lt(static, carry["ip_rev_hard"], topo_local),
                _gather_lt(static, carry["ip_rev_pref"], topo_local),
                _gather_lt(static, carry["ip_rev_anti"], topo_local),
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
        elif isinstance(name, tuple) and name[0] == "NodeLabelPriority":
            static_add = static_add + int(weight) * R.node_label(
                static[f"nl_prio_{name[1]}"], name[2]
            )
        elif isinstance(name, tuple) and name[0] == "ServiceAntiAffinity":
            pass  # per-pick renormalization: the replay consumes the
            # svc rows emitted below
        else:
            raise ValueError(f"priority {name!r} is not mesh-wave-eligible")
    # service rows (the single-device probe's svc_counts/svc_total/
    # svc_pin; see probe.N_STK_ROWS)
    from kubernetes_tpu_torch.snapshot.services import ORD_NONE

    first_peer = carry["svc_first_peer"]
    G = first_peer.shape[0]
    if G:
        g = pod["svc_group"].clamp(0, G - 1)
        has_group = pod["svc_group"] >= 0
        # the peer-count table is REPLICATED (G, N_global): emit this
        # shard's slice so the concatenated rows equal the single-device
        # probe's global row
        counts_g = torch.where(has_group, carry["svc_peer_node_count"][g],
                               0)
        svc_counts = counts_g[offset:offset + N]
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


def _mesh_probe_fn(config, num_zones, num_values, J, n_per_shard,
                   n_global, s, static, carry, pod):
    """Shard s's wave probe (models/probe._probe_fn, sharded): this
    shard's slice of the packed table product. Concatenated along the
    node axis, the shards' products are the (N_STK_ROWS + J-words, N)
    array the single-device probe ships, so the replay and the commit
    mapping are untouched."""
    from kubernetes_tpu_torch.models.probe import _TORCH_DTYPE, _tab_dtype

    stk, tab = _mesh_probe_rows(
        config, num_zones, num_values, J, n_per_shard, n_global, s, static,
        carry, pod,
    )
    N = n_per_shard
    dt = np.dtype(_tab_dtype(config))
    k = 8 // dt.itemsize
    tabp = tab.to(_TORCH_DTYPE[dt]).reshape(J // k, k, N).transpose(1, 2)
    tabw = tabp.contiguous().view(-1).view(I64).reshape(J // k, N)
    return torch.cat([stk, tabw], dim=0)


def _mesh_group_probe_fn(config, num_zones, num_values, G, n_per_shard,
                         n_global, s, static, carry, pods):
    """Shard s's grouped header probe: _mesh_probe_rows at J=1 for each of
    the G run representatives of `pods` (stacked on a leading axis of
    G_bucket rows; the padded slots repeat the last header, as
    models/probe._group_probe_fn does). No resource block ships back:
    the host rebuilds the j-axis against the resident state's exact
    usage mirror (models/hosttab). -> i64[G_bucket * N_STK_ROWS,
    n_per_shard]."""
    G_bucket = pods["req_mcpu"].shape[0]
    stks = [
        _mesh_probe_rows(config, num_zones, num_values, 1, n_per_shard,
                         n_global, s, static, carry,
                         {f: t[g] for f, t in pods.items()})[0]
        for g in range(G)
    ]
    stks += [stks[-1]] * (G_bucket - G)
    return torch.cat(stks, dim=0)


def _mesh_apply_group_fn(config, n_global, mesh, statics, carries, pods,
                         touch_idx, touch_cnt):
    """The grouped commit fold over the mesh, in place: commits arrive in
    scatter form (per-run touched node ids + amounts, one copy a distinct
    device); each shard folds its slice of the rebuilt per-run global
    counts [G, N]. Valid for PURE runs only (models/wave.run_pure):
    resource block, port masks, spread class counts and the round-robin
    counter; the replicated ip/svc tables are untouched."""
    counts_by_dev = {
        d: _group_counts_from_touch(n_global, touch_idx[d], touch_cnt[d])
        for d in mesh.distinct_devices()
    }
    n_per_shard = n_global // mesh.size
    for s, d in enumerate(mesh.devices):
        p, cr = pods[s], carries[s]
        offset = s * n_per_shard
        counts = counts_by_dev[d][:, offset:offset + n_per_shard]
        commit = torch.stack([
            p["commit_mcpu"], p["commit_mem"], p["commit_gpu"],
            p["nz_mcpu"], p["nz_mem"], torch.ones_like(p["commit_mcpu"]),
        ])  # (6, G)
        cr["res"] += (commit[:, :, None] * counts[None, :, :]).sum(dim=1)
        bits = torch.where((counts > 0)[:, :, None],
                           p["port_mask"][:, None, :], 0)  # (G, n, W)
        while bits.shape[0] > 1:  # OR over the runs, halving
            if bits.shape[0] % 2:
                bits = torch.cat([bits, torch.zeros_like(bits[:1])])
            h = bits.shape[0] // 2
            bits = bits[:h] | bits[h:]
        cr["port_mask"] |= bits[0]
        cr["class_count"].index_add_(1, p["class_id"],
                                     counts.T.contiguous())
    for t in mesh.first_shard_of():
        carries[t]["last_idx"] += counts_by_dev[mesh.devices[t]].sum()


def _mesh_apply_fn(config, n_global, mesh, statics, carries, pods,
                   touch_idx, touch_cnt):
    """The wave commit fold over the mesh, in place: commits arrive in
    scatter form (touched node ids + amounts); node-axis tables take
    each shard's slice of the rebuilt global counts; the replicated
    interpod and service tables take the identical global fold once a
    distinct device (the pattern interpod_commit uses in the mesh
    scan)."""
    counts_by_dev = {
        d: _counts_from_touch(n_global, touch_idx[d], touch_cnt[d])
        for d in mesh.distinct_devices()
    }
    n_per_shard = n_global // mesh.size
    for s, d in enumerate(mesh.devices):
        p, cr = pods[s], carries[s]
        offset = s * n_per_shard
        counts = counts_by_dev[d][offset:offset + n_per_shard]
        commit = torch.stack([
            p["commit_mcpu"], p["commit_mem"], p["commit_gpu"],
            p["nz_mcpu"], p["nz_mem"], torch.ones_like(p["commit_mcpu"]),
        ])
        cr["res"] += commit[:, None] * counts[None, :]
        cr["port_mask"] |= torch.where((counts > 0)[:, None],
                                       p["port_mask"][None, :], 0)
        cr["class_count"].index_add_(1, p["class_id"].view(1),
                                     counts[:, None])
    for t in mesh.first_shard_of():
        p, cr, st = pods[t], carries[t], statics[t]
        counts_global = counts_by_dev[mesh.devices[t]]
        k = counts_global.sum()
        cr["last_idx"] += k
        u_topo = st["ip_u_topo"]
        U = u_topo.shape[0]
        term_count = cr["ip_term_count"]
        if U and term_count.shape[1]:
            dom = st["ip_topo_dom"][u_topo]  # (U, NG)
            mu = p["ip_match_spec"][st["ip_u_spec"]].to(I64)
            add = torch.where(dom >= 0, mu[:, None] * counts_global[None, :],
                              0)
            rows = torch.arange(U, device=dom.device)[:, None].expand_as(dom)
            term_count.index_put_(
                (rows, dom.clamp(0, term_count.shape[1] - 1)), add,
                accumulate=True)
        lt_u = st["ip_lt_u"]
        LT = lt_u.shape[0]
        E = lt_u.shape[1] if LT else 0
        own_anti = cr["ip_own_anti"]
        if U and LT and E and own_anti.shape[2]:
            q = u_topo[lt_u.clamp(0, U - 1)]
            domq = st["ip_topo_dom"][q]  # (LT, E, NG)
            validq = (lt_u >= 0)[:, :, None] & (domq >= 0)
            sdq = domq.clamp(0, own_anti.shape[2] - 1)
            dv = sdq.device
            index = (
                torch.arange(LT, device=dv)[:, None, None].expand_as(sdq),
                torch.arange(E, device=dv)[None, :, None].expand_as(sdq),
                sdq,
            )
            c = torch.where(validq, counts_global[None, None, :], 0)
            for key, own in (("ip_own_anti", "ip_own_anti_hard"),
                             ("ip_rev_hard", "ip_own_hard"),
                             ("ip_rev_pref", "ip_own_pref"),
                             ("ip_rev_anti", "ip_own_anti_pref")):
                cr[key].index_put_(index, p[own][:, None, None] * c,
                                   accumulate=True)
        if cr["ip_spec_total"].shape[0]:
            cr["ip_spec_total"] += p["ip_match_spec"].to(I64) * k
        # service tables are replicated: the identical GLOBAL fold
        SV.service_commit_bulk(
            cr["svc_first_peer"], cr["svc_peer_node_count"],
            cr["svc_peer_total"], st["svc_node_ord"], p["svc_member"],
            counts_global,
        )


def _counts_from_touch(n_global, touch_idx, touch_cnt):
    """Dense i64[N] commit counts from the scatter-form shipment
    (touched node ids padded with -1 + per-node amounts)."""
    valid = touch_idx >= 0
    safe = touch_idx.clamp(0, n_global - 1)
    return torch.zeros((n_global,), dtype=I64,
                       device=touch_idx.device).index_add_(
        0, safe, torch.where(valid, touch_cnt, 0))


def _group_counts_from_touch(n_global, touch_idx, touch_cnt):
    """Scatter-form -> dense i64[G, N] per-run commit counts."""
    G, M = touch_idx.shape
    valid = touch_idx >= 0
    safe = touch_idx.clamp(0, n_global - 1)
    g_i = torch.arange(G, dtype=I64, device=touch_idx.device)[:, None]
    out = torch.zeros((G, n_global), dtype=I64, device=touch_idx.device)
    out.index_put_((g_i.expand(G, M), safe),
                   torch.where(valid, touch_cnt, 0), accumulate=True)
    return out


def _replicate(mesh: DeviceMesh, arr: np.ndarray) -> dict:
    """A host array -> one placed tensor a distinct device."""
    return {d: place(arr, d) for d in mesh.distinct_devices()}


def _shard_rows(mesh: DeviceMesh, layout, bufs: dict) -> list:
    """A packed buffer on every distinct device -> each shard's unpacked
    fields (shards of one device share them)."""
    by_dev = {d: unpack(layout, b) for d, b in bufs.items()}
    return [by_dev[d] for d in mesh.devices]


class MeshBatchScheduler:
    """BatchScheduler over a DeviceMesh: node axis sharded, pods
    replicated. The pod scan is sequential by construction: one Python
    pass a pod over the shards."""

    def __init__(self, mesh: Optional[DeviceMesh] = None,
                 config: Optional[SchedulerConfig] = None):
        self.mesh = mesh if mesh is not None else _default_mesh()
        self.config = config or SchedulerConfig()

    def schedule(self, snap: ClusterSnapshot, batch: PodBatch,
                 last_node_index: int = 0):
        """-> (chosen i32[P] with -1 == unschedulable, final carry: each
        shard's carry dict)."""
        n_dev = self.mesh.size
        if len(snap.node_names) == 0:
            sched = BatchScheduler(self.config, device=self.mesh.devices[0])
            return (np.full(batch.num_pods, -1, np.int32),
                    sched.initial_carry(snap, last_node_index))
        snap = pad_snapshot(snap, n_dev)
        n = len(snap.node_names)
        n_per_shard = n // n_dev
        statics, carries = place_tables(
            self.mesh, host_static(self.config, snap),
            host_carry(snap, last_node_index))
        pods = {f: np.asarray(getattr(batch, f))
                for f in BatchScheduler.POD_FIELDS}
        num_zones = max(int(snap.zone_id.max()) + 1, 1)
        num_values = int(snap.svc_num_values)
        final, chosen = self._exec(statics, carries, pods, n, n_per_shard,
                                   num_zones, num_values, batch.num_pods)
        return chosen, final

    def _exec(self, statics, carries, pods, n, n_per_shard, num_zones,
              num_values, num_pods):
        """Scan host pod rows (name -> [P, ...]) through an EXTERNAL carry
        (the mesh wave's fallback flush threads its resident carry
        through here), in place. -> (carries, chosen i32[P] numpy)."""
        chosen = self._dispatch(statics, carries, pods, n, n_per_shard,
                                num_zones, num_values, num_pods)
        return carries, chosen.cpu().numpy().astype(np.int32)

    def _dispatch(self, statics, carries, pods, n, n_per_shard, num_zones,
                  num_values, num_pods):
        """_exec's device half: the pod rows uploaded once a distinct
        device, the scan steps enqueued -> chosen i64[P] on the mesh's
        first device (no host sync)."""
        layout, buf = pack_arrays(pods)
        rows = _shard_rows(self.mesh, layout,
                           {d: upload(buf, d)
                            for d in self.mesh.distinct_devices()})
        chosen = torch.empty((num_pods,), dtype=I64,
                             device=self.mesh.devices[0])
        for i in range(num_pods):
            pod_i = [{f: r[f][i] for f in BatchScheduler.POD_FIELDS}
                     for r in rows]
            chosen[i] = _mesh_scan_fn(
                self.config, num_zones, n_per_shard, n, num_values,
                self.mesh, statics, carries, pod_i)
        return chosen

    def schedule_names(self, snap: ClusterSnapshot, batch: PodBatch):
        names = list(snap.node_names)
        chosen, _ = self.schedule(snap, batch)
        return [names[i] if i >= 0 else None for i in chosen]


def _opaque_blocks(config) -> tuple:
    """Resident carry blocks this config's scan/impure folds can touch
    in ways the host mirrors cannot track (they resync from the next
    snapshot instead)."""
    blocks = []
    if MATCH_INTER_POD_AFFINITY in config.predicates or any(
        n == INTER_POD_AFFINITY for n, _ in config.priorities
    ):
        blocks.append("ip")
    if any(k in config.predicates for k in (
        NO_DISK_CONFLICT, MAX_EBS_VOLUME_COUNT, MAX_GCE_PD_VOLUME_COUNT,
    )):
        blocks.append("vol")
    if service_config_labels(config):
        blocks.append("svc")
    return tuple(blocks)


def _sparse_counts(counts: np.ndarray, floor: int = 64):
    """Dense i64[N] commit counts -> (idx i64[M], cnt i64[M]) scatter
    form, M pow2-bucketed (compile reuse) and padded with idx=-1: the
    commit shipment is O(touched nodes) <= O(picks), never O(N)."""
    from kubernetes_tpu_torch.snapshot.pad import next_pow2

    ids = np.nonzero(counts)[0]
    M = next_pow2(max(len(ids), 1), floor)
    idx = np.full(M, -1, np.int64)
    cnt = np.zeros(M, np.int64)
    idx[: len(ids)] = ids
    cnt[: len(ids)] = counts[ids]
    return idx, cnt


def _sparse_group_counts(counts_mat: np.ndarray, floor: int = 64):
    """Dense i64[G, N] -> (idx i64[G, M], cnt i64[G, M]) scatter form
    with a shared pow2 M bucket."""
    from kubernetes_tpu_torch.snapshot.pad import next_pow2

    G = counts_mat.shape[0]
    nz = [np.nonzero(row)[0] for row in counts_mat]
    width = max((len(i) for i in nz), default=0)
    M = next_pow2(max(width, 1), floor)
    idx = np.full((G, M), -1, np.int64)
    cnt = np.zeros((G, M), np.int64)
    for g, ids in enumerate(nz):
        idx[g, : len(ids)] = ids
        cnt[g, : len(ids)] = counts_mat[g, ids]
    return idx, cnt


class MeshWaveScheduler:
    """The wave fast path over a device mesh, resident-state edition:
    probe tables computed per shard against the DEVICE-RESIDENT sharded
    cluster state (K1 on each shard's slice), the replay on the host
    exactly as on one device, and the commit fold applied per shard from
    an O(picks) scatter-form shipment. Ineligible pods flush through the
    sharded scan with the SAME resident carry, so the combined output is
    bit-identical to the single-device wave and the serial oracle.
    Wave-to-wave the node tables stay on the devices: ``resident`` holds
    them, its host mirrors prove freshness, and only deltas (node
    add/remove scatter, invalidated blocks) ever re-ship. ``dispatches``
    tallies a wave's device dispatches with the JAX mesh driver's keys
    (probe, group_probe, apply, scan)."""

    def __init__(self, mesh: Optional[DeviceMesh] = None,
                 config: Optional[SchedulerConfig] = None,
                 min_run: int = 16, max_j: int = 1024,
                 pod_floor: int = 64, replay=None):
        from kubernetes_tpu_torch.models.replay import replay_fast

        self.mesh = mesh if mesh is not None else _default_mesh()
        self.config = config or SchedulerConfig()
        self.scan = MeshBatchScheduler(self.mesh, config=self.config)
        self.min_run = min_run
        self.max_j = max_j
        self.pod_floor = pod_floor
        self._replay = replay or replay_fast
        # the device-resident sharded cluster state (+ transfer stats)
        self.resident = ResidentClusterState(self.mesh)
        # reuse mode when the caller passes none: "auto" mirror-compares
        # (the daemon), "carry" trusts the resident carry, "reship"
        # re-places per wave (the A/B baseline)
        self.reuse_default = "auto"
        self.dispatches: dict = {}

    # -- dispatch wrappers ---------------------------------------------------

    def _place_replicated(self, layout, buf) -> list:
        """A packed pod/group buffer, shipped once a distinct device and
        counted once: -> each shard's unpacked rows. Both the probe and
        the fold read the same device copy."""
        bufs = {d: upload(buf, d) for d in self.mesh.distinct_devices()}
        self.resident.count_h2d(buf.nbytes)
        return _shard_rows(self.mesh, layout, bufs)

    def _gather_host(self, parts) -> np.ndarray:
        """The shards' outputs concatenated along the node axis, on the
        host (one copy)."""
        dev = parts[0].device
        return np.ascontiguousarray(
            torch.cat([p.to(dev) for p in parts], dim=1).cpu().numpy())

    def _probe_run(self, statics, carries, pods, n, n_per_shard,
                   num_zones, num_values, J) -> np.ndarray:
        return self._gather_host([
            _mesh_probe_fn(self.config, num_zones, num_values, J,
                           n_per_shard, n, s, statics[s], carries[s],
                           pods[s])
            for s in range(self.mesh.size)])

    def _apply_run(self, statics, carries, pods, counts, n):
        idx, cnt = _sparse_counts(counts)
        self.resident.count_h2d(idx.nbytes + cnt.nbytes)
        _mesh_apply_fn(self.config, n, self.mesh, statics, carries, pods,
                       _replicate(self.mesh, idx),
                       _replicate(self.mesh, cnt))

    def _group_probe_run(self, statics, carries, pods, n, n_per_shard,
                         num_zones, num_values, G) -> np.ndarray:
        """-> headers i64[G_bucket, N_STK_ROWS, N]: the grouped header
        probe, one device-to-host copy (the resource block does not
        ship: the resident host mirror supplies the replay's usage)."""
        from kubernetes_tpu_torch.models.probe import N_STK_ROWS

        arr = self._gather_host([
            _mesh_group_probe_fn(self.config, num_zones, num_values, G,
                                 n_per_shard, n, s, statics[s], carries[s],
                                 pods[s])
            for s in range(self.mesh.size)])
        return arr.reshape(-1, N_STK_ROWS, n)

    def _apply_group_run(self, statics, carries, pods, counts_mat,
                         G_bucket, n):
        cm = np.zeros((G_bucket, n), np.int64)
        cm[: counts_mat.shape[0]] = counts_mat
        idx, cnt = _sparse_group_counts(cm)
        self.resident.count_h2d(idx.nbytes + cnt.nbytes)
        _mesh_apply_group_fn(self.config, n, self.mesh, statics, carries,
                             pods, _replicate(self.mesh, idx),
                             _replicate(self.mesh, cnt))

    # -- backlog driver ------------------------------------------------------

    def schedule_backlog(
        self,
        snap: ClusterSnapshot,
        batch: PodBatch,
        rep_idx: np.ndarray,
        last_node_index: int = 0,
        reuse: Optional[str] = None,
    ):
        """The single-device WaveScheduler.schedule_backlog semantics over
        the mesh: -> (chosen i32[P] node ids, final carry (each shard's
        dict), lastNodeIndex). `reuse` governs the resident state:
        "auto" mirror-compares against the snapshot and ships only
        deltas; "carry" trusts the resident carry outright (steady loops
        whose snapshot is the stale wave-0 view); "reship" re-places
        everything (the A/B baseline)."""
        from kubernetes_tpu_torch.models.probe import tables_from_packed
        from kubernetes_tpu_torch.models.replay import ReplayResult
        from kubernetes_tpu_torch.models.wave import (
            _host_group_cap,
            _permute_tables,
            classify_runs,
            gather_batch,
            group_buffer,
            host_group_replay,
            split_runs,
        )
        from kubernetes_tpu_torch.snapshot.pad import next_pow2, pad_batch

        if reuse is None:
            reuse = self.reuse_default
        n_dev = self.mesh.size
        snap = pad_snapshot(snap, n_dev)
        N = len(snap.node_names)
        n_per_shard = N // n_dev
        P_ = len(rep_idx)

        self.resident.begin_wave()
        statics, carries = self.resident.sync(
            self.config, snap, last_node_index, reuse=reuse
        )
        num_zones = max(int(snap.zone_id.max()) + 1, 1)
        num_values = int(snap.svc_num_values)
        zoned = bool(np.any(np.asarray(snap.zone_id) > 0))
        out = np.full(P_, -1, np.int32)
        perm = np.asarray(snap.name_desc_order).astype(np.int64)
        runs = split_runs(rep_idx)
        self.dispatches = {}
        pending: list = []
        L_host = int(last_node_index)
        blocks = _opaque_blocks(self.config)

        def count(key):
            self.dispatches[key] = self.dispatches.get(key, 0) + 1

        def flush():
            nonlocal L_host
            if not pending:
                return
            rows = np.asarray(pending, np.int64)
            seg = gather_batch(batch, rep_idx[rows])
            segp = pad_batch(seg, next_pow2(len(rows), self.pod_floor))
            pods = {
                f: np.asarray(getattr(segp, f))
                for f in BatchScheduler.POD_FIELDS
            }
            count("scan")
            self.resident.count_h2d(
                sum(v.nbytes for v in pods.values()))
            _c, chosen = self.scan._exec(
                statics, carries, pods, N, n_per_shard, num_zones,
                num_values, segp.num_pods,
            )
            chosen_host = chosen[: len(rows)]
            out[rows] = chosen_host
            L_host = int(carries[0]["last_idx"])
            # host-visible pure-channel commits keep the mirrors exact;
            # the opaque feature blocks resync from the next snapshot
            segf = {
                f: np.asarray(getattr(seg, f))
                for f in ("commit_mcpu", "commit_mem", "commit_gpu",
                          "nz_mcpu", "nz_mem", "port_mask", "class_id")
            }
            self.resident.note_scan(
                [{k: v[i] for k, v in segf.items()}
                 for i in range(len(rows))],
                chosen_host,
            )
            # invalidate only the blocks these pods can actually have
            # folded on device: a featureless scan wave must not force a
            # next-wave resync
            inv = []
            if "ip" in blocks and any(
                np.asarray(getattr(seg, f)).size
                and np.asarray(getattr(seg, f)).any()
                for f in ("ip_match_spec", "ip_own_hard", "ip_own_pref",
                          "ip_own_anti_hard", "ip_own_anti_pref")
            ):
                inv.append("ip")
            if "vol" in blocks and any(
                np.asarray(getattr(seg, f)).any()
                for f in ("vp_vol_rw", "vp_vol_ro", "vp_ebs", "vp_gce")
            ):
                inv.append("vol")
            if "svc" in blocks and np.asarray(seg.svc_member).any():
                inv.append("svc")
            if inv:
                self.resident.invalidate(*inv)
            pending.clear()

        infos = classify_runs(
            self.config, snap, batch, runs, num_values, self.min_run,
            device_zoned=False, zoned=zoned,
        )

        def run_single(info, done0=0):
            nonlocal L_host
            rep, start, length = (info["rep"], info["start"],
                                  info["length"])
            pod_host = {
                f: np.asarray(getattr(batch, f)[rep])
                for f in BatchScheduler.POD_FIELDS
            }
            pod_layout, pod_buf = pack_arrays(pod_host)
            pods = self._place_replicated(pod_layout, pod_buf)
            done = done0
            while done < length:
                K = length - done
                J, rows_n = self._pick_j(snap, batch, rep, K)
                count("probe")
                arr = self._probe_run(
                    statics, carries, pods, N, n_per_shard, num_zones,
                    num_values, J,
                )
                tables = tables_from_packed(
                    self.config, arr, num_zones, J, rows_n,
                    has_selectors=bool(batch.has_selectors[rep]),
                    zone_id=np.asarray(snap.zone_id) if zoned else None,
                    self_anti_veto=info["veto"],
                    svc_ctx=info["svc_ctx"],
                )
                if tables.sa_bail:
                    # ServiceAffinity dynamics the tables can't express
                    # (mid-run re-pin hazard): scan the rest of the run
                    pending.extend(range(start + done, start + length))
                    break
                res: ReplayResult = self._replay(
                    _permute_tables(tables, perm), K, L_host
                )
                if res.n_done == 0:
                    pending.extend(range(start + done, start + length))
                    break
                ids = np.where(res.chosen >= 0, perm[res.chosen], -1)
                out[start + done: start + done + res.n_done] = ids.astype(
                    np.int32
                )
                counts = np.zeros(N, np.int64)
                counts[perm] = res.counts
                count("apply")
                self._apply_run(statics, carries, pods, counts, N)
                self.resident.note_commit(pod_host, counts)
                if blocks and not info["pure"]:
                    # impure-but-eligible runs fold ip/svc tables on
                    # device; those mirrors go opaque until resynced
                    self.resident.invalidate(*blocks)
                L_host = res.last_node_index
                done += res.n_done

        def run_group(group):
            """K pure runs through ONE sharded header probe + ONE grouped
            fold; the host replay (shared with the single-device driver)
            rebuilds each run's j-axis against the resident usage mirror
            and replays in FIFO order."""
            nonlocal L_host
            G = len(group)
            G_bucket, glayout, gbuf = group_buffer(
                batch, [g["rep"] for g in group], floor=1
            )
            gpods = self._place_replicated(glayout, gbuf)
            count("group_probe")
            headers = self._group_probe_run(
                statics, carries, gpods, N, n_per_shard, num_zones,
                num_values, G,
            )
            usage = self.resident.usage()
            counts_mat, n_full, partial_done, L_host = host_group_replay(
                self.config, snap, batch,
                [(g["rep"], g["start"], g["length"]) for g in group],
                headers[:G], usage, self._replay, perm, L_host, out,
                zoned, self.max_j, num_zones,
            )
            if counts_mat.any():
                count("apply")
                self._apply_group_run(statics, carries, gpods, counts_mat,
                                      G_bucket, N)
                for g, info_g in enumerate(group):
                    if counts_mat[g].any():
                        pod_host = {
                            f: np.asarray(getattr(batch, f)[info_g["rep"]])
                            for f in ("commit_mcpu", "commit_mem",
                                      "commit_gpu", "nz_mcpu", "nz_mem",
                                      "port_mask", "class_id")
                        }
                        self.resident.note_commit(pod_host,
                                                  counts_mat[g])
            if n_full == G:
                return G, None
            return n_full, (n_full, partial_done)

        host_cap = _host_group_cap(N)
        idx = 0
        while idx < len(infos):
            info = infos[idx]
            if not info["eligible"]:
                pending.extend(range(info["start"],
                                     info["start"] + info["length"]))
                idx += 1
                continue
            flush()
            group = [info]
            jdx = idx + 1
            while (info["pure"] and jdx < len(infos)
                   and len(group) < host_cap and infos[jdx]["pure"]):
                group.append(infos[jdx])
                jdx += 1
            # resident modes route even SINGLETON pure runs through the
            # header-only probe: the exact host usage mirror rebuilds
            # the j-table (models/hosttab), so the full [J, N] probe and
            # its O(J*N) device-to-host shipment drop out of the steady
            # wave. reuse="reship" keeps the full probe per singleton run
            # as the A/B baseline.
            if len(group) >= 2 or (info["pure"] and reuse != "reship"):
                consumed, partial = run_group(group)
                if partial is not None:
                    g_idx, done = partial
                    run_single(group[g_idx], done0=done)
                    idx += g_idx + 1
                else:
                    idx += consumed
                continue
            run_single(info)
            idx += 1
        flush()
        self.resident.finish_wave(L_host)
        return out, carries, L_host

    def _pick_j(self, snap: ClusterSnapshot, batch: PodBatch, rep: int,
                K: int):
        from kubernetes_tpu_torch.models.wave import pick_j

        return pick_j(self.config, self.max_j, snap, batch, rep, K)
