"""Gang scheduling director: PodGroup-aware wave planning, parking,
priority preemption, and heterogeneity-aware placement scores.

The director sits between the scheduler control loop (scheduler/core)
and the wave algorithm. Per cycle it:

  1. partitions the drained wave into singletons and gangs (pods
     sharing the ``scheduler.k8s.io/pod-group`` label, joined to their
     PodGroup via the podgroup informer),
  2. parks gangs that cannot yet satisfy ``minMember`` (bound members
     counted from the scheduler cache snapshot + members in this wave)
     WITHOUT submitting them — a waiting gang consumes nothing,
  3. orders the backlog [singletons (FIFO) | gangs by priority desc]
     with every gang's members contiguous, so each gang is one run for
     the grouped probe/replay machinery (O(1) dispatches regardless of
     gang count) and a parked gang can never pollute the singletons
     scheduled ahead of it,
  4. attaches the Gavel-style throughput score row per gang (weight x
     normalized throughput of the gang's workload class on each node's
     accelerator type, read from node labels),
  5. post-checks all-or-nothing on the returned hosts (the wave driver
     already enforces it in-program for eligible runs; the check also
     covers the scan/mesh fallback paths) and, for a parked gang with
     priority, plans preemption: the device victim scorer
     (ops/preempt.py) ranks eviction candidates lowest-priority-first /
     fewest-victims / newest-first, the host places the whole gang over
     the scored nodes, and the victims go out through the batch delete
     door. The invariant — preemption never evicts an equal-or-higher
     priority pod — is structural: the scorer masks candidates at
     ``prio < gang_prio`` and the director asserts it again on the
     chosen set.

No gangs in the wave = the director returns it untouched (the default
profile stays bit-identical to the serial oracle).

PyTorch counterpart of kubernetes_tpu/scheduler/gang.py: GangParked,
_place_gang and _victims_from_slots are copies; GangDirector is the JAX
package's with one recorded deviation, the device its VictimScorer
scores on (the CUDA kernel K6, ops/preempt_kernel.py, unless the caller
passes device="cpu").
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kubernetes_tpu_torch.api.types import (
    POD_GROUP_LABEL,
    Pod,
    pod_resource_request,
    resource_list_cpu_milli,
    resource_list_gpu,
    resource_list_memory,
)
from kubernetes_tpu_torch.metrics import (
    scheduler_gangs_parked_total,
    scheduler_gangs_scheduled_total,
    scheduler_preemption_victims_total,
)
from kubernetes_tpu_torch.ops.preempt import (
    INVALID_PRIO,
    VictimScorer,
    pack_candidates,
)

log = logging.getLogger(__name__)


class GangParked(Exception):
    """A gang member held back by all-or-nothing semantics; carries the
    human-readable parking reason kubectl describe surfaces."""


class GangDirector:
    """Deviation from kubernetes_tpu/scheduler/gang.py GangDirector: the
    constructor takes `device` ("cuda" by default) and builds its scorer
    as VictimScorer(device=device), because the port's victim scorer
    places its tables on a torch device (the card's kernel K6, or the
    plain version on the CPU) where the JAX package's runs on JAX's
    default device. Everything else is the JAX class."""

    def __init__(
        self,
        pod_group_lister=None,
        status_updater=None,
        preemptor=None,
        throughput: Optional[Dict[str, Dict[str, float]]] = None,
        accel_label_key: str = "accelerator",
        het_weight: int = 1,
        recorder=None,
        backoff_initial: float = 2.0,
        backoff_max: float = 30.0,
        clock=time.monotonic,
        device="cuda",
    ):
        """pod_group_lister() -> iterable[PodGroup];
        status_updater(namespace, name, status_dict) PATCHes the
        PodGroup status subresource; preemptor(victim_pods) evicts
        through the batch door; throughput is the per-accelerator-type
        matrix {workload_class: {accel_type: normalized_throughput}}
        with node types read from the ``accel_label_key`` node label.

        backoff_initial/backoff_max: per-gang exponential re-probe
        backoff after a resource park. A perpetually-unfit giant gang
        used to re-enter every wave (one full probe/replay per wave —
        cheap per gang, measurable at high gang counts); now it sits
        out doubling windows, capped at ``backoff_max`` seconds — the
        starvation cap: every gang re-probes at least that often, so a
        freed-up cluster is noticed within one cap interval. A gang
        parked for preemption retries NEXT wave (the evictions just
        paid for that retry), and a successful schedule clears the
        backoff."""
        self.pod_group_lister = pod_group_lister
        self.status_updater = status_updater
        self.preemptor = preemptor
        self.throughput = throughput or {}
        self.accel_label_key = accel_label_key
        self.het_weight = max(0, int(het_weight))
        self.recorder = recorder
        self.backoff_initial = float(backoff_initial)
        self.backoff_max = float(backoff_max)
        self._clock = clock
        #: (ns, gang) -> (current delay seconds, earliest next attempt)
        self._backoff: Dict[Tuple[str, str], Tuple[float, float]] = {}
        self._scorer = VictimScorer(device=device)

    # -- wave planning --------------------------------------------------------

    def _pg_map(self) -> Dict[Tuple[str, str], object]:
        if self.pod_group_lister is None:
            return {}
        out = {}
        try:
            for pg in self.pod_group_lister():
                out[(pg.metadata.namespace or "default",
                     pg.metadata.name)] = pg
        except Exception:
            log.debug("podgroup lister failed", exc_info=True)
        return out

    def _bound_members(self, state, ns: str, group: str) -> int:
        n = 0
        for info in state.node_infos.values():
            for p in info.pods:
                if (p.metadata.namespace or "default") == ns and (
                    p.metadata.labels or {}
                ).get(POD_GROUP_LABEL) == group:
                    n += 1
        return n

    def _score_by_name(self, state, workload_class: str):
        """The heterogeneity term: {node_name: int score} from the
        throughput matrix row of the gang's workload class, normalized
        Gavel-style against the best accelerator type for that class
        (0..10 x het_weight, integer — the replay buckets by score)."""
        row = self.throughput.get(workload_class)
        if not row or self.het_weight <= 0:
            return None
        best = max(row.values())
        if best <= 0:
            return None
        out = {}
        for name, info in state.node_infos.items():
            node = info.node
            if node is None:
                continue
            accel = (node.metadata.labels or {}).get(self.accel_label_key)
            thr = row.get(accel or "", 0.0)
            if thr > 0:
                out[name] = int(round(
                    10.0 * self.het_weight * thr / best))
        return out or None

    def plan_wave(self, wave: Sequence[Pod], state):
        """-> (backlog, layout, parked). backlog is the reordered wave;
        layout the gang spans for the wave driver ([] when no gang made
        it through member gating); parked is [(pod, GangParked)] for
        gangs short of minMember (they never enter the backlog)."""
        groups: Dict[Tuple[str, str], List[Pod]] = {}
        singles: List[Pod] = []
        arrival: Dict[Tuple[str, str], int] = {}
        for i, pod in enumerate(wave):
            name = (pod.metadata.labels or {}).get(POD_GROUP_LABEL, "")
            if not name:
                singles.append(pod)
                continue
            key = (pod.metadata.namespace or "default", name)
            groups.setdefault(key, []).append(pod)
            arrival.setdefault(key, i)
        if not groups:
            return list(wave), [], []
        pg_map = self._pg_map()
        # prune backoff state for deleted PodGroups: a gang recreated
        # under the same name must not inherit a stale delay, and the
        # dict must not grow with gang churn
        if pg_map:
            for key in list(self._backoff):
                if key not in pg_map:
                    del self._backoff[key]
        parked: List[Tuple[Pod, Exception]] = []
        ready: List[Tuple[int, int, tuple, object, List[Pod]]] = []
        for key, members in groups.items():
            ns, gname = key
            pg = pg_map.get(key)
            if pg is None:
                msg = (f"pod group {gname!r} not yet visible to the "
                       "scheduler; parking members")
                parked += [(p, GangParked(msg)) for p in members]
                scheduler_gangs_parked_total.inc(reason="members")
                self._park_status(ns, gname, None, members, msg,
                                  reason="members")
                continue
            need = int(pg.spec.min_member)
            have = self._bound_members(state, ns, gname) + len(members)
            if have < need:
                msg = (f"waiting for gang members: have {have} of "
                       f"minMember {need}")
                parked += [(p, GangParked(msg)) for p in members]
                scheduler_gangs_parked_total.inc(reason="members")
                self._park_status(ns, gname, pg, members, msg,
                                  reason="members")
                continue
            ent = self._backoff.get(key)
            if ent is not None and self._clock() < ent[1]:
                # resource-parked recently: sit this wave out instead
                # of re-probing (exponential, capped at backoff_max —
                # the starvation cap)
                msg = (f"gang backing off {ent[0]:.0f}s after a "
                       "resource park; will re-probe by the cap")
                parked += [(p, GangParked(msg)) for p in members]
                scheduler_gangs_parked_total.inc(reason="backoff")
                continue
            ready.append((int(pg.spec.priority), arrival[key], key, pg,
                          members))
        # singletons first (FIFO — a parked gang behind them can never
        # starve them), then gangs by priority desc / arrival asc
        ready.sort(key=lambda r: (-r[0], r[1]))
        backlog: List[Pod] = list(singles)
        layout: List[dict] = []
        for prio, _arr, key, pg, members in ready:
            entry = {
                "start": len(backlog),
                "length": len(members),
                "key": key,
                "group": pg,
                "priority": prio,
                "score_by_name": self._score_by_name(
                    state, pg.spec.workload_class),
            }
            backlog.extend(members)
            layout.append(entry)
        return backlog, layout, parked

    # -- post-wave enforcement ------------------------------------------------

    def after_wave(self, backlog: Sequence[Pod], hosts: List[Optional[str]],
                   layout: Sequence[dict], state):
        """All-or-nothing over the returned hosts: a gang with any
        unplaced member is parked wholesale (covers the scan/mesh
        fallback paths; the wave driver already discarded eligible-run
        partials). Parked gangs with priority trigger preemption
        planning. Returns (hosts, errors {backlog index: GangParked})."""
        errors: Dict[int, Exception] = {}
        for entry in layout:
            s, n = entry["start"], entry["length"]
            span = hosts[s:s + n]
            ns, gname = entry["key"]
            pg = entry["group"]
            members = list(backlog[s:s + n])
            if all(h is not None for h in span):
                scheduler_gangs_scheduled_total.inc()
                self._backoff.pop(entry["key"], None)
                total = self._bound_members(state, ns, gname) + n
                self._update_status(ns, gname, {
                    "phase": "Scheduled",
                    "scheduled": total,
                    "members": total,
                    "unschedulable": [],
                    "message": "",
                })
                continue
            # park: strip every member's host so nothing binds
            for i in range(s, s + n):
                hosts[i] = None
            unsched = [
                m.metadata.name for m, h in zip(members, span) if h is None
            ]
            preempted = 0
            if entry["priority"] > 0 and self.preemptor is not None:
                preempted = self._plan_preemption(entry, members, state)
            if preempted:
                msg = (f"preempting {preempted} lower-priority pods "
                       f"for gang {gname!r}; retrying next wave")
                reason = "preempting"
                # the evictions paid for an immediate retry
                self._backoff.pop(entry["key"], None)
            else:
                msg = (f"gang parked: {len(unsched)} of {n} members "
                       "unschedulable (insufficient resources); no "
                       "partial binds")
                reason = "resources"
                prev = self._backoff.get(entry["key"])
                delay = self.backoff_initial if prev is None else min(
                    prev[0] * 2, self.backoff_max)
                self._backoff[entry["key"]] = (
                    delay, self._clock() + delay)
            scheduler_gangs_parked_total.inc(reason=reason)
            self._park_status(ns, gname, pg, members, msg,
                              reason=reason, unschedulable=unsched,
                              preempted=preempted)
            err = GangParked(msg)
            for i in range(s, s + n):
                errors[i] = err
        return hosts, errors

    # -- preemption -----------------------------------------------------------

    def _priority_of(self, pod: Pod, pg_map) -> int:
        name = (pod.metadata.labels or {}).get(POD_GROUP_LABEL, "")
        if not name:
            return 0
        pg = pg_map.get((pod.metadata.namespace or "default", name))
        return int(pg.spec.priority) if pg is not None else 0

    def _plan_preemption(self, entry: dict, members: List[Pod],
                         state) -> int:
        """Choose victims so the WHOLE gang fits, then evict them
        through the batch door. Returns the victim count (0 = no
        feasible plan, nothing evicted — pointless partial evictions
        would churn lower tiers without unparking the gang)."""
        gang_prio = int(entry["priority"])
        pg_map = self._pg_map()
        node_names = [
            nm for nm, info in state.node_infos.items()
            if info.node is not None
        ]
        if not node_names:
            return 0
        # candidate table: every bound pod of STRICTLY lower priority
        cand_pods: List[Pod] = []
        cands = []
        for nm in node_names:
            info = state.node_infos[nm]
            for p in info.pods:
                pr = self._priority_of(p, pg_map)
                if pr >= gang_prio:
                    continue
                mcpu, mem, gpu = pod_resource_request(p)
                cands.append((nm, pr, len(cand_pods),
                              (mcpu, mem, gpu, 1)))
                cand_pods.append(p)
        if not cands:
            return 0
        # newest-first needs real creation order: ordinal = rank by
        # (creationTimestamp, name)
        order_rank = sorted(
            range(len(cand_pods)),
            key=lambda i: (
                cand_pods[i].metadata.creation_timestamp or "",
                cand_pods[i].metadata.name,
            ),
        )
        ordinal = {i: r for r, i in enumerate(order_rank)}
        cands = [(nm, pr, ordinal[i], res) for nm, pr, i, res in cands]
        prio, ordn, res, node_index = pack_candidates(node_names, cands)
        N = prio.shape[0]
        free = np.zeros((N, 4), np.int64)
        for nm in node_names:
            info = state.node_infos[nm]
            alloc = info.node.status.allocatable or {}
            i = node_index[nm]
            free[i] = (
                resource_list_cpu_milli(alloc) - info.requested_milli_cpu,
                resource_list_memory(alloc) - info.requested_memory,
                resource_list_gpu(alloc) - info.requested_gpu,
                int(str(alloc.get("pods", 0) or 0)) - len(info.pods),
            )
        # size the plan by the LARGEST member request per resource:
        # gang members are usually template-identical, but a mixed
        # gang planned off members[0] alone could evict victims and
        # STILL not fit next wave — the pointless-eviction case
        mcpu = mem = gpu = 0
        for m in members:
            c, mm, g = pod_resource_request(m)
            mcpu, mem, gpu = max(mcpu, c), max(mem, mm), max(gpu, g)
        req = np.array([mcpu, mem, gpu, 1], np.int64)
        # DEVICE scoring: per-node eviction order + shortest fitting
        # prefix + prefix cost, one dispatch
        needed, cost, dev_order = self._scorer.score(
            prio, ordn, res, free, req, gang_prio)
        plan = _place_gang(
            len(members), req, free, prio, res, dev_order, needed, cost)
        if plan is None:
            return 0
        victims = _victims_from_slots(plan, node_names, node_index,
                                      cands, cand_pods, dev_order)
        # the invariant, asserted on the CHOSEN set (belt + suspenders
        # over the scorer's mask)
        for v in victims:
            assert self._priority_of(v, pg_map) < gang_prio, (
                "preemption invariant violated: equal-or-higher "
                "priority victim selected"
            )
        try:
            self.preemptor(victims)
        except Exception:
            log.warning("preemption eviction failed", exc_info=True)
            return 0
        scheduler_preemption_victims_total.inc(len(victims))
        if self.recorder is not None:
            for v in victims:
                try:
                    self.recorder.eventf(
                        v, "Normal", "Preempted",
                        "Preempted by pod group %s (priority %d)",
                        entry["key"][1], gang_prio,
                    )
                except Exception:
                    pass
        return len(victims)

    # -- status ---------------------------------------------------------------

    def _park_status(self, ns, gname, pg, members, msg, reason="",
                     unschedulable=None, preempted=0):
        status = {
            "phase": "Preempting" if reason == "preempting" else "Parked",
            "members": len(members),
            "unschedulable": sorted(unschedulable if unschedulable
                                    is not None else
                                    [m.metadata.name for m in members]),
            "message": msg,
        }
        if preempted and pg is not None:
            status["preempted"] = int(pg.status.preempted) + preempted
        self._update_status(ns, gname, status)

    def _update_status(self, ns: str, name: str, status: dict) -> None:
        if self.status_updater is None:
            return
        try:
            self.status_updater(ns, name, status)
        except Exception:
            log.debug("podgroup status update failed", exc_info=True)


def _place_gang(k: int, req: np.ndarray, free: np.ndarray,
                prio: np.ndarray, res: np.ndarray, dev_order: np.ndarray,
                needed: np.ndarray, cost: np.ndarray):
    """Host placement over the device scores: greedily seat k members,
    consuming eviction prefixes in the device-computed order. Returns
    the set of (node_row, sorted_slot) victim positions, or None when
    the whole gang cannot be seated (no evictions then).

    The per-member node choice follows the device ranking — fewest
    additional victims, then cheapest prefix (summed victim priority),
    then node order — recomputed host-side as free capacity and
    consumed prefixes evolve (k is gang-sized; this is numpy per
    member, not per node)."""
    N, C = prio.shape
    free_h = free.astype(np.int64).copy()
    # freed resources in device eviction order, invalid slots zeroed
    sorted_prio = np.take_along_axis(prio, dev_order, axis=1)
    valid = sorted_prio != INVALID_PRIO
    sorted_res = np.take_along_axis(res, dev_order[:, :, None], axis=1)
    sorted_res = np.where(valid[:, :, None], sorted_res, 0)
    cum = np.cumsum(sorted_res, axis=1)
    cumprio = np.cumsum(np.where(valid, sorted_prio, 0), axis=1)
    prefix_ok = np.cumsum(valid, axis=1) == np.arange(1, C + 1)[None, :]
    consumed = np.zeros(N, np.int64)
    chosen: set = set()
    BIG = np.int64(1) << 62
    rows = np.arange(N)
    for member in range(k):
        if member == 0:
            # first seat: the DEVICE scores apply verbatim (free and
            # consumed are still at their probed values)
            need = needed.astype(np.int64)
            pcost = cost
        else:
            # subsequent seats: host mirror of the device program's
            # prefix math over the mutated free/consumed state (the
            # hosttab idiom — same integer arithmetic, bit-exact at
            # member 0, differentially tested)
            idx = np.maximum(consumed - 1, 0)
            base = np.where((consumed > 0)[:, None], cum[rows, idx], 0)
            pbase = np.where(consumed > 0, cumprio[rows, idx], 0)
            extra = cum - base[:, None, :]  # [N, C, 4]
            fits_now = np.all(free_h >= req[None, :], axis=1)
            fits_after = (
                np.all(free_h[:, None, :] + extra >= req[None, None, :],
                       axis=2)
                & prefix_ok
                & (np.arange(C)[None, :] >= consumed[:, None])
            )
            any_fit = fits_after.any(axis=1)
            first = np.argmax(fits_after, axis=1)
            need = np.where(
                fits_now, 0,
                np.where(any_fit, first - consumed + 1, -1),
            )
            pcost = np.where(
                need > 0, cumprio[rows, first] - pbase,
                np.where(need == 0, 0, BIG),
            )
        usable = need >= 0
        if not usable.any():
            return None
        # lexicographic (need, cost, node order) via argmin over a
        # composite key; argmin's first-index rule is the node tiebreak
        key = np.where(
            usable,
            need.astype(np.int64) * (np.int64(1) << 40)
            + np.minimum(pcost, (np.int64(1) << 39) - 1),
            BIG,
        )
        n = int(np.argmin(key))
        e = int(need[n])
        if e < 0:
            return None
        for j in range(int(consumed[n]), int(consumed[n]) + e):
            chosen.add((n, j))
            free_h[n] += sorted_res[n, j]
        consumed[n] += e
        free_h[n] -= req
    return chosen


def _victims_from_slots(plan, node_names, node_index, cands, cand_pods,
                        dev_order):
    """(node_row, sorted_slot) -> victim Pod objects: re-derive the
    per-node candidate column order pack_candidates wrote, then apply
    the device's sort permutation."""
    per_node: Dict[int, List[int]] = {}
    for ci, (nm, _pr, _od, _res) in enumerate(cands):
        i = node_index.get(nm)
        if i is not None:
            per_node.setdefault(i, []).append(ci)
    victims = []
    for n_row, slot in sorted(plan):
        col = int(dev_order[n_row, slot])
        cols = per_node.get(n_row, [])
        if col < len(cols):
            victims.append(cand_pods[cols[col]])
    return victims
