"""The optimizing wave driver: joint packing over the probe's tables.

Where the greedy driver replays the serial pick sequence (bit-identical
to the oracle), this driver solves the wave's optimizer-eligible slots
as one [pods x nodes] assignment problem:

  1. ONE grouped header probe over the wave's unique templates (the
     same ``probe_group`` program the greedy grouped path dispatches)
     produces every template's static fit row, j=0 score row, and the
     live resource block — predicates stay the single source of truth.
  2. ONE assignment dispatch (auction rounds or top-K beam,
     scheduler/optimizer/ops/assign.py) proposes a node per slot,
     respecting per-node multi-resource capacity, gang groups riding as
     contiguous priority-tiered blocks, and solve order (priority desc,
     demand desc, FIFO).
  3. The host re-validates EVERY proposal against the serial
     predicates before commit: the probed static fit row plus the exact
     integer mirror of ops/predicates.pod_fits_resources, applied
     sequentially in solve order so each acceptance sees the usage the
     earlier acceptances produced. A rejected proposal falls back to
     the greedy scan for that pod (``scheduler_optimizer_fallbacks_
     total``); a gang with any rejected member is parked whole —
     nothing binds.
  4. Accepted placements fold into the device carry with the grouped
     commit scatter; everything else (ineligible templates, fallback
     pods) runs through the serial-equivalent scan against that carry.

Dispatch budget per wave: probe_group + assign + grouped apply + scan
= at most 4, independent of template count — the same O(1) contract
the greedy grouped path established, enforced by the registered
transfer contracts and asserted in tests/test_optimizer.py.

Eligibility is conservative and reuses the wave driver's own gates: a
template joins the joint problem only when its commits touch nothing
but the resource block (models/wave.run_pure), it owns no self-veto
and no service context, and it wants no host ports (port coupling
stays with the greedy machinery, which models it exactly). Everything
else — and every slot the solver leaves unassigned — takes the scan,
so the profile can never bind a placement the serial predicates would
reject.

PyTorch counterpart of kubernetes_tpu/scheduler/optimizer/profile.py,
line for line against the port's wave API: the group's pod rows ship in
one packed transfer (models/wave.group_buffer, Packer.upload) and feed
both WaveProbe.probe_group (K1 at J=1 for each representative) and the
standalone grouped fold (WaveScheduler._apply_group_packed); the solve
is AssignSolver on the wave driver's device (K7 on the card); the
remainder runs through the serial scan's run(), which, like the port's
greedy driver, neither pads the pods nor compiles per shape, and counts
``scan_pods`` beside ``scan``.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence

import numpy as np

from kubernetes_tpu_torch.metrics import (
    scheduler_optimizer_fallbacks_total,
    scheduler_optimizer_placements_total,
    scheduler_optimizer_waves_total,
)
from kubernetes_tpu_torch.models import hosttab
from kubernetes_tpu_torch.models.batch import BatchScheduler
from kubernetes_tpu_torch.models.pack import unpack
from kubernetes_tpu_torch.models.wave import (
    WaveScheduler,
    _host_group_cap,
    config_eligible,
    gather_batch,
    group_buffer,
    run_eligible,
    run_pure,
)
from kubernetes_tpu_torch.scheduler.optimizer.ops.assign import (
    RES_ROWS,
    AssignSolver,
)
from kubernetes_tpu_torch.snapshot.pad import next_pow2
from kubernetes_tpu_torch.trace.profile import phase_timer

log = logging.getLogger(__name__)


def _max_slots() -> int:
    """Joint-problem size cap: slots beyond it take the greedy scan
    (the [P, N] solve tensors are per-wave uploads; unbounded P would
    make a 30k-pod wave ship a 30k x N matrix for templates the greedy
    path already packs perfectly)."""
    raw = os.environ.get("KUBERNETES_TPU_OPT_SLOTS", "")
    if raw:
        try:
            return max(16, int(raw))
        except ValueError:
            log.warning("ignoring malformed KUBERNETES_TPU_OPT_SLOTS=%r",
                        raw)
    return 4096


class OptimizingWaveDriver:
    """Drop-in for WaveScheduler.schedule_backlog behind the
    ``optimizing`` profile; shares the wrapped WaveScheduler's device
    state cache, probe programs, and commit folds."""

    def __init__(self, wave: Optional[WaveScheduler] = None, config=None,
                 device="cuda"):
        self.wave = wave if wave is not None else WaveScheduler(
            config=config, device=device)
        self.config = self.wave.config
        self.solver = AssignSolver(device=self.wave.device)
        self.max_slots = _max_slots()
        #: per-wave tally, aliased to the wave driver's (tests assert
        #: the O(1) dispatch budget on either handle)
        self.dispatches: dict = {}
        #: per-wave stats: slots solved / placed / fallbacks
        self.stats: dict = {}

    # -- eligibility ---------------------------------------------------------

    def _opt_reps(self, snap, batch, rep_idx) -> dict:
        """{rep: True} for templates the joint problem may take."""
        from kubernetes_tpu_torch.snapshot.encode import (
            service_config_labels,
        )

        config = self.config
        if not config_eligible(config):
            return {}
        svc_free = not service_config_labels(config)
        out = {}
        for rep in np.unique(np.asarray(rep_idx)):
            rep = int(rep)
            eligible, veto = run_eligible(config, batch, rep, snap,
                                          config_ok=True)
            if not eligible or veto is not None:
                continue
            if not run_pure(config, batch, rep, svc_free=svc_free):
                continue
            if batch.port_mask.size and np.any(batch.port_mask[rep]):
                # port coupling (self- and cross-template conflicts)
                # stays with the greedy machinery, which models it
                continue
            out[rep] = True
        return out

    # -- the wave ------------------------------------------------------------

    def schedule_backlog(
        self,
        snap,
        batch,
        rep_idx: np.ndarray,
        last_node_index: int = 0,
        keep: frozenset = frozenset(),
        source: str = "full",
        gangs: Optional[Sequence[dict]] = None,
    ):
        """Same contract as WaveScheduler.schedule_backlog: ->
        (chosen i32[P] node ids with -1 == unschedulable, final carry,
        final lastNodeIndex)."""
        wave = self.wave
        config = self.config
        static, carry, num_zones, num_values = wave._wave_setup(
            snap, keep, source, last_node_index)
        self.dispatches = wave.dispatches
        P = len(rep_idx)
        N = snap.num_nodes
        out = np.full(P, -1, np.int32)
        rep_idx = np.asarray(rep_idx)

        opt_reps = self._opt_reps(snap, batch, rep_idx)
        gangs = list(gangs or ())
        in_gang = np.zeros(P, bool)
        for g in gangs:
            in_gang[int(g["start"]):int(g["start"]) + int(g["length"])] \
                = True

        # units: atomic blocks the solver and the validator both respect
        # — a gang span whole, a singleton position alone. A gang with
        # any optimizer-ineligible member routes to the scan wholesale
        # (the director's post-hoc check still guards its binds).
        units: List[dict] = []
        budget = self.max_slots
        remainder: List[int] = []
        n_gangs = len(gangs)
        for gi, g in enumerate(gangs):
            s, ln = int(g["start"]), int(g["length"])
            pos = list(range(s, s + ln))
            if (ln <= budget
                    and all(int(rep_idx[i]) in opt_reps for i in pos)):
                units.append({
                    "positions": pos,
                    "gang": g,
                    # the director ordered gangs by priority desc;
                    # preserve that ordering inside the solver
                    "prio": n_gangs - gi,
                })
                budget -= ln
            else:
                remainder.extend(pos)
        for i in range(P):
            if in_gang[i]:
                continue
            if int(rep_idx[i]) in opt_reps and budget > 0:
                units.append({"positions": [i], "gang": None, "prio": 0})
                budget -= 1
            else:
                remainder.append(i)

        placed = fallbacks = 0
        if units:
            carry, placed, fallbacks, counts_sum = self._solve_units(
                snap, batch, rep_idx, static, carry, num_zones,
                num_values, units, out, remainder, N)
        else:
            scheduler_optimizer_waves_total.inc(solver="none")
            counts_sum = 0
        self.stats = {
            "slots": sum(len(u["positions"]) for u in units),
            "placed": placed,
            "fallbacks": fallbacks,
        }

        # everything else — ineligible templates and rejected proposals
        # — through the serial-equivalent scan, against the carry the
        # optimizer's commits already folded into
        L_host = int(last_node_index) + int(counts_sum)
        if remainder:
            rows = np.asarray(sorted(remainder), np.int64)
            seg = gather_batch(batch, rep_idx[rows])
            pods = wave._packer.ship({
                f: np.asarray(getattr(seg, f))
                for f in BatchScheduler.POD_FIELDS
            })
            with phase_timer("score"):
                wave._count("scan")
                wave._count("scan_pods", len(rows))
                chosen = wave.scan.run(static, carry, pods, num_zones,
                                       num_values)
                out[rows] = chosen.cpu().numpy()
                L_host = int(carry["last_idx"])
        return out, carry, L_host

    # -- the joint solve -----------------------------------------------------

    def _solve_units(self, snap, batch, rep_idx, static, carry,
                     num_zones, num_values, units, out, remainder, N):
        """Probe + solve + validate + fold. Mutates ``out`` (accepted
        placements) and ``remainder`` (rejected singleton proposals);
        returns (carry, placed, fallbacks, committed_count)."""
        wave = self.wave
        config = self.config
        positions = [i for u in units for i in u["positions"]]
        reps = sorted({int(rep_idx[i]) for i in positions})
        cap_g = _host_group_cap(N)
        if len(reps) > cap_g:
            # templates beyond the probe-shipment cap route to the scan
            keep_reps = set(reps[:cap_g])
            kept_units = []
            for u in units:
                if all(int(rep_idx[i]) in keep_reps
                       for i in u["positions"]):
                    kept_units.append(u)
                else:
                    remainder.extend(u["positions"])
            units = kept_units
            reps = sorted(keep_reps)
            if not units:
                scheduler_optimizer_waves_total.inc(solver="none")
                return carry, 0, 0, 0
        g_of_rep = {r: g for g, r in enumerate(reps)}

        G_bucket, glayout, gbuf = group_buffer(batch, reps, floor=8)
        gpods = unpack(glayout, wave._packer.upload(gbuf))
        with phase_timer("probe"):
            wave._count("group_probe")
            carry, headers, usage = wave.probe.probe_group(
                static, carry, None, gpods, len(reps), num_zones,
                num_values, wave._apply_fn, wave._apply_group_fn,
            )

        alloc = {
            f: np.asarray(getattr(snap, f)).astype(np.int64)
            for f in ("alloc_mcpu", "alloc_mem", "alloc_gpu",
                      "alloc_pods")
        }
        usage = usage.astype(np.int64)
        # free capacity at wave start, in predicate row order; the
        # solver and the validator both check used + req <= cap — the
        # exact rearrangement of alloc >= pod_req + used
        cap = np.stack([
            alloc["alloc_mcpu"] - usage[0],
            alloc["alloc_mem"] - usage[1],
            alloc["alloc_gpu"] - usage[2],
            alloc["alloc_pods"] - usage[5],
        ], axis=1)  # i64[N, 4]

        per_rep = {}
        for r in reps:
            g = g_of_rep[r]
            pod = {
                f: np.asarray(getattr(batch, f))[r]
                for f in ("req_mcpu", "req_mem", "req_gpu", "zero_req",
                          "commit_mcpu", "commit_mem", "commit_gpu",
                          "nz_mcpu", "nz_mem", "port_mask")
            }
            _res_fit1, tab1 = hosttab.resource_tables(
                config, pod, alloc, usage, 1)
            zero = bool(pod["zero_req"])
            per_rep[r] = {
                # the probed static fit row: every configured predicate
                # except resources (padded nodes are False here)
                "fit": headers[g, 0].astype(bool),
                # j=0 priority score: weighted LR/BA at current usage
                # plus the probe's static additive row (Equal /
                # ImageLocality / NodeLabel)
                "score": tab1[0] + headers[g, 2].astype(np.int64),
                "req": np.array([int(pod["req_mcpu"]),
                                 int(pod["req_mem"]),
                                 int(pod["req_gpu"]), 1], np.int64),
                "commit": np.array([int(pod["commit_mcpu"]),
                                    int(pod["commit_mem"]),
                                    int(pod["commit_gpu"]), 1],
                                   np.int64),
                # zero-request pods skip cpu/mem/gpu but never the pod
                # count (predicates.go:423-431 order quirk)
                "check": np.array([not zero, not zero, not zero, True],
                                  bool),
                "zero_req": zero,
            }

        # solve order: priority desc (gangs as the director ranked
        # them), then demand desc (big slots claim contiguous capacity
        # before small ones fragment it — the packing win over FIFO),
        # then arrival
        def demand(u):
            r = int(rep_idx[u["positions"][0]])
            q = per_rep[r]["req"]
            return int(q[0]) + int(q[1] >> 20) + int(q[2]) * 1024

        units = sorted(
            units,
            key=lambda u: (-u["prio"], -demand(u), u["positions"][0]),
        )
        slots = [i for u in units for i in u["positions"]]
        S = len(slots)
        P_bucket = next_pow2(S, floor=16)
        fit = np.zeros((P_bucket, N), bool)
        score = np.zeros((P_bucket, N), np.int64)
        req = np.zeros((P_bucket, RES_ROWS), np.int64)
        commit = np.zeros((P_bucket, RES_ROWS), np.int64)
        check = np.zeros((P_bucket, RES_ROWS), bool)
        prio = np.zeros(P_bucket, np.int32)
        order = np.arange(P_bucket, dtype=np.int32)
        s = 0
        for u in units:
            add = None
            if u["gang"] is not None:
                add = u["gang"].get("score_add")
            for i in u["positions"]:
                r = int(rep_idx[i])
                row = per_rep[r]
                fit[s] = row["fit"]
                score[s] = row["score"] if add is None \
                    else row["score"] + np.asarray(add, np.int64)
                req[s] = row["req"]
                commit[s] = row["commit"]
                check[s] = row["check"]
                prio[s] = u["prio"]
                s += 1

        with phase_timer("score"):
            wave._count("assign")
            owner, solver_name = self.solver.solve(
                fit, score, req, commit, check, cap, prio, order, S)
        scheduler_optimizer_waves_total.inc(solver=solver_name)

        # -- host re-validation against the serial predicates, in solve
        # order: each acceptance commits its usage before the next
        # validates, so the accepted set is exactly a serial-predicate-
        # feasible packing
        used_h = np.zeros((N, RES_ROWS), np.int64)
        counts_mat = np.zeros((G_bucket, N), np.int64)
        placed = fallbacks = 0

        def _valid(row, n):
            if n < 0 or n >= N or not row["fit"][n]:
                return False
            lhs = used_h[n] + row["req"]
            ok = (lhs <= cap[n]) | ~row["check"]
            return bool(ok.all())

        s = 0
        for u in units:
            span = u["positions"]
            picks = []
            ok = True
            for i in span:
                r = int(rep_idx[i])
                row = per_rep[r]
                n = int(owner[s])
                s += 1
                if _valid(row, n):
                    used_h[n] += row["commit"]
                    picks.append((i, r, n))
                else:
                    ok = False
                    if u["gang"] is not None:
                        break
                    remainder.append(i)
                    fallbacks += 1
                    scheduler_optimizer_fallbacks_total.inc(
                        reason="unassigned" if n < 0 else "predicate")
            if u["gang"] is not None and not ok:
                # all-or-nothing: roll the gang's tentative commits
                # back and park it whole — no member binds, no member
                # takes the scan (a partial scan bind would only be
                # stripped by the director afterwards)
                for _i, r, n in picks:
                    used_h[n] -= per_rep[r]["commit"]
                s += len(span) - len(picks) - 1
                fallbacks += len(span)
                scheduler_optimizer_fallbacks_total.inc(
                    len(span), reason="gang")
                continue
            for i, r, n in picks:
                out[i] = n
                counts_mat[g_of_rep[r], n] += 1
                placed += 1
        if placed:
            scheduler_optimizer_placements_total.inc(placed)
            carry = wave._apply_group_packed(static, carry, gpods,
                                             counts_mat)
        return carry, placed, fallbacks, int(counts_mat.sum())
