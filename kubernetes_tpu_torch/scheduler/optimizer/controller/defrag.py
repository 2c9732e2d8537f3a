"""Idle-cycle defragmentation: un-strand free capacity by migration.

A cluster that schedules greedily for long enough ends up with its free
capacity smeared in slivers: every node keeps 1-2 CPUs free, none can
seat the next 4-CPU trainer, and the wave scheduler truthfully reports
the gang unschedulable even though the cluster is half empty in
aggregate. This controller measures that stranding from the scheduler's
host usage mirrors (the same per-node requested/allocatable accounting
the cache snapshot carries), and when fragmentation crosses a
threshold, proposes a bounded migration set that evacuates a few
lightly-loaded stranded nodes into OTHER stranded nodes — turning
slivers into whole free nodes without touching the nodes that already
fit the target shape.

Safety rules, all structural:

  * a migration may only touch a pod whose priority is STRICTLY below
    the beneficiary priority (the highest tier among pending pods, the
    same invariant gang preemption enforces — equal-or-higher priority
    pods are never moved), asserted again on the chosen set;
  * destinations are only nodes that cannot seat the target shape
    anyway (moving a pod onto a node that could host the trainer would
    defragment one node by fragmenting another);
  * at most ``KUBERNETES_TPU_DEFRAG_BUDGET`` pods move per cycle
    (default 8), and a node is evacuated completely or not at all — a
    half-evacuated node is still stranded, so partial moves would be
    pure churn;
  * the controller backs off exponentially while the scheduler is busy
    (defrag is an idle-cycle activity; the wave loop always wins).

Execution is evict + rebind: the evictions go out as ONE batch-door
request (the same ``/api/v1/batch`` transaction the wave binder rides),
and each migrated pod is re-created already assigned to its
destination node. tests/test_optimizer.py fuzzes the invariant that a
migration plan never reduces the schedulable-pod count.

Copy of kubernetes_tpu/scheduler/optimizer/controller/defrag.py: only the import package differs.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from kubernetes_tpu_torch.api.types import (
    POD_GROUP_LABEL,
    Pod,
    pod_resource_request,
    resource_list_cpu_milli,
    resource_list_gpu,
    resource_list_memory,
    shallow_copy,
)
from kubernetes_tpu_torch.controller.framework import PeriodicRunner
from kubernetes_tpu_torch.metrics import (
    defrag_fragmentation_ratio,
    defrag_migrations_total,
)

log = logging.getLogger(__name__)

#: resource vector order shared with the optimizer's solver tables
RES_ROWS = 4  # mcpu, mem bytes, devices, pod slots


def default_budget() -> int:
    raw = os.environ.get("KUBERNETES_TPU_DEFRAG_BUDGET", "")
    if raw:
        try:
            return max(0, int(raw))
        except ValueError:
            log.warning(
                "ignoring malformed KUBERNETES_TPU_DEFRAG_BUDGET=%r", raw)
    return 8


def _alloc_vec(info) -> np.ndarray:
    alloc = (info.node.status.allocatable or {}) if info.node else {}
    return np.array([
        resource_list_cpu_milli(alloc),
        resource_list_memory(alloc),
        resource_list_gpu(alloc),
        int(str(alloc.get("pods", 0) or 0)),
    ], np.int64)


def _free_vec(info) -> np.ndarray:
    return _alloc_vec(info) - np.array([
        info.requested_milli_cpu,
        info.requested_memory,
        info.requested_gpu,
        len(info.pods),
    ], np.int64)


def _pod_vec(pod: Pod) -> np.ndarray:
    mcpu, mem, gpu = pod_resource_request(pod)
    return np.array([mcpu, mem, gpu, 1], np.int64)


def _fits(req: np.ndarray, free: np.ndarray) -> bool:
    return bool((req <= free).all())


def target_shape(state, pending: Optional[List[Pod]] = None) -> np.ndarray:
    """The shape defragmentation serves: the elementwise-max resource
    request over pending pods when there are any (the workload actually
    waiting for contiguous capacity), else over bound pods (the biggest
    shape the cluster hosts — the thing the NEXT arrival will look
    like)."""
    best = np.zeros(RES_ROWS, np.int64)
    best[3] = 1
    pods = list(pending or ())
    if not pods:
        for info in state.node_infos.values():
            pods.extend(info.pods)
    for p in pods:
        best = np.maximum(best, _pod_vec(p))
    return best


def fragmentation(state, target: np.ndarray) -> float:
    """Stranded fraction of free capacity: summed free mcpu on nodes
    that cannot seat ``target``, over total free mcpu. 0.0 on an empty
    or perfectly packable cluster, -> 1.0 when every free sliver is
    too small to matter."""
    total = stranded = 0
    for info in state.node_infos.values():
        if info.node is None:
            continue
        free = _free_vec(info)
        cpu = max(int(free[0]), 0)
        total += cpu
        if not _fits(target, free):
            stranded += cpu
    return (stranded / total) if total else 0.0


def propose_migrations(
    state,
    target: np.ndarray,
    budget: int,
    beneficiary_priority: int = 1,
    priority_of: Optional[Callable[[Pod], int]] = None,
) -> List[Tuple[Pod, str, str]]:
    """-> [(pod, source_node, dest_node)]: a plan that fully evacuates
    some set of stranded nodes into other stranded nodes, within
    ``budget`` moves, touching only pods with priority strictly below
    ``beneficiary_priority``. Every constraint is re-checked against
    the evolving plan, so the returned list is feasible as a sequence."""
    prio = priority_of or (lambda p: 0)
    names = [nm for nm, info in state.node_infos.items()
             if info.node is not None]
    free: Dict[str, np.ndarray] = {
        nm: _free_vec(state.node_infos[nm]) for nm in names
    }
    alloc: Dict[str, np.ndarray] = {
        nm: _alloc_vec(state.node_infos[nm]) for nm in names
    }
    stranded = {nm for nm in names if not _fits(target, free[nm])}
    # sources: stranded nodes whose full capacity WOULD seat the target
    # once empty, cheapest evacuation first
    sources = sorted(
        (nm for nm in stranded
         if state.node_infos[nm].pods and _fits(target, alloc[nm])),
        key=lambda nm: (len(state.node_infos[nm].pods),
                        sum(prio(p) for p in state.node_infos[nm].pods),
                        nm),
    )
    plan: List[Tuple[Pod, str, str]] = []
    evacuated: set = set()
    received: set = set()
    for src in sources:
        if src in received:
            # it took a migrated pod already this cycle; evacuating it
            # now would undo that move — pure churn
            continue
        pods = list(state.node_infos[src].pods)
        if len(plan) + len(pods) > budget:
            continue
        if any(prio(p) >= beneficiary_priority for p in pods):
            continue  # the preemption invariant: never touch the tier
        # best-fit-decreasing into OTHER stranded, un-evacuated nodes:
        # tightest destination first, so receiving nodes fill whole
        # instead of every stranded node absorbing one sliver
        moves: List[Tuple[Pod, str, str]] = []
        trial_free = {nm: free[nm].copy() for nm in names}
        ok = True
        for p in sorted(pods, key=lambda q: -int(_pod_vec(q)[0])):
            vec = _pod_vec(p)
            dst = None
            dst_slack = None
            for nm in names:
                if nm == src or nm in evacuated or nm not in stranded:
                    continue
                if _fits(vec, trial_free[nm]):
                    slack = int(trial_free[nm][0] - vec[0])
                    if dst is None or slack < dst_slack:
                        dst, dst_slack = nm, slack
            if dst is None:
                ok = False
                break
            trial_free[dst] = trial_free[dst] - vec
            moves.append((p, src, dst))
        if not ok:
            continue
        for p, _s, d in moves:
            free[d] = free[d] - _pod_vec(p)
            received.add(d)
        free[src] = alloc[src].copy()
        evacuated.add(src)
        plan.extend(moves)
        if len(plan) >= budget:
            break
    for p, _s, _d in plan:  # belt + suspenders over the source gate
        assert prio(p) < beneficiary_priority, (
            "defrag invariant violated: equal-or-higher priority pod "
            "in the migration plan"
        )
    return plan


def apply_migrations_to_state(state, plan) -> None:
    """Simulate a plan against a ClusterState (tests and dry runs):
    remove each pod from its source NodeInfo, assign a rebound clone to
    the destination."""
    for pod, src, dst in plan:
        info = state.node_infos.get(src)
        if info is not None:
            info.remove_pod(pod)
        clone = shallow_copy(pod)
        clone.spec = shallow_copy(pod.spec)
        clone.spec.node_name = dst
        state.assign(clone)


class DefragController(PeriodicRunner):
    """The idle-cycle loop (the shared PeriodicRunner harness).
    ``state_fn()`` supplies the usage mirror (a scheduler-cache
    snapshot or any ClusterState); ``busy_fn()`` says whether the
    scheduler has work (queue depth or a wave in flight);
    ``pending_fn()`` lists pending pods (the beneficiary tier);
    ``client`` executes plans through the batch door (None = propose
    only, for embedding in tests and dry runs)."""

    SYNC_PERIOD = 15.0
    THREAD_NAME = "defrag"

    def __init__(self, state_fn, client=None, busy_fn=None,
                 pending_fn=None, pod_group_lister=None,
                 budget: Optional[int] = None,
                 frag_threshold: float = 0.25,
                 backoff_max: float = 120.0,
                 clock: Callable[[], float] = time.monotonic,
                 recorder=None):
        self.state_fn = state_fn
        self.client = client
        self.busy_fn = busy_fn or (lambda: False)
        self.pending_fn = pending_fn or (lambda: [])
        self.pod_group_lister = pod_group_lister
        self.budget = default_budget() if budget is None else int(budget)
        self.frag_threshold = float(frag_threshold)
        self.backoff_max = float(backoff_max)
        self.clock = clock
        self.recorder = recorder
        self._backoff = 0.0
        self._next_ok = 0.0
        self.last_fragmentation = 0.0

    # -- priorities ----------------------------------------------------------

    def _pg_priorities(self) -> Dict[Tuple[str, str], int]:
        out: Dict[Tuple[str, str], int] = {}
        if self.pod_group_lister is None:
            return out
        try:
            for pg in self.pod_group_lister():
                out[(pg.metadata.namespace or "default",
                     pg.metadata.name)] = int(pg.spec.priority)
        except Exception:
            log.debug("podgroup lister failed", exc_info=True)
        return out

    def _priority_fn(self, pg_prio) -> Callable[[Pod], int]:
        def prio(pod: Pod) -> int:
            name = (pod.metadata.labels or {}).get(POD_GROUP_LABEL, "")
            if not name:
                return 0
            return pg_prio.get(
                (pod.metadata.namespace or "default", name), 0)
        return prio

    # -- one cycle -----------------------------------------------------------

    def sync_once(self) -> dict:
        """-> {"outcome": ..., "migrations": int, "fragmentation": f}.
        Outcomes: busy (backing off), calm (below threshold), migrated,
        no_plan."""
        now = self.clock()
        if self.busy_fn() or now < self._next_ok:
            # the scheduler always wins the box: double the back-off
            # (capped) and try again later
            if self.busy_fn():
                self._backoff = min(
                    max(self._backoff * 2, self.SYNC_PERIOD),
                    self.backoff_max)
                self._next_ok = now + self._backoff
            return {"outcome": "busy", "migrations": 0,
                    "fragmentation": self.last_fragmentation}
        self._backoff = 0.0
        state = self.state_fn()
        pending = list(self.pending_fn() or ())
        target = target_shape(state, pending)
        frag = fragmentation(state, target)
        self.last_fragmentation = frag
        defrag_fragmentation_ratio.set(frag)
        if frag <= self.frag_threshold:
            return {"outcome": "calm", "migrations": 0,
                    "fragmentation": frag}
        pg_prio = self._pg_priorities()
        prio = self._priority_fn(pg_prio)
        # the protected tier: with pending pods, their highest priority
        # (floor 1 so the baseline tier still moves priority-0 pods);
        # idle-speculative defrag serves future arrivals at the same
        # floor — only the zero tier is ever touched then
        beneficiary = 1
        if pending:
            beneficiary = max(
                max((prio(p) for p in pending), default=0), 1)
        plan = propose_migrations(
            state, target, self.budget,
            beneficiary_priority=beneficiary, priority_of=prio)
        if not plan:
            return {"outcome": "no_plan", "migrations": 0,
                    "fragmentation": frag}
        if self.client is not None:
            self._execute(plan)
        defrag_migrations_total.inc(len(plan))
        return {"outcome": "migrated", "migrations": len(plan),
                "fragmentation": frag, "plan": plan}

    def _execute(self, plan) -> None:
        """Evict through the batch door (one request, one store
        transaction), then re-create each pod already assigned to its
        destination — the rebind half."""
        from kubernetes_tpu_torch.client.rest import batch_delete_item

        try:
            self.client.commit_batch(
                batch_delete_item("pods", p.metadata.name,
                                  p.metadata.namespace or "default")
                for p, _s, _d in plan
            )
        except Exception:
            log.warning("defrag eviction batch failed", exc_info=True)
            return
        for p, _src, dst in plan:
            clone = shallow_copy(p)
            clone.metadata = shallow_copy(p.metadata)
            clone.metadata.resource_version = ""
            clone.spec = shallow_copy(p.spec)
            clone.spec.node_name = dst
            try:
                self.client.pods(
                    p.metadata.namespace or "default").create(clone)
            except Exception:
                log.warning("defrag rebind create failed for %s",
                            p.metadata.name, exc_info=True)
            if self.recorder is not None:
                try:
                    self.recorder.eventf(
                        p, "Normal", "Defragmented",
                        "Migrated %s from %s to %s",
                        p.metadata.name, _src, dst)
                except Exception:
                    pass
