"""Schedule explorers: bounded exhaustive BFS + seeded random walks.

**BFS** explores every enabled event order from the initial state,
breadth-first with stateless re-execution: a frontier entry is just
an event prefix; expanding it rebuilds a fresh cluster and replays
the prefix (schedules are short, clusters are tiny — determinism is
worth more than the re-execution cost). Because the search is
breadth-first, the first violating schedule found is minimal in
event count. Visited-state pruning stores the FULL logical
fingerprint (``SimCluster.fingerprint``), not a hash — pruning can
never be unsound via collision.

**Random** walks sample long schedules the bounded BFS cannot reach:
any in-flight message may be delivered next (reorder — the sim
equivalent of the nemesis jitter verb), and crash / torn-write /
recover / partition / heal faults are injected at a configured rate,
keeping at most a minority crashed so the acked-durability invariant
stays meaningful.

Both return the violating :class:`~..schedule.Schedule` (violation
attached) or ``None`` if the budget passed clean.

Copy of kubernetes_tpu/analysis/sim/explore.py: only the import package differs.
"""

from __future__ import annotations

import random
from collections import deque
from typing import Any, List, Optional, Tuple

from kubernetes_tpu_torch.analysis.sim.harness import SimCluster
from kubernetes_tpu_torch.analysis.sim.invariants import (check_final,
                                                    check_step)
from kubernetes_tpu_torch.analysis.sim.schedule import Schedule


def _run_prefix(sched: Schedule,
                events: List[List[Any]]) -> Tuple[SimCluster,
                                                  List[str]]:
    """Fresh cluster + replay `events`; returns (cluster, violations
    observed during the replay)."""
    cluster = sched.build_cluster()
    found: List[str] = []
    for ev in events:
        cluster.step(ev)
        found.extend(check_step(cluster))
    return cluster, found


def explore_bfs(base: Optional[Schedule] = None,
                max_depth: int = 8,
                max_states: int = 20_000,
                keys: Tuple[str, ...] = ("x",),
                with_dup: bool = True,
                with_drop: bool = True) -> Optional[Schedule]:
    """Bounded exhaustive search. `base.events` (if any) is a fixed
    prelude replayed before exploration starts — the standard trick
    for focusing the exhaustive budget past an election."""
    sched = base if base is not None else Schedule()
    prelude = list(sched.events)
    seen: set = set()
    frontier: deque = deque([[]])
    states = 0
    while frontier and states < max_states:
        prefix = frontier.popleft()
        cluster, found = _run_prefix(sched, prelude + prefix)
        try:
            if found:
                return Schedule(
                    events=prelude + prefix, n=sched.n,
                    seed=sched.seed, fsync=sched.fsync,
                    replication_batch=sched.replication_batch,
                    lease_factor=sched.lease_factor,
                    violation=found)
            fp = cluster.fingerprint()
            if fp in seen:
                continue
            seen.add(fp)
            states += 1
            if len(prefix) >= max_depth:
                continue
            children = cluster.enabled_events(
                head_only=True, keys=keys, with_dup=with_dup,
                with_drop=with_drop)
        finally:
            cluster.close()
        for ev in children:
            frontier.append(prefix + [ev])
    return None


def _fault_candidates(cluster: SimCluster,
                      rng: random.Random) -> List[List[Any]]:
    out: List[List[Any]] = []
    minority = (len(cluster.ids) - 1) // 2
    if len(cluster.crashed) < minority:
        for nid in sorted(cluster.nodes):
            torn = rng.choice([0.0, 0.3, 0.7])
            out.append(["fault", "crash", [nid], [], torn])
    for nid in sorted(cluster.crashed):
        out.append(["fault", "recover", [nid], [], 0.0])
    if not cluster.net.blocked:
        for nid in cluster.ids:
            rest = [p for p in cluster.ids if p != nid]
            out.append(["fault", "partition", [nid], rest, 0.0])
    else:
        out.append(["fault", "heal", [], [], 0.0])
    return out


#: event kinds that move the protocol forward; a uniform pick over
#: ALL enabled events is dominated by drop/dup/tick chaos and almost
#: never finishes an election inside a short walk, so the random
#: explorer picks from this subset most of the time
_PROGRESS = ("deliver", "replicate", "propose", "apply", "read",
             "barrier")


def explore_random(base: Optional[Schedule] = None,
                   schedules: int = 50,
                   steps: int = 60,
                   seed: int = 0,
                   fault_rate: float = 0.08,
                   keys: Tuple[str, ...] = ("x", "y")
                   ) -> Optional[Schedule]:
    """Seeded random schedule sampling with reorder + faults."""
    sched = base if base is not None else Schedule()
    prelude = list(sched.events)
    for i in range(schedules):
        rng = random.Random(seed * 99_991 + i)
        cluster, found = _run_prefix(sched, prelude)
        events = list(prelude)
        try:
            if found:
                return Schedule(
                    events=events, n=sched.n, seed=sched.seed,
                    fsync=sched.fsync,
                    replication_batch=sched.replication_batch,
                    lease_factor=sched.lease_factor, violation=found)
            for _ in range(steps):
                choices = cluster.enabled_events(
                    head_only=False, keys=keys)
                if rng.random() < fault_rate:
                    choices = _fault_candidates(cluster, rng) \
                        or choices
                elif rng.random() < 0.75:
                    choices = [e for e in choices
                               if e[0] in _PROGRESS] or choices
                if not choices:
                    break
                ev = choices[rng.randrange(len(choices))]
                cluster.step(ev)
                events.append(ev)
                found = check_step(cluster)
                if found:
                    return Schedule(
                        events=events, n=sched.n, seed=sched.seed,
                        fsync=sched.fsync,
                        replication_batch=sched.replication_batch,
                        lease_factor=sched.lease_factor,
                        violation=found)
            found = check_final(cluster)
            if found:
                return Schedule(
                    events=events, n=sched.n, seed=sched.seed,
                    fsync=sched.fsync,
                    replication_batch=sched.replication_batch,
                    lease_factor=sched.lease_factor, violation=found)
        finally:
            cluster.close()
    return None
