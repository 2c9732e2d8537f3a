"""Witness of two open faults of the scheduler daemon's gang director,
in both packages (ROADMAP.md queue 3). It exits 1 while either stands
and 0 once both are fixed; pytest does not collect it.

    JAX_PLATFORMS=cpu python3 -m tests.witness_gang_status_races

1. A stale scheduler cache preempts again. A gang parked for preemption
   retries in the next wave, which the daemon plans on its scheduler
   cache. If the cache has not yet observed the evictions, the director
   picks the same victims again, evicts them again and counts them
   twice. Here the second wave runs on the first wave's state.
2. A stale PodGroup informer loses a count. A preempting park writes
   `preempted` as the count the director's PodGroup lister shows plus
   the new victims. The lister is the daemon's informer, and nothing
   waits for it to hold the previous write, so the earlier victims drop
   out of the count. Here the gang preempts twice for different victims
   (the first victims' room is taken again in between) while the lister
   shows the PodGroup as it was created.

Over the wire both make the PodGroup's `preempted` count depend on the
threads' timing; tests/test_torch_wire.py's wire_run waits them out so
that its comparison of the two daemons holds.
"""

from __future__ import annotations

import sys

import kubernetes_tpu.api.types as JT
from kubernetes_tpu.oracle import ClusterState as JaxState
from kubernetes_tpu.scheduler import gang as JG
from kubernetes_tpu.scheduler.tpu_algorithm import TPUScheduleAlgorithm

import kubernetes_tpu_torch.api.types as TT
from kubernetes_tpu_torch.harness import scenarios as S
from kubernetes_tpu_torch.oracle import ClusterState as PortState
from kubernetes_tpu_torch.scheduler import gang as PG
from kubernetes_tpu_torch.scheduler.algorithm import TorchScheduleAlgorithm

PACKAGES = {
    "port": (TT, PortState, PG,
             lambda: TorchScheduleAlgorithm(device="cpu", min_run=16),
             {"device": "cpu"}),
    "jax": (JT, JaxState, JG, lambda: TPUScheduleAlgorithm(min_run=16), {}),
}


def preempting_gang(T, CS, G, dkw):
    """-> (director, its statuses, its victims, nodes, bound pods, the
    gang's members): full nodes of priority-0 pods and a priority gang of
    6 x 2 CPU that can only bind by preemption. The director's PodGroup
    lister shows the PodGroups as created."""
    nodes, bound = S.bound_cluster(T, 24, per_node=6, cpu="500m")
    wave, groups = S.gang_wave(T, singles=20, gangs=8, members=4, big=6,
                               big_cpu="2", short=2)
    statuses, evicted = [], []
    director = G.GangDirector(
        pod_group_lister=lambda: list(groups),
        status_updater=lambda ns, name, st: statuses.append(
            (name, dict(st))),
        preemptor=evicted.extend, **dkw)
    big = [p for p in wave
           if p.metadata.labels.get(T.POD_GROUP_LABEL) == "big"]
    return director, statuses, evicted, nodes, bound, big


def witness(name) -> dict:
    T, CS, G, make, dkw = PACKAGES[name]
    out = {}
    # 1: the second wave plans on a state that still holds the victims
    d, statuses, evicted, nodes, bound, big = preempting_gang(T, CS, G, dkw)
    algo = make()
    state = CS.build(nodes, assigned_pods=bound)
    S.director_wave(d, algo, big, state)
    first = [v.metadata.name for v in evicted]
    S.director_wave(d, algo, big, state)
    again = sorted(set(first) & {v.metadata.name
                                 for v in evicted[len(first):]})
    out["victims evicted twice"] = again
    # 2: the victims' room is taken again, so the gang preempts anew
    d, statuses, evicted, nodes, bound, big = preempting_gang(T, CS, G, dkw)
    S.director_wave(d, algo, big, CS.build(nodes, assigned_pods=bound))
    gone = {v.metadata.name for v in evicted}
    refill = S.pause_pods(T, len(gone), labels={"app": "filler"},
                          requests={"cpu": "500m", "memory": "500Mi"},
                          prefix="refill")
    for p, v in zip(refill, evicted):
        p.spec.node_name = v.spec.node_name
        p.metadata.creation_timestamp = "2026-01-02T00:00:00Z"
    live = [p for p in bound if p.metadata.name not in gone] + refill
    S.director_wave(d, algo, big, CS.build(nodes, assigned_pods=live))
    counts = [st["preempted"] for n, st in statuses
              if n == "big" and "preempted" in st]
    out["preempted counts written"] = counts
    out["victims of both preemptions"] = len(evicted)
    return out


def main() -> int:
    faults = 0
    for name in PACKAGES:
        got = witness(name)
        print(name, got)
        if got["victims evicted twice"]:
            faults += 1
            print(f"  {name}: fault 1, a stale cache evicts "
                  f"{len(got['victims evicted twice'])} victims again")
        counts = got["preempted counts written"]
        victims = got["victims of both preemptions"]
        if len(counts) < 2 or counts[-1] != victims:
            faults += 1
            print(f"  {name}: fault 2, the last preempted count is "
                  f"{counts[-1] if counts else None} for {victims} victims")
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
