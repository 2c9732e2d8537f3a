"""Seeded-bug corpus: the checker's own regression suite.

A model checker that has never found a bug proves nothing — maybe the
invariants are vacuous, maybe the schedules never reach the dangerous
interleavings. So the corpus re-injects the three historical Raft
bugs this repo actually shipped and fixed (each as a monkeypatched
mutation of one ``QuorumNode`` method, the same shape the original
diff had) and gates that the checker finds every one within the quick
budget. If a refactor of the sim, the invariants, or the node ever
makes one undetectable, the analysis gate fails.

The three bugs:

``commit-past-match``
    The follower advanced its commit index to ``min(leaderCommit,
    log.last_index)`` instead of Raft §5.3's ``min(leaderCommit,
    index of last new entry)``. The raw log end may exceed the
    frontier this append verified. The trigger needs the leader's
    ``next_index`` to regress below a follower's real log end, which
    a DUPLICATED append's ok-reply causes (``next = match + 1``
    unconditionally), followed by a batch-capped re-send whose
    ``leaderCommit`` has run ahead of the batch frontier.

``ack-without-entry-check``
    Proposal acking checked only ``applied_index >= index`` without
    verifying the slot still holds the proposer's entry (same term).
    A deposed leader whose unreplicated entry was overwritten by the
    new leader acks the dead write once the OVERWRITING entry
    applies — an acked write the cluster never committed.

``barrier-bypass``
    The fresh-leader apply barrier reported ready before the term's
    start entry committed and applied, letting proposals evaluate
    against a state machine missing previously-acked writes. Found
    by the exhaustive explorer four events from boot.

Copy of kubernetes_tpu/analysis/sim/corpus.py: only the import package differs.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

from kubernetes_tpu_torch.analysis.sim.explore import (explore_bfs,
                                                 explore_random)
from kubernetes_tpu_torch.analysis.sim.schedule import Schedule, run
from kubernetes_tpu_torch.storage.quorum.node import (ACK_ACKED,
                                                ACK_PENDING,
                                                QuorumNode)

COMMIT_PAST_MATCH = "commit-past-match"
ACK_WITHOUT_ENTRY_CHECK = "ack-without-entry-check"
BARRIER_BYPASS = "barrier-bypass"

#: shared election prelude: ticks ``a``, delivers its prevote and
#: vote to ``b`` — message ids are deterministic from a fresh cluster
ELECT_A = [["tick", "a"], ["deliver", 1], ["deliver", 3]]


def _buggy_commit(self, leader_commit: int, match: int) -> None:
    # verbatim shape of the pre-fix follower commit advance
    if leader_commit > self.commit_index:
        self.commit_index = min(leader_commit,
                                self.raft_log.last_index)
        self._cv.notify_all()


def _buggy_ack(self, index: int, term: int) -> str:
    # pre-fix ack: apply position only, no same-term entry check
    return ACK_PENDING if self.applied_index < index else ACK_ACKED


def _buggy_barrier(self) -> bool:
    # pre-fix: barrier never actually gated anything
    return True


_MUTATIONS: Dict[str, Any] = {
    COMMIT_PAST_MATCH: ("_advance_commit_follower_locked",
                        _buggy_commit),
    ACK_WITHOUT_ENTRY_CHECK: ("_propose_status_locked", _buggy_ack),
    BARRIER_BYPASS: ("_barrier_ready_locked", _buggy_barrier),
}


@contextmanager
def mutate(name: str):
    """Swap the named historical bug back into ``QuorumNode`` for the
    duration of the block."""
    attr, buggy = _MUTATIONS[name]
    orig = getattr(QuorumNode, attr)
    setattr(QuorumNode, attr, buggy)
    try:
        yield
    finally:
        setattr(QuorumNode, attr, orig)


# -- targeted trigger schedules ---------------------------------------------
# Hand-minimized interleavings replayed as explicit schedules: fast
# (the quick analysis gate runs them on every invocation) and precise
# (each documents exactly the event order that made its bug bite).

#: leader a commits 1..5 with replication_batch=2; a duplicated first
#: append's late ok-reply regresses next_index(b) to 3; the batch-
#: capped re-send carries leaderCommit=5 but frontier=4 while b's log
#: ends at 5 — the buggy bound min(leaderCommit, last_index) commits 5
COMMIT_PAST_MATCH_EVENTS: List[List[Any]] = ELECT_A + [
    ["propose", "a", "x", "v1"],   # index 2
    ["propose", "a", "x", "v2"],   # index 3
    ["propose", "a", "x", "v3"],   # index 4
    ["replicate", "a", "b"],       # mid 5: (prev 0, [1,2], lc 0)
    ["dup", 5],                    # mid 6: the duplicate
    ["deliver", 5],                # b=[1,2]  match 2  commit(a)->2
    ["replicate", "a", "b"],       # mid 7: (prev 2, [3,4], lc 2)
    ["deliver", 7],                # b=[1..4] match 4  commit(a)->4
    ["propose", "a", "x", "v4"],   # index 5
    ["replicate", "a", "b"],       # mid 8: (prev 4, [5], lc 4)
    ["deliver", 8],                # b=[1..5] match 5  commit(a)->5
    ["deliver", 6],                # dup's ok reply: next(b) := 3 (!)
    ["replicate", "a", "b"],       # mid 9: (prev 2, [3,4], lc 5)
    ["deliver", 9],                # frontier 4 < b.last 5: bug bites
]

#: a leads term 1, appends x=v1 unreplicated, gets partitioned; b
#: wins term 2 via c and commits competing entries; after heal b's
#: appends overwrite a's entry — once a applies past the dead slot,
#: the buggy ack calls the overwritten proposal ACKED
ACK_WITHOUT_ENTRY_CHECK_EVENTS: List[List[Any]] = ELECT_A + [
    ["replicate", "a", "b"], ["deliver", 5],
    ["replicate", "a", "c"], ["deliver", 6],
    ["apply", "a"],
    ["propose", "a", "x", "v1"],               # index 2 term 1
    ["fault", "partition", ["a"], ["b", "c"], 0.0],
    ["tick", "b"], ["deliver", 8], ["deliver", 10],
    ["propose", "b", "x", "v2"],               # index 3 term 2
    ["replicate", "b", "c"], ["deliver", 11],  # b commits 3
    ["fault", "heal", [], [], 0.0],
    ["replicate", "b", "a"], ["deliver", 12],  # a's slot 2 overwritten
    ["apply", "a"], ["apply", "a"], ["apply", "a"],
]

_TARGETED: Dict[str, List[List[Any]]] = {
    COMMIT_PAST_MATCH: COMMIT_PAST_MATCH_EVENTS,
    ACK_WITHOUT_ENTRY_CHECK: ACK_WITHOUT_ENTRY_CHECK_EVENTS,
}


def _detect_targeted(events: List[List[Any]]) -> Optional[Schedule]:
    sched = Schedule(events=[list(e) for e in events])
    violations = run(sched)
    if not violations:
        return None
    sched.violation = violations
    return sched


def _detect_barrier_bypass() -> Optional[Schedule]:
    # exercised through the explorer on purpose: this bug is shallow
    # enough that bounded BFS from the election prelude must find a
    # MINIMAL counterexample (depth 1: the barrier probe itself)
    return explore_bfs(base=Schedule(events=[list(e)
                                             for e in ELECT_A]),
                       max_depth=2, max_states=500)


DETECTORS: Dict[str, Callable[[], Optional[Schedule]]] = {
    COMMIT_PAST_MATCH:
        lambda: _detect_targeted(COMMIT_PAST_MATCH_EVENTS),
    ACK_WITHOUT_ENTRY_CHECK:
        lambda: _detect_targeted(ACK_WITHOUT_ENTRY_CHECK_EVENTS),
    BARRIER_BYPASS: _detect_barrier_bypass,
}


def find_seeded_bugs() -> Dict[str, Optional[Schedule]]:
    """Re-inject each historical bug and run its detector. A healthy
    checker maps every name to a violating ``Schedule``; ``None``
    means the checker has gone blind to that bug class."""
    out: Dict[str, Optional[Schedule]] = {}
    for name, detect in DETECTORS.items():
        with mutate(name):
            out[name] = detect()
    return out


def check_clean(deep: bool = False,
                seed: int = 0) -> List[str]:
    """Model-check the UNMUTATED tree. Quick budget: the targeted
    trigger schedules (which must be quiet without their mutations),
    a bounded BFS from boot, and a few random fault schedules. Deep
    budget widens both explorers; CI runs it slow-marked."""
    violations: List[str] = []
    for name, events in sorted(_TARGETED.items()):
        found = run(Schedule(events=[list(e) for e in events]))
        violations.extend(f"[targeted:{name}] {v}" for v in found)
    bfs = explore_bfs(max_depth=4 if deep else 3,
                      max_states=4000 if deep else 800)
    if bfs is not None:
        violations.extend(
            f"[bfs:{' '.join(map(str, bfs.events))}] {v}"
            for v in bfs.violation or ())
    rnd = explore_random(schedules=40 if deep else 8,
                         steps=80 if deep else 40, seed=seed)
    if rnd is not None:
        violations.extend(
            f"[random:seed={seed}] {v}" for v in rnd.violation or ())
    return violations
