"""The safety properties checked after EVERY schedule event.

Each check inspects the whole cluster's logical state and returns
human-readable violation strings; ``check_step`` unions them with the
operational witnesses the harness collected during the event (commit
bound, barrier postcondition, lease-read freshness, committed-record
divergence) — those need before/after context only the executing step
has. ``check_final`` adds the end-of-schedule linearizability verdict
over the recorded client history.

The names follow the Raft paper's Figure 3:

  ====================  ==================================================
  election safety       at most one leader per term, ever
  log matching          same (index, term) => same entry and same prefix
  leader completeness   every committed entry is in every current
                        leader's log
  state-machine safety  no two nodes apply different entries at one index
  acked durability      an acked write's (term, index, payload) stays in
                        the committed record forever
  config serialization  at most one membership change in flight
  ====================  ==================================================

Copy of kubernetes_tpu/analysis/sim/invariants.py: only the import package differs.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from kubernetes_tpu_torch.storage.quorum import linearize
from kubernetes_tpu_torch.storage.quorum.log import KIND_CONFIG
from kubernetes_tpu_torch.storage.quorum.node import LEADER


class InvariantViolation(AssertionError):
    """A schedule reached a state that breaks a safety property. The
    message carries every violated property; the explorer attaches
    the minimal reproducing schedule."""


def _log_tuples(node) -> List[Tuple[int, int, bytes, int]]:
    rl = node.raft_log
    return [(e.index, e.term, bytes(e.payload), e.kind)
            for e in rl.entries_from(rl.snap_index + 1, 10 ** 9)]


def election_safety(cluster) -> List[str]:
    return [
        f"election-safety: term {t} had leaders {sorted(who)}"
        for t, who in sorted(cluster.leaders_by_term.items())
        if len(who) > 1
    ]


def log_matching(cluster) -> List[str]:
    out: List[str] = []
    nodes = [cluster.nodes[n] for n in sorted(cluster.nodes)]
    for i, a in enumerate(nodes):
        la = {idx: (term, payload, kind)
              for idx, term, payload, kind in _log_tuples(a)}
        for b in nodes[i + 1:]:
            lb = {idx: (term, payload, kind)
                  for idx, term, payload, kind in _log_tuples(b)}
            common = sorted(set(la) & set(lb))
            agree_up_to = 0
            for idx in common:
                if la[idx][0] == lb[idx][0]:
                    if la[idx] != lb[idx]:
                        out.append(
                            f"log-matching: {a.node_id}/{b.node_id} "
                            f"index {idx} term {la[idx][0]}: "
                            f"different entries")
                    agree_up_to = idx
            # prefix half: below any index where terms agree, every
            # common index must agree too
            for idx in common:
                if idx <= agree_up_to and la[idx] != lb[idx]:
                    out.append(
                        f"log-matching: {a.node_id}/{b.node_id} "
                        f"diverge at {idx} below agreed "
                        f"index {agree_up_to}")
    return out


def leader_completeness(cluster) -> List[str]:
    out: List[str] = []
    for nid in sorted(cluster.nodes):
        node = cluster.nodes[nid]
        if node.role != LEADER:
            continue
        held = {idx: (term, payload, kind)
                for idx, term, payload, kind in _log_tuples(node)}
        for idx, rec in sorted(cluster.committed.items()):
            if idx <= node.raft_log.snap_index:
                continue
            if node.raft_log.term < rec[0]:
                # Raft §5.4: completeness binds leaders of terms >=
                # the commit term; a deposed leader that has not yet
                # heard of the newer term is exempt (it can no longer
                # commit anything — it lacks a current-term majority)
                continue
            if held.get(idx) != rec:
                out.append(
                    f"leader-completeness: leader {nid} (term "
                    f"{node.raft_log.term}) holds {held.get(idx)} at "
                    f"committed index {idx}, record says {rec}")
    return out


def state_machine_safety(cluster) -> List[str]:
    out: List[str] = []
    applied: Dict[int, Tuple[str, bytes]] = {}
    for nid in sorted(cluster.machines):
        for idx, payload in cluster.machines[nid].applied:
            prev = applied.get(idx)
            if prev is None:
                applied[idx] = (nid, payload)
            elif prev[1] != payload:
                out.append(
                    f"state-machine-safety: index {idx} applied as "
                    f"{prev[1]!r} on {prev[0]} but {payload!r} on "
                    f"{nid}")
            rec = cluster.committed.get(idx)
            if rec is not None and rec[1] != payload and rec[2] != \
                    KIND_CONFIG:
                out.append(
                    f"state-machine-safety: {nid} applied {payload!r} "
                    f"at {idx}, committed record holds {rec[1]!r}")
    return out


def acked_durability(cluster) -> List[str]:
    out: List[str] = []
    for p in cluster.pending:
        if p.op.status != linearize.OK or p.op.kind != "write":
            continue
        rec = cluster.committed.get(p.index)
        want = f"{p.op.key}={p.op.value}".encode()
        if rec is None:
            out.append(
                f"acked-durability: op {p.op.op_id} acked at index "
                f"{p.index} which is not in the committed record")
        elif rec[0] != p.term or rec[1] != want:
            out.append(
                f"acked-durability: op {p.op.op_id} acked as "
                f"(term {p.term}, {want!r}) at {p.index}, committed "
                f"record holds (term {rec[0]}, {rec[1]!r})")
    return out


def config_serialization(cluster) -> List[str]:
    out: List[str] = []
    for nid in sorted(cluster.nodes):
        node = cluster.nodes[nid]
        if node.role != LEADER:
            continue
        in_flight = [idx for idx, _t, _p, kind in _log_tuples(node)
                     if kind == KIND_CONFIG
                     and idx > node.commit_index]
        if len(in_flight) > 1:
            out.append(
                f"config-serialization: leader {nid} has "
                f"{len(in_flight)} membership changes in flight "
                f"(indexes {in_flight})")
    return out


#: every per-step structural check, in reporting order
STEP_CHECKS = (
    election_safety,
    log_matching,
    leader_completeness,
    state_machine_safety,
    acked_durability,
    config_serialization,
)


def check_step(cluster) -> List[str]:
    """All violations visible right now: the structural invariants
    over current state plus the witnesses the last events recorded
    (drained here, so each is reported once)."""
    found: List[str] = list(cluster.witnesses)
    cluster.witnesses = []
    for chk in STEP_CHECKS:
        found.extend(chk(cluster))
    return found


def check_final(cluster) -> List[str]:
    """End-of-schedule: the recorded client history must linearize
    against the committed record's final state."""
    result = linearize.check(cluster.ops,
                             final_state=cluster.final_state())
    return [f"linearizability: {e}" for e in result.errors]
