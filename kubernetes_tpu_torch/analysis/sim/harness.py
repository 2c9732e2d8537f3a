"""SimCluster: a quorum cluster under total schedule control.

The cluster builds real ``QuorumNode`` objects over the sim seams
(``SimClock`` / ``SimTransport`` / ``SimDisk``) and NEVER calls
``start()`` — no thread runs. Instead the schedule's events drive the
node's extracted step functions directly:

  ========================  ==============================================
  event                     effect
  ========================  ==============================================
  ``["tick", n]``           advance virtual time past n's election timer
                            and run one ``_election_tick_locked`` (may
                            enqueue a pre-vote round into SimNet)
  ``["replicate", s, d]``   leader s builds its next AppendEntries /
                            snapshot-install for d and enqueues it
  ``["deliver", mid]``      dst processes message `mid` via the real
                            ``_dispatch``; the reply is routed back into
                            the sender's reply handler
  ``["drop", mid]``         message `mid` is lost before processing
  ``["drop_reply", mid]``   dst processes `mid` but the REPLY is lost —
                            the indeterminate-RPC case
  ``["dup", mid]``          message `mid` is duplicated in flight
  ``["apply", n]``          n applies exactly one committed entry
  ``["propose", n, k, v]``  client write k=v at n (no-op unless leader);
                            acked/lost asynchronously via status polling
  ``["read", n, k]``        lease read of k at n (no-op unless servable)
  ``["barrier", n]``        n evaluates its apply-barrier gate (the
                            barrier-postcondition witness point)
  ``["fault", k, a, b, m]`` a ``harness.faults.FaultSpec``: partition /
                            isolate / heal to SimNet, crash (with torn-
                            write fraction m) / recover to the cluster
  ========================  ==============================================

Every event is deterministic: same construction parameters + same
event list = bit-identical run. After each event the harness folds
newly committed entries into a global committed record, polls every
pending proposal's honest-ack status, and exposes the state the
invariant checks (``invariants.check_step``) need.

Copy of kubernetes_tpu/analysis/sim/harness.py: only the import package differs.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.analysis.sim.clock import SimClock
from kubernetes_tpu_torch.analysis.sim.disk import SimDisk, SimIOError
from kubernetes_tpu_torch.analysis.sim.net import SimNet, SimTransport
from kubernetes_tpu_torch.harness.faults import FaultKind, FaultSpec
from kubernetes_tpu_torch.storage.quorum import linearize
from kubernetes_tpu_torch.storage.quorum.log import KIND_DATA
from kubernetes_tpu_torch.storage.quorum.node import (ACK_ACKED, ACK_LOST,
                                                ACK_PENDING, LEADER,
                                                NodeConfig, QuorumNode)

#: margin added when a tick advances past a timer: larger than any
#: accumulated per-event epsilon, smaller than the timers themselves
_TICK_MARGIN = 0.01
_STEP_EPS = 1e-6


class _StateMachine:
    """The applied state of one node: a tiny kv store fed ``k=v``
    payloads, recording the exact apply sequence for the
    state-machine-safety invariant."""

    def __init__(self):
        self.kv: Dict[str, Tuple[str, int]] = {}  # key -> (value, rv)
        self.applied: List[Tuple[int, bytes]] = []  # (index, payload)

    def apply(self, payload: bytes, index: int) -> None:
        self.applied.append((index, bytes(payload)))
        k, _, v = bytes(payload).partition(b"=")
        self.kv[k.decode()] = (v.decode(), index)

    def state_blob(self) -> bytes:
        return b"\n".join(
            f"{k}\t{v}\t{rv}".encode()
            for k, (v, rv) in sorted(self.kv.items()))

    def install(self, blob: bytes) -> None:
        self.kv = {}
        for line in blob.split(b"\n"):
            if line:
                k, v, rv = line.decode().split("\t")
                self.kv[k] = (v, int(rv))


class _PendingOp:
    __slots__ = ("op", "node", "index", "term", "done")

    def __init__(self, op: linearize.Op, node: str, index: int,
                 term: int):
        self.op = op
        self.node = node
        self.index = index
        self.term = term
        self.done = False


class SimCluster:
    def __init__(self, n: int = 3, seed: int = 0, fsync: bool = True,
                 replication_batch: int = 2,
                 lease_factor: float = 0.75,
                 election_timeout: float = 1.0):
        self.seed = seed
        self.fsync = fsync
        self.clock = SimClock()
        self.disk = SimDisk()
        self.net = SimNet()
        self.transport = SimTransport()
        self.ids = [chr(ord("a") + i) for i in range(n)]
        self.replication_batch = replication_batch
        self.lease_factor = lease_factor
        self.election_timeout = election_timeout
        self.nodes: Dict[str, QuorumNode] = {}
        self.machines: Dict[str, _StateMachine] = {}
        self.gen: Dict[str, int] = {nid: 0 for nid in self.ids}
        self.crashed: set = set()
        #: global committed record: index -> (term, payload, kind)
        self.committed: Dict[int, Tuple[int, bytes, int]] = {}
        #: term -> set of node ids ever observed leading it
        self.leaders_by_term: Dict[int, set] = {}
        self.ops: List[linearize.Op] = []
        self.pending: List[_PendingOp] = []
        #: operational witnesses that need before/after context the
        #: step itself owns (commit bound, barrier postcondition,
        #: lease-read freshness); invariants.check_step drains these
        self.witnesses: List[str] = []
        for nid in self.ids:
            self._boot(nid)

    # -- construction --------------------------------------------------------

    def _data_dir(self, nid: str) -> str:
        return f"/sim/{nid}"

    def _boot(self, nid: str) -> QuorumNode:
        idx = self.ids.index(nid)
        sm = _StateMachine()
        cfg = NodeConfig(
            node_id=nid,
            data_dir=self._data_dir(nid),
            peers={p: ("sim", self.ids.index(p) + 1)
                   for p in self.ids if p != nid},
            listen_host="sim",
            listen_port=idx + 1,
            election_timeout=self.election_timeout,
            heartbeat_interval=0.1,
            rpc_timeout=1.0,
            snapshot_every=10 ** 9,  # compaction off: full logs keep
            # the log-matching invariant byte-checkable
            fsync=self.fsync,
            lease_factor=self.lease_factor,
            replication_batch=self.replication_batch,
            clock=self.clock,
            transport=self.transport,
            disk=self.disk,
            rng=random.Random(
                self.seed * 1_000_003 + idx * 101
                + self.gen[nid] * 7919),
        )
        node = QuorumNode(cfg, apply_fn=sm.apply,
                          install_fn=sm.install,
                          state_fn=sm.state_blob)
        self.nodes[nid] = node
        self.machines[nid] = sm
        return node

    # -- event execution -----------------------------------------------------

    def step(self, event: List[Any]) -> None:
        """Execute one schedule event, then refresh the global
        committed record, leader observations, and proposal acks."""
        self.clock.advance(_STEP_EPS)
        kind = event[0]
        if kind == "tick":
            self._tick(event[1])
        elif kind == "replicate":
            self._replicate(event[1], event[2])
        elif kind == "deliver":
            self._deliver(event[1], drop_reply=False)
        elif kind == "drop":
            if event[1] in self.net.by_mid:
                self.net.take(event[1])
        elif kind == "drop_reply":
            self._deliver(event[1], drop_reply=True)
        elif kind == "dup":
            if event[1] in self.net.by_mid:
                self.net.duplicate(event[1])
        elif kind == "apply":
            node = self.nodes.get(event[1])
            if node is not None:
                node._apply_next()
        elif kind == "propose":
            self._propose(event[1], event[2], event[3])
        elif kind == "read":
            self._read(event[1], event[2])
        elif kind == "barrier":
            self._barrier(event[1])
        elif kind == "fault":
            self._fault(FaultSpec(FaultKind(event[1]),
                                  tuple(event[2]), tuple(event[3]),
                                  float(event[4])))
        else:
            raise ValueError(f"unknown sim event {event!r}")
        self._observe()

    def _tick(self, nid: str) -> None:
        node = self.nodes.get(nid)
        if node is None:
            return
        with node._mu:
            self.clock.advance_to(
                max(node._last_contact + node._timeout,
                    node._prevote_last + node._timeout)
                + _TICK_MARGIN)
            plan = node._election_tick_locked(self.clock.monotonic())
        if plan is None:
            return
        round_id, msg, peers = plan
        for pid in peers:
            self.net.send(nid, pid, msg, "prevote",
                          ctx=(round_id, self.gen[nid]))

    def _replicate(self, src: str, dst: str) -> None:
        node = self.nodes.get(src)
        if node is None or node.role != LEADER:
            return
        with node._mu:
            if node.role != LEADER:
                return
            plan = node._build_replication_locked(dst)
        if plan is None:
            return
        t0 = self.clock.monotonic()
        if plan[0] == "snap":
            _, msg, snap_idx = plan
            self.net.send(src, dst, msg, "snap",
                          ctx=(msg[1], t0, snap_idx, self.gen[src]),
                          ctx_fp=(msg[1], snap_idx, self.gen[src]))
        else:
            _, msg = plan
            self.net.send(src, dst, msg, "append",
                          ctx=(msg[1], t0, self.gen[src]),
                          ctx_fp=(msg[1], self.gen[src]))

    def _deliver(self, mid: int, drop_reply: bool) -> None:
        if mid not in self.net.by_mid:
            return  # already consumed (replay of a stale schedule)
        m = self.net.take(mid)
        dst = self.nodes.get(m.dst)
        if dst is None:
            return  # process died with the message in its queue
        commit_before = dst.commit_index
        reply = dst._dispatch(m.payload)
        if m.reply_kind == "append":
            self._witness_commit_bound(m, dst, commit_before, reply)
        if drop_reply:
            return
        src = self.nodes.get(m.src)
        if src is None or self.gen[m.src] != m.ctx[-1]:
            return  # sender crashed (or is a later incarnation)
        if m.reply_kind == "prevote":
            begin = src._on_prevote_reply(m.dst, m.ctx[0], reply)
            if begin is not None:
                term, vote_msg, peers = begin
                for pid in peers:
                    self.net.send(m.src, pid, vote_msg, "vote",
                                  ctx=(term, self.gen[m.src]))
        elif m.reply_kind == "vote":
            src._on_vote_reply(m.dst, m.ctx[0], reply)
        elif m.reply_kind == "append":
            if reply and reply[0] == "apprep":
                with src._mu:
                    src._on_append_reply_locked(
                        m.dst, m.ctx[0], m.ctx[1], reply)
        elif m.reply_kind == "snap":
            if reply and reply[0] == "snaprep":
                with src._mu:
                    src._on_snap_reply_locked(
                        m.dst, m.ctx[0], m.ctx[1], m.ctx[2], reply)

    def _witness_commit_bound(self, m, dst: QuorumNode,
                              commit_before: int, reply: Any) -> None:
        """Raft §5.3: a follower's commit index moves to at most
        min(leaderCommit, index of last new entry) — the match
        frontier this very append verified — never the raw log end.
        (Catches the historical commit-past-match bug, which is
        observationally silent until a stale suffix sits beyond the
        delivered batch.)"""
        if not reply or reply[0] != "apprep" or not reply[2]:
            return
        leader_commit, match = m.payload[6], reply[3]
        bound = max(commit_before, min(leader_commit, match))
        if dst.commit_index > bound:
            self.witnesses.append(
                f"commit-bound: {dst.node_id} advanced commit to "
                f"{dst.commit_index} > max(prior {commit_before}, "
                f"min(leaderCommit {leader_commit}, match {match}))")

    def _propose(self, nid: str, key: str, value: str) -> None:
        node = self.nodes.get(nid)
        if node is None or node.role != LEADER:
            return
        with node._mu:
            if node.role != LEADER:
                return
            term, index = node._leader_append_locked(
                f"{key}={value}".encode(), KIND_DATA)
        op = linearize.Op(
            op_id=len(self.ops), process=f"client-{nid}",
            kind="write", key=key, value=value,
            t_invoke=self.clock.monotonic(),
            t_complete=0.0, status=linearize.INFO)
        self.ops.append(op)
        self.pending.append(_PendingOp(op, nid, index, term))

    def _read_servable(self, node: QuorumNode) -> bool:
        return (node.role == LEADER and node._barrier_ready_locked()
                and node._lease_expiry_locked()
                > self.clock.monotonic())

    def _read(self, nid: str, key: str) -> None:
        node = self.nodes.get(nid)
        if node is None:
            return
        with node._mu:
            if not self._read_servable(node):
                return
            value, rv = self.machines[nid].kv.get(key, (None, 0))
        now = self.clock.monotonic()
        # direct freshness witness: a lease read must reflect every
        # write committed anywhere before this instant
        newest = max((i for i, (_t, p, k) in self.committed.items()
                      if k == KIND_DATA
                      and bytes(p).partition(b"=")[0].decode() == key),
                     default=0)
        if newest > rv:
            self.witnesses.append(
                f"lease-read: {nid} served {key}={value!r}@rv{rv} "
                f"while index {newest} holds a newer committed write")
        if rv:
            self.ops.append(linearize.Op(
                op_id=len(self.ops), process=f"client-{nid}",
                kind="read", key=key, value=value, rv=rv,
                t_invoke=now, t_complete=now, status=linearize.OK))

    def _barrier(self, nid: str) -> None:
        node = self.nodes.get(nid)
        if node is None or node.role != LEADER:
            return
        with node._mu:
            ready = node._barrier_ready_locked()
            if ready and (node.commit_index < node._term_start_index
                          or node.applied_index < node.commit_index):
                self.witnesses.append(
                    f"apply-barrier: {nid} reported barrier-ready at "
                    f"commit={node.commit_index} "
                    f"term_start={node._term_start_index} "
                    f"applied={node.applied_index}")

    def _fault(self, spec: FaultSpec) -> None:
        if spec.kind is FaultKind.CRASH:
            nid = spec.a_side[0]
            node = self.nodes.pop(nid, None)
            if node is None:
                return
            # power cut first (revokes handles, tears the unsynced
            # tail), THEN kill() — so kill's close() flushes nothing
            self.disk.crash(self._data_dir(nid) + "/", spec.magnitude)
            try:
                node.kill()
            except SimIOError:
                pass
            self.machines.pop(nid, None)
            self.crashed.add(nid)
            self.gen[nid] += 1
            self.net.drop_node(nid)
        elif spec.kind is FaultKind.RECOVER:
            nid = spec.a_side[0]
            if nid in self.nodes or nid not in self.crashed:
                return
            self.crashed.discard(nid)
            self._boot(nid)
        else:
            self.net.apply(spec, self.ids)

    # -- post-event bookkeeping ----------------------------------------------

    def _observe(self) -> None:
        for nid, node in self.nodes.items():
            if node.role == LEADER:
                self.leaders_by_term.setdefault(
                    node.raft_log.term, set()).add(nid)
        # fold newly committed entries into the global record; an
        # index committed twice with different content is the
        # sharpest possible safety violation
        for node in self.nodes.values():
            rl = node.raft_log
            for idx in range(1, node.commit_index + 1):
                e = rl.entry(idx)
                if e is None:
                    continue
                rec = (e.term, bytes(e.payload), e.kind)
                prev = self.committed.get(idx)
                if prev is None:
                    self.committed[idx] = rec
                elif prev != rec:
                    self.witnesses.append(
                        f"committed-divergence: index {idx} committed "
                        f"as {prev} and as {rec} (via {node.node_id})")
        # omniscient resolution for indeterminate proposals: the
        # client never learned the outcome (origin crashed / deposed
        # before acking), but if the committed record holds the
        # proposer's own entry at its index the write DID commit —
        # give the op its true rv (status stays INFO) so the
        # linearizability model can justify reads that observed it
        for p in self.pending:
            if p.op.status == linearize.INFO and p.op.rv is None:
                rec = self.committed.get(p.index)
                if rec is not None and rec[0] == p.term and \
                        rec[1] == f"{p.op.key}={p.op.value}".encode():
                    p.op.rv = p.index
        # poll honest-ack status for every pending proposal
        now = self.clock.monotonic()
        for p in self.pending:
            if p.done:
                continue
            node = self.nodes.get(p.node)
            if node is None:
                if p.node in self.crashed:
                    p.done = True  # origin died: indeterminate (INFO)
                    p.op.t_complete = now
                continue
            with node._mu:
                st = node._propose_status_locked(p.index, p.term)
            if st == ACK_PENDING:
                continue
            p.done = True
            p.op.t_complete = now
            if st == ACK_ACKED:
                p.op.status = linearize.OK
                p.op.rv = p.index
            elif st == ACK_LOST:
                p.op.status = linearize.FAIL
            # ACK_INDETERMINATE stays INFO

    # -- enabled-event enumeration (for the explorer) ------------------------

    def enabled_events(self, head_only: bool = True,
                       keys: Tuple[str, ...] = ("x",),
                       with_dup: bool = True,
                       with_drop: bool = True) -> List[List[Any]]:
        """Events worth exploring from the current state, each as its
        schedule-serializable form. Deterministic order."""
        out: List[List[Any]] = []
        for m in self.net.deliverable(head_only):
            if m.dst not in self.nodes:
                continue
            out.append(["deliver", m.mid])
            if with_drop:
                out.append(["drop", m.mid])
                out.append(["drop_reply", m.mid])
            if with_dup:
                out.append(["dup", m.mid])
        for nid in self.ids:
            node = self.nodes.get(nid)
            if node is None:
                continue
            if node.role != LEADER:
                out.append(["tick", nid])
            else:
                for pid in self.ids:
                    if pid != nid:
                        out.append(["replicate", nid, pid])
                for k in keys:
                    out.append(["propose", nid, k,
                                f"v{len(self.ops)}"])
                out.append(["barrier", nid])
                with node._mu:
                    if self._read_servable(node):
                        for k in keys:
                            out.append(["read", nid, k])
            if node._pending_snap is not None \
                    or node.applied_index < node.commit_index:
                out.append(["apply", nid])
        return out

    # -- state fingerprint (for explorer pruning) ----------------------------

    def fingerprint(self) -> Tuple:
        """The full logical state as a hashable value — no hashing, so
        pruning can never be unsound via collision. Clock-derived
        values (_last_contact, timers, lease anchors, send times) are
        excluded: they never gate which events the explorer enables
        (ticks jump time past timers deterministically)."""
        nodes = []
        for nid in self.ids:
            node = self.nodes.get(nid)
            if node is None:
                nodes.append((nid, "crashed", self.gen[nid]))
                continue
            rl = node.raft_log
            with node._mu:
                nodes.append((
                    nid, self.gen[nid], node.role, rl.term,
                    rl.voted_for, rl.snap_index,
                    tuple((e.term, e.index, bytes(e.payload), e.kind)
                          for e in rl.entries_from(
                              rl.snap_index + 1, 10 ** 9)),
                    node.commit_index, node.applied_index,
                    node.leader_id, node._term_start_index,
                    tuple(sorted(node._next_index.items())),
                    tuple(sorted(node._match_index.items())),
                    tuple(sorted(node._votes)),
                    tuple(sorted(node._prevotes)),
                    node._prevote_round,
                    node._confirm_seq,
                    tuple(sorted(node._confirm_acked.items())),
                    tuple(sorted(self.machines[nid].kv.items())),
                ))
        return (
            tuple(nodes),
            self.net.fingerprint(),
            self.disk.fingerprint("/sim/"),
            tuple((o.kind, o.key, o.value, o.rv, o.status)
                  for o in self.ops),
        )

    # -- end-of-run checks ---------------------------------------------------

    def final_state(self) -> Dict[str, Tuple[Any, int]]:
        """{key: (value, rv)} per the global committed record — the
        store state a quiesced cluster would converge to."""
        out: Dict[str, Tuple[Any, int]] = {}
        for idx in sorted(self.committed):
            term, payload, kind = self.committed[idx]
            if kind != KIND_DATA or not payload:
                continue
            k, _, v = bytes(payload).partition(b"=")
            out[k.decode()] = (v.decode(), idx)
        return out

    def close(self) -> None:
        for node in list(self.nodes.values()):
            try:
                node.kill()
            except SimIOError:
                pass
        self.nodes.clear()
