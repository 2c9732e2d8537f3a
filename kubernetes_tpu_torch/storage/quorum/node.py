"""QuorumNode: the Raft-shaped consensus member under QuorumStore.

One node = one RaftLog (durable term/vote/entries/snapshot), one
PeerServer (votes, appends, snapshot installs, forwarded client ops),
and four kinds of threads:

  * a **ticker** that fires elections on randomized timeouts
    (follower/candidate silence -> candidacy; terms + persisted votes
    guarantee at most one leader per term),
  * one **replicator per peer** (leader only): AppendEntries with
    per-follower next/match indices, decrement-on-conflict backoff,
    and a snapshot install when the follower's next index has been
    compacted out of the log window,
  * an **apply loop**, the only mutator of the state machine: applies
    committed entries in order via ``apply_fn``, installs leader-sent
    snapshots via ``install_fn``, and compacts the raft log through
    ``state_fn`` every ``snapshot_every`` applied entries,
  * the PeerServer's per-connection handler threads.

Commit = majority match on an entry of the current term (the leader's
own durable append counts). Linearizable reads ride ``read_barrier``:
the leader captures commit_index as the read index, proves it still
leads, then waits until the read index is applied — a read served
after the barrier can never be a deposed leader's stale view (the
etcd3 ReadIndex protocol). Followers forward the barrier and then
wait for their own apply position to pass the returned index.

**Leader leases** (round 13): leadership proof is usually free. Every
successful AppendEntries reply records the SEND time of the call that
earned it; the lease extends to (majority-th most recent ack's send
time) + ``lease_factor`` x ``election_timeout``. While the lease is
live, a barrier serves WITHOUT the heartbeat confirm round (counted in
``quorum_lease_reads_total``; the slow confirm path counts
``quorum_readindex_rounds_total``). Safety: no member grants a
pre-vote — and therefore no real election can begin — before
``election_timeout`` of leader silence, and silence starts no earlier
than the last append's send time, so a deposing election cannot
complete while any correctly-measured lease (factor < 1) is live.

**Pre-vote** (round 13, always on): a would-be candidate first probes
electability with a term-UNCHANGED "prevote" round; peers grant only
when their own leader has gone silent past the election timeout and
the candidate's log is current. Only a majority of prevotes starts a
real (term-bumping) election — a rejoining partitioned member, whose
peers still hear a healthy leader, can no longer force the cluster
through a term it cannot win (``quorum_prevote_rounds_total``).

**Dynamic membership** (round 13): ``propose_config`` replicates an
add/remove of one member as a KIND_CONFIG log entry; every member
applies it to its own peer set at commit (single-server change — one
membership delta in flight at a time), so majority math, replicators,
and lease accounting all follow the logged configuration with no
downtime. A joining member simply starts as a follower pointed at the
cluster; pre-vote keeps its timeouts from disturbing anyone until the
leader's replicator reaches it (snapshot install included).

The node knows nothing about the storage.Interface: payloads are
opaque bytes the store evaluates and applies. That keeps every
consensus decision testable with byte payloads and fault-injected
sockets, independent of the object model above it.

Copy of kubernetes_tpu/storage/quorum/node.py: only the import package differs.
"""

from __future__ import annotations

import logging
import random
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.analysis import races as _races
from kubernetes_tpu_torch.metrics import (
    quorum_append_rtt_seconds,
    quorum_commit_index,
    quorum_leader_changes_total,
    quorum_lease_reads_total,
    quorum_prevote_rounds_total,
    quorum_readindex_rounds_total,
    quorum_snapshot_installs_total,
    quorum_term,
)
from kubernetes_tpu_torch.storage.quorum.io import WALL_CLOCK
from kubernetes_tpu_torch.storage.quorum.log import (
    KIND_CONFIG,
    KIND_DATA,
    Entry,
    RaftLog,
)
from kubernetes_tpu_torch.storage.quorum.rpc import TCP_TRANSPORT, RPCError
from kubernetes_tpu_torch.storage.replicated import NotPrimary

log = logging.getLogger(__name__)

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"

#: _propose_status_locked outcomes: the proposal is still in flight,
#: honestly committed+applied, definitively truncated by a competing
#: leader, or unknowable (compacted across a term change).
ACK_PENDING = "pending"
ACK_ACKED = "acked"
ACK_LOST = "lost"
ACK_INDETERMINATE = "indeterminate"


class QuorumUnavailable(NotPrimary):
    """No leader reachable / no majority: the write or linearizable
    read cannot be served right now. Subclasses NotPrimary so the
    apiserver's existing 503 mapping applies — clients retry through
    transport failover onto a node that can reach the leader.

    ``indeterminate``: the operation may ALREADY have committed (a
    propose that timed out mid-replication, a forwarded batch whose
    reply was lost). The apiserver surfaces it in the 503 body so the
    multi-endpoint transport knows a blind replay is NOT safe; the
    default False means the request definitively did not execute."""

    indeterminate = False


class NotLeader(QuorumUnavailable):
    """This node is not the leader; carries the best leader hint."""

    def __init__(self, msg: str, leader_id: str = ""):
        super().__init__(msg)
        self.leader_id = leader_id


@dataclass
class NodeConfig:
    node_id: str
    data_dir: str
    #: peer id -> (host, port) of the peer's RPC listener; does NOT
    #: include this node. May be rewired (nemesis proxies) before start.
    peers: Dict[str, Tuple[str, int]] = field(default_factory=dict)
    listen_host: str = "127.0.0.1"
    listen_port: int = 0
    #: base election timeout; each reset re-rolls uniform [T, 2T].
    #: etcd's defaults (1s election / 100ms heartbeat): tight enough
    #: for sub-2s failover, loose enough that GIL stalls under a
    #: co-located traffic burst don't read as leader death (tests
    #: that WANT fast elections pass ~0.15-0.2 explicitly)
    election_timeout: float = 1.0
    heartbeat_interval: float = 0.1
    rpc_timeout: float = 1.0
    #: applied entries between raft-log compactions
    snapshot_every: int = 4096
    fsync: bool = False
    #: lease window as a fraction of the BASE election timeout. Must
    #: stay < 1: a pre-vote needs election_timeout of silence, silence
    #: is measured from append RECEIVE (>= the leader's send time the
    #: lease is measured from), and the margin absorbs clock-rate
    #: drift between members. 0 disables lease reads (every barrier
    #: pays the confirm round).
    lease_factor: float = 0.75
    #: max entries per AppendEntries batch. Replication of a long tail
    #: happens across several round trips; the sim checker shrinks
    #: this so multi-batch interleavings (the states where a follower's
    #: log is shorter than leader_commit) are reachable in short
    #: schedules.
    replication_batch: int = 64
    #: environment seams for the deterministic-simulation checker
    #: (analysis/sim). None = production: the wall clock, framed TCP,
    #: the real filesystem, and the process-global rng — exactly the
    #: pre-seam code path.
    clock: Optional[Any] = field(default=None, repr=False)
    transport: Optional[Any] = field(default=None, repr=False)
    disk: Optional[Any] = field(default=None, repr=False)
    rng: Optional[Any] = field(default=None, repr=False)


class QuorumNode:
    def __init__(self, config: NodeConfig,
                 apply_fn: Callable[[bytes, int], None],
                 install_fn: Callable[[bytes], None],
                 state_fn: Callable[[], bytes],
                 client_fn: Optional[Callable[[Any], Any]] = None):
        self.config = config
        self.node_id = config.node_id
        self.apply_fn = apply_fn
        self.install_fn = install_fn
        self.state_fn = state_fn
        #: handler for forwarded client ops (set by QuorumStore)
        self.client_fn = client_fn
        self._clock = config.clock if config.clock is not None \
            else WALL_CLOCK
        self._transport = config.transport if config.transport is not None \
            else TCP_TRANSPORT
        self._rng = config.rng if config.rng is not None else random
        self.raft_log = RaftLog(config.data_dir, fsync=config.fsync,
                                disk=config.disk)

        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self.role = FOLLOWER  # guarded-by: self._mu
        self.leader_id = ""  # guarded-by: self._mu
        self.commit_index = self.raft_log.snap_index  # guarded-by: self._mu
        self.applied_index = self.raft_log.snap_index  # guarded-by: self._mu
        self._next_index: Dict[str, int] = {}  # guarded-by: self._mu
        self._match_index: Dict[str, int] = {}  # guarded-by: self._mu
        #: read-index confirmation round: barrier bumps the seq, every
        #: heartbeat carries the latest, replies record it per peer
        self._confirm_seq = 0  # guarded-by: self._mu
        self._confirm_acked: Dict[str, int] = {}  # guarded-by: self._mu
        #: leader lease bookkeeping: per peer, the SEND time (monotonic)
        #: of the most recent append/snapshot call whose reply arrived
        #: at our current term — the conservative end of the window in
        #: which that peer provably still followed us
        self._ack_start: Dict[str, float] = {}  # guarded-by: self._mu
        #: pre-vote probe round: id fences stale grants, set collects
        #: the grants of the current round only. Rounds are paced by
        #: _prevote_last, NOT by touching _last_contact — probing must
        #: not reset anyone's leader-silence clock (two nodes probing
        #: each other would deny each other forever)
        self._prevote_round = 0  # guarded-by: self._mu
        self._prevotes: set = set()  # guarded-by: self._mu
        self._prevote_last = 0.0  # guarded-by: self._mu
        #: one membership change in flight at a time (single-server
        #: change rule); cleared at apply or on any role change
        self._config_inflight = False  # guarded-by: self._mu
        #: this member was removed from the cluster by a committed
        #: config entry: stop standing for election, serve nothing
        self._removed = False  # guarded-by: self._mu
        #: first index of the current leadership term (the no-op);
        #: read barriers wait for it to commit (Raft §8: a new leader
        #: may not know the commit frontier until its own term commits)
        self._term_start_index = 0  # guarded-by: self._mu
        self._votes: set = set()  # guarded-by: self._mu
        self._last_contact = self._clock.monotonic()  # guarded-by: self._mu
        self._timeout = self._roll_timeout()  # guarded-by: self._mu
        self._force_compact = False  # guarded-by: self._mu
        self._pending_snap: Optional[Tuple[int, bytes]] = None  # guarded-by: self._mu
        #: terms in which THIS node won an election (chaos suite
        #: aggregates across nodes: a term may appear on at most one)
        self.terms_led: List[int] = []  # guarded-by: self._mu
        self._stopped = threading.Event()
        self._killed = False  # guarded-by: self._mu

        # restore the state machine from the raft snapshot before any
        # entry applies (a restarted node replays committed entries on
        # top of this; commit_index itself is not persisted — the next
        # leader's term commit re-establishes the frontier)
        _si, _st, blob = self.raft_log.snapshot()
        if blob is not None:
            self.install_fn(blob)

        self._server = self._transport.listen(
            self._dispatch, config.listen_host, config.listen_port)
        self.address = self._server.address
        self._repl_clients: Dict[str, PeerClient] = {}  # guarded-by: self._mu
        self._vote_clients: Dict[str, PeerClient] = {}  # guarded-by: self._mu
        # _threads is append-only bookkeeping (start()/apply thread);
        # joins never iterate it concurrently with appends
        self._threads: List[threading.Thread] = []
        self._started = False  # replicators for dynamically-added
        # peers spawn at config apply only once start() has run
        _races.track(self, "quorum.QuorumNode")

    # -- lifecycle -----------------------------------------------------------

    def set_peers(self, peers: Dict[str, Tuple[str, int]]) -> None:
        """Wire (or re-wire) peer addresses before start(). Separate
        from __init__ so a cluster can bind all listeners first, then
        exchange addresses — and so tests can splice a nemesis proxy
        into any edge."""
        self.config.peers = {
            pid: tuple(addr) for pid, addr in peers.items()
            if pid != self.node_id
        }

    def start(self) -> "QuorumNode":
        to = self.config.rpc_timeout
        with self._mu:
            self._repl_clients = {
                pid: self._transport.connect(addr, to)
                for pid, addr in self.config.peers.items()
            }
            # elections must not queue behind an in-flight replication
            # call on the shared per-peer socket: separate ballot
            # clients
            self._vote_clients = {
                pid: self._transport.connect(addr, to)
                for pid, addr in self.config.peers.items()
            }
        # only now may peer/client messages arrive: every owner
        # (node AND the store wrapping it) finished construction
        self._server.serve()
        self._threads = [
            threading.Thread(target=self._ticker, daemon=True,
                             name=f"quorum-tick-{self.node_id}"),
            threading.Thread(target=self._apply_loop, daemon=True,
                             name=f"quorum-apply-{self.node_id}"),
        ]
        for t in self._threads:
            t.start()
        for pid in self.config.peers:
            self._spawn_replicator(pid)
        self._started = True
        return self

    def _spawn_replicator(self, pid: str) -> None:
        th = threading.Thread(
            target=self._replicator, args=(pid,), daemon=True,
            name=f"quorum-repl-{self.node_id}-{pid}")
        self._threads.append(th)
        th.start()

    def kill(self) -> None:
        """Simulated kill -9: sever every socket and stop every thread
        without flushing anything beyond what is already durable. A
        fresh node on the same data_dir is the restart."""
        with self._mu:
            self._killed = True
            self._cv.notify_all()
        self._stopped.set()
        self._server.close()
        with self._mu:
            clients = (list(self._repl_clients.values())
                       + list(self._vote_clients.values()))
        for c in clients:
            c.close()
        self.raft_log.close()

    def close(self) -> None:
        """Graceful stop (same surface; the raft log is append-durable
        at every commit, so there is nothing extra to flush)."""
        self.kill()

    # -- observers -----------------------------------------------------------

    def is_leader(self) -> bool:
        with self._mu:
            return self.role == LEADER

    def leader_hint(self) -> str:
        with self._mu:
            return self.leader_id if self.role != LEADER else self.node_id

    def status(self) -> Dict[str, Any]:
        """Identity block for /healthz and debugging."""
        with self._mu:
            return {
                "node": self.node_id,
                "role": self.role,
                "term": self.raft_log.term,
                "leader": (self.node_id if self.role == LEADER
                           else self.leader_id),
                "commit_index": self.commit_index,
                "applied_index": self.applied_index,
                "peers": len(self.config.peers),
                "members": sorted([self.node_id]
                                  + list(self.config.peers)),
                "lease_valid": (self._lease_expiry_locked()
                                > self._clock.monotonic()),
                "removed": self._removed,
            }

    def wait_applied(self, index: int, timeout: float) -> bool:
        """Block until the local apply position reaches `index` (the
        follower half of a read barrier)."""
        deadline = self._clock.monotonic() + timeout
        with self._mu:
            while self.applied_index < index:
                left = deadline - self._clock.monotonic()
                if left <= 0 or self._killed:
                    return False
                self._cv.wait(left)
            return True

    # -- client surface ------------------------------------------------------

    def propose(self, payload: bytes, timeout: float = 5.0) -> int:
        """Leader-only: append `payload` as one log entry, replicate,
        and return its index once it is committed AND applied locally.
        Raises NotLeader immediately on a non-leader, and
        QuorumUnavailable when the entry cannot reach a majority (or
        was truncated by a competing leader) within `timeout` — the
        outcome is then indeterminate and the caller must not treat
        the write as acknowledged."""
        return self._propose_entry(payload, KIND_DATA, timeout)

    def propose_config(self, change: List[Any],
                       timeout: float = 5.0) -> int:
        """Leader-only membership change: replicate ``["add", pid,
        [host, port]]`` or ``["remove", pid]`` as ONE config entry;
        every member applies it to its peer set at commit (majority
        math, replicators, and lease accounting follow). Single-server
        change rule: one membership delta in flight at a time."""
        from kubernetes_tpu_torch.runtime import tlv

        kind = change[0]
        if kind not in ("add", "remove"):
            raise ValueError(f"unknown membership change {kind!r}")
        if kind == "add" and len(change) != 3:
            raise ValueError("add takes [\"add\", id, [host, port]]")
        with self._mu:
            if self.role != LEADER:
                raise NotLeader(
                    f"{self.node_id} is {self.role}", self.leader_id)
            if self._config_inflight:
                raise QuorumUnavailable(
                    "a membership change is already in flight")
            self._config_inflight = True
        try:
            return self._propose_entry(
                tlv.dumps(list(change)), KIND_CONFIG, timeout)
        except Exception as e:
            # a DETERMINATE failure frees the slot; an indeterminate
            # one (the entry is in our log and may still commit) must
            # keep the single-change rule armed — the flag clears at
            # apply, or on any role/term change
            if not getattr(e, "indeterminate", False):
                with self._mu:
                    self._config_inflight = False
            raise

    def _propose_entry(self, payload: bytes, kind: int,
                       timeout: float) -> int:
        deadline = self._clock.monotonic() + timeout
        with self._mu:
            if self.role != LEADER:
                raise NotLeader(
                    f"{self.node_id} is {self.role}", self.leader_id)
            term, index = self._leader_append_locked(payload, kind)
            while True:
                status = self._propose_status_locked(index, term)
                if status == ACK_ACKED:
                    return index
                if status == ACK_LOST:
                    # a competing leader truncated our suffix: the
                    # entry is definitively lost, never acked
                    raise QuorumUnavailable(
                        f"entry {index} (term {term}) superseded")
                if status == ACK_INDETERMINATE:
                    err = QuorumUnavailable(
                        f"entry {index} compacted across a term change "
                        f"(term {term} -> {self.raft_log.term})")
                    err.indeterminate = True
                    raise err
                left = deadline - self._clock.monotonic()
                if left <= 0 or self._killed:
                    err = QuorumUnavailable(
                        f"entry {index} not committed within {timeout}s "
                        "(no majority reachable?)")
                    # the entry is in OUR log: a later majority may
                    # still commit it — the caller must not blind-retry
                    err.indeterminate = True
                    raise err
                self._cv.wait(left)

    def _leader_append_locked(self, payload: bytes,
                              kind: int) -> Tuple[int, int]:
        """Durably append one entry to the leader's own log ->
        (term, index). The non-blocking half of propose: the
        deterministic simulator appends here and then polls
        ``_propose_status_locked`` between schedule events instead of
        blocking on the condition variable."""
        term = self.raft_log.term
        index = self.raft_log.last_index + 1
        self.raft_log.append([Entry(term, index, payload, kind)])
        self._maybe_commit_locked()  # single-node: majority of 1
        self._cv.notify_all()
        return term, index

    def _propose_status_locked(self, index: int, term: int) -> str:
        """The honest-ack decision for a proposal appended at (term,
        index). The apply position passing `index` is NOT enough: a
        competing leader's overwriting entry advances it too. The ack
        is only honest when the slot still holds OUR entry (same
        term) — otherwise this proposal was truncated away and acking
        it would invent a commit the cluster never made (found by the
        partition chaos checker as a duplicate rv). Compaction may
        have folded the slot into the snapshot while we waited: if
        our term never moved, nothing could have overwritten it (only
        a higher-term leader truncates) and the compacted entry was
        ours; if the term DID move, whose entry got compacted is
        unknowable — indeterminate, not a clean failure."""
        rl = self.raft_log
        if index > rl.snap_index:
            if rl.term_at(index) != term:
                return ACK_LOST
        elif rl.term != term:
            return ACK_INDETERMINATE
        if self.applied_index < index:
            return ACK_PENDING
        return ACK_ACKED

    def apply_barrier(self, timeout: float = 5.0) -> None:
        """Leader-only: block until this term's start entry has
        committed and every committed entry is applied locally. A
        fresh leader holds all previously-ACKED writes in its LOG
        (election restriction) but may not have applied them yet —
        evaluating a proposal before this barrier would let a write
        land on a state missing its predecessors."""
        deadline = self._clock.monotonic() + timeout
        with self._mu:
            if self.role != LEADER:
                raise NotLeader(
                    f"{self.node_id} is {self.role}", self.leader_id)
            term = self.raft_log.term
            while not self._barrier_ready_locked():
                if not self._wait_leader_locked(term, deadline):
                    raise QuorumUnavailable(
                        "leader state never caught up to the commit "
                        "frontier (no majority reachable?)")

    def _barrier_ready_locked(self) -> bool:
        """True once this term's start entry has committed AND every
        committed entry is applied locally — the gate a fresh leader
        must pass before evaluating any proposal (the apply-barrier
        rule; bypassing it lets a write land on a state missing its
        predecessors)."""
        return (self.commit_index >= self._term_start_index
                and self.applied_index >= self.commit_index)

    def read_barrier(self, timeout: float = 2.0) -> int:
        """Linearizable read point (etcd ReadIndex): capture the
        commit index, prove leadership, wait until it is applied,
        return it. Proof is the leader LEASE when live (zero extra
        messages — the hot-read fast path) and a heartbeat confirm
        round otherwise. Raises NotLeader/QuorumUnavailable when this
        node cannot prove leadership — a lease-holding leader that
        loses its majority stops serving within the lease window by
        construction (the lease simply runs out)."""
        deadline = self._clock.monotonic() + timeout
        with self._mu:
            if self.role != LEADER:
                raise NotLeader(
                    f"{self.node_id} is {self.role}", self.leader_id)
            term = self.raft_log.term
            # a fresh leader's commit frontier is unknown until its own
            # no-op commits (Raft §8)
            while self.commit_index < self._term_start_index:
                if not self._wait_leader_locked(term, deadline):
                    raise QuorumUnavailable("term-start entry never "
                                            "committed (no majority?)")
            read_index = self.commit_index
            if self._lease_expiry_locked() > self._clock.monotonic():
                quorum_lease_reads_total.inc()
            elif self.config.peers:
                quorum_readindex_rounds_total.inc()
                self._confirm_seq += 1
                seq = self._confirm_seq
                self._cv.notify_all()  # wake replicators to carry it
                while not self._confirm_majority_locked(seq):
                    if not self._wait_leader_locked(term, deadline):
                        raise QuorumUnavailable(
                            "leadership not confirmed by a majority "
                            "(partitioned from the quorum?)")
            else:
                # single-node cluster with leases disabled: the local
                # commit IS the majority
                quorum_readindex_rounds_total.inc()
            while self.applied_index < read_index:
                if not self._wait_leader_locked(term, deadline):
                    raise QuorumUnavailable("read index never applied")
            return read_index

    def _wait_leader_locked(self, term: int, deadline: float) -> bool:
        """One bounded wait tick; False on deadline. Raises NotLeader
        the moment this node stops leading `term` — a barrier or
        commit wait must never survive deposition."""
        if self.role != LEADER or self.raft_log.term != term:
            raise NotLeader(f"{self.node_id} deposed", self.leader_id)
        left = deadline - self._clock.monotonic()
        if left <= 0 or self._killed:
            return False
        self._cv.wait(min(left, 0.05))
        return True

    def _confirm_majority_locked(self, seq: int) -> bool:
        acked = 1 + sum(1 for v in self._confirm_acked.values()
                        if v >= seq)
        return acked >= self._majority()

    # -- leader lease --------------------------------------------------------

    def _lease_ack_locked(self, pid: str, term: int, t_sent: float) -> None:
        """Record leadership contact with `pid`: a same-term reply to a
        call SENT at t_sent proves the peer still followed us at t_sent
        or later (the conservative end)."""
        if self.role != LEADER or self.raft_log.term != term:
            return
        if t_sent > self._ack_start.get(pid, 0.0):
            self._ack_start[pid] = t_sent
            self._cv.notify_all()  # a barrier may be lease-waiting

    def _lease_expiry_locked(self) -> float:
        """Monotonic time until which this leader's lease is provably
        safe: the majority-th most recent contact time + the lease
        window. No member can GRANT a pre-vote (the only road to a
        term bump) before election_timeout of silence, and its silence
        clock started no earlier than our send time — so with
        lease_factor < 1 no deposing election completes inside the
        window. 0.0 when not leading or leases are disabled."""
        if self.role != LEADER or self.config.lease_factor <= 0:
            return 0.0
        times = sorted(
            [self._clock.monotonic()]
            + [self._ack_start.get(p, 0.0) for p in self.config.peers],
            reverse=True)
        anchor = times[self._majority() - 1]
        if anchor <= 0.0:
            return 0.0
        return anchor + (self.config.election_timeout
                         * self.config.lease_factor)

    def compact_now(self) -> None:
        """Force a raft-log compaction at the current applied index
        (test hook for the snapshot-install path)."""
        with self._mu:
            self._force_compact = True
            self._cv.notify_all()

    # -- RPC dispatch --------------------------------------------------------

    def _dispatch(self, msg: Any) -> Any:
        kind = msg[0]
        if kind == "vote":
            return self._on_vote(msg)
        if kind == "prevote":
            return self._on_prevote(msg)
        if kind == "append":
            return self._on_append(msg)
        if kind == "snap":
            return self._on_snapshot(msg)
        if kind == "barrier":
            # forwarded linearizable-read barrier from a follower
            try:
                return ["barrierrep", True,
                        self.read_barrier(timeout=msg[1]), ""]
            except NotPrimary as e:
                return ["barrierrep", False, 0, str(e)]
        if kind == "who":
            return ["whorep", self.leader_hint()]
        if kind == "fwd":
            if self.client_fn is None:
                return ["fwdrep", False, "no client handler", None]
            return self.client_fn(msg)
        return ["err", f"unknown message kind {kind!r}"]

    def _on_prevote(self, msg: Any) -> Any:
        """Electability probe: grant iff the candidate COULD win a real
        election right now — its target term is ahead of ours, its log
        is current, and OUR leader has been silent past the base
        election timeout (the lease check: a member still hearing a
        healthy leader refuses, so a flapping rejoiner can't stampede
        the cluster into a new term). Grants change NO state — nothing
        persists, no vote is spent, our term does not move."""
        _, target_term, _cand, last_idx, last_term = msg
        with self._mu:
            if self._killed:
                return ["prevoterep", self.raft_log.term, False]
            cur = self.raft_log.term
            granted = False
            if target_term > cur:
                mine = (self.raft_log.last_term, self.raft_log.last_index)
                silent = (self._clock.monotonic() - self._last_contact
                          >= self.config.election_timeout)
                if ((last_term, last_idx) >= mine
                        and (silent or self.role == CANDIDATE)
                        and self.role != LEADER):
                    granted = True
            return ["prevoterep", cur, granted]

    def _on_vote(self, msg: Any) -> Any:
        _, term, cand, last_idx, last_term = msg
        with self._mu:
            if self._killed:
                return ["voterep", self.raft_log.term, False]
            if term > self.raft_log.term:
                self._step_down_locked(term, "")
            cur = self.raft_log.term
            granted = False
            if term == cur and self.raft_log.voted_for in ("", cand):
                mine = (self.raft_log.last_term, self.raft_log.last_index)
                if (last_term, last_idx) >= mine:
                    granted = True
                    # persist the ballot BEFORE it leaves: a forgotten
                    # vote re-cast after restart elects two leaders
                    self.raft_log.save_hardstate(cur, cand)
                    self._touch_locked()
            return ["voterep", cur, granted]

    def _on_append(self, msg: Any) -> Any:
        _, term, leader, prev_idx, prev_term, raw_entries, \
            leader_commit, seq = msg
        with self._mu:
            if self._killed:
                return ["apprep", self.raft_log.term, False, 0, 0]
            if term < self.raft_log.term:
                return ["apprep", self.raft_log.term, False, 0, seq]
            if term > self.raft_log.term or self.role != FOLLOWER:
                self._step_down_locked(term, leader)
            self.leader_id = leader
            self._touch_locked()
            rl = self.raft_log
            if prev_idx > rl.last_index:
                # gap: tell the leader where our log actually ends
                return ["apprep", rl.term, False, rl.last_index, seq]
            if prev_idx >= rl.snap_index:
                have = rl.term_at(prev_idx)
                if have is not None and have != prev_term:
                    # conflicting suffix: back the leader up past it
                    return ["apprep", rl.term, False,
                            max(rl.snap_index, prev_idx - 1), seq]
            match = prev_idx + len(raw_entries)
            new: List[Entry] = []
            for row in raw_entries:
                t, i, payload = row[0], row[1], row[2]
                ekind = row[3] if len(row) > 3 else KIND_DATA
                if i <= rl.snap_index:
                    continue  # already folded into our snapshot
                have = rl.term_at(i)
                if have is None and i > rl.last_index:
                    new.append(Entry(t, i, payload, ekind))
                elif have != t:
                    rl.truncate_from(i)
                    new.append(Entry(t, i, payload, ekind))
                # have == t: duplicate delivery of an entry we hold
            if new:
                rl.append(new)
            self._advance_commit_follower_locked(leader_commit, match)
            return ["apprep", rl.term, True, match, seq]

    def _advance_commit_follower_locked(self, leader_commit: int,
                                        match: int) -> None:
        """Advance a follower's commit index from a successful append.
        Commit bound: the VERIFIED match frontier of THIS append
        (prev_idx + delivered entries — Raft's "index of last new
        entry"), never the raw log end: a healed follower may still
        hold a stale conflicting suffix from its own old term beyond
        the frontier, and applying it against a leader_commit that ran
        ahead of the delivered batch would ack a write the cluster
        never committed (found by the partition chaos checker as a
        duplicate commit; re-found by the sim corpus as mutation
        ``commit-past-match``)."""
        if leader_commit > self.commit_index:
            bound = min(leader_commit, match)
            if bound > self.commit_index:
                self.commit_index = bound
                quorum_commit_index.labels(self.node_id).set(
                    self.commit_index)
                self._cv.notify_all()

    def _on_snapshot(self, msg: Any) -> Any:
        _, term, leader, last_idx, last_term, blob = msg
        with self._mu:
            if self._killed or term < self.raft_log.term:
                return ["snaprep", self.raft_log.term, False]
            if term > self.raft_log.term or self.role != FOLLOWER:
                self._step_down_locked(term, leader)
            self.leader_id = leader
            self._touch_locked()
            if last_idx > self.raft_log.snap_index:
                # durable before the reply: an acked install the
                # follower then loses would strand the leader's
                # next_index beyond reality
                self.raft_log.install_snapshot(last_idx, last_term, blob)
                self._pending_snap = (last_idx, blob)
                self.commit_index = max(self.commit_index, last_idx)
                self._cv.notify_all()
            return ["snaprep", self.raft_log.term, True]

    # -- role machinery ------------------------------------------------------

    def _roll_timeout(self) -> float:
        t = self.config.election_timeout
        return self._rng.uniform(t, 2 * t)

    def _touch_locked(self) -> None:
        self._last_contact = self._clock.monotonic()

    def _majority(self) -> int:
        return (len(self.config.peers) + 1) // 2 + 1

    def _step_down_locked(self, term: int, leader: str) -> None:
        if term > self.raft_log.term:
            self.raft_log.save_hardstate(term, "")
            quorum_term.labels(self.node_id).set(term)
        was = self.role
        self.role = FOLLOWER
        self.leader_id = leader
        self._config_inflight = False
        self._timeout = self._roll_timeout()
        self._touch_locked()
        if was != FOLLOWER:
            log.info("%s: stepped down to follower at term %s",
                     self.node_id, term)
        self._cv.notify_all()

    def _ticker(self) -> None:
        while not self._stopped.wait(0.01):
            with self._mu:
                if self._killed:
                    return
                plan = self._election_tick_locked(
                    self._clock.monotonic())
            if plan is None:
                continue
            round_id, msg, peers = plan
            quorum_prevote_rounds_total.inc()
            for pid in peers:
                threading.Thread(
                    target=self._solicit_prevote,
                    args=(pid, round_id, msg),
                    daemon=True,
                    name=f"quorum-preballot-{self.node_id}-{pid}",
                ).start()

    def _election_tick_locked(
            self, now: float) -> Optional[Tuple[int, Any, List[str]]]:
        """One election-timer check at `now`. Returns (round_id,
        prevote_msg, peers) when a pre-vote round should be solicited
        — the production ticker fans the solicitation out on threads,
        the simulator enqueues the messages into SimNet. None when
        the timer has not fired (or a single-node cluster elected
        itself on the spot)."""
        if self.role == LEADER or self._removed:
            return None
        if now - self._last_contact < self._timeout:
            return None
        if now - self._prevote_last < self._timeout:
            return None  # a probe round is still maturing
        self._timeout = self._roll_timeout()
        self._prevote_last = now
        if not self.config.peers:
            # single-node cluster: no one to probe, elect now
            self._begin_election_locked()
            return None
        # silence past the randomized timeout: probe electability
        # WITHOUT touching the term (pre-vote) — the real election
        # starts only on a majority of grants
        self._prevote_round += 1
        self._prevotes = {self.node_id}
        msg = ["prevote", self.raft_log.term + 1, self.node_id,
               self.raft_log.last_index, self.raft_log.last_term]
        return self._prevote_round, msg, list(self.config.peers)

    def _solicit_prevote(self, pid: str, round_id: int,
                         msg: Any) -> None:
        with self._mu:
            client = self._vote_clients.get(pid)
        if client is None:
            return
        try:
            reply = client.call(
                msg, timeout=min(self.config.rpc_timeout,
                                 self.config.election_timeout))
        except RPCError:
            return
        begin = self._on_prevote_reply(pid, round_id, reply)
        if begin is not None:
            term, vote_msg, peers = begin
            for peer in peers:
                threading.Thread(
                    target=self._solicit_vote,
                    args=(peer, term, vote_msg),
                    daemon=True,
                    name=f"quorum-ballot-{self.node_id}-{peer}",
                ).start()

    def _on_prevote_reply(
            self, pid: str, round_id: int,
            reply: Any) -> Optional[Tuple[int, Any, List[str]]]:
        """Count one pre-vote reply. Returns (term, vote_msg, peers)
        the moment a majority of grants starts the real (term-bumping)
        election — the caller solicits the actual ballots."""
        if not reply or reply[0] != "prevoterep":
            return None
        _, rterm, granted = reply
        with self._mu:
            if self._killed or self._removed:
                return None
            if rterm > self.raft_log.term:
                # someone is already ahead: adopt the term, no ballot
                self._step_down_locked(rterm, "")
                return None
            if (self._prevote_round != round_id or not granted
                    or self.role == LEADER):
                return None
            self._prevotes.add(pid)
            if len(self._prevotes) < self._majority():
                return None
            self._prevote_round += 1  # fence the round's stragglers
            begin = self._begin_election_locked()
            if begin is None:
                return None
            term, last_idx, last_term = begin
            vote_msg = ["vote", term, self.node_id, last_idx, last_term]
            return term, vote_msg, list(self.config.peers)

    def _begin_election_locked(self):
        """Bump the term, persist the self-vote, become CANDIDATE.
        Returns (term, last_idx, last_term) for the caller to solicit
        real votes with, or None when the cluster is single-node (we
        won on the spot)."""
        term = self.raft_log.term + 1
        self.raft_log.save_hardstate(term, self.node_id)
        quorum_term.labels(self.node_id).set(term)
        self.role = CANDIDATE
        self.leader_id = ""
        self._votes = {self.node_id}
        self._config_inflight = False
        self._timeout = self._roll_timeout()
        self._touch_locked()
        last_idx = self.raft_log.last_index
        last_term = self.raft_log.last_term
        if self._votes_win_locked():
            return None  # single-node cluster: instant leader
        return term, last_idx, last_term

    def _solicit_vote(self, pid: str, term: int, msg: Any) -> None:
        with self._mu:
            client = self._vote_clients.get(pid)
        if client is None:
            return
        try:
            reply = client.call(
                msg, timeout=min(self.config.rpc_timeout,
                                 self.config.election_timeout))
        except RPCError:
            return
        self._on_vote_reply(pid, term, reply)

    def _on_vote_reply(self, pid: str, term: int, reply: Any) -> None:
        """Count one real-election ballot reply for `term`."""
        if not reply or reply[0] != "voterep":
            return
        _, rterm, granted = reply
        with self._mu:
            if self._killed:
                return
            if rterm > self.raft_log.term:
                self._step_down_locked(rterm, "")
                return
            if (self.role != CANDIDATE
                    or self.raft_log.term != term or not granted):
                return
            self._votes.add(pid)
            self._votes_win_locked()

    def _votes_win_locked(self) -> bool:
        if len(self._votes) < self._majority():
            return False
        term = self.raft_log.term
        self.role = LEADER
        self.leader_id = self.node_id
        self.terms_led.append(term)
        last = self.raft_log.last_index
        self._next_index = {p: last + 1 for p in self.config.peers}
        self._match_index = {p: 0 for p in self.config.peers}
        self._confirm_acked = {p: 0 for p in self.config.peers}
        # lease accounting restarts at zero: a fresh leader holds no
        # lease until a majority of appends have been acked
        self._ack_start = {p: 0.0 for p in self.config.peers}
        self._config_inflight = False
        # the term-start no-op: commits the new leader's view of the
        # log prefix and anchors read barriers (empty payload; the
        # apply loop skips it)
        self._term_start_index = last + 1
        self.raft_log.append([Entry(term, last + 1, b"")])
        self._maybe_commit_locked()
        quorum_leader_changes_total.inc(node=self.node_id)
        log.info("%s: LEADER at term %s (log at %s)",
                 self.node_id, term, last + 1)
        self._cv.notify_all()
        return True

    # -- replication (leader) ------------------------------------------------

    def _replicator(self, pid: str) -> None:
        with self._mu:
            client = self._repl_clients.get(pid)
        if client is None:
            return
        hb = self.config.heartbeat_interval
        while not self._stopped.is_set():
            with self._mu:
                if self._killed:
                    return
                if pid not in self.config.peers:
                    return  # removed by a committed config entry
                if self.role != LEADER:
                    self._cv.wait(0.1)
                    continue
                term = self.raft_log.term
                plan = self._build_replication_locked(pid)
            if plan is None:
                # snapshot needed but the blob is absent: wait it out
                self._clock.sleep(hb)
                continue
            if plan[0] == "snap":
                _, msg, snap_idx = plan
                t0 = self._clock.monotonic()
                try:
                    reply = client.call(
                        msg, timeout=max(5.0, self.config.rpc_timeout))
                except RPCError:
                    self._clock.sleep(hb)
                    continue
                with self._mu:
                    installed = self._on_snap_reply_locked(
                        pid, term, t0, snap_idx, reply)
                if installed:
                    quorum_snapshot_installs_total.inc()
                continue
            _, msg = plan
            t0 = self._clock.monotonic()
            try:
                reply = client.call(msg)
            except RPCError:
                # peer unreachable: retry at heartbeat cadence (the
                # election timer on the OTHER side decides liveness)
                with self._mu:
                    self._cv.wait(hb)
                continue
            quorum_append_rtt_seconds.observe(
                self._clock.monotonic() - t0)
            if not reply or reply[0] != "apprep":
                self._clock.sleep(hb)
                continue
            with self._mu:
                if self._on_append_reply_locked(pid, term, t0, reply):
                    # idle (nothing new, seq current): heartbeat pace;
                    # a fresh append or barrier notifies us awake
                    self._cv.wait(hb)

    def _build_replication_locked(self, pid: str) -> Optional[Tuple]:
        """Build the next replication message for `pid` from the
        leader's bookkeeping: ("append", msg) for a log append (empty
        entry list = heartbeat), ("snap", msg, snap_idx) when the
        follower's next entry was compacted away, or None when the
        needed snapshot blob is absent (nothing sendable yet)."""
        term = self.raft_log.term
        nxt = self._next_index.get(pid, 1)
        prev = nxt - 1
        prev_term = self.raft_log.term_at(prev)
        if prev_term is None:
            # the follower's next entry was compacted away: ship the
            # whole snapshot instead
            snap_idx, snap_term, blob = self.raft_log.snapshot()
            if blob is None:
                return None
            return ("snap", ["snap", term, self.node_id, snap_idx,
                             snap_term, blob], snap_idx)
        entries = self.raft_log.entries_from(
            nxt, self.config.replication_batch)
        return ("append",
                ["append", term, self.node_id, prev, prev_term,
                 [[e.term, e.index, e.payload, e.kind]
                  for e in entries],
                 self.commit_index, self._confirm_seq])

    def _on_snap_reply_locked(self, pid: str, term: int, t0: float,
                              snap_idx: int, reply: Any) -> bool:
        """Process a snapshot-install reply for a call sent at t0;
        True when the follower accepted the install."""
        if not reply or reply[0] != "snaprep":
            return False
        if reply[1] > self.raft_log.term:
            self._step_down_locked(reply[1], "")
            return False
        if not reply[2]:
            return False
        self._next_index[pid] = snap_idx + 1
        self._match_index[pid] = max(
            self._match_index.get(pid, 0), snap_idx)
        self._lease_ack_locked(pid, term, t0)
        return True

    def _on_append_reply_locked(self, pid: str, term: int, t0: float,
                                reply: Any) -> bool:
        """Process one AppendEntries reply for a call sent (at our
        term `term`) at t0: advance match/next/commit/lease/confirm
        bookkeeping. Returns True when the replicator may idle at
        heartbeat pace (nothing new to send, confirm seq current)."""
        _, rterm, ok, match, rseq = reply
        if rterm > self.raft_log.term:
            self._step_down_locked(rterm, "")
            return False
        if self.role != LEADER or self.raft_log.term != term:
            return False
        # lease contact: ANY same-term reply (success or conflict
        # backoff) proves the peer followed us at some point AFTER
        # this call's send time
        self._lease_ack_locked(pid, term, t0)
        if ok:
            if match > self._match_index.get(pid, 0):
                self._match_index[pid] = match
                self._maybe_commit_locked()
            self._next_index[pid] = match + 1
            if rseq > self._confirm_acked.get(pid, 0):
                self._confirm_acked[pid] = rseq
                self._cv.notify_all()  # barrier waiters
            return (self.raft_log.last_index < self._next_index[pid]
                    and self._confirm_seq == rseq)
        # conflict hint: jump next_index straight to just past the
        # follower's usable log end
        self._next_index[pid] = max(
            1, min(self._next_index.get(pid, 1) - 1, match + 1))
        return False

    def _maybe_commit_locked(self) -> None:
        """Advance commit_index to the highest index replicated on a
        majority whose entry is of the CURRENT term (Raft §5.4.2: a
        leader never counts replicas of older-term entries)."""
        if self.role != LEADER:
            return
        matches = sorted(
            [self.raft_log.last_index]
            + [self._match_index.get(p, 0) for p in self.config.peers],
            reverse=True)
        candidate = matches[self._majority() - 1]
        if candidate > self.commit_index and \
                self.raft_log.term_at(candidate) == self.raft_log.term:
            self.commit_index = candidate
            quorum_commit_index.labels(self.node_id).set(candidate)
            self._cv.notify_all()

    # -- membership (applied config entries) ---------------------------------

    def _apply_config(self, payload: bytes) -> None:
        """Apply ONE committed membership change to this member's view
        of the cluster — identical on every member, so majority math
        never diverges. Runs on the apply thread only."""
        from kubernetes_tpu_torch.runtime import tlv

        with tlv.allow_dynamic():
            change = tlv.loads(payload)
        kind, pid = change[0], change[1]
        spawn = None
        with self._mu:
            self._config_inflight = False
            if kind == "add":
                addr = (change[2][0], int(change[2][1]))
                if pid == self.node_id:
                    pass  # my own join commit: nothing to wire
                elif pid in self.config.peers:
                    self.config.peers[pid] = addr  # re-address
                else:
                    self.config.peers[pid] = addr
                    to = self.config.rpc_timeout
                    self._repl_clients[pid] = self._transport.connect(
                        addr, to)
                    self._vote_clients[pid] = self._transport.connect(
                        addr, to)
                    self._next_index[pid] = self.raft_log.last_index + 1
                    self._match_index[pid] = 0
                    self._confirm_acked[pid] = 0
                    self._ack_start[pid] = 0.0
                    if self._started:
                        spawn = pid
                    log.info("%s: member %s added at %s:%s",
                             self.node_id, pid, addr[0], addr[1])
            elif kind == "remove":
                if pid == self.node_id:
                    # I was removed: stop standing for election, stop
                    # leading; the survivors' majority math no longer
                    # counts me
                    self._removed = True
                    if self.role == LEADER:
                        self.role = FOLLOWER
                        self.leader_id = ""
                    log.info("%s: removed from the cluster (idle)",
                             self.node_id)
                else:
                    self.config.peers.pop(pid, None)
                    rc = self._repl_clients.pop(pid, None)
                    vc = self._vote_clients.pop(pid, None)
                    self._next_index.pop(pid, None)
                    self._match_index.pop(pid, None)
                    self._confirm_acked.pop(pid, None)
                    self._ack_start.pop(pid, None)
                    for c in (rc, vc):
                        if c is not None:
                            c.close()
                    # a shrunk cluster may already satisfy commit /
                    # confirm majorities: re-evaluate both
                    self._maybe_commit_locked()
                    log.info("%s: member %s removed", self.node_id, pid)
            self._cv.notify_all()
        if spawn is not None:
            self._spawn_replicator(spawn)

    # -- apply loop ----------------------------------------------------------

    def _apply_next(self) -> bool:
        """Apply exactly one pending item — a leader-installed
        snapshot, or the next committed-but-unapplied entry. Returns
        False when the state machine is current. The production apply
        loop batches (below) for throughput; the deterministic
        simulator steps one entry at a time through this so invariants
        can be checked between applies."""
        with self._mu:
            snap = self._pending_snap
            self._pending_snap = None
            e: Optional[Entry] = None
            if snap is None:
                if self.applied_index < self.commit_index:
                    e = self.raft_log.entry(self.applied_index + 1)
                if e is None:
                    return False
        if snap is not None:
            idx, blob = snap
            self.install_fn(blob)
            with self._mu:
                if idx > self.applied_index:
                    self.applied_index = idx
                self._cv.notify_all()
            return True
        if e.kind == KIND_CONFIG:
            try:
                self._apply_config(e.payload)
            except Exception:
                log.exception(
                    "%s: membership change at entry %s failed",
                    self.node_id, e.index)
        elif e.payload:
            try:
                self.apply_fn(e.payload, e.index)
            except Exception:
                log.exception("%s: apply of entry %s failed",
                              self.node_id, e.index)
        with self._mu:
            self.applied_index = e.index
            self._cv.notify_all()
        return True

    def _apply_loop(self) -> None:
        while not self._stopped.is_set():
            with self._mu:
                if self._killed:
                    return
                snap = self._pending_snap
                self._pending_snap = None
                batch: List[Entry] = []
                if snap is None:
                    # strictly up to commit_index: the log routinely
                    # holds entries BEYOND it (a follower receives
                    # appends before the commit frontier advances;
                    # the leader appends its own proposal before the
                    # majority acks) and applying one would ack a
                    # write no majority holds
                    while (self.applied_index + len(batch)
                           < self.commit_index):
                        e = self.raft_log.entry(self.applied_index
                                                + len(batch) + 1)
                        if e is None:
                            break
                        batch.append(e)
                        if len(batch) >= 256:
                            break
                    if not batch and not self._force_compact:
                        self._cv.wait(0.2)
                        continue
                force = self._force_compact
                self._force_compact = False
            if snap is not None:
                idx, blob = snap
                self.install_fn(blob)
                with self._mu:
                    if idx > self.applied_index:
                        self.applied_index = idx
                    self._cv.notify_all()
                continue
            for e in batch:
                if e.kind == KIND_CONFIG:
                    try:
                        self._apply_config(e.payload)
                    except Exception:
                        log.exception(
                            "%s: membership change at entry %s failed",
                            self.node_id, e.index)
                elif e.payload:
                    try:
                        self.apply_fn(e.payload, e.index)
                    except Exception:
                        # an apply error is a state-machine bug, not a
                        # consensus event; surface loudly but keep the
                        # node participating (skipping would diverge)
                        log.exception("%s: apply of entry %s failed",
                                      self.node_id, e.index)
                with self._mu:
                    self.applied_index = e.index
                    self._cv.notify_all()
            with self._mu:
                applied = self.applied_index
                due = force or (applied - self.raft_log.snap_index
                                >= self.config.snapshot_every)
                snap_term = self.raft_log.term_at(applied)
            if due and snap_term is not None and \
                    applied > self.raft_log.snap_index:
                # the apply thread is the only state-machine mutator,
                # so the blob is exactly the state at `applied`
                blob = self.state_fn()
                self.raft_log.compact(applied, snap_term, blob)
