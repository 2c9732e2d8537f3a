"""QuorumStore: the storage.Interface facade over a QuorumNode.

The store IS the replicated state machine: a MemoryStore whose public
mutators are rerouted through consensus instead of writing in place.
The write path is *leader-evaluates, quorum-commits, apply-delivers*:

  1. Under a propose lock the leader EVALUATES the mutation against
     its fully-applied state — optimistic-concurrency checks run here,
     resourceVersions are assigned here — producing a batch of plain
     records ``[ev_type, key, rv, obj]`` and per-item results, without
     touching the store.
  2. The record batch is one raft log entry; ``QuorumNode.propose``
     returns once a majority has durably appended it.
  3. The apply loop — the ONLY state-machine mutator, identical on
     every member — writes the records into ``_data``/``_tlv_blobs``
     and delivers the watch events. Watchers therefore only ever see
     COMMITTED writes (the window replicated.py had, where a watcher
     could observe a write that died with the primary, is closed by
     construction), and the cacher's ``watch_bootstrap`` feed and
     per-prefix progress-rv stamping work unchanged on any member.

The propose lock is held from evaluation through local apply, so the
next evaluation always sees every prior acked write — that serializes
writers per node, which the batch doors (`create_batch`,
`update_batch`, `/api/v1/batch`) already amortize: a whole wave is one
entry, one majority round trip.

Reads are linearizable via read-index: `get`/`list` barrier through
the leader (followers forward the barrier, then wait for their own
apply position) before serving their local state. `scan_refs` — the
metadata GC sweep — deliberately stays local/stale. Closure-carrying
verbs (`guaranteed_update`, `update_batch`) cannot ship their
mutation functions to a remote leader; a follower runs them as
read-evaluate-CAS loops against forwarded conditional batches, the
classic client-side GuaranteedUpdate retry inverted into the store.

Copy of kubernetes_tpu/storage/quorum/store.py: only the import package differs.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.runtime import tlv
from kubernetes_tpu_torch.storage.quorum.node import (
    NodeConfig,
    NotLeader,
    QuorumNode,
    QuorumUnavailable,
)
from kubernetes_tpu_torch.storage.quorum.rpc import (
    PeerClient,
    RPCConnectError,
    RPCError,
)
from kubernetes_tpu_torch.storage.store import (
    ADDED,
    DELETED,
    DELETE_OBJECT,
    ERROR,
    MODIFIED,
    Conflict,
    KeyExists,
    KeyNotFound,
    MemoryStore,
    StorageError,
    WatchEvent,
    _dc,
)

log = logging.getLogger(__name__)

#: wire marker for "no expected resourceVersion" in conditional ops
_ANY_RV = -1

_ERR_KINDS = {
    "KeyExists": KeyExists,
    "KeyNotFound": KeyNotFound,
    "Conflict": Conflict,
    "Storage": StorageError,
}


def _encode_err(e: Exception) -> List[Any]:
    for kind, cls in _ERR_KINDS.items():
        if isinstance(e, cls):
            return ["err", kind, str(e)]
    return ["err", "Storage", f"{type(e).__name__}: {e}"]


def _decode_result(r: List[Any]):
    if r[0] == "ok":
        return int(r[1])
    if r[0] == "okobj":
        return r[1]
    if r[0] == "none":
        return None
    kind = _ERR_KINDS.get(r[1], StorageError)
    return kind(r[2])


class QuorumStore(MemoryStore):
    """A quorum member's storage.Interface endpoint. Construct one per
    member, `set_peers` + `start` it, and hand it to an APIServer —
    leader or follower, the server need not know which."""

    def __init__(self, config: NodeConfig, history_size: int = 8192,
                 write_timeout: float = 10.0,
                 read_timeout: float = 5.0):
        super().__init__(history_size)
        self.write_timeout = write_timeout
        self.read_timeout = read_timeout
        #: serializes evaluate -> propose -> applied on this node, so
        #: every evaluation sees all prior acked writes applied
        self._propose_mu = threading.Lock()
        self._fwd_mu = threading.Lock()
        self._fwd_clients: Dict[str, PeerClient] = {}  # guarded-by: self._fwd_mu
        self.node = QuorumNode(
            config,
            apply_fn=self._apply_payload,
            install_fn=self._install_state,
            state_fn=self._state_blob,
            client_fn=self._handle_forward,
        )
        self.node_id = config.node_id

    # -- lifecycle -----------------------------------------------------------

    @property
    def address(self) -> Tuple[str, int]:
        return self.node.address

    def set_peers(self, peers: Dict[str, Tuple[str, int]]) -> None:
        self.node.set_peers(peers)

    def start(self) -> "QuorumStore":
        self.node.start()
        return self

    def close(self) -> None:
        self.node.close()

    def kill(self) -> None:
        """Simulated kill -9 of this member (chaos hook)."""
        self.node.kill()

    def quorum_status(self) -> Dict[str, Any]:
        """Leader identity / role / indices for /healthz."""
        return self.node.status()

    # -- membership ----------------------------------------------------------

    def add_member(self, node_id: str, address: Tuple[str, int],
                   timeout: float = 10.0) -> int:
        """Replicate an add of `node_id` @ `address` through the log
        (leader-only; raises NotLeader elsewhere). The new member
        should already be RUNNING as a follower pointed at the
        cluster — pre-vote keeps its timeouts harmless until the
        leader's replicator reaches it (snapshot install included)."""
        return self.node.propose_config(
            ["add", node_id, [address[0], int(address[1])]],
            timeout=timeout)

    def remove_member(self, node_id: str, timeout: float = 10.0) -> int:
        """Replicate a removal of `node_id` (leader-only). The removed
        member goes idle when it applies the entry; survivors shrink
        their majority math at theirs."""
        return self.node.propose_config(["remove", node_id],
                                        timeout=timeout)

    def wait_leader(self, timeout: float = 10.0) -> bool:
        """Block until SOME member is known to lead (local role or a
        leader hint learned from appends) — a cluster-warmup hook."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.node.is_leader() or self.node.leader_hint():
                return True
            time.sleep(0.02)
        return False

    # -- state-machine callbacks (node apply thread) -------------------------

    def _apply_payload(self, payload: bytes, index: int) -> None:
        """Apply ONE committed entry: decode its records and commit
        them into the local state — identical, in order, on every
        member. Watch events (and the history window) materialize
        here, never at propose time."""
        with tlv.allow_dynamic():
            records = tlv.loads(payload)
        events = []
        with self._lock:
            for ev_type, key, rv, obj in records:
                prev = self._data.get(key)
                prev_obj = prev[0] if prev is not None else None
                pblob = self._tlv_blobs.get(key)
                if ev_type == DELETED:
                    self._data.pop(key, None)
                    self._tlv_blobs.pop(key, None)
                    events.append((key, WatchEvent(
                        DELETED, prev_obj if prev_obj is not None
                        else obj, rv,
                        prev_obj if prev_obj is not None else obj,
                        obj_blob=pblob, prev_blob=pblob, key=key)))
                else:
                    self._data[key] = (obj, rv)
                    oblob = self._encode_blob(key, obj)
                    events.append((key, WatchEvent(
                        ev_type, obj, rv, prev_obj,
                        obj_blob=oblob, prev_blob=pblob, key=key)))
                if rv > self._rv:
                    self._rv = rv
            if events:
                self._record_batch(events)

    def _install_state(self, blob: bytes) -> None:
        """Replace the whole state machine with a leader snapshot (the
        lagging/fresh-member catch-up, and restart recovery). Any live
        watcher spans a history discontinuity and is terminated with
        ERROR so its consumer relists (the Compacted contract)."""
        with tlv.allow_dynamic():
            rv, data = tlv.loads(blob)
        with self._lock:
            self._data = {k: (o, orv) for k, (o, orv) in data.items()}
            self._tlv_blobs.clear()
            self._history = []
            self._rv = max(self._rv, rv)
            self._compacted_rv = self._rv
            watchers, self._watchers = self._watchers, []
        for _prefix, stream in watchers:
            stream._deliver(WatchEvent(ERROR, None, rv))
            stream.stop()

    def _state_blob(self) -> bytes:
        """Serialize the applied state (the raft snapshot body; the
        replicated.py snapshot shape, so the two HA profiles stay
        file-compatible in spirit)."""
        with self._lock:
            return tlv.dumps(
                [self._rv,
                 {k: [o, orv] for k, (o, orv) in self._data.items()}]
            )

    # -- evaluation (leader, under _propose_mu) ------------------------------

    def _evaluate(self, ops: List[Any]):
        """Dry-run `ops` against the applied state: assign rvs, run
        the optimistic-concurrency checks, and emit (records, results)
        without mutating anything. Per-item isolation: an item's error
        lands in its result slot and consumes no rv."""
        records: List[List[Any]] = []
        results: List[Any] = []
        with self._lock:
            rv = self._rv
            # keys this batch already wrote: later items in the same
            # entry must see the batch's own effects
            staged: Dict[str, Tuple[Any, int, bool]] = {}

            def current(key):
                if key in staged:
                    obj, curv, deleted = staged[key]
                    return (None, 0, False) if deleted \
                        else (obj, curv, True)
                if key in self._data:
                    obj, curv = self._data[key]
                    return obj, curv, True
                return None, 0, False

            for op in ops:
                kind = op[0]
                try:
                    if kind == "create":
                        _, key, obj = op
                        _cur, _crv, exists = current(key)
                        if exists:
                            raise KeyExists(key)
                        rv += 1
                        self._set_rv(obj, rv)
                        records.append([ADDED, key, rv, obj])
                        staged[key] = (obj, rv, False)
                        results.append(rv)
                    elif kind == "update":
                        _, key, obj, expect = op
                        _cur, curv, exists = current(key)
                        if not exists:
                            raise KeyNotFound(key)
                        if expect != _ANY_RV and expect != curv:
                            raise Conflict(
                                f"{key}: rv {expect} != current {curv}")
                        rv += 1
                        self._set_rv(obj, rv)
                        records.append([MODIFIED, key, rv, obj])
                        staged[key] = (obj, rv, False)
                        results.append(rv)
                    elif kind == "delete":
                        _, key, expect = op
                        cur, curv, exists = current(key)
                        if not exists:
                            raise KeyNotFound(key)
                        if expect != _ANY_RV and expect != curv:
                            raise Conflict(
                                f"{key}: rv {expect} != current {curv}")
                        rv += 1
                        records.append([DELETED, key, rv, cur])
                        staged[key] = (None, rv, True)
                        results.append(("deleted", cur))
                    else:
                        raise StorageError(f"unknown op kind {kind!r}")
                except Exception as e:
                    results.append(e)
        return records, results

    # -- submit path ---------------------------------------------------------

    def _submit_local(self, ops: List[Any]) -> List[Any]:
        """Leader-side: evaluate + propose + wait-applied, all under
        the propose lock. Raises NotLeader for the forwarding layer
        when leadership moved."""
        with self._propose_mu:
            # a fresh leader first catches its applied state up to the
            # commit frontier — acked writes from prior terms must be
            # visible to this evaluation (raises NotLeader if deposed)
            self.node.apply_barrier(timeout=self.write_timeout)
            records, results = self._evaluate(ops)
            if records:
                self.node.propose(tlv.dumps(records),
                                  timeout=self.write_timeout)
            return results

    def _handle_forward(self, msg: Any) -> Any:
        """Peer-RPC handler for ["fwd", ops] from a follower taking
        client traffic. Results are re-encoded wire-safe (exceptions
        become tagged error lists); the indeterminate flag rides the
        reply so the follower's caller knows replay safety."""
        try:
            results = self._submit_local(msg[1])
        except NotLeader as e:
            return ["fwdrep", False, "notleader", e.leader_id]
        except QuorumUnavailable as e:
            return ["fwdrep", False, "unavailable", str(e),
                    bool(e.indeterminate)]
        out = []
        for r in results:
            if isinstance(r, Exception):
                out.append(_encode_err(r))
            elif isinstance(r, tuple) and r and r[0] == "deleted":
                out.append(["okobj", r[1]])
            elif r is None:
                out.append(["none"])
            else:
                out.append(["ok", int(r)])
        return ["fwdrep", True, out, ""]

    def _fwd_client(self, leader_id: str) -> Optional[PeerClient]:
        addr = self.node.config.peers.get(leader_id)
        if addr is None:
            return None
        with self._fwd_mu:
            c = self._fwd_clients.get(leader_id)
            if c is None or c.address != tuple(addr):
                c = PeerClient(addr, timeout=self.write_timeout)
                self._fwd_clients[leader_id] = c
            return c

    def _submit(self, ops: List[Any]) -> List[Any]:
        """Run `ops` through consensus from wherever we are: locally
        when leading, forwarded to the leader otherwise, retrying
        through elections until the write deadline."""
        deadline = time.monotonic() + self.write_timeout
        last_err: Optional[Exception] = None
        while time.monotonic() < deadline:
            if self.node.is_leader():
                try:
                    return self._submit_local(ops)
                except NotLeader as e:
                    last_err = e
                except QuorumUnavailable as e:
                    # indeterminate (no majority in time): surface —
                    # retrying could double-apply a committed entry
                    raise
            else:
                leader = self.node.leader_hint()
                client = self._fwd_client(leader) if leader else None
                if client is not None:
                    try:
                        reply = client.call(
                            ["fwd", ops],
                            timeout=max(0.05,
                                        deadline - time.monotonic()))
                        if reply[0] == "fwdrep" and reply[1]:
                            return [_decode_result(r) for r in reply[2]]
                        if reply[0] == "fwdrep" and \
                                reply[2] == "unavailable":
                            err = QuorumUnavailable(reply[3])
                            err.indeterminate = bool(
                                reply[4] if len(reply) > 4 else False)
                            raise err
                        last_err = QuorumUnavailable(
                            f"leader moved (hint {reply[3]!r})")
                    except RPCConnectError as e:
                        last_err = e  # never left this host: retry
                    except RPCError as e:
                        # the batch may have REACHED the leader and
                        # committed even though the reply was lost —
                        # re-sending could double-apply (and report a
                        # committed create as KeyExists). Same
                        # indeterminate contract as the local path.
                        err = QuorumUnavailable(
                            f"forwarded write outcome unknown: {e}")
                        err.indeterminate = True
                        raise err
                else:
                    last_err = QuorumUnavailable("no known leader")
            time.sleep(0.03)
        raise QuorumUnavailable(
            f"write not acknowledged within {self.write_timeout}s: "
            f"{last_err}")

    # -- linearizable read point ---------------------------------------------

    def read_index(self, timeout: Optional[float] = None) -> int:
        """Confirmed-leadership read barrier from any member: leaders
        run the heartbeat round; followers forward the barrier and
        wait for their own apply position to pass it. Returns the
        read index actually applied locally."""
        to = self.read_timeout if timeout is None else timeout
        deadline = time.monotonic() + to
        last_err: Optional[Exception] = None
        while time.monotonic() < deadline:
            left = max(0.05, deadline - time.monotonic())
            if self.node.is_leader():
                try:
                    return self.node.read_barrier(timeout=left)
                except QuorumUnavailable as e:
                    last_err = e
            else:
                leader = self.node.leader_hint()
                client = self._fwd_client(leader) if leader else None
                if client is not None:
                    try:
                        reply = client.call(["barrier", left],
                                            timeout=left)
                        if reply[0] == "barrierrep" and reply[1]:
                            idx = int(reply[2])
                            if self.node.wait_applied(
                                    idx, deadline - time.monotonic()):
                                return idx
                            last_err = QuorumUnavailable(
                                f"apply never reached read index {idx}")
                        else:
                            last_err = QuorumUnavailable(
                                reply[3] if len(reply) > 3 else
                                "barrier refused")
                    except RPCError as e:
                        last_err = e
                else:
                    last_err = QuorumUnavailable("no known leader")
            time.sleep(0.03)
        raise QuorumUnavailable(
            f"linearizable read barrier failed within {to}s: {last_err}")

    # -- storage.Interface: reads --------------------------------------------

    def get(self, key: str):
        self.read_index()
        return super().get(key)

    def list(self, prefix: str):
        self.read_index()
        return super().list(prefix)

    # scan_refs / watch / watch_bootstrap / current_rv: local committed
    # state on purpose — the GC sweep tolerates staleness, and watches
    # are committed-only by construction (events deliver at apply).

    # -- storage.Interface: writes -------------------------------------------

    def _one(self, op: List[Any]):
        r = self._submit([op])[0]
        if isinstance(r, Exception):
            raise r
        return r

    def create(self, key: str, obj: Any, owned: bool = False) -> int:
        # ownership can't transfer into a replicated log entry the
        # proposer may retry: always evaluate an isolation copy
        return self._one(["create", key, obj if owned else _dc(obj)])

    def create_batch(self, items) -> List[Optional[Exception]]:
        results = self._submit([["create", k, o] for k, o in items])
        return [r if isinstance(r, Exception) else None
                for r in results]

    def update(self, key: str, obj: Any, expect_rv: Optional[int] = None,
               owned: bool = False) -> int:
        return self._one([
            "update", key, obj if owned else _dc(obj),
            _ANY_RV if expect_rv is None else int(expect_rv)])

    def delete(self, key: str, expect_rv: Optional[int] = None) -> Any:
        r = self._one([
            "delete", key,
            _ANY_RV if expect_rv is None else int(expect_rv)])
        # local evaluation hands back the stored object's live ref;
        # the caller gets the usual isolation copy
        return _dc(r[1]) if isinstance(r, tuple) else r

    def guaranteed_update(self, key: str, fn,
                          ignore_not_found: bool = False) -> int:
        """Read-evaluate-CAS against the quorum: the closure runs HERE
        (it cannot travel to a remote leader); a Conflict means the
        value moved under us — re-read and re-apply, exactly the
        client-side GuaranteedUpdate loop."""
        deadline = time.monotonic() + self.write_timeout
        while True:
            self.read_index()
            with self._lock:
                if key in self._data:
                    cur_obj, cur_rv = self._data[key]
                    cur = self._copy_of(key, cur_obj)
                else:
                    if not ignore_not_found:
                        raise KeyNotFound(key)
                    cur, cur_rv = None, 0
            new = fn(cur)
            if new is None:
                return self.current_rv
            try:
                if cur_rv:
                    return self._one(["update", key, new, cur_rv])
                return self._one(["create", key, new])
            except (Conflict, KeyExists, KeyNotFound):
                if time.monotonic() >= deadline:
                    raise
                continue

    def update_batch(self, ops) -> List[Optional[Exception]]:
        """The wave-commit door: evaluate every closure against the
        linearizable read point, ship ONE conditional batch entry,
        retry only the items whose keys moved. A full wave is still
        one log entry and one majority round trip in the common
        (uncontended) case."""
        ops = list(ops)
        out: List[Optional[Exception]] = [None] * len(ops)
        pending = list(range(len(ops)))
        deadline = time.monotonic() + self.write_timeout
        while pending:
            self.read_index()
            batch: List[List[Any]] = []
            slots: List[int] = []
            for i in pending:
                op = ops[i]
                key, fn = op[0], op[1]
                copier = op[2] if len(op) > 2 else None
                try:
                    with self._lock:
                        if key not in self._data:
                            raise KeyNotFound(key)
                        stored, cur_rv = self._data[key]
                        cur = (copier(stored) if copier is not None
                               else self._copy_of(key, stored))
                    new = fn(cur)
                    if new is None:
                        out[i] = None
                        continue
                    if new is DELETE_OBJECT:
                        batch.append(["delete", key, cur_rv])
                    else:
                        batch.append(["update", key, new, cur_rv])
                    slots.append(i)
                except Exception as e:
                    out[i] = e
            if not batch:
                return out
            results = self._submit(batch)
            retry: List[int] = []
            for slot, r in zip(slots, results):
                if isinstance(r, Conflict):
                    retry.append(slot)  # key moved: re-read, re-apply
                elif isinstance(r, Exception):
                    out[slot] = r
                else:
                    out[slot] = None
            if retry and time.monotonic() >= deadline:
                err = Conflict("update_batch: contention persisted "
                               "past the write deadline")
                for slot in retry:
                    out[slot] = err
                return out
            pending = retry
        return out


def build_cluster(
    base_dir: str,
    n: int = 3,
    peer_addrs: Optional[Dict[str, Tuple[str, int]]] = None,
    **node_kw,
) -> List[QuorumStore]:
    """Construct, wire, and start an n-member cluster in this process
    (the test/bench/local-up constructor). Members bind ephemeral
    listeners first, then exchange addresses — `peer_addrs` overrides
    any member's advertised address (the nemesis-proxy splice point:
    map a node id to its proxy instead of its listener)."""
    import os

    stores = [
        QuorumStore(NodeConfig(
            node_id=f"q{i}",
            data_dir=os.path.join(base_dir, f"q{i}"),
            **node_kw,
        ))
        for i in range(n)
    ]
    addrs = {s.node_id: s.address for s in stores}
    if peer_addrs:
        addrs.update({k: tuple(v) for k, v in peer_addrs.items()})
    for s in stores:
        s.set_peers({pid: a for pid, a in addrs.items()
                     if pid != s.node_id})
        s.start()
    return stores
