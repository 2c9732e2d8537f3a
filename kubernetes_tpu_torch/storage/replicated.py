"""Replicated storage: synchronous WAL shipping + standby promotion.

The reference's persistence tier is an etcd CLUSTER: raft replicates
every write to a quorum before it is acknowledged, so losing the leader
machine loses nothing (pkg/storage/etcd3/store.go — the etcd client —
and the etcd server's raft log behind it). storage/durable.FileStore
gave this framework single-node durability; this module adds the
survives-member-loss property, scaled to the primary/standby pair that
fits a framework whose apiserver embeds its store:

  * `ReplicatedStore` (the primary) serves a replication listener.
    A connecting follower first receives a full snapshot (the raft
    snapshot analogue), then every committed mutation as a
    length-prefixed TLV record IN COMMIT ORDER, and acks bytes applied.
  * Commits are SYNCHRONOUS once a follower is attached: the mutation
    returns — and watchers see it — only after the follower has
    durably appended the record. kill -9 on the primary then cannot
    lose an acknowledged write: either it never acked (client retries)
    or the follower has it. A follower that stalls past `sync_timeout`
    is dropped and the primary degrades to unreplicated (availability
    over replication for the tail, exactly etcd's leader-minority
    behavior inverted for a 2-node pair — documented, not hidden).
  * `FollowerStore` applies the stream into its own WAL + snapshot
    (FileStore mechanics) and can `promote()` into a fully writable
    store with RV continuity; a `PromotionMonitor` watches the primary
    and fires promotion after consecutive liveness failures — the
    lease-loss idiom of client/leaderelection.py, inverted: raft gives
    etcd leader election INSIDE the store; a 2-node WAL-shipping pair
    must elect from OUTSIDE, and the only authority left when the
    primary is gone is its failure to answer.

Wire: the record framing reuses the durable WAL's (length + CRC + TLV),
so what travels the socket is byte-identical to what lands in both WALs.

Copy of kubernetes_tpu/storage/replicated.py: only the import package differs.
"""

from __future__ import annotations

import logging
import os
import socket
import struct
import threading
import time
import zlib
from typing import Callable, Optional

from kubernetes_tpu_torch.runtime import tlv
from kubernetes_tpu_torch.storage.durable import FileStore, _LEN, _CRC
from kubernetes_tpu_torch.storage.store import WatchEvent

log = logging.getLogger(__name__)


class NotPrimary(Exception):
    """A write reached a standby that has not been promoted; the
    apiserver maps it to 503 so clients retry (through transport
    failover, usually onto the primary)."""


_MAGIC = b"KTREPL01"
_ACK = struct.Struct("<Q")
#: fencing token on the ack channel (2^64-1: impossible byte offset).
#: A follower sends it as its LAST word before promoting: the primary
#: must stop accepting writes — a stale primary that merely lost its
#: replication socket degrades and keeps serving, but one whose
#: standby PROMOTED is the split-brain half and must stand down.
_FENCE = (1 << 64) - 1


def _frame(payload: bytes) -> bytes:
    return _LEN.pack(len(payload)) + _CRC.pack(zlib.crc32(payload)) + payload


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("replication peer closed")
        buf += chunk
    return buf


def _read_frame(sock: socket.socket) -> bytes:
    hdr = _read_exact(sock, _LEN.size + _CRC.size)
    (n,) = _LEN.unpack_from(hdr, 0)
    (crc,) = _CRC.unpack_from(hdr, _LEN.size)
    body = _read_exact(sock, n)
    if zlib.crc32(body) != crc:
        raise ConnectionError("replication frame failed CRC")
    return body


class ReplicatedStore(FileStore):
    """FileStore + a replication listener shipping every commit to the
    attached follower synchronously."""

    def __init__(self, data_dir: str, host: str = "127.0.0.1",
                 repl_port: int = 0, sync_timeout: float = 5.0, **kw):
        super().__init__(data_dir, **kw)
        self.sync_timeout = sync_timeout
        self._repl_lock = threading.Lock()
        self._follower: Optional[socket.socket] = None  # guarded-by: self._repl_lock
        # bytes acked by the follower
        self._acked = 0  # guarded-by: self._repl_lock
        self._shipped = 0  # guarded-by: self._repl_lock
        # True once a promoted standby fenced us: every subsequent
        # write raises NotPrimary (503 -> clients fail over). Before
        # this flag, only the socket close "protected" the promotion
        # window — a stale primary with pooled client connections kept
        # acking writes the new primary would never see.
        self._fenced = False  # guarded-by: self._repl_lock
        self._ack_cond = threading.Condition(self._repl_lock)
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, repl_port))
        self._srv.listen(2)
        self.repl_address = self._srv.getsockname()
        self._stopped = False  # guarded-by: self._repl_lock
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="repl-accept").start()

    # -- follower attach -----------------------------------------------------

    def _accept_loop(self) -> None:
        while True:
            with self._repl_lock:
                if self._stopped:
                    return
            try:
                conn, _addr = self._srv.accept()
            except OSError:
                return
            try:
                self._attach(conn)
            except Exception:
                log.exception("replication attach failed")
                try:
                    conn.close()
                except OSError:
                    pass

    def _attach(self, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # a stalled or hostile peer must never wedge the attach path —
        # and ESPECIALLY not the snapshot send below, which runs under
        # the store lock (every read/write waits on it)
        conn.settimeout(self.sync_timeout)
        if _read_exact(conn, len(_MAGIC)) != _MAGIC:
            raise ConnectionError("bad replication magic")
        # snapshot under the store lock so the record stream resumes
        # exactly where the snapshot ends (no gap, no replay overlap);
        # the socket timeout bounds how long a non-reading peer can
        # hold the lock once the kernel buffer fills
        with self._lock:
            body = tlv.dumps([
                "snap", self._rv,
                {k: [o, rv] for k, (o, rv) in self._data.items()},
            ])
            conn.sendall(_frame(body))
            conn.settimeout(None)
            with self._repl_lock:
                old = self._follower
                self._follower = conn
                self._shipped = 0
                self._acked = 0
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        threading.Thread(target=self._ack_loop, args=(conn,),
                         daemon=True, name="repl-acks").start()
        log.info("replication follower attached from %s",
                 conn.getpeername())

    def _ack_loop(self, conn: socket.socket) -> None:
        try:
            while True:
                data = _read_exact(conn, _ACK.size)
                (n,) = _ACK.unpack(data)
                with self._ack_cond:
                    if self._follower is not conn:
                        # this socket was replaced by a fresh attach: a
                        # late buffered ack counts against the OLD
                        # stream's byte offsets and must never satisfy
                        # the new follower's sync wait — that would
                        # void the acked-write-survives-kill-9
                        # guarantee for writes the new follower hasn't
                        # durably applied yet
                        return
                    if n == _FENCE:
                        # the standby promoted: WE are now the stale
                        # half. Fence every future write and unblock
                        # any commit waiting on acks (it fails with
                        # NotPrimary instead of timing out)
                        self._fenced = True
                        self._follower = None
                        self._ack_cond.notify_all()
                        log.warning(
                            "FENCED by promoted standby: this store "
                            "rejects all writes from now on")
                        break
                    self._acked = n
                    self._ack_cond.notify_all()
            try:
                conn.close()
            except OSError:
                pass
        except (ConnectionError, OSError):
            self._drop_follower(conn)

    def _drop_follower(self, conn: socket.socket) -> None:
        with self._ack_cond:
            if self._follower is conn:
                self._follower = None
                # unblock any commit waiting on acks: degraded mode
                self._ack_cond.notify_all()
        try:
            conn.close()
        except OSError:
            pass

    # -- commit path ---------------------------------------------------------

    def _reject_if_fenced(self) -> None:
        with self._repl_lock:
            if self._fenced:
                raise NotPrimary(
                    "store was fenced by its promoted standby (this "
                    "is the stale primary of a completed failover)"
                )

    @property
    def fenced(self) -> bool:
        with self._repl_lock:
            return self._fenced

    # every public mutator checks the fence FIRST — before the local
    # commit, so a fenced primary's state stops moving at the moment
    # the new primary took over (the term boundary, in quorum terms)

    def create(self, key, obj, owned=False):
        self._reject_if_fenced()
        return super().create(key, obj, owned=owned)

    def create_batch(self, items):
        self._reject_if_fenced()
        return super().create_batch(items)

    def update(self, key, obj, expect_rv=None, owned=False):
        self._reject_if_fenced()
        return super().update(key, obj, expect_rv=expect_rv,
                              owned=owned)

    def update_batch(self, ops):
        self._reject_if_fenced()
        return super().update_batch(ops)

    def guaranteed_update(self, key, fn, ignore_not_found=False):
        self._reject_if_fenced()
        return super().guaranteed_update(
            key, fn, ignore_not_found=ignore_not_found
        )

    def delete(self, key, expect_rv=None):
        self._reject_if_fenced()
        return super().delete(key, expect_rv=expect_rv)

    def _record(self, key: str, ev: WatchEvent) -> None:
        # ship BEFORE the local WAL append + watcher delivery: an event
        # a watcher saw must already be on the follower (kill -9 safe)
        rec = tlv.dumps(["rec", ev.type, key, ev.resource_version,
                         ev.object])
        self._ship_synced(_frame(rec))
        super()._record(key, ev)

    def _record_batch(self, items) -> None:
        # batch commits replicate as one shipment: every record of the
        # burst goes to the follower in a single sendall and ONE ack
        # round-trip covers the whole batch (the per-event ack wait was
        # a sync_timeout-bounded stall per record otherwise)
        if items:
            frames = b"".join(
                _frame(tlv.dumps(["rec", ev.type, key,
                                  ev.resource_version, ev.object]))
                for key, ev in items
            )
            self._ship_synced(frames)
        super()._record_batch(items)

    def _ship_synced(self, frame: bytes) -> None:
        conn = self._follower
        if conn is not None:
            stalled = False
            try:
                conn.sendall(frame)
                with self._ack_cond:
                    self._shipped += len(frame)
                    target = self._shipped
                    deadline = time.monotonic() + self.sync_timeout
                    while (self._follower is conn
                           and self._acked < target):
                        left = deadline - time.monotonic()
                        if left <= 0:
                            log.error(
                                "replication follower stalled >%ss; "
                                "dropping it (degraded, unreplicated)",
                                self.sync_timeout,
                            )
                            stalled = True
                            break
                        self._ack_cond.wait(left)
                    if self._fenced:
                        # the fence arrived while this commit waited
                        # for acks: fail it loudly — the new primary
                        # may or may not have the record, and a silent
                        # degraded-mode success here would double-ack
                        raise NotPrimary(
                            "fenced while awaiting replication ack "
                            "(outcome owned by the promoted standby)"
                        )
            except OSError:
                self._drop_follower(conn)
            if stalled:
                # drop WITH a socket close (outside the condition —
                # _drop_follower retakes it): merely clearing
                # self._follower leaves the stalled peer's stream
                # intact, so it never observes the break, never
                # re-attaches, and keeps serving stale reads forever
                self._drop_follower(conn)

    def close(self) -> None:
        with self._repl_lock:
            self._stopped = True
        try:
            self._srv.close()
        except OSError:
            pass
        with self._repl_lock:
            conn, self._follower = self._follower, None
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
        super().close()


class FollowerStore(FileStore):
    """A standby store fed by a primary's replication stream. Until
    promote(), every mutating verb raises (the apiserver in front of it
    stays unserved/503); reads reflect the replicated state."""

    def __init__(self, data_dir: str, primary_addr, **kw):
        super().__init__(data_dir, **kw)
        self._promoted = threading.Event()
        self._primary_addr = tuple(primary_addr)
        self._applied = 0  # follow-loop thread only
        # the live replication socket: written by the follow loop,
        # read by promote() to deliver the fence token — a real
        # cross-thread handoff, so locked, not just close-protected
        self._conn_mu = threading.Lock()
        self._conn: Optional[socket.socket] = None  # guarded-by: self._conn_mu
        self._sync_once = threading.Event()
        self._thread = threading.Thread(
            target=self._follow_loop, daemon=True, name="repl-follow"
        )
        self._thread.start()

    # -- stream apply --------------------------------------------------------

    def _follow_loop(self) -> None:
        while not self._promoted.is_set():
            try:
                conn = socket.create_connection(self._primary_addr,
                                                timeout=5)
            except OSError:
                # keep retrying: a transient break must not silently
                # end replication for good (the stale standby would
                # keep serving reads while the primary degrades to
                # unreplicated). Promotion — the one legitimate exit —
                # flips the loop condition.
                time.sleep(0.2 if self._sync_once.is_set() else 0.1)
                continue
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conn_mu:
                self._conn = conn
            try:
                conn.sendall(_MAGIC)
                body = _read_frame(conn)
                with tlv.allow_dynamic():
                    kind, rv, data = tlv.loads(body)
                if kind != "snap":
                    raise ConnectionError("expected snapshot first")
                self._apply_snapshot(rv, data)
                self._applied = 0
                self._sync_once.set()
                conn.settimeout(None)
                while not self._promoted.is_set():
                    body = _read_frame(conn)
                    with tlv.allow_dynamic():
                        rec = tlv.loads(body)
                    self._apply_record(rec)
                    self._applied += (len(body) + _LEN.size + _CRC.size)
                    conn.sendall(_ACK.pack(self._applied))
            except (ConnectionError, OSError) as e:
                if not self._promoted.is_set():
                    log.warning("replication stream broke: %s", e)
            finally:
                with self._conn_mu:
                    self._conn = None
                try:
                    conn.close()
                except OSError:
                    pass
            # stream broke: reconnect (a fresh attach re-snapshots, so
            # state converges again); promotion ends the loop
            time.sleep(0.2)
        return

    def _apply_snapshot(self, rv: int, data: dict) -> None:
        with self._lock:
            self._data = {k: (o, orv) for k, (o, orv) in data.items()}
            self._tlv_blobs.clear()
            self._rv = rv
            self._compacted_rv = rv
            if self._wal is not None:
                self._snapshot_locked()  # persist the synced state

    def _apply_record(self, rec) -> None:
        kind, ev_type, key, rv, obj = rec
        if kind != "rec":
            raise ConnectionError(f"unexpected replication kind {kind!r}")
        with self._lock:
            prev = self._data.get(key, (None, 0))[0]
            if ev_type == "DELETED":
                self._data.pop(key, None)
                self._tlv_blobs.pop(key, None)
            else:
                self._data[key] = (obj, rv)
                self._tlv_blobs.pop(key, None)
            self._rv = max(self._rv, rv)
            self._compacted_rv = self._rv
            # durable BEFORE the ack leaves (FileStore._record appends
            # the WAL); watcher delivery on a standby reaches nobody
            # (no watchers until the apiserver serves post-promotion)
            ev = WatchEvent(ev_type, obj, rv, prev)
            super()._record(key, ev)

    # -- promotion -----------------------------------------------------------

    def promote(self) -> None:
        """Become the writable store (RV sequence continues where the
        stream stopped). Idempotent. If the old primary is merely
        DEEMED dead (slow, not gone) and still holds pooled client
        connections, the fence token sent here makes it reject every
        subsequent write — before it, only the socket close protected
        the promotion window, and a live stale primary kept acking
        writes the promoted store would never see."""
        if self._promoted.is_set():
            return
        self._promoted.set()
        with self._conn_mu:
            conn = self._conn
        if conn is not None:
            try:
                # last word on the ack channel: FENCE, then hang up.
                # Best-effort by design — a truly dead primary has
                # nobody to fence
                conn.sendall(_ACK.pack(_FENCE))
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        with self._lock:
            if self._wal is not None:
                self._snapshot_locked()
        log.warning("standby PROMOTED at rv=%s", self.current_rv)

    @property
    def promoted(self) -> bool:
        return self._promoted.is_set()

    def synced(self, timeout: float = 10.0) -> bool:
        """True once the initial snapshot sync has applied."""
        return self._sync_once.wait(timeout)

    def _reject_if_standby(self) -> None:
        if not self._promoted.is_set():
            raise NotPrimary(
                "store is a replication standby (not promoted)"
            )

    def create(self, key, obj, owned=False):
        self._reject_if_standby()
        return super().create(key, obj, owned=owned)

    def update(self, key, obj, expect_rv=None, owned=False):
        self._reject_if_standby()
        return super().update(key, obj, expect_rv=expect_rv, owned=owned)

    def update_batch(self, ops):
        self._reject_if_standby()
        return super().update_batch(ops)

    def guaranteed_update(self, key, fn, ignore_not_found=False):
        self._reject_if_standby()
        return super().guaranteed_update(
            key, fn, ignore_not_found=ignore_not_found
        )

    def delete(self, key, expect_rv=None):
        self._reject_if_standby()
        return super().delete(key, expect_rv=expect_rv)


class PromotionMonitor:
    """Promote the standby after `failures` consecutive primary liveness
    probe failures — the external election a 2-node WAL-shipping pair
    needs (raft does this INSIDE a 3+-member etcd; with two members and
    the primary dead, the probe's silence is the only ballot). The probe
    interval x failures product bounds unavailability; binding clients
    retry through it (client/transport failover)."""

    def __init__(self, follower: FollowerStore, probe: Callable[[], bool],
                 interval: float = 0.2, failures: int = 5,
                 on_promote: Optional[Callable[[], None]] = None):
        self.follower = follower
        self.probe = probe
        self.interval = interval
        self.failures = failures
        self.on_promote = on_promote
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="promotion-monitor"
        )

    def run(self) -> "PromotionMonitor":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        misses = 0
        while not self._stop.wait(self.interval):
            ok = False
            try:
                ok = bool(self.probe())
            except Exception:
                ok = False
            misses = 0 if ok else misses + 1
            if misses >= self.failures:
                self.follower.promote()
                if self.on_promote is not None:
                    try:
                        self.on_promote()
                    except Exception:
                        log.exception("on_promote callback failed")
                return
