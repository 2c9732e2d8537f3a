"""Durable storage backend: WAL + snapshot under the versioned store.

The reference's entire resilience story is "etcd is the only checkpoint"
(SURVEY §5.4; pkg/storage/etcd/etcd_helper.go, etcd3/store.go): every
component is a stateless cache of etcd, rebuilt via list+watch, and an
apiserver restart loses nothing because etcd persists the raft log.
MemoryStore made the apiserver itself the point of data loss; FileStore
closes that hole with the same mechanics etcd uses, scaled to one node:

  * every committed mutation appends one length-prefixed record to a
    write-ahead log (the raft-log analogue) before watchers see it;
  * a periodic snapshot (temp file + fsync + atomic rename) bounds WAL
    replay, after which the log is truncated;
  * recovery loads the snapshot, replays the WAL (tolerating a torn
    tail from a mid-write crash), and resumes the resourceVersion
    sequence exactly where it stopped — RV continuity means clients'
    optimistic-concurrency tokens stay valid across the restart.

Watch history is NOT persisted: recovery sets the compaction horizon to
the recovered RV, so any watcher resuming from a pre-crash version gets
Compacted and relists — precisely the reflector's crash-recovery
contract (reflector.go ListAndWatch).

On-disk format: every WAL record and the snapshot body are TLV
(runtime/tlv.py — data-only, no code execution on load) with a CRC32
per record, so a corrupt file surfaces as a clear CorruptStoreError
instead of arbitrary deserialization behavior. data_dir should still be
private to the apiserver: the CRC detects corruption, not tampering
(an attacker with write access can forge valid records — exactly as
with etcd's data directory).

Copy of kubernetes_tpu/storage/durable.py: only the import package differs.
"""

from __future__ import annotations

import os
import struct
import zlib

from kubernetes_tpu_torch.runtime import tlv
from kubernetes_tpu_torch.storage.store import MemoryStore, WatchEvent

_LEN = struct.Struct("<I")
_CRC = struct.Struct("<I")
_SNAP_MAGIC = b"KTSNAP02"
_WAL_MAGIC = b"KTWAL002"


class CorruptStoreError(Exception):
    """Persisted state failed integrity/format checks (not a torn tail:
    torn tails are expected after a crash and silently discarded)."""


class FileStore(MemoryStore):
    """MemoryStore persisted to `data_dir` (wal.log + snapshot.db)."""

    def __init__(
        self,
        data_dir: str,
        history_size: int = 8192,
        snapshot_every: int = 4096,
        fsync: bool = False,
    ):
        super().__init__(history_size)
        self._dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self._wal_path = os.path.join(data_dir, "wal.log")
        self._snap_path = os.path.join(data_dir, "snapshot.db")
        self._snapshot_every = snapshot_every
        self._fsync = fsync
        self._appends = 0
        self._wal = None  # guard: no WAL writes during recovery replay
        self._recover()
        self._open_wal()

    # -- persistence hooks ---------------------------------------------------

    @staticmethod
    def _wal_record(key: str, ev: WatchEvent) -> bytes:
        rec = tlv.dumps([ev.type, key, ev.resource_version, ev.object])
        return _LEN.pack(len(rec)) + _CRC.pack(zlib.crc32(rec)) + rec

    def _record(self, key: str, ev: WatchEvent) -> None:
        # called under self._lock by every mutation, after the in-memory
        # commit and before watcher delivery
        if self._wal is not None:
            self._wal.write(self._wal_record(key, ev))
            self._wal.flush()
            if self._fsync:
                os.fsync(self._wal.fileno())
            self._appends += 1
            if self._appends >= self._snapshot_every:
                self._snapshot_locked()
        super()._record(key, ev)

    def _record_batch(self, items) -> None:
        # one transaction, ONE WAL append: the whole burst's records go
        # to disk in a single write+flush (and at most one fsync) —
        # per-record flush churn was the durable store's slice of the
        # bulk-bind commit window. The record format is unchanged, so
        # recovery replays a batch exactly like sequential appends.
        if self._wal is not None and items:
            self._wal.write(
                b"".join(self._wal_record(k, ev) for k, ev in items)
            )
            self._wal.flush()
            if self._fsync:
                os.fsync(self._wal.fileno())
            self._appends += len(items)
            if self._appends >= self._snapshot_every:
                self._snapshot_locked()
        super()._record_batch(items)

    def snapshot_now(self) -> None:
        """Force a snapshot + WAL truncation (test hook / shutdown)."""
        with self._lock:
            if self._wal is not None:
                self._snapshot_locked()

    def close(self) -> None:
        with self._lock:
            if self._wal is not None:
                self._snapshot_locked()
                self._wal.close()
                self._wal = None

    # -- internals -----------------------------------------------------------

    def _open_wal(self) -> None:
        if not os.path.exists(self._wal_path) or self._wal_rewrite_header:
            # fresh log, or a torn creation whose magic never fully hit
            # disk: (re)write the header and fsync it so a crash right
            # after this point leaves a recoverable file
            self._wal = open(self._wal_path, "wb")
            self._wal.write(_WAL_MAGIC)
            self._wal.flush()
            os.fsync(self._wal.fileno())
            return
        # truncate any torn tail recovery discarded: appending committed
        # records BEHIND torn bytes would lose them on the next replay
        size = os.path.getsize(self._wal_path)
        if self._wal_valid_end < size:
            with open(self._wal_path, "r+b") as f:
                f.truncate(self._wal_valid_end)
                f.flush()
                os.fsync(f.fileno())
        self._wal = open(self._wal_path, "ab")

    def _snapshot_locked(self) -> None:
        tmp = self._snap_path + ".tmp"
        body = tlv.dumps(
            [self._rv, {k: [o, rv_] for k, (o, rv_) in self._data.items()}]
        )
        with open(tmp, "wb") as f:
            f.write(_SNAP_MAGIC)
            f.write(_LEN.pack(len(body)) + _CRC.pack(zlib.crc32(body)))
            f.write(body)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._snap_path)
        # the snapshot covers everything: truncate the log
        if self._wal is not None:
            self._wal.close()
        with open(self._wal_path, "wb") as f:
            f.write(_WAL_MAGIC)
            f.flush()
            os.fsync(f.fileno())
        self._wal = open(self._wal_path, "ab")
        self._appends = 0

    def _recover(self) -> None:
        data: dict = {}
        rv = 0
        self._wal_valid_end = 0
        self._wal_rewrite_header = False
        if os.path.exists(self._snap_path):
            with open(self._snap_path, "rb") as f:
                magic = f.read(len(_SNAP_MAGIC))
                header = f.read(_LEN.size + _CRC.size)
                body = f.read()
            if magic != _SNAP_MAGIC:
                raise CorruptStoreError(
                    f"{self._snap_path}: bad or unsupported snapshot "
                    f"magic {magic!r} (expected {_SNAP_MAGIC!r})"
                )
            if len(header) < _LEN.size + _CRC.size:
                raise CorruptStoreError(
                    f"{self._snap_path}: truncated snapshot header"
                )
            (n,) = _LEN.unpack_from(header, 0)
            (crc,) = _CRC.unpack_from(header, _LEN.size)
            if len(body) != n or zlib.crc32(body) != crc:
                raise CorruptStoreError(
                    f"{self._snap_path}: snapshot failed integrity check "
                    "(length or CRC mismatch)"
                )
            try:
                with tlv.allow_dynamic():
                    rv, raw_data = tlv.loads(body)
            except tlv.TLVError as e:
                raise CorruptStoreError(
                    f"{self._snap_path}: undecodable snapshot: {e}"
                ) from e
            data = {k: (o, orv) for k, (o, orv) in raw_data.items()}
        if os.path.exists(self._wal_path):
            with open(self._wal_path, "rb") as f:
                raw = f.read()
            if not raw:
                # crash between file creation and the magic hitting
                # disk: no record can exist; rewrite the header
                self._wal_rewrite_header = True
            if raw and not raw.startswith(_WAL_MAGIC):
                if _WAL_MAGIC.startswith(raw[: len(_WAL_MAGIC)]):
                    # torn creation: the crash hit between creating the
                    # file and its magic reaching disk — no record can
                    # exist yet; rewrite the header and carry on
                    raw = b""
                    self._wal_rewrite_header = True
                else:
                    raise CorruptStoreError(
                        f"{self._wal_path}: bad or unsupported WAL magic "
                        f"(expected {_WAL_MAGIC!r})"
                    )
            pos = len(_WAL_MAGIC) if raw.startswith(_WAL_MAGIC) else 0
            hdr = _LEN.size + _CRC.size
            while pos + hdr <= len(raw):
                (n,) = _LEN.unpack_from(raw, pos)
                (crc,) = _CRC.unpack_from(raw, pos + _LEN.size)
                if pos + hdr + n > len(raw):
                    break  # torn tail: crash mid-append; discard
                rec = raw[pos + hdr : pos + hdr + n]
                ok = zlib.crc32(rec) == crc
                decoded = None
                if ok:
                    try:
                        with tlv.allow_dynamic():
                            decoded = tlv.loads(rec)
                    except tlv.TLVError:
                        ok = False
                if not ok:
                    # A torn write can only be the FINAL append. If more
                    # bytes follow this record's claimed extent, this is
                    # mid-file corruption — refusing loudly beats
                    # silently truncating later committed records.
                    if pos + hdr + n < len(raw):
                        raise CorruptStoreError(
                            f"{self._wal_path}: record at byte {pos} "
                            "failed integrity check with committed "
                            "records after it (mid-file corruption)"
                        )
                    break  # torn/overwritten tail record: discard
                ev_type, key, ev_rv, obj = decoded
                if ev_type == "DELETED":
                    data.pop(key, None)
                else:
                    data[key] = (obj, ev_rv)
                rv = max(rv, ev_rv)
                pos += hdr + n
            self._wal_valid_end = pos
        self._data = data
        self._rv = rv
        # no persisted watch history: pre-crash watch windows are gone,
        # resuming watchers must relist (Compacted)
        self._compacted_rv = rv

    @staticmethod
    def wipe(data_dir: str) -> None:
        """Remove persisted state (test hook)."""
        for name in ("wal.log", "snapshot.db", "snapshot.db.tmp"):
            try:
                os.unlink(os.path.join(data_dir, name))
            except FileNotFoundError:
                pass
