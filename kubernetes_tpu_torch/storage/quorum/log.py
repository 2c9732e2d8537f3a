"""Durable raft state: hard state (term/vote), entry log, snapshot.

Raft's safety argument leans on three things surviving kill -9: the
current term, the vote cast in it, and every appended log entry. This
module persists all three with the durable store's own on-disk
mechanics (storage/durable.py): length+CRC+TLV records with a
tolerated torn tail on the log, and temp-file + fsync + atomic-rename
snapshots — so a record that was mid-write when the process died is
discarded, and anything before it replays bit-identically.

Files under ``data_dir``:

  * ``hardstate``  — one TLV record [term, voted_for], rewritten
    atomically on every term/vote change (fsync'd BEFORE the vote or
    ballot leaves the node — a re-vote after restart would elect two
    leaders in one term).
  * ``raft.log``   — magic + framed [term, index, payload] records.
  * ``raft.snap``  — magic + one framed [last_index, last_term,
    state_blob] record; covers every entry <= last_index, after which
    the log is truncated (the FileStore snapshot+WAL compaction
    contract, applied to a consensus log).

Copy of kubernetes_tpu/storage/quorum/log.py: only the import package differs.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import List, Optional, Tuple

from kubernetes_tpu_torch.runtime import tlv
from kubernetes_tpu_torch.storage.durable import _CRC, _LEN, CorruptStoreError
from kubernetes_tpu_torch.storage.quorum.io import OS_DISK, Disk

_HS_MAGIC = b"KTQHS001"
_LOG_MAGIC = b"KTQLOG01"
_SNAP_MAGIC = b"KTQSNP01"


def frame(payload: bytes) -> bytes:
    """length + CRC32 + payload — the one framing every quorum byte
    (WAL record, snapshot body, peer RPC message) travels in."""
    return _LEN.pack(len(payload)) + _CRC.pack(zlib.crc32(payload)) + payload


_HDR = _LEN.size + _CRC.size


def read_framed(raw: bytes, pos: int) -> Tuple[Optional[bytes], int]:
    """Decode one frame at `pos`; -> (payload | None, next_pos).
    None means a torn/corrupt record starting at pos (caller decides
    whether that is an expected tail or mid-file corruption)."""
    if pos + _HDR > len(raw):
        return None, pos
    (n,) = _LEN.unpack_from(raw, pos)
    (crc,) = _CRC.unpack_from(raw, pos + _LEN.size)
    if pos + _HDR + n > len(raw):
        return None, pos
    body = raw[pos + _HDR : pos + _HDR + n]
    if zlib.crc32(body) != crc:
        return None, pos
    return body, pos + _HDR + n


#: Entry kinds: DATA payloads go to the state machine's apply_fn;
#: CONFIG payloads are membership changes the NODE applies itself
#: (add/remove a quorum member through the replicated log — the
#: single-server membership-change form, applied at commit).
KIND_DATA = 0
KIND_CONFIG = 1


class Entry:
    """One log slot: (term, index, payload bytes, kind). The payload is
    opaque to the log — the node stores TLV-encoded record batches
    (KIND_DATA) or membership changes (KIND_CONFIG)."""

    __slots__ = ("term", "index", "payload", "kind")

    def __init__(self, term: int, index: int, payload: bytes,
                 kind: int = KIND_DATA):
        self.term = term
        self.index = index
        self.payload = payload
        self.kind = kind

    def __repr__(self):  # debugging / assertion messages
        return (f"Entry(t={self.term}, i={self.index}, "
                f"{len(self.payload)}B"
                + (", cfg)" if self.kind == KIND_CONFIG else ")"))


class RaftLog:
    """The persistent half of a quorum member. All mutators are called
    under the owning node's state lock; the log keeps its own small
    lock only so read-side helpers (replicator threads slicing entries)
    are safe against concurrent appends."""

    def __init__(self, data_dir: str, fsync: bool = False,
                 disk: Optional[Disk] = None):
        self._dir = data_dir
        self._disk = disk if disk is not None else OS_DISK
        self._disk.makedirs(data_dir)
        self._hs_path = os.path.join(data_dir, "hardstate")
        self._log_path = os.path.join(data_dir, "raft.log")
        self._snap_path = os.path.join(data_dir, "raft.snap")
        self._fsync = fsync
        self._lock = threading.Lock()
        # snapshot point: every entry <= snap_index lives only in the
        # snapshot; the in-memory list holds entries snap_index+1..last
        self.snap_index = 0  # guarded-by: self._lock
        self.snap_term = 0  # guarded-by: self._lock
        self._snap_blob: Optional[bytes] = None  # guarded-by: self._lock
        self._entries: List[Entry] = []  # guarded-by: self._lock
        self.term = 0  # guarded-by: self._lock
        self.voted_for: str = ""  # guarded-by: self._lock
        self._wal = None  # guarded-by: self._lock
        with self._lock:
            self._recover_locked()
            self._open_wal_locked()

    # -- hard state ----------------------------------------------------------

    def save_hardstate(self, term: int, voted_for: str) -> None:
        """Persist term + vote BEFORE acting on either (fsync'd: a
        granted vote that does not survive kill -9 lets the restarted
        node vote twice in one term — two leaders)."""
        with self._lock:
            self.term = term
            self.voted_for = voted_for
            body = tlv.dumps([term, voted_for])
            tmp = self._hs_path + ".tmp"
            with self._disk.open(tmp, "wb") as f:
                f.write(_HS_MAGIC)
                f.write(frame(body))
                f.flush()
                self._disk.fsync(f)
            self._disk.replace(tmp, self._hs_path)

    # -- entries -------------------------------------------------------------

    @property
    def last_index(self) -> int:
        with self._lock:
            return self._entries[-1].index if self._entries \
                else self.snap_index

    @property
    def last_term(self) -> int:
        with self._lock:
            return self._entries[-1].term if self._entries \
                else self.snap_term

    def term_at(self, index: int) -> Optional[int]:
        """Term of the entry at `index`; snapshot point included. None
        when the index is out of the retained window."""
        with self._lock:
            if index == self.snap_index:
                return self.snap_term
            if index == 0:
                return 0
            i = index - self.snap_index - 1
            if 0 <= i < len(self._entries):
                return self._entries[i].term
            return None

    def entry(self, index: int) -> Optional[Entry]:
        with self._lock:
            i = index - self.snap_index - 1
            if 0 <= i < len(self._entries):
                return self._entries[i]
            return None

    def entries_from(self, index: int, max_n: int = 64) -> List[Entry]:
        """Entries [index, index+max_n) still in the log window —
        empty when `index` has been compacted into the snapshot (the
        replicator then falls back to a snapshot install)."""
        with self._lock:
            i = index - self.snap_index - 1
            if i < 0 or i >= len(self._entries):
                return []
            return self._entries[i : i + max_n]

    def append(self, entries: List[Entry]) -> None:
        """Append pre-indexed entries (contiguous with last_index) and
        make them durable in one write+flush."""
        if not entries:
            return
        with self._lock:
            expect = (self._entries[-1].index if self._entries
                      else self.snap_index) + 1
            if entries[0].index != expect:
                raise CorruptStoreError(
                    f"non-contiguous raft append: {entries[0].index} "
                    f"after {expect - 1}"
                )
            self._entries.extend(entries)
            if self._wal is not None:
                self._wal.write(b"".join(
                    frame(tlv.dumps([e.term, e.index, e.payload, e.kind]))
                    for e in entries
                ))
                self._wal.flush()
                if self._fsync:
                    self._disk.fsync(self._wal)

    def truncate_from(self, index: int) -> None:
        """Drop every entry >= index (a follower discarding a suffix
        that conflicts with the leader's log). Rewrites the on-disk log
        — conflict truncation is rare (leader changes only), so the
        full rewrite stays off every hot path."""
        with self._lock:
            i = index - self.snap_index - 1
            if i < 0:
                self._entries = []
            elif i < len(self._entries):
                del self._entries[i:]
            else:
                return
            self._rewrite_log_locked()

    def compact(self, last_index: int, last_term: int,
                state_blob: bytes) -> None:
        """Fold everything <= last_index into a snapshot and truncate
        the log prefix (FileStore._snapshot_locked's contract for a
        consensus log)."""
        with self._lock:
            if last_index <= self.snap_index:
                return
            keep = [e for e in self._entries if e.index > last_index]
            self._write_snap_locked(last_index, last_term, state_blob)
            self.snap_index = last_index
            self.snap_term = last_term
            self._snap_blob = state_blob
            self._entries = keep
            self._rewrite_log_locked()

    def install_snapshot(self, last_index: int, last_term: int,
                         state_blob: bytes) -> None:
        """Replace the ENTIRE log with a leader-sent snapshot (the
        lagging/fresh-follower catch-up path): every local entry is
        superseded."""
        with self._lock:
            self._write_snap_locked(last_index, last_term, state_blob)
            self.snap_index = last_index
            self.snap_term = last_term
            self._snap_blob = state_blob
            self._entries = []
            self._rewrite_log_locked()

    def snapshot(self) -> Tuple[int, int, Optional[bytes]]:
        with self._lock:
            return self.snap_index, self.snap_term, self._snap_blob

    def close(self) -> None:
        with self._lock:
            if self._wal is not None:
                self._wal.close()
                self._wal = None

    # -- internals -----------------------------------------------------------

    def _write_snap_locked(self, last_index: int, last_term: int,
                           state_blob: bytes) -> None:
        tmp = self._snap_path + ".tmp"
        body = tlv.dumps([last_index, last_term, state_blob])
        with self._disk.open(tmp, "wb") as f:
            f.write(_SNAP_MAGIC)
            f.write(frame(body))
            f.flush()
            self._disk.fsync(f)
        self._disk.replace(tmp, self._snap_path)

    def _rewrite_log_locked(self) -> None:
        if self._wal is not None:
            self._wal.close()
        tmp = self._log_path + ".tmp"
        with self._disk.open(tmp, "wb") as f:
            f.write(_LOG_MAGIC)
            f.write(b"".join(
                frame(tlv.dumps([e.term, e.index, e.payload, e.kind]))
                for e in self._entries
            ))
            f.flush()
            self._disk.fsync(f)
        self._disk.replace(tmp, self._log_path)
        self._wal = self._disk.open(self._log_path, "ab")

    def _open_wal_locked(self) -> None:
        if not self._disk.exists(self._log_path) or self._rewrite_header:
            self._wal = self._disk.open(self._log_path, "wb")
            self._wal.write(_LOG_MAGIC)
            self._wal.flush()
            self._disk.fsync(self._wal)
            return
        size = self._disk.getsize(self._log_path)
        if self._valid_end < size:
            # truncate the torn tail recovery discarded: appending
            # behind torn bytes would lose the new records on replay
            with self._disk.open(self._log_path, "r+b") as f:
                f.truncate(self._valid_end)
                f.flush()
                self._disk.fsync(f)
        self._wal = self._disk.open(self._log_path, "ab")

    def _recover_locked(self) -> None:
        self._valid_end = 0
        self._rewrite_header = False
        if self._disk.exists(self._hs_path):
            raw = self._disk.read_bytes(self._hs_path)
            if not raw.startswith(_HS_MAGIC):
                raise CorruptStoreError(
                    f"{self._hs_path}: bad hardstate magic")
            body, _ = read_framed(raw, len(_HS_MAGIC))
            if body is None:
                raise CorruptStoreError(
                    f"{self._hs_path}: hardstate failed integrity check")
            with tlv.allow_dynamic():
                self.term, self.voted_for = tlv.loads(body)
        if self._disk.exists(self._snap_path):
            raw = self._disk.read_bytes(self._snap_path)
            if not raw.startswith(_SNAP_MAGIC):
                raise CorruptStoreError(
                    f"{self._snap_path}: bad snapshot magic")
            body, _ = read_framed(raw, len(_SNAP_MAGIC))
            if body is None:
                raise CorruptStoreError(
                    f"{self._snap_path}: snapshot failed integrity check")
            with tlv.allow_dynamic():
                self.snap_index, self.snap_term, self._snap_blob = \
                    tlv.loads(body)
        if self._disk.exists(self._log_path):
            raw = self._disk.read_bytes(self._log_path)
            if raw and not raw.startswith(_LOG_MAGIC):
                if _LOG_MAGIC.startswith(raw[: len(_LOG_MAGIC)]):
                    raw = b""  # torn creation: magic never fully landed
                else:
                    raise CorruptStoreError(
                        f"{self._log_path}: bad raft log magic")
            if not raw:
                self._rewrite_header = True
            pos = len(_LOG_MAGIC) if raw else 0
            while True:
                body, nxt = read_framed(raw, pos)
                if body is None:
                    # a torn record can only be the final append; bytes
                    # beyond its claimed extent mean mid-file corruption
                    if pos + _HDR <= len(raw):
                        (n,) = _LEN.unpack_from(raw, pos)
                        if pos + _HDR + n < len(raw):
                            raise CorruptStoreError(
                                f"{self._log_path}: record at byte "
                                f"{pos} failed integrity check with "
                                "committed records after it")
                    break
                try:
                    with tlv.allow_dynamic():
                        row = tlv.loads(body)
                    # pre-membership logs framed [term, index, payload];
                    # absent kind decodes as DATA
                    term, index, payload = row[0], row[1], row[2]
                    kind = row[3] if len(row) > 3 else KIND_DATA
                except (tlv.TLVError, IndexError, ValueError):
                    break  # torn/overwritten tail record
                if index > self.snap_index:
                    # drop any stale prefix the snapshot superseded;
                    # tolerate a replayed overlap after compaction
                    if self._entries and \
                            index <= self._entries[-1].index:
                        del self._entries[index - self.snap_index - 1:]
                    self._entries.append(Entry(term, index, payload, kind))
                pos = nxt
            self._valid_end = pos

    @staticmethod
    def wipe(data_dir: str) -> None:
        """Remove persisted raft state (test hook)."""
        for name in ("hardstate", "raft.log", "raft.snap",
                     "hardstate.tmp", "raft.log.tmp", "raft.snap.tmp"):
            try:
                os.unlink(os.path.join(data_dir, name))
            except FileNotFoundError:
                pass
