"""In-memory filesystem with an explicit durability model.

Satisfies the ``io.Disk`` seam. Three layers per file:

  * **buffered** — bytes written to a handle but not yet flushed.
    Lost entirely at crash.
  * **flushed** — in the file's content (visible to readers) but not
    fsync'd. At crash the flushed-but-unsynced region is *torn*: a
    ``CRASH`` fault's magnitude ``f`` keeps the first
    ``int(unsynced_len * f)`` bytes of it, which can cut mid-record —
    exactly the torn tail ``log.RaftLog`` recovery must tolerate.
  * **synced** — covered by ``fsync`` (or written via the atomic
    ``replace``, which is modeled as durable). Survives any crash.

``crash(prefix, torn)`` applies the model to every file under a
node's data dir and invalidates its open handles, so a recovered node
re-opened over the same ``SimDisk`` sees exactly what a real process
would find on disk after ``kill -9`` mid-write.

Copy of kubernetes_tpu/analysis/sim/disk.py: only the import package differs.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


class SimIOError(OSError):
    """Raised when a crashed node's code touches its (revoked)
    handles — the sim equivalent of the process being gone."""


class _SimHandle:
    """File handle over SimDisk content. Supports the exact surface
    the quorum storage layer uses: write/flush/truncate/close and the
    context-manager protocol (plus read() for completeness)."""

    def __init__(self, disk: "SimDisk", path: str, mode: str):
        self.disk = disk
        self.path = path
        self.mode = mode
        self.closed = False
        self._buf = bytearray()  # written, not yet flushed
        if mode == "wb":
            disk._files[path] = bytearray()
            disk._synced[path] = 0
        elif mode in ("ab", "r+b", "rb"):
            if path not in disk._files:
                if mode == "ab":
                    disk._files[path] = bytearray()
                    disk._synced.setdefault(path, 0)
                else:
                    raise FileNotFoundError(path)
        else:
            raise ValueError(f"unsupported mode {mode!r}")
        disk._handles.append(self)

    def _check(self) -> None:
        if self.closed:
            raise SimIOError(f"I/O on closed/crashed handle {self.path}")

    def write(self, data: bytes) -> int:
        self._check()
        self._buf += data
        return len(data)

    def read(self) -> bytes:
        self._check()
        return bytes(self.disk._files[self.path])

    def flush(self) -> None:
        self._check()
        if self._buf:
            self.disk._files[self.path] += self._buf
            self._buf = bytearray()

    def truncate(self, n: int) -> None:
        self._check()
        f = self.disk._files[self.path]
        del f[n:]
        if self.disk._synced.get(self.path, 0) > n:
            self.disk._synced[self.path] = n

    def close(self) -> None:
        if not self.closed:
            # a close flushes buffered bytes (they reach the page
            # cache) but does NOT sync them
            self.flush()
            self.closed = True

    def __enter__(self) -> "_SimHandle":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class SimDisk:
    """One shared in-memory filesystem for a whole sim cluster; nodes
    are separated by data-dir prefix so crash faults can target one
    node's files."""

    def __init__(self):
        self._files: Dict[str, bytearray] = {}
        self._synced: Dict[str, int] = {}
        self._dirs: set = set()
        self._handles: List[_SimHandle] = []

    # -- io.Disk surface -----------------------------------------------------

    def makedirs(self, path: str) -> None:
        self._dirs.add(path)

    def exists(self, path: str) -> bool:
        return path in self._files

    def getsize(self, path: str) -> int:
        return len(self._files[path])

    def read_bytes(self, path: str) -> bytes:
        return bytes(self._files[path])

    def open(self, path: str, mode: str) -> _SimHandle:
        return _SimHandle(self, path, mode)

    def fsync(self, handle: _SimHandle) -> None:
        handle._check()
        handle.flush()
        self._synced[handle.path] = len(self._files[handle.path])

    def replace(self, src: str, dst: str) -> None:
        # atomic rename after the temp file was fsync'd: durable
        self._files[dst] = self._files.pop(src)
        self._synced.pop(src, None)
        self._synced[dst] = len(self._files[dst])

    def unlink(self, path: str) -> None:
        self._files.pop(path, None)
        self._synced.pop(path, None)

    # -- crash model ---------------------------------------------------------

    def crash(self, prefix: str, torn: float = 0.0) -> None:
        """Power-cut every file under ``prefix``: buffered bytes
        vanish, the flushed-but-unsynced region is torn at fractional
        offset ``torn``, synced bytes survive. Open handles under the
        prefix are revoked."""
        for h in self._handles:
            if h.path.startswith(prefix) and not h.closed:
                h._buf = bytearray()  # buffered writes never landed
                h.closed = True
        for path, content in self._files.items():
            if not path.startswith(prefix):
                continue
            synced = self._synced.get(path, 0)
            if len(content) > synced:
                keep = synced + int((len(content) - synced) * torn)
                del content[keep:]
                self._synced[path] = min(synced, keep)

    def fingerprint(self, prefix: str = "") -> Tuple:
        """Hashable durable-state summary (for explorer pruning)."""
        return tuple(sorted(
            (p, bytes(c), self._synced.get(p, 0))
            for p, c in self._files.items() if p.startswith(prefix)))
