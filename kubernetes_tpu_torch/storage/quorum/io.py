"""Injectable environment seams for the quorum layer.

The consensus code never touches the wall clock, the filesystem, or
the network directly — it goes through three tiny interfaces so the
deterministic-simulation checker (``analysis/sim``) can substitute
virtual time, an in-memory disk with crash-point truncation, and a
schedule-controlled network while production runs the real thing on
a bit-identical code path:

  * ``Clock``   — ``monotonic()`` + ``sleep()``; production is the
    process clock, the sim advances virtual time under schedule
    control so election timers and lease expiry fire exactly when
    the explorer says so.
  * ``Disk``    — the handful of file operations ``RaftLog`` needs;
    production is the OS, the sim models flushed-vs-fsynced bytes so
    a crash event can tear the unsynced tail at any byte.
  * ``Transport`` (in ``rpc.py``) — listener + per-peer client
    factory; production is framed TCP, the sim is per-edge message
    queues with delivery, drop, duplication, reorder, and partition.

Default instances are module singletons: constructing a node without
explicit seams costs nothing beyond an attribute load.

Copy of kubernetes_tpu/storage/quorum/io.py: only the import package differs.
"""

from __future__ import annotations

import os
import time
from typing import Optional


class Clock:
    """Time source interface. ``monotonic`` must never go backwards;
    ``sleep`` blocks the calling thread (production) or is a no-op
    under simulation (sim code never calls blocking paths)."""

    def monotonic(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError


class WallClock(Clock):
    """Production clock: the process-wide monotonic clock."""

    def monotonic(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


WALL_CLOCK = WallClock()


class Disk:
    """Filesystem interface for RaftLog: exactly the operations the
    durable raft state needs, nothing more. ``fsync`` takes the open
    handle (not a descriptor) so an in-memory disk can mark its own
    buffers durable."""

    def makedirs(self, path: str) -> None:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def getsize(self, path: str) -> int:
        raise NotImplementedError

    def read_bytes(self, path: str) -> bytes:
        raise NotImplementedError

    def open(self, path: str, mode: str):
        raise NotImplementedError

    def fsync(self, handle) -> None:
        raise NotImplementedError

    def replace(self, src: str, dst: str) -> None:
        raise NotImplementedError

    def unlink(self, path: str) -> None:
        raise NotImplementedError


class OsDisk(Disk):
    """Production disk: thin passthrough to the OS."""

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def getsize(self, path: str) -> int:
        return os.path.getsize(path)

    def read_bytes(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def open(self, path: str, mode: str):
        return open(path, mode)

    def fsync(self, handle) -> None:
        os.fsync(handle.fileno())

    def replace(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def unlink(self, path: str) -> None:
        os.unlink(path)


OS_DISK = OsDisk()
