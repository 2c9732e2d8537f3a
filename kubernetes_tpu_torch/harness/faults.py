"""One fault vocabulary for chaos AND model checking.

``harness/nemesis.py`` (socket-level chaos on real clusters) and
``analysis/sim`` (the deterministic-simulation model checker) inject
the same conceptual faults; this module is the shared spec so a
scenario expressed for one can be read by the other. A ``FaultSpec``
is pure data — (kind, subjects, magnitude) — and each backend owns
its interpretation:

  * the nemesis applies it to live TCP edges (``Nemesis.apply``),
  * the simulator applies it to the virtual cluster (SimNet queues,
    SimDisk crash points) as schedule events.

Kinds the nemesis cannot express (a byte-level torn-write crash) and
kinds the sim interprets more sharply (DROP/DUPLICATE act on one
in-flight protocol message, not a byte stream) are documented per
member; the enum is the superset both sides draw from.

Copy of kubernetes_tpu/harness/faults.py: only the import package differs.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


class FaultKind(enum.Enum):
    #: symmetric blackhole between two node sets (nemesis: pump
    #: stall; sim: edges deliver nothing until HEAL)
    PARTITION = "partition"
    #: cut one node off from everyone, both directions
    ISOLATE = "isolate"
    #: asymmetric latency on one (src, dst) edge
    ONE_WAY_DELAY = "one_way_delay"
    #: randomized holdback on one edge — reorders protocol messages
    #: (the sim gets reorder for free: any in-flight message may be
    #: delivered next)
    JITTER = "jitter"
    #: lose one in-flight message (sim-only as a discrete event; the
    #: nemesis approximates it with partition-during-flight)
    DROP = "drop"
    #: deliver one in-flight message twice (sim-only as a discrete
    #: event; the nemesis approximates it via rpc-timeout retries)
    DUPLICATE = "duplicate"
    #: kill -9 a node; with `magnitude` in [0, 1) the sim tears the
    #: node's last unsynced disk write at that fractional byte offset
    CRASH = "crash"
    #: restart a crashed node from its durable state
    RECOVER = "recover"
    #: lift every standing fault
    HEAL = "heal"


@dataclass(frozen=True)
class FaultSpec:
    """(kind, who, how much). `a_side`/`b_side` name node sets for
    PARTITION; single-subject kinds use `a_side[0]` (and `b_side[0]`
    for the dst of an edge fault). `magnitude` is seconds for
    delay/jitter and the torn-write fraction for CRASH."""

    kind: FaultKind
    a_side: Tuple[str, ...] = ()
    b_side: Tuple[str, ...] = ()
    magnitude: float = 0.0

    @staticmethod
    def partition(a_side: List[str], b_side: List[str]) -> "FaultSpec":
        return FaultSpec(FaultKind.PARTITION, tuple(a_side),
                         tuple(b_side))

    @staticmethod
    def isolate(node: str) -> "FaultSpec":
        return FaultSpec(FaultKind.ISOLATE, (node,))

    @staticmethod
    def one_way_delay(src: str, dst: str,
                      seconds: float) -> "FaultSpec":
        return FaultSpec(FaultKind.ONE_WAY_DELAY, (src,), (dst,),
                         seconds)

    @staticmethod
    def jitter(src: str, dst: str, seconds: float) -> "FaultSpec":
        return FaultSpec(FaultKind.JITTER, (src,), (dst,), seconds)

    @staticmethod
    def crash(node: str, torn: float = 0.0) -> "FaultSpec":
        return FaultSpec(FaultKind.CRASH, (node,), magnitude=torn)

    @staticmethod
    def recover(node: str) -> "FaultSpec":
        return FaultSpec(FaultKind.RECOVER, (node,))

    @staticmethod
    def heal() -> "FaultSpec":
        return FaultSpec(FaultKind.HEAL)
