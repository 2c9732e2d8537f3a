"""Schedules: the serialized, replayable unit of simulation.

A schedule is JSON — the cluster construction parameters plus the
exact event list — so a violation the explorer finds is a *file*: it
can be attached to a bug report, replayed under a debugger, and
re-checked in CI. Replay is bit-deterministic because every source of
nondeterminism (time, delivery, rng seeds) is either in the file or
derived from it.

Copy of kubernetes_tpu/analysis/sim/schedule.py: only the import package differs.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from kubernetes_tpu_torch.analysis.sim.harness import SimCluster
from kubernetes_tpu_torch.analysis.sim.invariants import (check_final,
                                                    check_step)

VERSION = 1


@dataclass
class Schedule:
    """Construction parameters + event list (+ the violation it
    reproduces, when the explorer emitted it)."""

    events: List[List[Any]] = field(default_factory=list)
    n: int = 3
    seed: int = 0
    fsync: bool = True
    replication_batch: int = 2
    lease_factor: float = 0.75
    violation: Optional[List[str]] = None

    def build_cluster(self) -> SimCluster:
        return SimCluster(n=self.n, seed=self.seed, fsync=self.fsync,
                          replication_batch=self.replication_batch,
                          lease_factor=self.lease_factor)

    # -- serialization -------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps({
            "version": VERSION,
            "config": {
                "n": self.n,
                "seed": self.seed,
                "fsync": self.fsync,
                "replication_batch": self.replication_batch,
                "lease_factor": self.lease_factor,
            },
            "events": self.events,
            "violation": self.violation,
        }, indent=2)

    @staticmethod
    def from_json(text: str) -> "Schedule":
        doc = json.loads(text)
        if doc.get("version") != VERSION:
            raise ValueError(
                f"unsupported schedule version {doc.get('version')!r}")
        cfg: Dict[str, Any] = doc.get("config", {})
        return Schedule(
            events=[list(e) for e in doc["events"]],
            n=int(cfg.get("n", 3)),
            seed=int(cfg.get("seed", 0)),
            fsync=bool(cfg.get("fsync", True)),
            replication_batch=int(cfg.get("replication_batch", 2)),
            lease_factor=float(cfg.get("lease_factor", 0.75)),
            violation=doc.get("violation"),
        )

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")
        return path

    @staticmethod
    def load(path: str) -> "Schedule":
        with open(path) as f:
            return Schedule.from_json(f.read())


def run(schedule: Schedule,
        check_every_step: bool = True) -> List[str]:
    """Execute a schedule from a fresh cluster; return every invariant
    violation observed (per-step structural checks + the final
    linearizability verdict). Deterministic: two runs of the same
    schedule return identical lists."""
    cluster = schedule.build_cluster()
    try:
        violations: List[str] = []
        for ev in schedule.events:
            cluster.step(ev)
            if check_every_step:
                violations.extend(check_step(cluster))
        if not check_every_step:
            violations.extend(check_step(cluster))
        violations.extend(check_final(cluster))
        return violations
    finally:
        cluster.close()


def replay(schedule: Schedule) -> List[str]:
    """Re-run an emitted counterexample. Returns the violations found
    (callers assert they match ``schedule.violation``)."""
    return run(schedule)
