"""Deterministic-simulation model checker for ``storage/quorum``.

FoundationDB-style: the SAME state-transition code the threaded
production node runs is driven single-threaded under a virtual clock
(``SimClock``), an in-memory network with per-edge queues
(``SimNet``), and an in-memory filesystem that models crash points
and torn tails (``SimDisk``). A *schedule* — a serialized list of
events (deliver this message, tick that node's election timer, crash
node b with a 40% torn final write…) — fully determines the
execution, so any interleaving the checker finds is a file a human
can replay under a debugger.

Layout:

  * ``clock`` / ``disk`` / ``net`` — the three simulated environments
    behind the seams ``NodeConfig`` exposes.
  * ``harness`` — ``SimCluster``: builds an N-node cluster over those
    environments, executes schedule events, enumerates which events
    are enabled, records a linearizability history.
  * ``invariants`` — the per-step safety checks (election safety, log
    matching, leader completeness, …) and the end-of-schedule
    linearizability check.
  * ``schedule`` — JSON (de)serialization and deterministic replay of
    schedules and violations.
  * ``explore`` — bounded exhaustive BFS with fingerprint pruning,
    plus seeded random schedule sampling with faults.
  * ``corpus`` — the seeded historical-bug mutations and the gate
    that the checker re-finds each within the quick budget.

Copy of kubernetes_tpu/analysis/sim/__init__.py: only the import package differs.
"""

from kubernetes_tpu_torch.analysis.sim.clock import SimClock
from kubernetes_tpu_torch.analysis.sim.disk import SimDisk
from kubernetes_tpu_torch.analysis.sim.net import SimNet, SimTransport
from kubernetes_tpu_torch.analysis.sim.harness import SimCluster
from kubernetes_tpu_torch.analysis.sim.invariants import (InvariantViolation,
                                                    check_step)
from kubernetes_tpu_torch.analysis.sim.schedule import Schedule, replay
from kubernetes_tpu_torch.analysis.sim.explore import (explore_bfs,
                                                 explore_random)

__all__ = [
    "SimClock", "SimDisk", "SimNet", "SimTransport", "SimCluster",
    "InvariantViolation", "check_step", "Schedule", "replay",
    "explore_bfs", "explore_random",
]
