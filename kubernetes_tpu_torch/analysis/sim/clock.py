"""Virtual time for the simulator.

One ``SimClock`` is shared by every node in a ``SimCluster`` — the
schedule, not the OS, decides when time passes. ``monotonic()``
returns the virtual now; ``sleep()`` is a no-op because nothing in
the sim ever blocks (the node's background threads are never started;
the harness drives the extracted step functions directly and any
residual ``sleep`` call must not stall the single-threaded run).

Copy of kubernetes_tpu/analysis/sim/clock.py: only the import package differs.
"""

from __future__ import annotations


class SimClock:
    """Schedule-controlled clock satisfying the ``io.Clock`` surface."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def monotonic(self) -> float:
        return self.now

    def sleep(self, seconds: float) -> None:
        # Nothing to wait FOR: sim code runs to completion between
        # events and only the schedule advances time.
        pass

    def advance(self, seconds: float) -> float:
        """Move virtual time forward (never backward)."""
        if seconds > 0:
            self.now += seconds
        return self.now

    def advance_to(self, t: float) -> float:
        if t > self.now:
            self.now = t
        return self.now
