"""Per-phase wire-path profiling.

The port's counterpart of kubernetes_tpu/trace/profile.py. This module
owns the phase vocabulary and the timers the layers hang on their seams:

    encode    snapshot/batch encode (full or incremental wave view)
    probe     device predicate-probe dispatch (models/probe)
    score     the serial scan (models/batch)
    replay    host/device replay + carry-fold commits (models/replay,
              models/zreplay, the fold)
    transfer  host<->device shipping
    wire      TLV watch-frame decode + response decode in the client
    bind      the async bind commit (wave bulk bind included)

Timers observe into ``scheduler_wave_phase_seconds{phase=...}``; a
bench prints a per-rep breakdown by diffing ``phase_totals()`` around
the measurement window. Timers are gated on the trace switch
(KUBERNETES_TPU_TRACE): disabled, each is a no-op costing one global
read.

Everything but install_compile_listener is a verbatim copy of the JAX
module's (tests/test_torch_isolation.py FUNCTION_COPIES). That one is a
no-op here: see its docstring.
"""

from __future__ import annotations

import threading
import time
from typing import Dict

from kubernetes_tpu_torch.metrics import scheduler_wave_phase_seconds
from kubernetes_tpu_torch.trace import spans as _span

#: the closed phase vocabulary (the bench table iterates this order)
PHASES = ("encode", "probe", "score", "replay", "transfer", "wire", "bind")


class _ExclusiveAccountant:
    """Partition wall time across phases. Phase occurrences overlap
    freely across threads (16 bind-pool binds in flight while the next
    wave encodes while two watch readers decode), so summing
    per-occurrence wall overcounts wildly — the first bench table read
    344% of window wall. This accountant keeps ONE global timeline:
    every phase enter/exit advances it and attributes the elapsed slice
    to the highest-priority phase currently active (the PHASES order;
    bind last, so the wait-on-apiserver lane soaks up only what nothing
    else claims). Per-phase exclusive totals therefore sum to <= wall
    exactly, and the shortfall is genuine idle time."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rank = {p: i for i, p in enumerate(PHASES)}
        self._depth = [0] * len(PHASES)
        self._active = -1  # lowest active rank, -1 = idle
        self._last = time.perf_counter()
        self._totals = [0.0] * len(PHASES)

    def enter(self, phase: str) -> None:
        i = self._rank[phase]
        with self._lock:
            # the clock read MUST happen under the lock: a pre-lock
            # read raced against a contended writer produces a stale
            # timestamp, negative slices, and a _last that moves
            # backwards (double-attributing the same wall slice)
            now = time.perf_counter()
            if self._active >= 0:
                self._totals[self._active] += now - self._last
            self._last = now
            self._depth[i] += 1
            if self._active < 0 or i < self._active:
                self._active = i

    def exit(self, phase: str) -> None:
        i = self._rank[phase]
        with self._lock:
            now = time.perf_counter()
            if self._active >= 0:
                self._totals[self._active] += now - self._last
            self._last = now
            self._depth[i] -= 1
            if i == self._active:
                nxt = -1
                for j in range(i, len(self._depth)):
                    if self._depth[j]:
                        nxt = j
                        break
                self._active = nxt

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            now = time.perf_counter()
            if self._active >= 0:
                self._totals[self._active] += now - self._last
            self._last = now
            return dict(zip(PHASES, self._totals))


_ACCOUNTANT = _ExclusiveAccountant()


class _PhaseTimer:
    __slots__ = ("_hist", "_phase", "_t0")

    def __init__(self, hist, phase):
        self._hist = hist
        self._phase = phase

    def __enter__(self) -> "_PhaseTimer":
        _ACCOUNTANT.enter(self._phase)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self._hist.observe(time.perf_counter() - self._t0)
        _ACCOUNTANT.exit(self._phase)
        return False


class _NullTimer:
    __slots__ = ()

    def __enter__(self) -> "_NullTimer":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _NullTimer()

# child histograms resolved once (labels() takes a lock on first use)
_HIST = {p: scheduler_wave_phase_seconds.labels(p) for p in PHASES}


def phase_timer(phase: str):
    """``with phase_timer("probe"): ...`` — observes wall seconds into
    the phase histogram (per-occurrence work) and the exclusive
    timeline (wall partition); no-op while tracing is disabled."""
    if not _span._ENABLED:
        return _NULL
    return _PhaseTimer(_HIST[phase], phase)


def phase_totals() -> Dict[str, float]:
    """Cumulative per-occurrence seconds per phase since process start
    (histogram sums; zero-filled over the vocabulary so diffs are
    stable). Occurrences overlap across threads — for a partition of
    wall use exclusive_totals()."""
    sums = scheduler_wave_phase_seconds.sums()
    return {p: sums.get(p, 0.0) for p in PHASES}


def exclusive_totals() -> Dict[str, float]:
    """Cumulative EXCLUSIVE seconds per phase (the single-timeline
    partition): diffs over a window sum to <= the window's wall, so
    the bench breakdown reads as 'where the wall went'."""
    return _ACCOUNTANT.snapshot()


def overlap_totals() -> Dict[str, float]:
    """Cumulative OVERLAPPED seconds per phase: occurrence wall
    (phase_totals) minus the exclusive timeline's attribution — the
    time a phase spent running concurrently under a higher-priority
    phase. The double-buffered wave pipeline
    (KUBERNETES_TPU_PIPELINE) shows up here as encode/transfer
    seconds hidden under an in-flight probe window; a serial run
    reads ~0 everywhere. Diff over a bench window like the other
    totals."""
    pt = phase_totals()
    et = exclusive_totals()
    return {p: max(0.0, pt[p] - et[p]) for p in PHASES}


def install_compile_listener() -> None:
    """Does nothing: the port compiles no XLA programs.

    Deviation from kubernetes_tpu/trace/profile.py
    install_compile_listener, which subscribes to jax.monitoring's
    compile-duration events and observes them into
    scheduler_xla_compile_seconds. The port's only compiled code is its
    CUDA kernels, built by nvcc once per source at first use
    (native/build.py); chip_smoke.py times those builds on its `build`
    line. The metric stays registered (metrics/ is a copy) and reads 0."""
