"""Lock-order sanitizer: acquisition-order graph + cycle detection.

The replicated-store ack races of PR 1 (and the lock/ack interplay an
external review caught in storage/replicated.py) were ordering bugs no
unit test provoked deterministically. This pass makes ordering a
checkable artifact: while instrumented, every ``threading.Lock()`` /
``threading.RLock()`` **created from kubernetes_tpu code** is wrapped in
a ``TrackedLock`` keyed by its creation site (module:line). Each
acquisition records edges ``held-site -> acquired-site`` into a global
graph; a cycle in that graph is a lock-order inversion — two threads
can interleave into deadlock even if this run didn't.

Armed under the chaos suite (tests/test_chaos.py instruments the module
and asserts ``assert_no_cycles`` after every test), so the kill/restart
scenarios double as lock-order witnesses. Also usable standalone:

    with locks.instrumented():
        ... drive components ...
    locks.assert_no_cycles()

Notes on fidelity:
  * Re-entrant acquisition of the SAME lock instance records nothing
    (RLock semantics). Two DIFFERENT instances from the same creation
    site nesting under each other yields a self-edge — a real hazard
    (same-class instance nesting deadlocks unless globally ordered),
    reported as a cycle of length 1.
  * Locks created before instrumentation stay raw and invisible; the
    chaos tests build their components inside the instrumented window.
  * ``threading.Condition`` over a tracked lock routes acquire/release
    through the wrapper, so condition waits keep the held-set honest.

Copy of kubernetes_tpu/analysis/locks.py: only the import package differs.
"""

from __future__ import annotations

import sys
import threading
import traceback
from contextlib import contextmanager
from typing import Dict, List, Optional, Set, Tuple

from kubernetes_tpu_torch.analysis import Finding

_real_lock = threading.Lock
_real_rlock = threading.RLock

# race-detector happens-before hooks (analysis/races installs them
# while armed): release publishes the releasing thread's vector clock
# on the lock, acquire adopts it — the release→acquire edge. None =
# detector disarmed, zero overhead beyond one global read.
race_acquire_hook = None
race_release_hook = None


class _TLS(threading.local):
    def __init__(self):
        self.held: List["TrackedLock"] = []


_tls = _TLS()


class LockGraph:
    """site -> site acquisition edges with one sample stack each."""

    def __init__(self):
        self._mu = _real_lock()
        self.edges: Dict[Tuple[str, str], str] = {}

    def record(self, held: "TrackedLock", acquiring: "TrackedLock") -> None:
        key = (held.site, acquiring.site)
        if key in self.edges:
            return
        stack = "".join(traceback.format_stack(limit=8)[:-2])
        with self._mu:
            self.edges.setdefault(key, stack)

    def reset(self) -> None:
        with self._mu:
            self.edges.clear()

    def cycles(self) -> List[List[str]]:
        """Every elementary ordering cycle reachable in the site graph
        (DFS; one representative per cycle set)."""
        with self._mu:
            adj: Dict[str, Set[str]] = {}
            for a, b in self.edges:
                adj.setdefault(a, set()).add(b)
        out: List[List[str]] = []
        seen_cycles: Set[frozenset] = set()

        def dfs(start: str, node: str, path: List[str],
                on_path: Set[str]) -> None:
            for nxt in adj.get(node, ()):
                if nxt == start:
                    key = frozenset(path)
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        out.append(path + [start])
                elif nxt not in on_path and nxt > start:
                    # only expand nodes ordered after start: each cycle
                    # is found exactly once, from its smallest node
                    dfs(start, nxt, path + [nxt], on_path | {nxt})

        for a, b in list(adj.items()):
            if a in b:  # self-edge: same-site instance nesting
                key = frozenset((a,))
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    out.append([a, a])
        for start in sorted(adj):
            dfs(start, start, [start], {start})
        return out

    def findings(self) -> List[Finding]:
        res = []
        for cyc in self.cycles():
            chain = " -> ".join(cyc)
            first_edge = (cyc[0], cyc[1])
            sample = self.edges.get(first_edge, "")
            res.append(Finding(
                "locks", "lock-order-cycle", cyc[0],
                f"acquisition-order cycle {chain} — threads taking "
                "these locks in the observed orders can deadlock. "
                f"Sample acquisition stack for {first_edge}:\n{sample}",
            ))
        return res


GRAPH = LockGraph()


class TrackedLock:
    """A Lock/RLock wrapper recording acquisition-order edges."""

    # __weakref__ so the race detector's per-lock clock registry can
    # finalize-clean without ever pinning a lock alive
    __slots__ = ("_lock", "site", "_reentrant", "__weakref__")

    def __init__(self, real, site: str, reentrant: bool):
        self._lock = real
        self.site = site
        self._reentrant = reentrant

    # -- tracking core -------------------------------------------------------

    def _note_acquired(self) -> None:
        hook = race_acquire_hook
        if hook is not None:
            hook(self)
        held = _tls.held
        if any(h is self for h in held):
            held.append(self)  # re-entrant: no new ordering info
            return
        for h in held:
            GRAPH.record(h, self)
        held.append(self)

    def _note_released(self) -> None:
        hook = race_release_hook
        if hook is not None:
            hook(self)
        held = _tls.held
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                return

    # -- lock surface --------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._note_acquired()
        return ok

    def release(self) -> None:
        self._note_released()
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def locked(self) -> bool:
        return self._lock.locked()

    def __getattr__(self, name):
        # RLock's _is_owned/_release_save/_acquire_restore for Condition
        return getattr(self._lock, name)


_installed = 0
_install_mu = _real_lock()


def _should_track(frame) -> bool:
    mod = frame.f_globals.get("__name__", "")
    return mod.startswith("kubernetes_tpu_torch.") and \
        not mod.startswith("kubernetes_tpu_torch.analysis")


def _make_factory(real_factory, reentrant: bool):
    def factory(*args, **kwargs):
        real = real_factory(*args, **kwargs)
        frame = sys._getframe(1)
        if _should_track(frame):
            site = (f"{frame.f_globals.get('__name__', '?')}:"
                    f"{frame.f_lineno}")
            return TrackedLock(real, site, reentrant)
        return real

    return factory


def install() -> None:
    """Start wrapping lock creation from kubernetes_tpu modules."""
    global _installed
    with _install_mu:
        _installed += 1
        if _installed == 1:
            threading.Lock = _make_factory(_real_lock, False)
            threading.RLock = _make_factory(_real_rlock, True)


def uninstall() -> None:
    global _installed
    with _install_mu:
        _installed = max(0, _installed - 1)
        if _installed == 0:
            threading.Lock = _real_lock
            threading.RLock = _real_rlock


@contextmanager
def instrumented(reset: bool = False):
    """Instrument lock creation for the duration of the block. The edge
    graph persists across blocks (orders are global facts) unless
    ``reset`` asks for a clean slate."""
    if reset:
        GRAPH.reset()
    install()
    try:
        yield GRAPH
    finally:
        uninstall()


def assert_no_cycles(context: str = "") -> None:
    """Raise AssertionError listing every ordering cycle observed."""
    found = GRAPH.findings()
    if found:
        from kubernetes_tpu_torch.analysis import render_report

        raise AssertionError(
            render_report(found, f"lock-order cycles {context}:")
        )
