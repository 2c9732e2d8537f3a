"""Rebuild sentinel: fail when a steady-state wave builds or loads a
kernel library.

The port's drivers buy their throughput by building each kernel library
once (nvcc for the CUDA kernels, cc for the host engine and the CPython
extensions) and loading it once; an edit that keys a build on a per-wave
value, or drops a library's cached handle, silently turns every wave
into a multi-second compile or a fresh dlopen. This sentinel counts the
events native/build.py reports through its one listener seam
(add_build_listener): every compiler run (build_cuda_file, ensure_replay,
ensure_kquantity, ensure_ktlv) and every load of a built library (the
kernel wrappers' load()/_lib() through load_library, and the CPython
extensions' first import), each named with the library's file and the
seconds it took.

    sentinel = CompileSentinel()          # installs the listener
    ... warm-up wave (builds and loads freely) ...
    with sentinel.expect_no_compiles("wave 2"):
        ... steady-state wave ...         # any build/load -> AssertionError

Deviation from kubernetes_tpu/analysis/compile_guard.py <module>: the
events are native/build.py's builds and library loads, not
jax.monitoring's XLA compile events; the API (install, compile_count,
expect_no_compiles(label), events as (event, seconds) pairs) is the
JAX package's, so harness code written against it runs unchanged.
"""

from __future__ import annotations

import threading
import weakref
from contextlib import contextmanager
from typing import List, Tuple

# native/build.py's listeners have no unregister, so exactly ONE
# module-level listener ever registers; it fans events out to the live
# sentinels (weakly held: a dropped sentinel stops receiving and can be
# collected instead of leaking an ever-growing events list per
# construction site)
_sentinels: "weakref.WeakSet[CompileSentinel]" = weakref.WeakSet()
_listener_lock = threading.Lock()
_listener_installed = False


def _on_event(kind: str, name: str, seconds: float) -> None:
    for s in list(_sentinels):
        s._note(f"{kind} {name}", seconds)


def _install_listener() -> None:
    global _listener_installed
    with _listener_lock:
        if _listener_installed:
            return
        _listener_installed = True
        from kubernetes_tpu_torch.native.build import add_build_listener

        add_build_listener(_on_event)


class CompileSentinel:
    """Counts kernel-library builds and loads; armable windows."""

    def __init__(self):
        self._mu = threading.Lock()
        self.events: List[Tuple[str, float]] = []
        self.install()

    def install(self) -> None:
        _install_listener()
        _sentinels.add(self)

    def _note(self, event: str, duration: float) -> None:
        with self._mu:
            self.events.append((event, duration))

    def compile_count(self) -> int:
        with self._mu:
            return len(self.events)

    @contextmanager
    def expect_no_compiles(self, label: str = ""):
        """Assert zero builds or library loads happen inside the block."""
        before = self.compile_count()
        yield self
        with self._mu:
            new = self.events[before:]
        if new:
            detail = ", ".join(
                f"{ev} ({dur:.3f}s)" for ev, dur in new[:5]
            )
            where = label or "guarded window"
            raise AssertionError(
                f"rebuild in steady state ({where}): "
                f"{len(new)} kernel build/load event(s): {detail}"
            )
