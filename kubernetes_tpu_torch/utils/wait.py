"""Periodic and conditional wait loops (pkg/util/wait).

`until` is the reference's wait.Until (scheduler.go:89 runs scheduleOne
under it); `poll_until` is wait.Poll. Loops stop via a threading.Event
rather than a Go stop-channel.

Copy of kubernetes_tpu/utils/wait.py: only the import package differs.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from kubernetes_tpu_torch.utils.clock import Clock, DEFAULT_CLOCK


def until(
    fn: Callable[[], None],
    period: float,
    stop: threading.Event,
    clock: Optional[Clock] = None,
) -> None:
    """Run fn every `period` seconds until `stop` is set. fn runs
    immediately first (wait.Until semantics). Crashes are contained the
    way util/runtime.HandleCrash does — logged, loop continues."""
    clock = clock or DEFAULT_CLOCK
    while not stop.is_set():
        try:
            fn()
        except Exception as exc:  # HandleCrash analogue
            import logging

            logging.getLogger("kubernetes_tpu_torch.wait").exception(
                "observed a panic: %s", exc
            )
        if period <= 0:
            if stop.is_set():
                return
            continue
        if stop.wait(timeout=period):
            return


def poll_until(
    condition: Callable[[], bool],
    interval: float,
    timeout: float,
    clock: Optional[Clock] = None,
) -> bool:
    """wait.Poll: run condition every interval until it returns True or
    timeout elapses. Returns whether the condition succeeded."""
    clock = clock or DEFAULT_CLOCK
    deadline = clock.now() + timeout
    while True:
        if condition():
            return True
        if clock.now() >= deadline:
            return False
        clock.sleep(interval)


def run_in_thread(
    fn: Callable[[], None], name: str = "", daemon: bool = True
) -> threading.Thread:
    t = threading.Thread(target=fn, name=name or fn.__name__, daemon=daemon)
    t.start()
    return t
