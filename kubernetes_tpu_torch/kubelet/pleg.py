"""Pod lifecycle event generator (pkg/kubelet/pleg/generic.go).

Relist-based: every period, list runtime pods, diff container states
against the previous relist, and emit PodLifecycleEvents. The kubelet's
syncLoop consumes the channel alongside config updates (syncLoopIteration
case plegCh, kubelet.go:2543).

Copy of kubernetes_tpu/kubelet/pleg.py: only the import package differs."""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Tuple

from kubernetes_tpu_torch.kubelet.runtime import ContainerRuntime

# event types (pleg/pleg.go)
CONTAINER_STARTED = "ContainerStarted"
CONTAINER_DIED = "ContainerDied"
POD_SYNC = "PodSync"


@dataclass(frozen=True)
class PodLifecycleEvent:
    pod_uid: str
    type: str
    data: str = ""  # container name


class PLEG:
    def __init__(self, runtime: ContainerRuntime, relist_period: float = 1.0):
        self.runtime = runtime
        self.period = relist_period
        self.events: "queue.Queue[PodLifecycleEvent]" = queue.Queue(maxsize=1000)
        self._last: Dict[Tuple[str, str], str] = {}  # (uid, container) -> state
        self._stop = threading.Event()
        self._thread = None

    def relist(self) -> None:
        """generic.go:151 relist: diff current vs old container states."""
        current: Dict[Tuple[str, str], str] = {}
        for pod in self.runtime.list_pods():
            for c in pod.containers:
                current[(pod.uid, c.name)] = c.state
        for (uid, cname), state in current.items():
            old = self._last.get((uid, cname))
            if old != state:
                if state == "running":
                    self._emit(PodLifecycleEvent(uid, CONTAINER_STARTED, cname))
                elif state == "exited":
                    self._emit(PodLifecycleEvent(uid, CONTAINER_DIED, cname))
        for (uid, cname), old in self._last.items():
            if (uid, cname) not in current and old != "exited":
                self._emit(PodLifecycleEvent(uid, CONTAINER_DIED, cname))
        self._last = current

    def _emit(self, ev: PodLifecycleEvent) -> None:
        try:
            self.events.put_nowait(ev)
        except queue.Full:
            pass  # the reference drops + logs when the channel is full

    def run(self) -> "PLEG":
        def loop():
            while not self._stop.wait(self.period):
                try:
                    self.relist()
                except Exception:
                    pass

        self._thread = threading.Thread(target=loop, name="pleg", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
