"""Memory-pressure eviction (pkg/kubelet/eviction).

The manager polls a memory-availability signal (the cadvisor seam —
injected here the way kubemark injects fake stats). When available memory
drops under the configured threshold it (a) reports MemoryPressure, which
the kubelet's next heartbeat writes into the node conditions — feeding
the scheduler's CheckNodeMemoryPressure predicate end-to-end — and
(b) evicts one pod per sync ranked by QoS class: BestEffort first, then
Burstable, Guaranteed last (eviction/helpers.go rankMemoryPressure; the
reference breaks ties by usage-over-request, here by pod age). An evicted
pod is killed in the runtime and its API status set to Failed with
reason "Evicted" (eviction_manager.go evictPod) — the object survives so
controllers observe the failure and replace it.

After pressure clears, MemoryPressure stays asserted for a transition
period (--eviction-pressure-transition-period) to stop flapping.

Copy of kubernetes_tpu/kubelet/eviction.py: only the import package differs.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from kubernetes_tpu_torch.api import types as t

REASON_EVICTED = "Evicted"
MESSAGE_EVICTED = "The node was low on resource: memory."


def pod_qos_class(pod: t.Pod) -> str:
    """pkg/api/... qos.GetPodQOS: Guaranteed (limits == requests set for
    every container), Burstable (any request), BestEffort (none)."""
    any_req = False
    all_guaranteed = bool(pod.spec.containers)
    for c in pod.spec.containers:
        req = {k: v for k, v in (c.requests or {}).items()
               if k in ("cpu", "memory")}
        lim = {k: v for k, v in (c.limits or {}).items()
               if k in ("cpu", "memory")}
        if req or lim:
            any_req = True
        if not (req and lim and all(
            str(lim.get(k)) == str(req.get(k)) for k in ("cpu", "memory")
        )):
            all_guaranteed = False
    if not any_req:
        return "BestEffort"
    return "Guaranteed" if all_guaranteed else "Burstable"


_QOS_RANK = {"BestEffort": 0, "Burstable": 1, "Guaranteed": 2}


class EvictionManager:
    def __init__(
        self,
        client,
        runtime,
        node_name: str,
        memory_available_fn: Callable[[], int],
        memory_threshold: int,
        sync_period: float = 1.0,
        pressure_transition_period: float = 5.0,
        recorder=None,
    ):
        self.client = client
        self.runtime = runtime
        self.node_name = node_name
        self.memory_available = memory_available_fn
        self.threshold = memory_threshold
        self.sync_period = sync_period
        self.transition_period = pressure_transition_period
        self.recorder = recorder
        self._pressure_since: Optional[float] = None
        self._last_observed_pressure = float("-inf")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # consulted by the kubelet heartbeat (tryUpdateNodeStatus ->
    # setNodeMemoryPressureCondition)
    @property
    def under_memory_pressure(self) -> bool:
        if self._pressure_since is not None:
            return True
        return (
            time.monotonic() - self._last_observed_pressure
            < self.transition_period
        )

    def _candidates(self) -> List[t.Pod]:
        """Active pods on this node, worst-ranked first."""
        pods, _ = self.client.pods("").list(
            field_selector=f"spec.nodeName={self.node_name}"
        )
        active = [
            p for p in pods
            if p.status.phase not in ("Succeeded", "Failed")
            and p.metadata.deletion_timestamp is None
        ]
        active.sort(key=lambda p: (
            _QOS_RANK.get(pod_qos_class(p), 1),
            p.metadata.creation_timestamp or "",
        ))
        return active

    def _evict(self, pod: t.Pod) -> None:
        self.runtime.kill_pod(pod.metadata.uid)
        pod.status.phase = "Failed"
        pod.status.reason = REASON_EVICTED
        pod.status.message = MESSAGE_EVICTED
        try:
            self.client.pods(pod.metadata.namespace).update_status(pod)
        except Exception:
            pass
        if self.recorder is not None:
            self.recorder.eventf(
                pod, "Warning", REASON_EVICTED, MESSAGE_EVICTED
            )

    def sync_once(self) -> None:
        if self.threshold <= 0:
            return
        available = self.memory_available()
        if available >= self.threshold:
            if self._pressure_since is not None:
                self._last_observed_pressure = time.monotonic()
            self._pressure_since = None
            return
        if self._pressure_since is None:
            self._pressure_since = time.monotonic()
        self._last_observed_pressure = time.monotonic()
        # one eviction per sync (eviction_manager.go: reclaim, re-observe)
        for pod in self._candidates():
            self._evict(pod)
            return

    def _loop(self) -> None:
        while not self._stop.wait(self.sync_period):
            try:
                self.sync_once()
            except Exception:
                pass

    def run(self) -> "EvictionManager":
        self._thread = threading.Thread(
            target=self._loop, name=f"eviction-{self.node_name}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
