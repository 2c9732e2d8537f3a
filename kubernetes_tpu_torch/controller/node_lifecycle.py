"""Node lifecycle controller (pkg/controller/node/nodecontroller.go).

monitorNodeStatus (:550): every period, compare each node's Ready
condition heartbeat against the grace period; stale heartbeats flip
Ready to Unknown; nodes NotReady/Unknown past the pod-eviction timeout
have their pods deleted through a rate-limited eviction queue
(:evictPods, RateLimitedTimedQueue).

Copy of kubernetes_tpu/controller/node_lifecycle.py: only the import package differs.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.client.rest import APIStatusError, RESTClient
from kubernetes_tpu_torch.controller.framework import PeriodicRunner, SharedInformerFactory
from kubernetes_tpu_torch.utils.flowcontrol import TokenBucketRateLimiter


def _parse_ts(ts: Optional[str]) -> float:
    if not ts:
        return 0.0
    from datetime import datetime, timezone

    return (
        datetime.strptime(ts, "%Y-%m-%dT%H:%M:%SZ")
        .replace(tzinfo=timezone.utc)
        .timestamp()
    )


class NodeLifecycleController(PeriodicRunner):
    SYNC_PERIOD = 5.0
    THREAD_NAME = "node-controller"
    def __init__(
        self,
        client: RESTClient,
        informers: SharedInformerFactory,
        recorder=None,
        node_monitor_grace_period: float = 40.0,
        pod_eviction_timeout: float = 300.0,
        eviction_qps: float = 0.1,  # --node-eviction-rate (nodes/sec)
        now: Callable[[], float] = time.time,
    ):
        self.client = client
        self.recorder = recorder
        self.node_informer = informers.nodes()
        self.pod_informer = informers.pods()
        self.grace = node_monitor_grace_period
        self.eviction_timeout = pod_eviction_timeout
        self.now = now
        # nodecontroller.go:86 podEvictor rate limiter
        self.eviction_limiter = TokenBucketRateLimiter(eviction_qps, 10)
        # node -> time Ready first observed not-True
        self._not_ready_since: Dict[str, float] = {}
        self._evicted: set = set()

    # -- one monitoring pass (tests drive this directly) ---------------------

    def monitor_once(self) -> None:
        for node in self.node_informer.store.list():
            self._check_node(node)

    def _ready_condition(self, node: t.Node) -> Optional[t.NodeCondition]:
        for c in node.status.conditions:
            if c.type == "Ready":
                return c
        return None

    def _check_node(self, node: t.Node) -> None:
        name = node.metadata.name
        ready = self._ready_condition(node)
        now = self.now()
        heartbeat = _parse_ts(ready.last_heartbeat_time) if ready else 0.0
        if ready is not None and ready.status == "True":
            if now - heartbeat <= self.grace or heartbeat == 0.0:
                self._not_ready_since.pop(name, None)
                self._evicted.discard(name)
                return
            # stale heartbeat: mark Unknown (monitorNodeStatus:640-660)
            self._set_ready_status(node, "Unknown", "NodeStatusUnknown")
        since = self._not_ready_since.setdefault(name, now)
        if now - since < self.eviction_timeout:
            return
        if name in self._evicted:
            return
        if not self.eviction_limiter.try_accept():
            return  # rate limited; retry next pass
        self._evict_pods(name)
        self._evicted.add(name)

    def _set_ready_status(self, node: t.Node, status: str, reason: str) -> None:
        ready = self._ready_condition(node)
        if ready is None:
            return
        ready.status = status
        ready.reason = reason
        try:
            self.client.nodes().update_status(node)
        except APIStatusError:
            pass
        if self.recorder is not None:
            self.recorder.eventf(
                node, "Normal", "NodeNotReady", f"Node {node.metadata.name} status is now: {status}"
            )

    def _evict_pods(self, node_name: str) -> None:
        """deletePods (nodecontroller.go:795): remove every pod bound to
        the dead node so controllers re-create them elsewhere."""
        for pod in self.pod_informer.store.list():
            if pod.spec.node_name == node_name:
                try:
                    self.client.pods(pod.metadata.namespace).delete(
                        pod.metadata.name
                    )
                except APIStatusError:
                    pass

    def sync_once(self) -> None:
        self.monitor_once()
