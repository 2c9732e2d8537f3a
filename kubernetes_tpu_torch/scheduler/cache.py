"""Scheduler cache: the assumed-pod state machine.

Reference: plugin/pkg/scheduler/schedulercache/{cache.go,interface.go}.
State machine (interface.go:31-46):

    Initial -> Assume -> Expire (TTL, bind lost)
                    \\-> Add (watch confirm) -> Update -> Remove
    Initial -> Add (scheduled pod seen first via watch)

AssumePod commits a decision locally before the bind lands so the next
scheduling cycle sees the resources as taken; the TTL repairs the cache
if the bind never confirms. snapshot() is GetNodeNameToInfoMap
(cache.go:77) — the ClusterState the algorithm (and the TPU snapshot
encoder) consumes.

Copy of kubernetes_tpu/scheduler/cache.py: only the import package differs.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

from kubernetes_tpu_torch.analysis import races as _races
from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.oracle.state import ClusterState, NodeInfo
from kubernetes_tpu_torch.utils.clock import DEFAULT_CLOCK, Clock


class CacheError(Exception):
    pass


@dataclass
class _PodState:
    pod: Pod
    deadline: Optional[float] = None  # None once confirmed by watch


def _key(pod: Pod) -> str:
    return f"{pod.metadata.namespace}/{pod.metadata.name}"


class SchedulerCache:
    """cache.go:44 schedulerCache. Thread-safe; single mutex like the
    reference (its per-cycle cost there was the clone under lock — here
    the snapshot is handed to the tensor encoder instead)."""

    def __init__(self, ttl: float = 30.0, clock: Clock = DEFAULT_CLOCK):
        self.ttl = ttl
        self.clock = clock
        self._lock = threading.Lock()
        self._assumed: set = set()  # guarded-by: self._lock
        self._pod_states: Dict[str, _PodState] = {}  # guarded-by: self._lock
        self._nodes: Dict[str, NodeInfo] = {}  # guarded-by: self._lock
        self._stop = threading.Event()
        self._cleanup_thread: Optional[threading.Thread] = None
        self._listeners: List = []  # guarded-by: self._lock
        _races.track(self, "scheduler.SchedulerCache")

    def add_listener(self, fn) -> None:
        """Subscribe to cache mutations: fn(kind, obj) called under the
        cache lock with kind in {pod_add, pod_remove, node_set,
        node_remove}. Every pod transition (assume, confirm, update,
        remove, expire, forget) decomposes into pod_add/pod_remove, so a
        listener integrating the stream reconstructs the cache state —
        the seam the incremental snapshot (snapshot/incremental.py)
        feeds from, mirroring how the reference's cache is itself the
        integral of the informer stream (cache.go:44).

        Current contents are replayed into the listener first (under the
        same lock), so subscribing late loses nothing."""
        with self._lock:
            for info in self._nodes.values():
                if info.node is not None:
                    fn("node_set", info.node)
            for st in self._pod_states.values():
                fn("pod_add", st.pod)
            self._listeners.append(fn)

    def _notify(self, kind: str, obj) -> None:
        for fn in self._listeners:
            fn(kind, obj)

    # -- lifecycle (factory.go:101 starts the 1s cleanup loop) ---------------

    def run(self, period: float = 1.0) -> "SchedulerCache":
        self._cleanup_thread = threading.Thread(
            target=self._cleanup_loop, args=(period,), daemon=True,
            name="schedulercache-cleanup",
        )
        self._cleanup_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def _cleanup_loop(self, period: float) -> None:
        while not self._stop.wait(period):
            self.cleanup_expired(self.clock.now())

    # -- pods ----------------------------------------------------------------

    def assume_pod(self, pod: Pod, now: Optional[float] = None) -> None:
        """cache.go:101 AssumePod (takes `now` for test determinism,
        cache.go:106 assumePod)."""
        key = _key(pod)
        with self._lock:
            if key in self._pod_states:
                raise CacheError(f"pod {key} is in the cache, so can't be assumed")
            self._add_pod_locked(pod)
            self._pod_states[key] = _PodState(
                pod, (now if now is not None else self.clock.now()) + self.ttl
            )
            self._assumed.add(key)

    def assume_pods(self, pods, now: Optional[float] = None):
        """Bulk AssumePod for a scheduling wave: one lock acquisition
        instead of one per pod (the per-pod form cost ~160us each at
        30k-pod waves, serial in the scheduling thread). Returns a
        CacheError-or-None per pod, aligned with the input."""
        t = (now if now is not None else self.clock.now()) + self.ttl
        out = []
        with self._lock:
            for pod in pods:
                key = _key(pod)
                if key in self._pod_states:
                    out.append(CacheError(
                        f"pod {key} is in the cache, so can't be assumed"
                    ))
                    continue
                self._add_pod_locked(pod)
                self._pod_states[key] = _PodState(pod, t)
                self._assumed.add(key)
                out.append(None)
        return out

    def has_pod(self, pod: Pod) -> bool:
        """True when the pod is already assumed or watch-confirmed — a
        FIFO pop of such a pod is a duplicate delivery (at-least-once
        watch semantics) and scheduling it again is always wrong."""
        with self._lock:
            return _key(pod) in self._pod_states

    def pod_keys(self) -> set:
        """Copy of every known pod key (assumed + confirmed) under one
        lock acquisition — the wave filter's bulk form of has_pod."""
        with self._lock:
            return set(self._pod_states)

    def forget_pod(self, pod: Pod) -> None:
        """cache.go ForgetPod: undo an assume whose bind failed."""
        key = _key(pod)
        with self._lock:
            state = self._pod_states.get(key)
            if state is None or key not in self._assumed:
                raise CacheError(f"pod {key} is not assumed")
            self._remove_pod_locked(state.pod)
            del self._pod_states[key]
            self._assumed.discard(key)

    def add_pod(self, pod: Pod) -> None:
        """cache.go:129 AddPod — watch confirmation (or a scheduled pod
        seen for the first time)."""
        key = _key(pod)
        with self._lock:
            state = self._pod_states.get(key)
            if state is not None and key in self._assumed:
                if state.pod.spec.node_name == pod.spec.node_name:
                    # confirm in place: the bind wrote only node_name +
                    # PodScheduled condition, so the assumed pod's
                    # accounting (requests, labels, ports) is already
                    # exact — flipping the state avoids a full
                    # remove+re-add (and its two incremental-encoder
                    # events) per confirmation, which at wave scale was
                    # most of the watch-ingest cost
                    self._pod_states[key] = _PodState(pod, None)
                    self._assumed.discard(key)
                    return
                # bound somewhere else than assumed: re-add under the
                # authoritative (bound) pod
                self._remove_pod_locked(state.pod)
                self._add_pod_locked(pod)
                self._pod_states[key] = _PodState(pod, None)
                self._assumed.discard(key)
            elif state is None:
                self._add_pod_locked(pod)
                self._pod_states[key] = _PodState(pod, None)
            else:
                raise CacheError(f"pod {key} was already added")

    def update_pod(self, old: Pod, new: Pod) -> None:
        """cache.go:156 UpdatePod."""
        key = _key(old)
        with self._lock:
            state = self._pod_states.get(key)
            if state is None or key in self._assumed:
                raise CacheError(f"pod {key} is not added to cache")
            self._remove_pod_locked(state.pod)
            self._add_pod_locked(new)
            self._pod_states[key] = _PodState(new, None)

    def remove_pod(self, pod: Pod) -> None:
        """cache.go:207 RemovePod."""
        key = _key(pod)
        with self._lock:
            state = self._pod_states.get(key)
            if state is None or key in self._assumed:
                raise CacheError(f"pod {key} is not added to cache")
            self._remove_pod_locked(state.pod)
            del self._pod_states[key]

    def is_assumed_pod(self, pod: Pod) -> bool:
        with self._lock:
            return _key(pod) in self._assumed

    def list_pods(self) -> List[Pod]:
        with self._lock:
            return [s.pod for s in self._pod_states.values()]

    # -- nodes ---------------------------------------------------------------

    def add_node(self, node: Node) -> None:
        with self._lock:
            info = self._nodes.get(node.metadata.name)
            if info is None:
                info = NodeInfo()
                self._nodes[node.metadata.name] = info
            info.node = node
            self._notify("node_set", node)

    def update_node(self, old: Node, new: Node) -> None:
        self.add_node(new)

    def remove_node(self, node: Node) -> None:
        with self._lock:
            info = self._nodes.get(node.metadata.name)
            if info is None:
                return
            # pods may still reference it; keep aggregates until they go
            # (cache.go:272 removes the node object only)
            info.node = None
            if not info.pods:
                del self._nodes[node.metadata.name]
            self._notify("node_remove", node)

    # -- snapshot + expiry ---------------------------------------------------

    def snapshot(
        self,
        services=None,
        controllers=None,
        replica_sets=None,
        pvs=None,
        pvcs=None,
    ) -> ClusterState:
        """GetNodeNameToInfoMap (cache.go:77): clone every NodeInfo under
        the lock. Auxiliary listers are passed through to the state."""
        with self._lock:
            state = ClusterState(
                services=list(services or []),
                controllers=list(controllers or []),
                replica_sets=list(replica_sets or []),
                pvs=list(pvs or []),
                pvcs=list(pvcs or []),
            )
            state.node_infos = {
                name: info.clone() for name, info in self._nodes.items()
            }
            return state

    def cleanup_expired(self, now: float) -> None:
        """cache.go:283 cleanupAssumedPods: drop assumes past deadline."""
        with self._lock:
            for key in list(self._assumed):
                state = self._pod_states[key]
                if state.deadline is not None and now >= state.deadline:
                    self._remove_pod_locked(state.pod)
                    del self._pod_states[key]
                    self._assumed.discard(key)

    # -- internals (callers hold the lock) -----------------------------------

    def _add_pod_locked(self, pod: Pod) -> None:
        node_name = pod.spec.node_name
        info = self._nodes.get(node_name)
        if info is None:
            info = NodeInfo()
            self._nodes[node_name] = info
        info.add_pod(pod)
        self._notify("pod_add", pod)

    def _remove_pod_locked(self, pod: Pod) -> None:
        node_name = pod.spec.node_name
        info = self._nodes.get(node_name)
        if info is None:
            return
        try:
            info.remove_pod(pod)
        except KeyError:
            return  # nothing removed: don't notify
        finally:
            if info.node is None and not info.pods:
                del self._nodes[node_name]
        self._notify("pod_remove", pod)
