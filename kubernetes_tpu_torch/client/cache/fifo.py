"""FIFO and DeltaFIFO producer/consumer queues.

Reference: pkg/client/cache/{fifo.go, delta_fifo.go}. FIFO holds the
latest version of each object (coalescing updates); the scheduler's
PodQueue is one. DeltaFIFO preserves the per-object sequence of change
types for consumers that need to see deletions distinctly (informers).

Copy of kubernetes_tpu/client/cache/fifo.py: only the import package differs.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.analysis import races as _races
from kubernetes_tpu_torch.client.cache.store import KeyFunc, meta_namespace_key_func


class ProcessError(Exception):
    """Raised by a pop processor to requeue the item (fifo.go ErrRequeue)."""


class FIFO:
    """Coalescing FIFO: at most one entry per key; Pop returns the
    latest version. Blocks on empty.

    A non-empty `name` reports the queue through the workqueue metric
    family (depth + adds + queue-wait) — the scheduler's pod queue is
    the named instance, so `workqueue_depth{name="scheduler-pods"}`
    exposes its backlog next to every controller queue's."""

    def __init__(self, key_func: KeyFunc = meta_namespace_key_func,
                 name: str = ""):
        self.key_func = key_func
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._items: Dict[str, Any] = {}  # guarded-by: self._cond
        # deque: list.pop(0) shifts the whole backlog per pop — at a
        # 30k-pod density backlog that turned the queue quadratic
        self._queue: deque = deque()  # guarded-by: self._cond
        self._closed = False
        self.name = name
        self._metrics = None
        if name:
            import time as _time

            from kubernetes_tpu_torch import metrics as _m

            self._metrics = (
                _m.workqueue_depth.labels(name),
                _m.workqueue_adds_total.child(name=name),
                _m.workqueue_queue_duration_seconds.labels(name),
                _time.monotonic,
            )
            self._added_at: Dict[str, float] = {}
        _races.track(self, "cache.FIFO")

    def add(self, obj: Any) -> None:
        key = self.key_func(obj)
        # put→get happens-before: producer-side mutations of the object
        # are ordered before the popping consumer's reads
        _races.note_put(self)
        with self._cond:
            if key not in self._items:
                self._queue.append(key)
                if self._metrics is not None:
                    depth, adds, _qd, now = self._metrics
                    adds()
                    self._added_at.setdefault(key, now())
                    depth.set(len(self._items) + 1)
            self._items[key] = obj
            self._cond.notify()

    def update(self, obj: Any) -> None:
        self.add(obj)

    def delete(self, obj: Any) -> None:
        key = self.key_func(obj)
        with self._cond:
            self._items.pop(key, None)
            # key stays in _queue; pop skips missing items (fifo.go Delete)
            if self._metrics is not None:
                # drop the enqueue timestamp NOW: a later re-add of the
                # same key must not inherit it (phantom queue-wait), and
                # never-recreated keys must not leak entries
                self._added_at.pop(key, None)
                self._metrics[0].set(len(self._items))

    def get_by_key(self, key: str) -> Optional[Any]:
        with self._lock:
            return self._items.get(key)

    def list(self) -> List[Any]:
        with self._lock:
            return list(self._items.values())

    def pop(self, timeout: Optional[float] = None) -> Any:
        """Block until an item is available and return it."""
        with self._cond:
            while True:
                while self._queue:
                    key = self._queue.popleft()
                    if key in self._items:
                        if self._metrics is not None:
                            depth, _adds, queue_dur, now = self._metrics
                            ts = now()
                            queue_dur.observe(
                                ts - self._added_at.pop(key, ts)
                            )
                            depth.set(len(self._items) - 1)
                        _races.note_get(self)
                        return self._items.pop(key)
                    elif self._metrics is not None:
                        self._added_at.pop(key, None)  # deleted entry
                if self._closed:
                    raise ShutDown
                if not self._cond.wait(timeout=timeout):
                    raise TimeoutError

    def replace(self, objs: Sequence[Any]) -> None:
        with self._cond:
            self._items = {self.key_func(o): o for o in objs}
            self._queue = deque(self._items.keys())
            if self._metrics is not None:
                depth, _adds, _qd, now = self._metrics
                ts = now()
                self._added_at = {k: ts for k in self._items}
                depth.set(len(self._items))
            if self._items:
                self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


class ShutDown(Exception):
    pass


@dataclass
class Delta:
    type: str  # Added | Updated | Deleted | Sync
    object: Any


class DeltaFIFO:
    """Per-key list of deltas; pop returns (key, [Delta...]). known_objects
    (the downstream store) lets Replace synthesize Deleted deltas for
    objects that vanished between lists (delta_fifo.go:394-430)."""

    def __init__(
        self,
        key_func: KeyFunc = meta_namespace_key_func,
        known_objects=None,
    ):
        self.key_func = key_func
        self.known_objects = known_objects
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._items: Dict[str, List[Delta]] = {}  # guarded-by: self._cond
        # deque + membership set: `key in list` and list.pop(0) are both
        # O(queue) — quadratic exactly when a density burst backs the
        # informer up (measured 21us/add at 30k-event backlogs)
        self._queue: deque = deque()  # guarded-by: self._cond
        self._queued: set = set()  # guarded-by: self._cond
        self._closed = False
        _races.track(self, "cache.DeltaFIFO")

    def _key_of(self, obj: Any) -> str:
        if isinstance(obj, Delta):
            obj = obj.object
        if isinstance(obj, DeletedFinalStateUnknown):
            return obj.key
        return self.key_func(obj)

    def _queue_delta(self, obj: Any, dtype: str) -> None:
        key = self._key_of(obj)
        _races.note_put(self)
        with self._cond:
            deltas = self._items.setdefault(key, [])
            deltas.append(Delta(dtype, obj))
            # collapse consecutive Deleted pairs (dedupDeltas)
            if (
                len(deltas) >= 2
                and deltas[-1].type == "Deleted"
                and deltas[-2].type == "Deleted"
            ):
                deltas[-2:] = [deltas[-1]]
            if key not in self._queued:
                self._queued.add(key)
                self._queue.append(key)
            self._cond.notify()

    def add(self, obj: Any) -> None:
        self._queue_delta(obj, "Added")

    def update(self, obj: Any) -> None:
        self._queue_delta(obj, "Updated")

    def delete(self, obj: Any) -> None:
        self._queue_delta(obj, "Deleted")

    def pop(self, timeout: Optional[float] = None) -> Tuple[str, List[Delta]]:
        return self.pop_process(None, timeout)

    def pop_process(
        self, process, timeout: Optional[float] = None
    ) -> Tuple[str, List[Delta]]:
        """Pop the next key's deltas; if `process` is given, invoke it
        UNDER the queue lock (fifo.go Pop(PopProcessFunc)) so replace()
        can never run in the window between removing deltas from the
        queue and applying them downstream — the ghost-object hazard."""
        with self._cond:
            while True:
                while self._queue:
                    key = self._queue.popleft()
                    self._queued.discard(key)
                    deltas = self._items.pop(key, None)
                    if deltas:
                        _races.note_get(self)
                        if process is not None:
                            process(key, deltas)
                        return key, deltas
                if self._closed:
                    raise ShutDown
                if not self._cond.wait(timeout=timeout):
                    raise TimeoutError

    def replace(self, objs: Sequence[Any]) -> None:
        keys = set()
        for o in objs:
            keys.add(self.key_func(o))
            self._queue_delta(o, "Sync")
        # Synthesize Deleted for objects that vanished during the watch
        # gap — both ones the downstream store knows AND ones whose Added
        # delta is still queued unprocessed (delta_fifo.go Replace scans
        # f.items for exactly this ghost case).
        stale: set = set()
        if self.known_objects is not None:
            stale.update(self.known_objects.list_keys())
        with self._lock:
            stale.update(
                k
                for k, deltas in self._items.items()
                if deltas and deltas[-1].type != "Deleted"
            )
        for key in stale - keys:
            old = (
                self.known_objects.get_by_key(key)
                if self.known_objects is not None
                else None
            )
            self._queue_delta(DeletedFinalStateUnknown(key, old), "Deleted")

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)


@dataclass
class DeletedFinalStateUnknown:
    """Placeholder for an object deleted while the watch was broken
    (delta_fifo.go DeletedFinalStateUnknown)."""

    key: str
    object: Any
