"""Controller framework + shared informers.

Reference: pkg/controller/framework/controller.go (:213 NewInformer,
:278 NewIndexerInformer) and shared_informer.go. An informer is a
Reflector feeding a DeltaFIFO, drained by a process loop that keeps a
Store current and invokes ResourceEventHandler callbacks.

Copy of kubernetes_tpu/client/informer.py: only the import package differs.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from kubernetes_tpu_torch.client.cache.fifo import (
    DeletedFinalStateUnknown,
    DeltaFIFO,
    ShutDown,
)
from kubernetes_tpu_torch.client.cache.reflector import Reflector
from kubernetes_tpu_torch.client.cache.store import (
    IndexFunc,
    Indexer,
    Store,
    meta_namespace_key_func,
)
from kubernetes_tpu_torch.client.rest import ResourceClient

log = logging.getLogger(__name__)


@dataclass
class ResourceEventHandler:
    on_add: Optional[Callable] = None
    on_update: Optional[Callable] = None  # (old, new)
    on_delete: Optional[Callable] = None


class Informer:
    """NewInformer/NewIndexerInformer: list+watch a resource, keep
    `store` synced, call handlers after the store is updated.

    direct=True skips the DeltaFIFO + process thread: the reflector
    thread applies each event to the store and handlers synchronously.
    Ordering is identical (one reflector thread already serializes the
    stream); the queue hop it removes measured ~2x the useful per-event
    work during density bursts. Use for informers whose handlers are
    quick and thread-safe (the scheduler's cache feeds)."""

    def __init__(
        self,
        resource: ResourceClient,
        handler: Optional[ResourceEventHandler] = None,
        indexers: Optional[Dict[str, IndexFunc]] = None,
        label_selector: str = "",
        field_selector: str = "",
        name: str = "",
        direct: bool = False,
    ):
        self.store: Store = (
            Indexer(meta_namespace_key_func, indexers)
            if indexers
            else Store(meta_namespace_key_func)
        )
        # _handlers_lock serializes delta dispatch with add_event_handler's
        # synthetic-add snapshot so late joiners see each object exactly once
        self._handlers_lock = threading.Lock()
        self._handlers: List[ResourceEventHandler] = []
        if handler is not None:
            self._handlers.append(handler)
        self._initial_processed = threading.Event()
        self._direct = direct
        if direct:
            feed = _DirectAdapter(self)
            self._fifo = None
        else:
            self._fifo = DeltaFIFO(
                meta_namespace_key_func, known_objects=self.store
            )
            feed = self._fifo
        self._reflector = Reflector(
            resource,
            feed,
            label_selector=label_selector,
            field_selector=field_selector,
            name=name or f"informer-{resource.resource}",
        )
        self._thread: Optional[threading.Thread] = None
        self._started_at: Optional[float] = None

    def _mark_synced(self) -> None:
        """Set has_synced exactly once, recording start->synced latency
        (informer_sync_duration_seconds) — the cache-warm time that gates
        every controller's first reconcile pass."""
        if self._initial_processed.is_set():
            return
        self._initial_processed.set()
        if self._started_at is not None:
            import time as _time

            from kubernetes_tpu_torch.metrics import informer_sync_duration_seconds

            informer_sync_duration_seconds.labels(
                self._reflector.name
            ).observe(_time.monotonic() - self._started_at)

    # SharedIndexInformer.AddEventHandler
    def add_event_handler(self, handler: ResourceEventHandler) -> None:
        with self._handlers_lock:
            # late joiners see the current world as synthetic adds; the
            # lock keeps the snapshot atomic wrt the process loop
            for obj in self.store.list():
                _call(handler.on_add, obj)
            self._handlers.append(handler)

    def run(self) -> "Informer":
        import time as _time

        self._started_at = _time.monotonic()
        self._reflector.run()
        if self._direct:
            return self
        self._thread = threading.Thread(
            target=self._process_loop,
            name=self._reflector.name,
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._reflector.stop()
        if self._fifo is not None:
            self._fifo.close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def has_synced(self) -> bool:
        """True once the initial list has been fully applied to the store
        (shared_informer.go HasSynced)."""
        return self._initial_processed.is_set()

    def wait_for_sync(self, timeout: float = 10.0) -> bool:
        return self._initial_processed.wait(timeout)

    def _process_loop(self) -> None:
        while True:
            try:
                # deltas are applied under the FIFO lock (pop_process) so
                # a concurrent relist's replace() always sees either the
                # queued delta or its downstream effect — never neither
                self._fifo.pop_process(self._apply_deltas, timeout=0.2)
            except ShutDown:
                return
            except TimeoutError:
                pass
            self._maybe_mark_synced()

    def _apply_deltas(self, key: str, deltas) -> None:
        for d in deltas:
            try:
                self._process_delta(d)
            except Exception:
                log.exception("informer handler failed for %s", key)

    def _maybe_mark_synced(self) -> None:
        # sync is declared only AFTER the popped deltas are applied, so a
        # waiter never observes an empty fifo with an un-applied object
        if (
            not self._initial_processed.is_set()
            and self._reflector.has_synced()
            and len(self._fifo) == 0
        ):
            self._mark_synced()

    def _process_delta(self, d) -> None:
        obj = d.object
        with self._handlers_lock:
            if d.type in ("Added", "Updated", "Sync"):
                old = self.store.get(obj)
                self.store.update(obj)
                if old is None:
                    for h in self._handlers:
                        _call(h.on_add, obj)
                else:
                    for h in self._handlers:
                        _call(h.on_update, old, obj)
            elif d.type == "Deleted":
                if isinstance(obj, DeletedFinalStateUnknown):
                    self.store.delete_by_key(obj.key)
                    obj = obj.object
                    if obj is None:
                        return
                else:
                    self.store.delete(obj)
                for h in self._handlers:
                    _call(h.on_delete, obj)


def _call(fn, *args) -> None:
    if fn is not None:
        fn(*args)


def _safe_call(fn, *args) -> None:
    """Per-event handler isolation, like _apply_deltas' in FIFO mode: a
    raising handler is logged and must not abort the watch stream (in
    direct mode the exception would otherwise propagate into the
    reflector and wedge it in a relist loop that can never sync)."""
    if fn is None:
        return
    try:
        fn(*args)
    except Exception:
        log.exception("informer handler failed")


class _DirectAdapter:
    """Reflector store adapter for direct-mode informers: every event
    applies to the informer store + handlers in the reflector thread,
    with Replace synthesizing Deleted for objects that vanished during
    a watch gap (the DeltaFIFO known-objects contract, inline)."""

    def __init__(self, inf: Informer):
        self.inf = inf

    def _apply(self, obj) -> None:
        inf = self.inf
        with inf._handlers_lock:
            old = inf.store.get(obj)
            inf.store.update(obj)
            if old is None:
                for h in inf._handlers:
                    _safe_call(h.on_add, obj)
            else:
                for h in inf._handlers:
                    _safe_call(h.on_update, old, obj)

    add = _apply
    update = _apply

    def delete(self, obj) -> None:
        inf = self.inf
        with inf._handlers_lock:
            inf.store.delete(obj)
            for h in inf._handlers:
                _safe_call(h.on_delete, obj)

    def replace(self, objs) -> None:
        inf = self.inf
        with inf._handlers_lock:
            fresh = {meta_namespace_key_func(o) for o in objs}
            stale = [
                (k, inf.store.get_by_key(k))
                for k in inf.store.list_keys()
                if k not in fresh
            ]
        for obj in objs:
            self._apply(obj)
        for key, old in stale:
            with inf._handlers_lock:
                inf.store.delete_by_key(key)
                # the informer's delta path hands the final known state
                # to on_delete and skips handlers when none exists
                if old is not None:
                    for h in inf._handlers:
                        _safe_call(h.on_delete, old)
        inf._mark_synced()
