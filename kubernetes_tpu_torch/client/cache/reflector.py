"""Reflector: mirror a watchable resource into a local store.

Reference: pkg/client/cache/reflector.go:56 (ListAndWatch at :281 —
list, record resourceVersion, watch from it, relist on error/410).
Runs in a daemon thread; errors back off and resync.

Copy of kubernetes_tpu/client/cache/reflector.py: only the import package differs.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from kubernetes_tpu_torch.client.rest import ResourceClient, WatchExpired
from kubernetes_tpu_torch.metrics import (
    reflector_list_duration_seconds,
    reflector_lists_total,
    reflector_watch_duration_seconds,
    watch_events_total,
)

log = logging.getLogger(__name__)


class Reflector:
    def __init__(
        self,
        resource: ResourceClient,
        store,
        label_selector: str = "",
        field_selector: str = "",
        relist_backoff: float = 0.05,
        max_relist_backoff: float = 5.0,
        name: str = "",
    ):
        self.resource = resource
        self.store = store
        self.label_selector = label_selector
        self.field_selector = field_selector
        self.relist_backoff = relist_backoff
        self.max_relist_backoff = max_relist_backoff
        self.name = name or resource.resource
        # bound counters with pre-built label keys: the watch handler
        # runs once per event during density bursts
        self._event_counters = {
            et: watch_events_total.child(name=self.name, type=et)
            for et in ("ADDED", "MODIFIED", "DELETED")
        }
        self._lists_counter = reflector_lists_total.child(name=self.name)
        self.last_sync_resource_version = "0"
        self._stop = threading.Event()
        self._synced_once = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._watch = None

    # -- lifecycle -----------------------------------------------------------

    def run(self) -> "Reflector":
        self._thread = threading.Thread(
            target=self._loop, name=f"reflector-{self.name}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        w = self._watch
        if w is not None:
            w.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def wait_for_sync(self, timeout: float = 10.0) -> bool:
        return self._synced_once.wait(timeout)

    def has_synced(self) -> bool:
        return self._synced_once.is_set()

    # -- core ----------------------------------------------------------------

    def _loop(self) -> None:
        backoff = self.relist_backoff
        while not self._stop.is_set():
            failed = False
            try:
                self._list_and_watch()
            except WatchExpired as e:
                # expected under compaction: relist promptly, no warning
                log.debug("reflector %s: %s; relisting", self.name, e)
            except Exception as e:
                failed = True
                log.warning("reflector %s: %s; relisting", self.name, e)
            if not self._stop.is_set():
                self._stop.wait(backoff)
            # exponential backoff while the server stays broken; one good
            # cycle resets it (reflector.go resyncPeriod + util backoff)
            backoff = (
                min(backoff * 2, self.max_relist_backoff)
                if failed
                else self.relist_backoff
            )

    def _list_and_watch(self) -> None:
        # list/relist latency + count (reflector metrics, the resync
        # and recovery-list signal the ROADMAP's queue-lag analysis needs)
        t0 = time.monotonic()
        items, rv = self.resource.list(
            label_selector=self.label_selector,
            field_selector=self.field_selector,
        )
        self.store.replace(items)
        self._lists_counter()
        reflector_list_duration_seconds.labels(self.name).observe(
            time.monotonic() - t0
        )
        self.last_sync_resource_version = rv
        self._synced_once.set()
        while not self._stop.is_set():
            try:
                self._watch = self.resource.watch(
                    resource_version=self.last_sync_resource_version,
                    label_selector=self.label_selector,
                    field_selector=self.field_selector,
                )
                # stop() may have run while the watch was being
                # established (self._watch still None there) — re-check so
                # the fresh stream doesn't leak and block the thread
                if self._stop.is_set():
                    self._watch.stop()
                    return
                w0 = time.monotonic()
                try:
                    self._watch_handler(self._watch)
                finally:
                    reflector_watch_duration_seconds.labels(
                        self.name
                    ).observe(time.monotonic() - w0)
            except WatchExpired:
                raise  # relist from scratch
            finally:
                self._watch = None

    def _watch_handler(self, watch) -> None:
        for ev_type, obj in watch:
            if self._stop.is_set():
                return
            rv = obj.metadata.resource_version
            if ev_type == "ADDED":
                self.store.add(obj)
            elif ev_type == "MODIFIED":
                self.store.update(obj)
            elif ev_type == "DELETED":
                self.store.delete(obj)
            else:
                log.warning("reflector %s: unknown event %s", self.name, ev_type)
                continue
            self._event_counters[ev_type]()
            if rv:
                self.last_sync_resource_version = rv
        # watch closed server-side: return to re-establish from last RV
