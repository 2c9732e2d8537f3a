"""Work queues (pkg/util/workqueue) and bounded fan-out.

WorkQueue: deduplicating queue with the dirty/processing discipline —
an item re-added while being processed is requeued when done, never
processed concurrently with itself. DelayingQueue adds add_after;
RateLimitingQueue adds per-item exponential requeue backoff. These are
what every controller loop drains.

parallelize() is workqueue.Parallelize (parallelizer.go:29-48), kept for
host-side fan-outs that have no tensor form; the scheduler's node scan
(its 16-worker user, generic_scheduler.go:161) is replaced by the device
program and does NOT use this.

Copy of kubernetes_tpu/utils/workqueue.py: only the import package differs.
"""

from __future__ import annotations

import heapq
import threading
import time as _time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

from kubernetes_tpu_torch.analysis import races as _races
from kubernetes_tpu_torch.utils.clock import Clock, DEFAULT_CLOCK
from kubernetes_tpu_torch.utils.flowcontrol import Backoff


class ShutDown(Exception):
    pass


class WorkQueue:
    """FIFO of unique items with in-flight tracking.

    A non-empty `name` opts the queue into the workqueue metric family
    (workqueue/metrics.go): per-queue depth, adds, queue-wait and
    work-duration — the controller-lag signals. Unnamed queues carry
    zero metric overhead (the scheduler-internal scratch queues)."""

    def __init__(self, name: str = ""):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: List[Hashable] = []  # guarded-by: self._cond
        self._dirty: set = set()  # guarded-by: self._cond
        self._processing: set = set()  # guarded-by: self._cond
        self._shutting_down = False
        self.name = name
        self._metrics = None
        if name:
            from kubernetes_tpu_torch import metrics as _m

            self._metrics = (
                _m.workqueue_depth.labels(name),
                _m.workqueue_adds_total.child(name=name),
                _m.workqueue_queue_duration_seconds.labels(name),
                _m.workqueue_work_duration_seconds.labels(name),
            )
            self._added_at: Dict[Hashable, float] = {}
            self._started_at: Dict[Hashable, float] = {}
        _races.track(self, f"workqueue.{type(self).__name__}")

    # metric helpers — called with self._cond held
    def _note_queued(self, item: Hashable) -> None:
        if self._metrics is not None:
            depth, adds, _qd, _wd = self._metrics
            adds()
            self._added_at.setdefault(item, _time.monotonic())
            depth.set(len(self._queue))

    def add(self, item: Hashable) -> None:
        # put→get happens-before: work done before the enqueue is
        # ordered before whatever the draining worker does with it
        _races.note_put(self)
        with self._cond:
            if self._shutting_down or item in self._dirty:
                return
            self._dirty.add(item)
            if item not in self._processing:
                self._queue.append(item)
                self._note_queued(item)
                self._cond.notify()

    def get(self, timeout: Optional[float] = None) -> Hashable:
        """Block until an item is available; raises ShutDown when the
        queue is drained and shutting down."""
        with self._cond:
            while not self._queue:
                if self._shutting_down:
                    raise ShutDown
                if not self._cond.wait(timeout=timeout):
                    raise TimeoutError
            item = self._queue.pop(0)
            self._processing.add(item)
            self._dirty.discard(item)
            if self._metrics is not None:
                depth, _adds, queue_dur, _wd = self._metrics
                now = _time.monotonic()
                queue_dur.observe(now - self._added_at.pop(item, now))
                self._started_at[item] = now
                depth.set(len(self._queue))
            _races.note_get(self)
            return item

    def done(self, item: Hashable) -> None:
        with self._cond:
            self._processing.discard(item)
            if self._metrics is not None:
                _depth, _adds, _qd, work_dur = self._metrics
                now = _time.monotonic()
                work_dur.observe(now - self._started_at.pop(item, now))
            if item in self._dirty:
                self._queue.append(item)
                self._note_queued(item)
                self._cond.notify()

    def shut_down(self) -> None:
        with self._cond:
            self._shutting_down = True
            self._cond.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)


class DelayingQueue(WorkQueue):
    """WorkQueue + add_after(item, delay). A waiter thread moves items
    from a heap into the queue when their time comes.

    Re-adding an item already waiting keeps the EARLIEST ready time
    (delaying_queue.go insert: "if the item already exists, only change
    the time if it would cause the item to be delivered earlier") — a
    controller that re-enqueues with a long backoff must not push out an
    imminent retry. Stale heap entries are invalidated lazily."""

    def __init__(self, clock: Optional[Clock] = None, name: str = ""):
        super().__init__(name=name)
        self._clock = clock or DEFAULT_CLOCK
        self._heap: List[Tuple[float, int, Hashable]] = []  # guarded-by: self._heap_cond
        # item -> ready time
        self._waiting: Dict[Hashable, float] = {}  # guarded-by: self._heap_cond
        self._seq = 0  # guarded-by: self._heap_cond
        # explicit Lock: a bare Condition()'s implicit RLock is built
        # inside the threading module, invisible to the lock sanitizer
        # and so to the race detector's lockset/HB analyses
        self._heap_cond = threading.Condition(threading.Lock())
        # the waiter's own shutdown signal: _shutting_down belongs to
        # the base queue's _cond, and the armed race detector flagged
        # the waiter's _heap_cond-guarded read of it (two different
        # guards on one field is exactly the inconsistency that turns
        # into a lost-wakeup under reordering)
        self._waiter_stop = False  # guarded-by: self._heap_cond
        self._waiter = threading.Thread(target=self._wait_loop, daemon=True)
        self._waiter.start()

    def add_after(self, item: Hashable, delay: float) -> None:
        # the eventual get must happen-after THIS caller, not just the
        # waiter thread that moves the item when its delay expires
        _races.note_put(self)
        if delay <= 0:
            with self._heap_cond:
                # an immediate add supersedes any pending delayed entry
                self._waiting.pop(item, None)
            self.add(item)
            return
        with self._heap_cond:
            ready_at = self._clock.now() + delay
            current = self._waiting.get(item)
            if current is not None and current <= ready_at:
                return  # already due sooner: keep the earlier deadline
            self._waiting[item] = ready_at
            heapq.heappush(self._heap, (ready_at, self._seq, item))
            self._seq += 1
            self._heap_cond.notify()

    def waiting(self) -> int:
        """Number of distinct items still delayed (test/introspection)."""
        with self._heap_cond:
            return len(self._waiting)

    def _wait_loop(self) -> None:
        while True:
            with self._heap_cond:
                if self._waiter_stop:
                    return
                if not self._heap:
                    self._heap_cond.wait(timeout=0.5)
                    continue
                ready_at = self._heap[0][0]
                now = self._clock.now()
                if ready_at > now:
                    self._heap_cond.wait(timeout=min(ready_at - now, 0.5))
                    continue
                ts, _, item = heapq.heappop(self._heap)
                if self._waiting.get(item) != ts:
                    continue  # superseded by an earlier re-add or add()
                del self._waiting[item]
            self.add(item)

    def shut_down(self) -> None:
        super().shut_down()
        with self._heap_cond:
            self._waiter_stop = True
            self._heap_cond.notify_all()


class RateLimitingQueue(DelayingQueue):
    """DelayingQueue + per-item exponential backoff requeues
    (workqueue/rate_limitting_queue.go)."""

    def __init__(
        self,
        base_delay: float = 0.005,
        max_delay: float = 1000.0,
        clock: Optional[Clock] = None,
        name: str = "",
    ):
        super().__init__(clock=clock, name=name)
        self._backoff = Backoff(base_delay, max_delay, clock=clock)
        self._requeues: dict = {}
        self._requeue_lock = threading.Lock()

    def add_rate_limited(self, item: Hashable) -> None:
        with self._requeue_lock:
            self._requeues[item] = self._requeues.get(item, 0) + 1
        if self.name:
            from kubernetes_tpu_torch.metrics import workqueue_retries_total

            workqueue_retries_total.inc(name=self.name)
        self.add_after(item, self._backoff.next_(str(item)))

    def num_requeues(self, item: Hashable) -> int:
        with self._requeue_lock:
            return self._requeues.get(item, 0)

    def forget(self, item: Hashable) -> None:
        with self._requeue_lock:
            self._requeues.pop(item, None)
        self._backoff.reset(str(item))


def parallelize(workers: int, pieces: int, do_work_piece: Callable[[int], Any]) -> None:
    """Bounded fan-out over indices with a completion barrier
    (parallelizer.go:29-48). Exceptions are contained per piece the way
    HandleCrash is (parallelizer.go:40)."""
    if pieces <= 0:
        return

    def safe(i: int) -> None:
        try:
            do_work_piece(i)
        except Exception as exc:
            import logging

            logging.getLogger("kubernetes_tpu_torch.workqueue").exception(
                "worker panic on piece %d: %s", i, exc
            )

    with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        list(pool.map(safe, range(pieces)))
