"""Event recorder/broadcaster (pkg/client/record).

Recorder.eventf → broadcaster fan-out → sinks. The apiserver sink
aggregates duplicates client-side before POSTing (events_cache.go:69-92:
same (object, reason, message) bumps count/lastTimestamp via PUT instead
of creating a new Event).

Copy of kubernetes_tpu/client/record.py: only the import package differs.
"""

from __future__ import annotations

import datetime
import itertools
import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.client.rest import APIStatusError, RESTClient

log = logging.getLogger(__name__)


def _now_iso() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ"
    )


def object_reference(obj: Any) -> t.ObjectReference:
    kind = type(obj).__name__
    return t.ObjectReference(
        kind=kind,
        namespace=getattr(obj.metadata, "namespace", ""),
        name=obj.metadata.name,
        uid=getattr(obj.metadata, "uid", ""),
    )


_SHUTDOWN = object()


class EventBroadcaster:
    """Fan events out to registered sinks (record/event.go broadcaster).

    Like the reference's watch.Broadcaster (queue length 1000,
    DropIfChannelFull), publishing is asynchronous on a bounded queue:
    recording an event must never block or slow a scheduling/bind path,
    and overload sheds events rather than throughput."""

    QUEUE_LEN = 1000

    def __init__(self):
        self._lock = threading.Lock()
        self._sinks: List[Callable[[t.Event], None]] = []
        import queue as _queue

        self._queue: "_queue.Queue" = _queue.Queue(maxsize=self.QUEUE_LEN)
        self._worker: Optional[threading.Thread] = None
        self._shut = False

    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            with self._lock:
                if self._shut:
                    return
                if self._worker is None or not self._worker.is_alive():
                    self._worker = threading.Thread(
                        target=self._drain, daemon=True, name="event-broadcaster"
                    )
                    self._worker.start()

    def _drain(self) -> None:
        import queue as _queue

        while True:
            ev = self._queue.get()
            if ev is _SHUTDOWN:
                return
            # gulp everything momentarily queued: a scheduling wave
            # records tens of thousands of events back-to-back, and
            # bulk-capable sinks (EventSink.record_many) turn the burst
            # into a handful of API requests instead of one per event
            batch = [ev]
            while len(batch) < 512:
                try:
                    nxt = self._queue.get_nowait()
                except _queue.Empty:
                    break
                if nxt is _SHUTDOWN:
                    # re-queue without blocking: a racing publisher may
                    # have refilled the bounded queue, and the worker is
                    # the only consumer. Dropping the sentinel is safe —
                    # _shut is already set, so we just exit after this
                    # batch instead.
                    try:
                        self._queue.put_nowait(nxt)
                    except _queue.Full:
                        self._deliver(batch)
                        return
                    break
                batch.append(nxt)
            self._deliver(batch)

    def _deliver(self, batch) -> None:
        with self._lock:
            sinks = list(self._sinks)
        for fn in sinks:
            many = getattr(
                getattr(fn, "__self__", None), "record_many", None
            )
            if many is not None:
                try:
                    many(batch)
                except Exception:
                    log.exception("event sink failed")
            else:
                # per-event isolation: one bad event must not drop the
                # rest of the batch for this sink
                for e in batch:
                    try:
                        fn(e)
                    except Exception:
                        log.exception("event sink failed")

    def shutdown(self) -> None:
        """Flush queued events and stop the worker (the reference's
        watch.Broadcaster.Shutdown). Terminal AND idempotent: events
        recorded afterwards (e.g. by still-draining bind threads) are
        dropped instead of resurrecting the worker, and a second
        shutdown() — controllers and their manager both shutting the
        shared broadcaster down — returns immediately instead of
        enqueueing another sentinel into a queue nobody drains."""
        with self._lock:
            already = self._shut
            self._shut = True
        worker = self._worker
        if already or worker is None or not worker.is_alive():
            return
        self._queue.put(_SHUTDOWN)
        worker.join(timeout=5.0)

    def start_logging(self, logf: Callable[[str], None] = log.info) -> None:
        self._add(
            lambda ev: logf(
                f"Event({ev.involved_object.namespace}/"
                f"{ev.involved_object.name}): type: {ev.type!r} "
                f"reason: {ev.reason!r} {ev.message}"
            )
        )

    def start_recording_to_sink(
        self,
        sink: "EventSink",
        correlator: Optional[EventCorrelator] = None,
        correlate: bool = True,
    ) -> None:
        """Fan events into `sink`, correlated by default: duplicates
        aggregate client-side (count/firstTimestamp/lastTimestamp) and a
        per-source+object token bucket sheds event storms before they
        reach the store (StartRecordingToSink's EventCorrelator)."""
        if correlate:
            sink = _CorrelatingSink(sink, correlator or EventCorrelator())
        self._add(sink.record)

    def _add(self, fn: Callable[[t.Event], None]) -> None:
        with self._lock:
            self._sinks.append(fn)

    def new_recorder(self, component: str) -> "EventRecorder":
        return EventRecorder(self, component)

    def _publish(self, ev: t.Event) -> None:
        import queue as _queue

        if self._shut:
            return
        self._ensure_worker()
        try:
            self._queue.put_nowait(ev)
        except _queue.Full:
            pass  # DropIfChannelFull (watch/mux.go:40)


class EventSpamFilter:
    """Token-bucket spam filter per (source, involved object) — the
    events_cache.go EventSourceObjectSpamFilter. Each source+object pair
    gets `burst` immediate events; afterwards tokens refill at `qps`
    (default one event per 5 minutes, the reference's default). The
    bucket map is LRU-bounded so a wave of distinct objects cannot grow
    it without bound."""

    def __init__(
        self,
        burst: int = 25,
        qps: float = 1.0 / 300.0,
        clock: Callable[[], float] = time.monotonic,
        max_keys: int = 4096,
    ):
        self.burst = float(burst)
        self.qps = qps
        self._clock = clock
        self._max_keys = max_keys
        self._lock = threading.Lock()
        # key -> [tokens, last refill ts]
        self._buckets: "OrderedDict[Tuple, List[float]]" = OrderedDict()

    @staticmethod
    def _key(ev: t.Event) -> Tuple:
        ref = ev.involved_object
        return (
            ev.source_component,
            ref.kind,
            ref.namespace,
            ref.name,
        )

    def allow(self, ev: t.Event) -> bool:
        now = self._clock()
        with self._lock:
            b = self._buckets.get(self._key(ev))
            if b is None:
                b = [self.burst, now]
                self._buckets[self._key(ev)] = b
                while len(self._buckets) > self._max_keys:
                    self._buckets.popitem(last=False)
            else:
                self._buckets.move_to_end(self._key(ev))
                b[0] = min(self.burst, b[0] + (now - b[1]) * self.qps)
                b[1] = now
            if b[0] >= 1.0:
                b[0] -= 1.0
                return True
            return False


class EventCorrelator:
    """Client-side event correlation (events_cache.go EventCorrelator):
    identical events (same source/object/reason/type/message) aggregate
    into one logical event whose count/firstTimestamp/lastTimestamp
    advance, and a per-source+object token bucket drops spam before it
    ever reaches the API. correlate() returns the (possibly rewritten)
    event to record, or None when the spam filter discarded it."""

    MAX_CACHE = 4096

    def __init__(
        self,
        spam_filter: Optional[EventSpamFilter] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._filter = spam_filter or EventSpamFilter(clock=clock)
        self._lock = threading.Lock()
        # aggregation key -> [canonical event name, count, firstTimestamp]
        self._cache: "OrderedDict[Tuple, List]" = OrderedDict()

    @staticmethod
    def _agg_key(ev: t.Event) -> Tuple:
        ref = ev.involved_object
        return (
            ev.source_component,
            ref.kind,
            ref.namespace,
            ref.name,
            ev.reason,
            ev.type,
            ev.message,
        )

    def correlate(self, ev: t.Event) -> Optional[t.Event]:
        key = self._agg_key(ev)
        with self._lock:
            rec = self._cache.get(key)
            if rec is None:
                self._cache[key] = [
                    ev.metadata.name, ev.count or 1, ev.first_timestamp,
                ]
                while len(self._cache) > self.MAX_CACHE:
                    self._cache.popitem(last=False)
            else:
                # the canonical (first-seen) name keeps every duplicate
                # aggregating onto ONE store object instead of minting a
                # new Event per occurrence
                rec[1] += 1
                self._cache.move_to_end(key)
                ev.metadata.name = rec[0]
                ev.count = rec[1]
                ev.first_timestamp = rec[2]
        if not self._filter.allow(ev):
            from kubernetes_tpu_torch.metrics import client_events_discarded_total

            client_events_discarded_total.inc(
                source=ev.source_component, reason=ev.reason
            )
            return None
        return ev


class _CorrelatingSink:
    """Sink adapter running every event through an EventCorrelator
    before delivery — the recordToSink pipeline shape. Exposes
    record_many so the broadcaster's batch path stays bulk-capable."""

    def __init__(self, sink: "EventSink", correlator: EventCorrelator):
        self.sink = sink
        self.correlator = correlator

    def record(self, ev: t.Event) -> None:
        out = self.correlator.correlate(ev)
        if out is not None:
            self.sink.record(out)

    def record_many(self, evs) -> None:
        out = [e for e in map(self.correlator.correlate, evs) if e is not None]
        if not out:
            return
        many = getattr(self.sink, "record_many", None)
        if many is not None:
            many(out)
        else:
            for e in out:
                self.sink.record(e)


_event_seq = itertools.count()


class EventRecorder:
    def __init__(self, broadcaster: EventBroadcaster, component: str):
        self.broadcaster = broadcaster
        self.component = component

    def event(self, obj: Any, event_type: str, reason: str, message: str) -> None:
        ref = object_reference(obj)
        now = _now_iso()
        ev = t.Event(
            metadata=t.ObjectMeta(
                # the reference names events <object>.<UnixNano>; a
                # process-wide counter keeps names unique here
                name=f"{ref.name}.{next(_event_seq):016x}",
                namespace=ref.namespace or "default",
            ),
            involved_object=ref,
            reason=reason,
            message=message,
            source_component=self.component,
            first_timestamp=now,
            last_timestamp=now,
            count=1,
            type=event_type,
        )
        self.broadcaster._publish(ev)

    def eventf(self, obj, event_type, reason, fmt, *args) -> None:
        self.event(obj, event_type, reason, fmt % args if args else fmt)


class EventSink:
    """Aggregating apiserver sink (events_cache.go EventCorrelator-lite).
    The dedup map is LRU-bounded like the reference's events cache."""

    MAX_SEEN = 4096

    def __init__(self, client: RESTClient):
        self.client = client
        self._lock = threading.Lock()
        # (ns, involved name, reason, message) -> (event name, count); LRU
        self._seen: "OrderedDict[Tuple[str, str, str, str], Tuple[str, int]]" = (
            OrderedDict()
        )

    def record(self, ev: t.Event) -> None:
        key = (
            ev.metadata.namespace,
            ev.involved_object.name,
            ev.reason,
            ev.message,
        )
        # the whole lookup→API-call→remember sequence is one critical
        # section so concurrent duplicate events aggregate instead of
        # racing into two creates (event volume is low; contention isn't)
        with self._lock:
            events = self.client.resource("events", ev.metadata.namespace)
            prior = self._seen.get(key)
            if prior is not None:
                name, count = prior
                # an upstream EventCorrelator may carry a HIGHER count
                # (this cache evicted mid-storm); never step backwards
                new_count = max(count + 1, ev.count or 1)
                try:
                    events.patch(
                        name,
                        {"count": new_count,
                         "lastTimestamp": ev.last_timestamp},
                    )
                    self._remember(key, (name, new_count))
                    return
                except APIStatusError:
                    pass  # fall through to create
            try:
                events.create(ev)
                self._remember(key, (ev.metadata.name, ev.count or 1))
            except APIStatusError:
                log.debug("event create failed", exc_info=True)

    def _remember(self, key, value) -> None:
        self._seen[key] = value
        self._seen.move_to_end(key)
        while len(self._seen) > self.MAX_SEEN:
            self._seen.popitem(last=False)

    def record_many(self, evs) -> None:
        """Bulk form the broadcaster uses for event storms: duplicates
        still aggregate through the patch path; fresh events go to the
        API in chunked create_many requests (one per namespace) instead
        of one POST each — a scheduling wave's 'Scheduled' burst was a
        30k-request flood otherwise."""
        with self._lock:
            fresh: "OrderedDict[str, list]" = OrderedDict()
            in_batch = {}
            for ev in evs:
                key = (
                    ev.metadata.namespace,
                    ev.involved_object.name,
                    ev.reason,
                    ev.message,
                )
                pending = in_batch.get(key)
                if pending is not None:
                    # duplicate within the same burst: aggregate onto the
                    # not-yet-created event instead of creating twice
                    pending.count += 1
                    pending.last_timestamp = ev.last_timestamp
                    continue
                prior = self._seen.get(key)
                if prior is not None:
                    name, count = prior
                    # same never-backwards rule as record(): a
                    # correlated event's count wins when higher
                    new_count = max(count + 1, ev.count or 1)
                    try:
                        self.client.resource(
                            "events", ev.metadata.namespace
                        ).patch(name, {
                            "count": new_count,
                            "lastTimestamp": ev.last_timestamp,
                        })
                        self._remember(key, (name, new_count))
                        continue
                    except APIStatusError:
                        pass  # fall through to create
                    except Exception:
                        # transport failure on ONE event must not drop
                        # the rest of the batch (per-event isolation)
                        log.debug("event patch failed", exc_info=True)
                        continue
                fresh.setdefault(ev.metadata.namespace, []).append((key, ev))
                in_batch[key] = ev
            for ns, pairs in fresh.items():
                events = self.client.resource("events", ns)
                batch = [ev for _k, ev in pairs]
                try:
                    results = events.create_many(batch)
                except Exception:
                    # bulk endpoint absent or down: per-event fallback
                    # with per-event isolation
                    results = None
                    for key, ev in pairs:
                        try:
                            events.create(ev)
                            self._remember(
                                key, (ev.metadata.name, ev.count or 1)
                            )
                        except Exception:
                            log.debug("event create failed", exc_info=True)
                if results is not None:
                    for (key, ev), res in zip(pairs, results):
                        if res.get("status") == "Success":
                            self._remember(
                                key, (ev.metadata.name, ev.count or 1)
                            )


class FakeRecorder:
    """Test seam (record/fake.go): collects '<type> <reason> <message>'."""

    def __init__(self):
        self.events: List[str] = []

    def event(self, obj, event_type, reason, message) -> None:
        self.events.append(f"{event_type} {reason} {message}")

    def eventf(self, obj, event_type, reason, fmt, *args) -> None:
        self.event(obj, event_type, reason, fmt % args if args else fmt)
