"""Apiserver watch cache (pkg/storage/cacher analogue).

One Cacher per resource root prefix sits between the apiserver's read
path and the store: a per-resource in-memory snapshot plus an event
ring, fed by ONE store watch, so steady-state lists, gets, and all
watch fan-out are served from the commit-time TLV bytes the store
already encoded once — the read path never re-enters the store and
never re-encodes an object per request/watcher.

Consistency is the reference's waitUntilFreshAndBlock contract
(cacher.go): a read first samples the resourceVersion of the last
commit under this resource's prefix (stamped lock-free on the feed
stream by the store — the etcd progress-notify analogue; the GLOBAL
store rv would strand quiet resources behind other resources' writes)
and blocks until the cache has processed at least that far, so reads
through the cache are exactly as fresh as reads through the store —
serve-from-cache vs serve-from-store equivalence is a test invariant
(tests/test_cacher.py), not a best effort. Anything the cache cannot serve (historic resourceVersions
outside the ring, payloads the strict TLV codec can't carry, an
unhealthy feed) falls back to the store and counts a miss.

Entries hold READ-ONLY references to the store's immutable-after-write
objects for selector matching, the commit-time TLV blob for zero-copy
wire splicing, and a per-commit wire-encoding memo shared with the
watch fan-out — N JSON watchers/listers pay ONE reflective encode per
commit, binary consumers pay none.

Copy of kubernetes_tpu/storage/cacher.py: only the import package differs.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.analysis import races as _races
from kubernetes_tpu_torch.apiserver.fields import (
    interest_values,
    lookup_field,
    matches_fields,
)
from kubernetes_tpu_torch.metrics import (
    apiserver_watch_cache_hits_total,
    apiserver_watch_cache_misses_total,
    storage_watch_cache_ring_evictions_total,
    storage_watch_fanout_pruned_total,
)
from kubernetes_tpu_torch.storage.store import (
    ERROR,
    Compacted,
    KeyNotFound,
    MemoryStore,
    WatchEvent,
    WatchStream,
    _LazyEvent,
    _tlv_native,
    deep_copy,
)

log = logging.getLogger(__name__)

_hit = apiserver_watch_cache_hits_total.child()
_miss = apiserver_watch_cache_misses_total.child()
_evicted = storage_watch_cache_ring_evictions_total.child()
_pruned = storage_watch_fanout_pruned_total.child()


class _Entry:
    """One cached object: the store's read-only ref, its commit blob,
    and the shared wire-encoding memo for this commit."""

    __slots__ = ("rv", "obj", "blob", "wire_cache")

    def __init__(self, rv: int, obj, blob: Optional[bytes],
                 wire_cache: Optional[dict] = None):
        self.rv = rv
        self.obj = obj  # READ-ONLY store ref; never hand to a consumer
        self.blob = blob  # commit-time TLV bytes (None = uncachable)
        self.wire_cache = wire_cache if wire_cache is not None else {}

    def isolation_copy(self):
        """A consumer-owned copy: one decode from the commit blob when
        possible, else the full deep copy."""
        if self.blob is not None:
            c = _tlv_native()
            if c is not None:
                try:
                    return c.loads(self.blob)
                except Exception:
                    pass
        return deep_copy(self.obj)

    def wire(self, codec):
        """The wire dict for this commit under `codec`, memoized per
        commit (racing encoders write the same value; the dict is
        read-only downstream). Versioned codecs key by their
        group-version NAME: codec_for() builds a fresh codec object per
        request, so id() would key the long-lived memo by freed
        addresses — same-gv hits by allocator accident, cross-gv
        collisions possible by the same accident. The gv-less default
        scheme is a process singleton, so id() is stable for it."""
        gv = getattr(codec, "gv", None)
        key = gv.name if gv is not None else id(codec)
        w = self.wire_cache.get(key)
        if w is None:
            w = codec.encode(self.obj)
            self.wire_cache[key] = w
        return w


class Cacher:
    """The per-resource watch cache. `prefix` is the resource's root
    store prefix (e.g. "/pods/"); reads may narrow to any sub-prefix
    (per-namespace lists)."""

    def __init__(self, store: MemoryStore, prefix: str,
                 ring_size: int = 8192, index_field: str = ""):
        """index_field: a dotted wire path (e.g. "spec.nodeName" for
        pods) whose equality/in-pinned watchers are fanned out via an
        interest index — each event is delivered only to the watchers
        pinned to its current or previous field value, so one kubelet's
        stream costs O(its own pods), not O(all pods), and a 5k-node
        hollow fleet doesn't turn every commit into 5k queue puts."""
        self.store = store
        self.prefix = prefix
        self.index_field = index_field
        # explicit Lock: a bare Condition() builds its RLock inside the
        # threading module, where the lock sanitizer's creation hook
        # can't see it — the guard would be invisible to the lockset
        # and happens-before analyses (analysis/races)
        self._cond = threading.Condition(threading.Lock())
        self._snap: Dict[str, _Entry] = {}  # guarded-by: self._cond
        # highest resourceVersion processed into the cache
        self._rv = 0  # guarded-by: self._cond
        # _LazyEvent protos
        self._ring: deque = deque(maxlen=ring_size)  # guarded-by: self._cond
        # events <= this rv are not in the ring (bootstrap point or
        # evicted); watch-from-older falls back to the store
        self._ring_horizon = 0  # guarded-by: self._cond
        # unindexed watchers: (prefix, stream, clauses|None). Clauses,
        # when present, pre-filter fan-out (deliver only events whose
        # current OR previous object matches — a superset of what the
        # downstream WatchResponse translation emits, so correctness is
        # unchanged; only wasted queue puts disappear).
        self._watchers: List[Tuple[str, WatchStream, Optional[list]]] = []  # guarded-by: self._cond
        # interest index: index-field value -> [(prefix, stream)].
        # Registered here instead of _watchers when the watcher's
        # selector pins index_field to a known value set.
        self._interest: Dict[str, List[Tuple[str, WatchStream]]] = {}  # guarded-by: self._cond
        self.healthy = False
        self._stopped = False
        self._feed_stream = None
        # weakref-safe: tracking must not pin an orphaned cacher alive
        # (the feed thread already holds it only weakly so test churn
        # can collect discarded apiservers' caches)
        _races.track(self, "storage.Cacher")
        self._start()

    # -- feed ----------------------------------------------------------------

    def _start(self) -> None:
        entries, rv, stream = self.store.watch_bootstrap(self.prefix)
        with self._cond:
            self._snap = {
                key: _Entry(mod_rv, obj, blob)
                for key, obj, mod_rv, blob in entries
            }
            self._rv = rv
            self._ring_horizon = rv
            self.healthy = True
        self._feed_stream = stream
        # the thread holds only a WEAK ref to the cacher: an apiserver
        # discarded without an explicit stop() (test churn) must not pin
        # its caches alive forever — once the cacher is collected, the
        # next idle tick stops the feed stream and exits the thread
        import weakref

        threading.Thread(
            target=_feed_entry, args=(weakref.ref(self), stream),
            daemon=True,
            name=f"watch-cache{self.prefix.rstrip('/')}",
        ).start()

    def _drain_watchers_locked(self) -> List[WatchStream]:
        """Detach and return every downstream stream (both registries),
        deduplicated. Caller holds self._cond."""
        streams = [s for _p, s, _c in self._watchers]
        seen = set(map(id, streams))
        for entries in self._interest.values():
            for _p, s in entries:
                if id(s) not in seen:
                    seen.add(id(s))
                    streams.append(s)
        del self._watchers[:]
        self._interest.clear()
        return streams

    def stop(self) -> None:
        # monotonic shutdown flag: the feed thread polls it unlocked
        # and tolerates one stale batch  # race: allow[monotonic shutdown flag]
        self._stopped = True
        if self._feed_stream is not None:
            self._feed_stream.stop()
        with self._cond:
            self.healthy = False
            watchers = self._drain_watchers_locked()
            self._cond.notify_all()
        for w in watchers:
            w.stop()

    def _feed_dead(self) -> None:
        """Feed gone (store watch overflowed, errored, or stopped):
        mark unhealthy so reads fall back to the store, and terminate
        downstream watchers into a relist."""
        with self._cond:
            self.healthy = False
            watchers = self._drain_watchers_locked()
            self._cond.notify_all()
        for s in watchers:
            with s._cond:
                if not s._stopped:
                    s._overflow_locked(self._rv, 0)

    @staticmethod
    def _event_refs(ev):
        """-> (cur, prev) read-only object refs for fan-out routing.
        Uses the store's match refs when present so a routing decision
        never pays a lazy decode."""
        cur = getattr(ev, "match_object", None)
        if cur is None:
            cur = ev.object
        prev = getattr(ev, "match_prev", None)
        if prev is None and ev.type != "ADDED":
            prev = ev.prev_object
        return cur, prev

    @classmethod
    def _event_matches(cls, ev, clauses) -> bool:
        """Fan-out pre-filter: does the event's current OR previous
        object match the field clauses? A superset of what the
        downstream selector-transition translation emits (entering and
        leaving the filter both touch one side), so pruning on it drops
        only events the WatchResponse would have discarded anyway."""
        cur, prev = cls._event_refs(ev)
        if cur is not None and matches_fields(cur, clauses):
            return True
        return prev is not None and matches_fields(prev, clauses)

    @classmethod
    def _event_field_values(cls, ev, field):
        """-> (current value, previous value) of the index field."""
        cur, prev = cls._event_refs(ev)
        vc = lookup_field(cur, field) if cur is not None else ""
        if prev is None or prev is cur:
            return vc, vc
        return vc, lookup_field(prev, field)

    @staticmethod
    def _route(targets, prefix, stream, ev) -> None:
        """Append ev to stream's pending burst (order-preserving; a
        stream indexed under both the event's current and previous
        field values must still receive the event once)."""
        ent = targets.get(id(stream))
        if ent is None:
            targets[id(stream)] = (stream, [ev])
        else:
            evs = ent[1]
            if not evs or evs[-1] is not ev:
                evs.append(ev)

    def _apply_batch(self, batch) -> None:
        """Apply a burst of store events to the snapshot + ring and fan
        it out. Runs on the feed thread only. Routing happens under the
        lock (index lookups + match-ref reads only); envelope building
        and delivery happen after release."""
        evicted = pruned = 0
        targets: Dict[int, tuple] = {}  # id(stream) -> (stream, [ev])
        with self._cond:
            for ev in batch:
                if ev.type == ERROR:
                    raise RuntimeError("store watch overflowed")
                key = getattr(ev, "key", "")
                proto = ev if isinstance(ev, _LazyEvent) else None
                if key:
                    if ev.type == "DELETED":
                        self._snap.pop(key, None)
                    else:
                        self._snap[key] = _Entry(
                            ev.resource_version,
                            ev.match_object if proto is not None
                            else ev.object,
                            proto.tlv_obj_blob if proto is not None
                            else None,
                            proto.wire_cache if proto is not None
                            else None,
                        )
                if proto is not None:
                    if len(self._ring) == self._ring.maxlen:
                        self._ring_horizon = (
                            self._ring[0].resource_version
                        )
                        evicted += 1
                    self._ring.append(proto)
                else:
                    # uncachable payload: the ring would replay a shared
                    # mutable object; advance the horizon past it
                    self._ring_horizon = ev.resource_version
                self._rv = batch[-1].resource_version
                # -- routing --
                for prefix, stream, clauses in self._watchers:
                    if not key.startswith(prefix):
                        continue
                    if clauses is not None and not self._event_matches(
                        ev, clauses
                    ):
                        pruned += 1
                        continue
                    self._route(targets, prefix, stream, ev)
                if self._interest:
                    vc, vp = self._event_field_values(ev, self.index_field)
                    hit = self._interest.get(vc)
                    if hit:
                        for prefix, stream in hit:
                            if key.startswith(prefix):
                                self._route(targets, prefix, stream, ev)
                    if vp != vc:
                        hit = self._interest.get(vp)
                        if hit:
                            for prefix, stream in hit:
                                if key.startswith(prefix):
                                    self._route(targets, prefix, stream,
                                                ev)
            self._cond.notify_all()
        if evicted:
            _evicted(evicted)
        if pruned:
            _pruned(pruned)
        for stream, evs in targets.values():
            # per-watcher envelopes: lazy events refan (shared blob,
            # private decode); plain fallback events get fresh deep
            # copies so no two watchers share a mutable object
            burst = [
                (ev.refan() if isinstance(ev, _LazyEvent)
                 else WatchEvent(ev.type, deep_copy(ev.object),
                                 ev.resource_version,
                                 deep_copy(ev.prev_object), key=ev.key))
                for ev in evs
            ]
            stream._deliver_many(burst)

    # -- consistency ---------------------------------------------------------

    def _fresh_target(self) -> int:
        """The freshness bar for a read arriving NOW: the rv of the
        last commit under THIS cacher's prefix (stamped lock-free on
        the feed stream by the store). NOT the store's global rv — a
        quiet resource would never catch up to other resources' writes
        and every read would stall into the fallback."""
        # write-once publication: _start sets the stream before the
        # cacher escapes _cacher_for's lock; the reference read is
        # GIL-atomic  # race: allow[write-once publication]
        return self._feed_stream._progress_rv

    def wait_fresh(self, rv: int, timeout: float = 5.0) -> bool:
        """Block until the cache has processed resourceVersion >= rv
        (cacher.go waitUntilFreshAndBlock). False = timed out or
        unhealthy; the caller falls back to the store."""
        import time as _time

        with self._cond:
            deadline = _time.monotonic() + timeout
            while self.healthy and self._rv < rv:
                left = deadline - _time.monotonic()
                if left <= 0 or not self._cond.wait(timeout=left):
                    break
            return self.healthy and self._rv >= rv

    # -- reads ---------------------------------------------------------------

    def list_entries(self, prefix: str) -> Optional[Tuple[List[_Entry], int]]:
        """All entries under `prefix` (must extend self.prefix) at a
        resourceVersion at least as fresh as the store's current one.
        None = cache can't serve (caller falls back; miss counted)."""
        # racy healthy fast-path: a stale read only costs one store
        # fallback or a wasted wait; settled under _cond by wait_fresh
        if not self.healthy:  # race: allow[racy healthy fast-path]
            _miss()
            return None
        target = self._fresh_target()
        if not self.wait_fresh(target):
            _miss()
            return None
        with self._cond:
            out = [
                e for k, e in sorted(self._snap.items())
                if k.startswith(prefix)
            ]
            rv = self._rv
        _hit()
        return out, rv

    def get_entry(self, key: str) -> Optional[_Entry]:
        """The entry for `key`, fresh per wait_fresh; raises KeyNotFound
        for a genuinely absent key, returns None when the cache can't
        serve (fall back; miss counted)."""
        if not self.healthy:  # race: allow[racy healthy fast-path]
            _miss()
            return None
        target = self._fresh_target()
        if not self.wait_fresh(target):
            _miss()
            return None
        with self._cond:
            entry = self._snap.get(key)
            if entry is None:
                _hit()  # a fresh authoritative absence IS a cache answer
                raise KeyNotFound(key)
        _hit()
        return entry

    # -- watch ---------------------------------------------------------------

    def watch(self, prefix: str, from_rv: int = 0,
              clauses: Optional[list] = None) -> Optional[WatchStream]:
        """A watch stream served from the cache's ring + fan-out.
        from_rv==0 means "from now" (freshness-synced with the store so
        a client that just wrote sees only what follows its write).
        None = the requested window predates the ring (fall back to the
        store, which replays its own history or raises Compacted).

        clauses (parsed field-selector clauses) turn on fan-out
        pre-filtering: when they pin index_field to a known value set
        the stream registers in the interest index (delivery cost
        O(matching events)); otherwise events are pre-matched against
        the clauses on the feed thread. Either way the stream receives
        a SUPERSET of what the downstream translation emits — the
        WatchResponse filter stays authoritative."""
        if not self.healthy:  # race: allow[racy healthy fast-path]
            _miss()
            return None
        if from_rv == 0:
            # "from now": sync to the store head so no event the store
            # already committed is double-delivered after registration
            if not self.wait_fresh(self._fresh_target()):
                _miss()
                return None
        else:
            # resume-from-rv: the feed must have processed everything
            # at or below from_rv BEFORE replay+registration, or the
            # pending backlog would fan out to this watcher afterwards
            # and deliver events <= from_rv the client already has
            # (cacher.go waitUntilFreshAndBlock; the min() keeps a
            # global-rv target from a store-fallback list from waiting
            # past this prefix's last commit)
            if not self.wait_fresh(min(from_rv, self._fresh_target())):
                _miss()
                return None
        with self._cond:
            if not self.healthy:
                _miss()
                return None
            if from_rv and from_rv < self._ring_horizon:
                if from_rv < self.store._compacted_rv:
                    # answer directly: the store would say the same
                    _hit()
                    raise Compacted(
                        f"requested {from_rv}, horizon "
                        f"{self.store._compacted_rv}"
                    )
                _miss()
                return None
            stream = WatchStream(self)
            if from_rv:
                for proto in self._ring:
                    if (proto.resource_version > from_rv
                            and proto.key.startswith(prefix)):
                        if clauses and not self._event_matches(proto,
                                                               clauses):
                            continue
                        stream._deliver(proto.refan())
            interest = (
                interest_values(clauses, self.index_field)
                if clauses and self.index_field else None
            )
            if interest is not None:
                # remembered on the stream so removal touches only its
                # own buckets, not the whole index
                stream._interest_keys = interest
                for v in interest:
                    self._interest.setdefault(v, []).append(
                        (prefix, stream)
                    )
            else:
                self._watchers.append(
                    (prefix, stream, list(clauses) if clauses else None)
                )
        _hit()
        return stream

    def _remove_watcher(self, stream: WatchStream) -> None:
        with self._cond:
            keys = getattr(stream, "_interest_keys", None)
            if keys is not None:
                for v in keys:
                    entries = self._interest.get(v)
                    if not entries:
                        continue
                    kept = [(p, s) for p, s in entries if s is not stream]
                    if kept:
                        self._interest[v] = kept
                    else:
                        del self._interest[v]
            else:
                self._watchers = [
                    (p, s, c) for p, s, c in self._watchers
                    if s is not stream
                ]


def _feed_entry(ref, stream) -> None:
    """The feed thread body. Holds the cacher only through `ref`
    between events, so an orphaned cacher is collectable; gulps event
    bursts so a batch commit costs one lock round-trip per watcher."""
    while True:
        try:
            batch = stream.next_events(max_n=4096, timeout=10.0)
        except TimeoutError:
            if ref() is None:
                stream.stop()
                return
            continue
        if batch is None:  # stream stopped
            cacher = ref()
            if cacher is not None and not cacher._stopped:
                cacher._feed_dead()
            return
        ended = batch[-1] is None
        if ended:
            batch.pop()
        cacher = ref()
        if cacher is None:
            stream.stop()
            return
        try:
            if batch:
                cacher._apply_batch(batch)
            if ended or cacher._stopped:
                if not cacher._stopped:
                    cacher._feed_dead()
                return
        except Exception:
            log.exception("watch cache feed failed for %s",
                          cacher.prefix)
            cacher._feed_dead()
            stream.stop()
            return
        del cacher
