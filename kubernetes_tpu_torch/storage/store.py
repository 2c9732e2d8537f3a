"""Versioned key-value store with watch (storage.Interface equivalent).

Contract surface mirrored from pkg/storage/interfaces.go:82-142:
Create / Get / List / GuaranteedUpdate / Delete / Watch(+prefix), all
keyed on resourceVersion. Event history is a bounded ring (the etcd3
compaction + cacher.go watch-window analogue): watching from a version
older than the horizon raises Compacted, which the reflector answers
with a fresh list (reflector.go ListAndWatch).

Objects are stored as deep copies and handed out as deep copies —
callers can mutate freely, like decoding fresh bytes from etcd.

Copy of kubernetes_tpu/storage/store.py: only the import package differs.
"""

from __future__ import annotations

import copy
import pickle
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from kubernetes_tpu_torch.analysis import races as _races

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"
ERROR = "ERROR"

#: sentinel a batch mutation fn may return to DELETE its key inside the
#: same transaction (the /api/v1/batch "delete" op rides the wave
#: commit's one-lock/one-WAL-append/one-burst contract)
DELETE_OBJECT = object()




def deep_copy(obj):
    """Deep copy through the native TLV codec when possible (~2x faster
    than pickle for the dataclass object graphs stored here — and every
    store write/read makes one: the decode-fresh-bytes-from-etcd
    illusion). Uses the STRICT encoder, which punts tuple-containing
    graphs to pickle, so copies are full-fidelity regardless of whether
    the C extension built (the wire dispatcher, not this helper, owns
    tuple->list normalization). Payloads the wire can't carry fall back
    to pickle, then copy.deepcopy. Shared isolation-copy helper (the
    apiserver's object-protocol boundary uses it too)."""
    c = _tlv_native()
    if c is not None:
        try:
            return c.loads(c.dumps_strict(obj))
        except Exception:
            pass  # Fallback (tuples, exotic payload) or unknown class
    try:
        return pickle.loads(pickle.dumps(obj, pickle.HIGHEST_PROTOCOL))
    except Exception:
        return copy.deepcopy(obj)


_TLV_NATIVE = None


def _tlv_native():
    """The C TLV codec, resolved lazily (imports api.types at first
    registry build — not something a storage import should force)."""
    global _TLV_NATIVE
    if _TLV_NATIVE is None:
        try:
            from kubernetes_tpu_torch.runtime import tlv as _t

            _TLV_NATIVE = _t._ktlv if _t._ktlv is not None else False
        except Exception:
            _TLV_NATIVE = False
    return _TLV_NATIVE or None


_dc = deep_copy



class StorageError(Exception):
    pass


class KeyNotFound(StorageError):
    pass


class KeyExists(StorageError):
    pass


class Conflict(StorageError):
    """resourceVersion precondition failed (optimistic concurrency)."""


class Compacted(StorageError):
    """Requested watch window is older than the retained history."""


class _LazyEvent:
    """A delivered watch event whose (object, prev_object) unpickle on
    first access. The store serializes each committed event ONCE and
    every watcher deserializes its own private copy on receipt — halving
    the per-watcher deep-copy cost of fan-out while keeping the
    decode-fresh-bytes isolation (no two watchers share an object).

    match_object/match_prev are READ-ONLY references to the store's own
    (immutable-after-write) objects, for selector filtering without an
    unpickle: a filtered-out event then costs the fan-out queue put and
    nothing else. They must never be handed to a consumer."""

    __slots__ = ("type", "resource_version", "_blob", "_pair", "_codec",
                 "match_object", "match_prev", "wire_cache", "key")

    def __init__(self, ev_type: str, rv: int, blob,
                 match_object=None, match_prev=None, wire_cache=None,
                 codec: str = "pickle", key: str = ""):
        self.type = ev_type
        self.resource_version = rv
        self.key = key
        # codec "tlv": blob is (obj_tlv_bytes, prev_tlv_bytes|None) —
        # two self-contained TLV values, so binary watch frontends can
        # splice obj_tlv_bytes into the wire verbatim (zero per-watcher
        # re-encode). codec "pickle": one pickled (obj, prev) pair.
        self._blob = blob
        self._pair = None
        self._codec = codec
        self.match_object = match_object
        self.match_prev = match_prev
        # per-COMMIT wire-encoding memo ({codec id: wire dict}): one
        # dict is created in _record and shared by every watcher's
        # event copy, so N wire watchers pay ONE reflective encode per
        # commit (the payload is read-only downstream; obj_mode
        # watchers never touch it, keeping their object isolation)
        self.wire_cache = wire_cache if wire_cache is not None else {}

    @property
    def tlv_obj_blob(self):
        """The object's self-contained TLV bytes, or None (non-TLV
        payload). Read-only wire splice for binary watch frontends."""
        return self._blob[0] if self._codec == "tlv" else None

    @property
    def tlv_prev_blob(self):
        """prev_object's self-contained TLV bytes, or None."""
        return self._blob[1] if self._codec == "tlv" else None

    def refan(self, wire_cache=None):
        """A fresh per-watcher copy of this event sharing the one
        commit-time blob (and, by default, the one wire-encoding memo):
        the cacher's fan-out hands each downstream watcher its own lazy
        envelope so no two consumers share a decoded object."""
        return _LazyEvent(
            self.type, self.resource_version, self._blob,
            self.match_object, self.match_prev,
            wire_cache=self.wire_cache if wire_cache is None else wire_cache,
            codec=self._codec, key=self.key,
        )

    def _unpack(self):
        if self._pair is None:
            if self._codec == "tlv":
                c = _tlv_native()
                oblob, pblob = self._blob
                self._pair = (
                    c.loads(oblob),
                    c.loads(pblob) if pblob is not None else None,
                )
            else:
                self._pair = pickle.loads(self._blob)
        return self._pair

    @property
    def object(self):
        return self._unpack()[0]

    @property
    def prev_object(self):
        return self._unpack()[1]


@dataclass
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED | ERROR
    object: Any
    resource_version: int
    # Previous value on MODIFIED/DELETED (the etcd prevNode): selector-
    # filtered watches need it to translate transitions in/out of the
    # filter into ADDED/DELETED (pkg/storage/etcd/etcd_watcher.go
    # sendModify).
    prev_object: Any = None
    # TLV bytes of object/prev_object when the commit path already has
    # them (the store's per-entry blob cache): _record then skips its
    # own encode entirely. None = encode on demand.
    obj_blob: Optional[bytes] = None
    prev_blob: Optional[bytes] = None
    # the store key the event committed under (the watch cache keys its
    # snapshot by it; empty on synthetic events like ERROR)
    key: str = ""


class WatchStream:
    """One watcher's event channel. Iterate to receive events; stop() to
    cancel. The store never blocks on a slow watcher: a full channel
    terminates the watch with ERROR, and the client relists — exactly the
    cacher.go "terminate blocked watchers" strategy (cacher.go:terminate).

    Hand-rolled deque+condition instead of queue.Queue: _deliver runs
    once per watcher per commit on the write hot path, and Queue's
    three-condition bookkeeping measured ~2x the cost of the append it
    wraps at density-burst rates."""

    # capacity sizes the burst a slow watcher may lag behind before the
    # store terminates it into a relist. Wave-bulk binding commits tens
    # of thousands of writes in one burst; queue entries are tiny (shared
    # lazy blobs), so a deep queue is far cheaper than the relist storm
    # an overflow triggers.
    def __init__(self, store, capacity: int = 65536):
        from collections import deque

        self._dq: deque = deque()
        self._capacity = capacity
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # any owner with a _remove_watcher(stream) method (the store, or
        # the apiserver watch cache fanning one store watch out)
        self._store = store
        self._stopped = False
        # resourceVersion of the last commit MATCHING this stream's
        # prefix (stamped by the store under its lock; read lock-free —
        # an int attribute write is atomic). The watch cache's
        # freshness target: a cache is fresh when it has processed up
        # to here, NOT up to the store's global rv — resources with no
        # recent writes would otherwise never look fresh (the etcd
        # progress-notify analogue).
        self._progress_rv = 0

    def _overflow_locked(self, rv: int, undelivered: int) -> None:
        """Slow-watcher policy (cacher.go blocked-watcher termination):
        drop the backlog, count the drops, terminate the stream with
        ERROR so the client relists. Undelivered events are
        unrecoverable anyway — the consumer must resync from a fresh
        List (the reflector translates the ERROR into a relist)."""
        from kubernetes_tpu_torch.metrics import storage_watch_events_dropped_total

        storage_watch_events_dropped_total.inc(len(self._dq) + undelivered)
        self._dq.clear()
        self._dq.append(WatchEvent(ERROR, None, rv))
        self._dq.append(None)
        self._stopped = True
        self._cond.notify_all()

    def _deliver(self, ev: WatchEvent) -> None:
        cond = self._cond
        with cond:
            if self._stopped:
                return
            if len(self._dq) >= self._capacity:
                self._overflow_locked(ev.resource_version, 1)
            else:
                self._dq.append(ev)
                cond.notify()
                return
        self._store._remove_watcher(self)

    def _deliver_many(self, evs) -> None:
        """Deliver a commit burst under ONE lock acquisition — a bulk
        bind used to pay one condition round-trip per event per watcher,
        which was a measurable slice of the batch-commit window."""
        if not evs:
            return
        cond = self._cond
        with cond:
            if self._stopped:
                return
            if len(self._dq) + len(evs) > self._capacity:
                self._overflow_locked(evs[-1].resource_version, len(evs))
            else:
                self._dq.extend(evs)
                cond.notify()
                return
        self._store._remove_watcher(self)

    def stop(self) -> None:
        with self._cond:
            if self._stopped:
                return
            self._stopped = True
            self._dq.append(None)
            self._cond.notify_all()
        self._store._remove_watcher(self)

    def __iter__(self) -> Iterator[WatchEvent]:
        while True:
            ev = self.next_event()
            if ev is None:
                return
            yield ev

    def next_event(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        """Blocking single-event read. None = the stream stopped; raises
        TimeoutError on timeout (distinguishing idle from stopped)."""
        with self._cond:
            while not self._dq:
                if not self._cond.wait(timeout=timeout):
                    raise TimeoutError
            ev = self._dq.popleft()
            if ev is None:
                self._dq.append(None)  # keep the sentinel for peers
            return ev

    def next_events(
        self, max_n: int = 0, timeout: Optional[float] = None
    ) -> Optional[List[Optional[WatchEvent]]]:
        """Drain every queued event (up to `max_n` when non-zero) under
        ONE condition acquisition. A burst consumer popping events one
        at a time pays a lock round-trip — under producer contention a
        futex syscall — PER EVENT; a 90k-event storm made that the
        single hottest slice of the apiserver's fan-out CPU. Returns
        None when the stream stopped with nothing queued; otherwise a
        list of events whose last element is None if the stream stopped
        behind them. Raises TimeoutError like next_event."""
        with self._cond:
            while not self._dq:
                if not self._cond.wait(timeout=timeout):
                    raise TimeoutError
            out: List[Optional[WatchEvent]] = []
            while self._dq and (not max_n or len(out) < max_n):
                ev = self._dq.popleft()
                if ev is None:
                    self._dq.append(None)  # keep the sentinel for peers
                    if not out:
                        return None
                    out.append(None)
                    break
                out.append(ev)
            return out


class MemoryStore:
    """The single source of truth (the framework's "etcd")."""

    def __init__(self, history_size: int = 8192):
        self._lock = threading.RLock()
        self._data: Dict[str, Tuple[Any, int]] = {}  # guarded-by: self._lock
        self._rv = 0  # guarded-by: self._lock
        self._history: List[Tuple[str, WatchEvent]] = []  # guarded-by: self._lock
        self._history_size = history_size
        self._compacted_rv = 0  # guarded-by: self._lock
        self._watchers: List[Tuple[str, WatchStream]] = []  # guarded-by: self._lock
        # key -> TLV bytes of the stored object, encoded ONCE at commit.
        # Serves three consumers that each used to encode on their own:
        # watch fan-out (the event's obj blob), the NEXT commit's
        # prev-object blob, and read-path isolation copies (loads(blob)
        # instead of a dumps+loads round trip). Entries exist only for
        # objects the strict codec can carry; absent = legacy path.
        self._tlv_blobs: Dict[str, bytes] = {}  # guarded-by: self._lock
        _races.track(self, f"storage.{type(self).__name__}")

    # -- reads ---------------------------------------------------------------

    @property
    def current_rv(self) -> int:
        with self._lock:
            return self._rv

    @staticmethod
    def _loads_or_dc(blob: Optional[bytes], obj):
        """One decode from the commit blob when possible, else the full
        deep copy — the single owner of that fallback contract."""
        if blob is not None:
            c = _tlv_native()
            if c is not None:
                try:
                    return c.loads(blob)
                except Exception:
                    pass
        return _dc(obj)

    def _copy_of(self, key: str, obj):
        """Isolation copy of a stored object — from its cached commit
        blob (one decode) when available, else the full deep copy."""
        return self._loads_or_dc(self._tlv_blobs.get(key), obj)

    def get(self, key: str) -> Tuple[Any, int]:
        with self._lock:
            if key not in self._data:
                raise KeyNotFound(key)
            obj, rv = self._data[key]
            return self._copy_of(key, obj), rv

    def list(self, prefix: str) -> Tuple[List[Any], int]:
        """All objects under prefix plus the store's current version (the
        List + resourceVersion pair the reflector records)."""
        with self._lock:
            out = [
                self._copy_of(key, obj)
                for key, (obj, _) in sorted(self._data.items())
                if key.startswith(prefix)
            ]
            return out, self._rv

    def scan_refs(self, prefix: str) -> List[Tuple[str, Any]]:
        """(key, LIVE object ref) pairs under prefix — no isolation
        copy, no TLV decode. For read-only metadata sweeps (the event
        TTL GC reads one timestamp per object): list() pays a full
        decode per object, which at a 30k-event population made each
        sweep cost ~1s of the create-storm window. Callers MUST NOT
        mutate the returned objects."""
        with self._lock:
            return [(key, obj) for key, (obj, _) in self._data.items()
                    if key.startswith(prefix)]

    # -- writes --------------------------------------------------------------

    def _next_rv(self) -> int:  # guarded-by: self._lock
        self._rv += 1
        return self._rv

    def _append_history(self, key: str, ev: WatchEvent) -> None:  # guarded-by: self._lock
        self._history.append((key, ev))
        if len(self._history) > self._history_size:
            drop = len(self._history) - self._history_size
            self._compacted_rv = self._history[drop - 1][1].resource_version
            del self._history[:drop]

    def _encode_fanout(self, ev: WatchEvent):
        """-> (blob, codec) for the one shared lazy fan-out payload.
        codec "tlv": blob is (obj_tlv, prev_tlv|None); "pickle": one
        pickled pair. Empty blob = unencodable (deliver deep copies).
        Strict TLV: obj_mode watchers get the same fidelity the pickle
        path would give; the commit path usually hands the blobs in
        (encoded once into _tlv_blobs)."""
        c = _tlv_native()
        if c is not None:
            try:
                oblob = ev.obj_blob
                if oblob is None:
                    oblob = c.dumps_strict(ev.object)
                if ev.prev_object is None:
                    pblob = None
                elif ev.prev_object is ev.object:
                    pblob = oblob  # DELETED: same object
                elif ev.prev_blob is not None:
                    pblob = ev.prev_blob
                else:
                    pblob = c.dumps_strict(ev.prev_object)
                return (oblob, pblob), "tlv"
            except Exception:
                pass
        try:
            return pickle.dumps(
                (ev.object, ev.prev_object), pickle.HIGHEST_PROTOCOL
            ), "pickle"
        except Exception:
            return b"", "pickle"

    def _fanout_proto(self, key: str, ev: WatchEvent):
        """The template _LazyEvent every matching watcher gets a refan()
        of, or None when the payload defies both codecs (the per-watcher
        deep-copy fallback applies)."""
        blob, codec = self._encode_fanout(ev)
        if not blob:
            return None
        return _LazyEvent(ev.type, ev.resource_version, blob,
                          ev.object, ev.prev_object, wire_cache={},
                          codec=codec, key=key)

    def _fallback_event(self, key: str, ev: WatchEvent) -> WatchEvent:
        return WatchEvent(ev.type, _dc(ev.object), ev.resource_version,
                          _dc(ev.prev_object), key=key)

    def _record(self, key: str, ev: WatchEvent) -> None:  # guarded-by: self._lock
        ev.key = key
        self._append_history(key, ev)
        proto = unencodable = None
        for prefix, stream in list(self._watchers):
            if key.startswith(prefix):
                if proto is None and unencodable is None:
                    proto = self._fanout_proto(key, ev)
                    unencodable = proto is None
                stream._deliver(
                    proto.refan() if proto is not None
                    else self._fallback_event(key, ev)
                )
                stream._progress_rv = ev.resource_version

    def _record_batch(self, items) -> None:  # guarded-by: self._lock
        """_record for a commit burst: history appended per event,
        compaction once, and each watcher receives its whole matching
        burst in ONE delivery (one lock acquisition per watcher per
        batch instead of per event)."""
        protos: List = []
        for key, ev in items:
            ev.key = key
            self._history.append((key, ev))
            protos.append(
                (key, self._fanout_proto(key, ev) if self._watchers
                 else None, ev)
            )
        if len(self._history) > self._history_size:
            drop = len(self._history) - self._history_size
            self._compacted_rv = self._history[drop - 1][1].resource_version
            del self._history[:drop]
        for prefix, stream in list(self._watchers):
            burst = []
            last_rv = 0
            for key, proto, ev in protos:
                if key.startswith(prefix):
                    burst.append(
                        proto.refan() if proto is not None
                        else self._fallback_event(key, ev)
                    )
                    last_rv = ev.resource_version
            stream._deliver_many(burst)
            if last_rv:
                stream._progress_rv = last_rv

    def create(self, key: str, obj: Any, owned: bool = False) -> int:
        """owned=True: the caller transfers ownership of obj (it already
        made an isolation copy and keeps no reference) so the store can
        skip its write copy — the apiserver's decode/copy boundary
        qualifies."""
        with self._lock:
            if key in self._data:
                raise KeyExists(key)
            rv = self._next_rv()
            stored = obj if owned else _dc(obj)
            self._set_rv(stored, rv)
            self._data[key] = (stored, rv)
            oblob = self._encode_blob(key, stored)
            self._record(key, WatchEvent(ADDED, stored, rv,
                                         obj_blob=oblob))
            return rv

    def create_batch(self, items) -> List[Optional[Exception]]:
        """create() for a list of (key, obj) as ONE transaction: one
        lock acquisition, one WAL append, one watch-event burst per
        watcher — the bulk-create endpoint commits hundreds of objects
        per request, and per-item lock/condition churn under a parallel
        create storm was a measured convoy. Ownership of every obj
        transfers to the store (the bulk endpoint's decode boundary
        qualifies); per-item isolation: each item succeeds or fails
        (KeyExists) independently."""
        out: List[Optional[Exception]] = []
        events: List = []
        with self._lock:
            for key, obj in items:
                try:
                    if key in self._data:
                        raise KeyExists(key)
                    rv = self._next_rv()
                    self._set_rv(obj, rv)
                    self._data[key] = (obj, rv)
                    oblob = self._encode_blob(key, obj)
                    events.append(
                        (key, WatchEvent(ADDED, obj, rv,
                                         obj_blob=oblob, key=key))
                    )
                    out.append(None)
                except Exception as e:
                    out.append(e)
            if events:
                self._record_batch(events)
        return out

    def _encode_blob(self, key: str, stored) -> Optional[bytes]:  # guarded-by: self._lock
        """Encode the committed object once; cache under key. None when
        the strict codec can't carry it (the legacy paths then apply)."""
        c = _tlv_native()
        if c is not None:
            try:
                blob = c.dumps_strict(stored)
                self._tlv_blobs[key] = blob
                return blob
            except Exception:
                pass
        self._tlv_blobs.pop(key, None)
        return None

    def _apply_update(self, key: str, obj: Any,  # guarded-by: self._lock
                      expect_rv: Optional[int] = None,
                      owned: bool = False):
        """Commit an update under the ALREADY-HELD lock without
        recording it; -> (rv, the MODIFIED WatchEvent). update() records
        immediately; update_batch() collects a burst first."""
        if key not in self._data:
            raise KeyNotFound(key)
        prev, cur = self._data[key]
        if expect_rv is not None and expect_rv != cur:
            raise Conflict(f"{key}: rv {expect_rv} != current {cur}")
        rv = self._next_rv()
        stored = obj if owned else _dc(obj)
        self._set_rv(stored, rv)
        pblob = self._tlv_blobs.get(key)
        self._data[key] = (stored, rv)
        oblob = self._encode_blob(key, stored)
        return rv, WatchEvent(MODIFIED, stored, rv, prev,
                              obj_blob=oblob, prev_blob=pblob, key=key)

    def update(self, key: str, obj: Any, expect_rv: Optional[int] = None,
               owned: bool = False) -> int:
        with self._lock:
            rv, ev = self._apply_update(key, obj, expect_rv, owned)
            self._record(key, ev)
            return rv

    def guaranteed_update(
        self,
        key: str,
        fn: Callable[[Any], Any],
        ignore_not_found: bool = False,
    ) -> int:
        """Retry loop applying fn to the latest value (interfaces.go:126
        GuaranteedUpdate). Under one process-wide lock the first attempt
        always wins, but the shape is kept so callers are written
        correctly. fn returning None aborts without writing."""
        with self._lock:
            if key not in self._data:
                if not ignore_not_found:
                    raise KeyNotFound(key)
                cur = None
            else:
                cur = self._copy_of(key, self._data[key][0])
            new = fn(cur)
            if new is None:
                return self._rv
            # fn returning the copy it was handed (the normal in-place
            # mutate) transfers ownership; any other object may still be
            # referenced by the caller and gets the defensive copy
            owned = new is cur
            if key in self._data:
                return self.update(key, new, owned=owned)
            return self.create(key, new, owned=owned)

    def update_batch(self, ops) -> List[Optional[Exception]]:
        """guaranteed_update semantics for a list of (key, fn) as ONE
        transaction: one lock acquisition, one WAL append (FileStore
        overrides _record_batch), one watch-event burst per watcher —
        the wave-bulk bind commits thousands of per-pod updates back to
        back, and per-item lock/condition churn was a measurable slice
        of the window. Per-item isolation: each item succeeds or fails
        independently — ANY exception (a StorageError or a raising
        mutation fn) stays with its item, so one bad mutation in a bulk
        bind can't 500 the whole BindingList.

        An op may be (key, fn) or (key, fn, copier). A copier replaces
        the generic isolation copy (a full TLV decode of the stored
        blob, ~30us/object) with a caller-supplied SPINE copy that
        clones exactly the layers `fn` mutates and shares the rest with
        the stored read-only object — legal because stored objects are
        never mutated in place (every write path makes its own copy
        first) and fan-out treats them as read-only refs. The batched
        bind door uses this: the assign mutation touches only
        spec.node_name, status.conditions, and metadata."""
        out: List[Optional[Exception]] = []
        events: List = []
        with self._lock:
            for op in ops:
                key, fn = op[0], op[1]
                copier = op[2] if len(op) > 2 else None
                try:
                    if key not in self._data:
                        raise KeyNotFound(key)
                    cur = (copier(self._data[key][0])
                           if copier is not None
                           else self._copy_of(key, self._data[key][0]))
                    new = fn(cur)
                    if new is None:
                        out.append(None)
                        continue
                    if new is DELETE_OBJECT:
                        obj, _cur_rv = self._data.pop(key)
                        blob = self._tlv_blobs.pop(key, None)
                        rv = self._next_rv()
                        events.append((key, WatchEvent(
                            DELETED, obj, rv, obj,
                            obj_blob=blob, prev_blob=blob, key=key,
                        )))
                        out.append(None)
                        continue
                    _rv, ev = self._apply_update(key, new,
                                                 owned=new is cur)
                    events.append((key, ev))
                    out.append(None)
                except Exception as e:
                    out.append(e)
            if events:
                self._record_batch(events)
        return out

    def delete(self, key: str, expect_rv: Optional[int] = None) -> Any:
        with self._lock:
            if key not in self._data:
                raise KeyNotFound(key)
            obj, cur = self._data[key]
            if expect_rv is not None and expect_rv != cur:
                raise Conflict(f"{key}: rv {expect_rv} != current {cur}")
            del self._data[key]
            blob = self._tlv_blobs.pop(key, None)
            rv = self._next_rv()
            self._record(key, WatchEvent(DELETED, obj, rv, obj,
                                         obj_blob=blob, prev_blob=blob))
            return self._loads_or_dc(blob, obj)

    # -- watch ---------------------------------------------------------------

    def watch(self, prefix: str, from_rv: int = 0) -> WatchStream:
        """Events for keys under prefix with resource_version > from_rv.
        from_rv==0 means "from now". Raises Compacted when the window is
        gone — the caller must relist."""
        with self._lock:
            if from_rv and from_rv < self._compacted_rv:
                raise Compacted(
                    f"requested {from_rv}, horizon {self._compacted_rv}"
                )
            stream = WatchStream(self)
            if from_rv:
                for key, ev in self._history:
                    if ev.resource_version > from_rv and key.startswith(prefix):
                        stream._deliver(
                            WatchEvent(
                                ev.type,
                                _dc(ev.object),
                                ev.resource_version,
                                _dc(ev.prev_object),
                            )
                        )
            self._watchers.append((prefix, stream))
            return stream

    def watch_bootstrap(self, prefix: str):
        """Atomic snapshot + watch registration for a cache tier (the
        watch cache's feed): under ONE lock acquisition returns
        (entries, rv, stream) where entries are (key, object_ref,
        mod_rv, tlv_blob|None) tuples and stream delivers every event
        with resource_version > rv. The object refs are the store's OWN
        immutable-after-write objects — read-only, never to be handed
        to a consumer without an isolation copy (decode the blob)."""
        with self._lock:
            entries = [
                (k, obj, rv, self._tlv_blobs.get(k))
                for k, (obj, rv) in sorted(self._data.items())
                if k.startswith(prefix)
            ]
            stream = WatchStream(self)
            stream._progress_rv = self._rv
            self._watchers.append((prefix, stream))
            return entries, self._rv, stream

    def _remove_watcher(self, stream: WatchStream) -> None:
        with self._lock:
            self._watchers = [(p, s) for p, s in self._watchers if s is not stream]

    def compact(self, keep_last: int = 0) -> None:
        """Force-drop history (etcd3 compact.go analogue); mainly a test
        hook for the relist path."""
        with self._lock:
            if keep_last >= len(self._history):
                return
            drop = len(self._history) - keep_last
            if drop > 0 and self._history:
                self._compacted_rv = self._history[drop - 1][1].resource_version
                del self._history[:drop]

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def _set_rv(obj: Any, rv: int) -> None:
        meta = getattr(obj, "metadata", None)
        if meta is not None and hasattr(meta, "resource_version"):
            meta.resource_version = str(rv)
