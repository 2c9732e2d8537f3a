"""Watch cache (storage/cacher.py) + wire-path batching tests.

Covers the r06 wire-path overhaul:
  * serve-from-cache vs serve-from-store equivalence (lists, gets,
    watch-from-RV, compaction -> 410-equivalent) — the cacher is a pure
    read-path accelerator and must never change an answer;
  * randomized interleaved writer/watcher fuzz;
  * slow-watcher backpressure policy (drop-with-counter + ERROR stop,
    reflector relists cleanly);
  * batched store commits (one watch burst, one WAL append);
  * HTTPTransport keep-alive pooling, pipelining, and the 8-thread
    hammer regression;
  * per-object audit events for batch commits.

The cases of tests/test_cacher.py, run against the port's copies
(kubernetes_tpu_torch), each with the mark it has there.
"""

from __future__ import annotations

import random
import threading
import time

import pytest

from kubernetes_tpu_torch.api.types import (
    Container,
    Node,
    NodeCondition,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodSpec,
)
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.rest import (
    RESTClient,
    batch_bind_item,
    batch_status_item,
)
from kubernetes_tpu_torch.client.transport import HTTPTransport, LocalTransport
from kubernetes_tpu_torch.storage import Cacher, Compacted, MemoryStore
from kubernetes_tpu_torch.storage.store import WatchStream


def mkpod(name: str, ns: str = "default", labels=None) -> Pod:
    return Pod(
        metadata=ObjectMeta(name=name, namespace=ns,
                            labels=dict(labels or {})),
        spec=PodSpec(containers=[Container(name="c", image="i")]),
    )


def mknode(name: str) -> Node:
    return Node(
        metadata=ObjectMeta(name=name),
        status=NodeStatus(
            allocatable={"cpu": "4", "memory": "32Gi", "pods": "110"},
            conditions=[NodeCondition("Ready", "True")],
        ),
    )


def drain(stream, n, timeout=5.0):
    """Read n events from a watch stream (fails the test on timeout)."""
    out = []
    deadline = time.monotonic() + timeout
    while len(out) < n:
        left = deadline - time.monotonic()
        assert left > 0, f"only {len(out)}/{n} events arrived"
        ev = stream.next_event(timeout=left)
        if ev is None:
            break
        out.append(ev)
    return out


class TestCacherEquivalence:
    def _store_with_pods(self, n=10):
        store = MemoryStore()
        for i in range(n):
            store.create(f"/pods/default/p{i:02d}", mkpod(f"p{i:02d}"))
        return store

    def test_list_matches_store(self):
        store = self._store_with_pods()
        cacher = Cacher(store, "/pods/")
        served = cacher.list_entries("/pods/default/")
        assert served is not None
        entries, rv = served
        objs, store_rv = store.list("/pods/default/")
        assert rv == store_rv
        assert [e.obj.metadata.name for e in entries] == [
            o.metadata.name for o in objs
        ]
        # isolation: cache copies are not the store's objects
        copy = entries[0].isolation_copy()
        copy.metadata.labels["mutated"] = "yes"
        assert "mutated" not in store.get("/pods/default/p00")[0].metadata.labels

    def test_list_sees_writes_after_bootstrap(self):
        """waitUntilFreshAndBlock: a read issued after a write must see
        it, even though the cache is fed asynchronously."""
        store = self._store_with_pods(3)
        cacher = Cacher(store, "/pods/")
        for i in range(20):
            store.create(f"/pods/default/late{i}", mkpod(f"late{i}"))
            served = cacher.list_entries("/pods/default/")
            assert served is not None
            entries, _ = served
            names = {e.obj.metadata.name for e in entries}
            assert f"late{i}" in names, "cache read missed its own write"

    def test_get_matches_store_and_absence(self):
        store = self._store_with_pods(2)
        cacher = Cacher(store, "/pods/")
        e = cacher.get_entry("/pods/default/p01")
        assert e is not None and e.obj.metadata.name == "p01"
        from kubernetes_tpu_torch.storage import KeyNotFound

        with pytest.raises(KeyNotFound):
            cacher.get_entry("/pods/default/nope")
        store.delete("/pods/default/p01")
        with pytest.raises(KeyNotFound):
            cacher.get_entry("/pods/default/p01")

    def test_watch_from_rv_replays_like_store(self):
        store = self._store_with_pods(2)
        cacher = Cacher(store, "/pods/")  # ring starts here
        rv0 = store.current_rv
        store.update("/pods/default/p00", mkpod("p00", labels={"v": "2"}))
        store.delete("/pods/default/p01")
        stream = cacher.watch("/pods/default/", from_rv=rv0)
        assert stream is not None, "in-ring window must serve from cache"
        got = drain(stream, 2)
        want = drain(store.watch("/pods/default/", from_rv=rv0), 2)
        assert [(e.type, e.resource_version) for e in got] == [
            (e.type, e.resource_version) for e in want
        ]
        assert got[0].object.metadata.labels == {"v": "2"}

    def test_watch_live_through_cache(self):
        store = self._store_with_pods(1)
        cacher = Cacher(store, "/pods/")
        s1 = cacher.watch("/pods/")
        s2 = cacher.watch("/pods/")
        store.create("/pods/default/live", mkpod("live"))
        ev1, = drain(s1, 1)
        ev2, = drain(s2, 1)
        assert ev1.type == ev2.type == "ADDED"
        # fan-out isolation: each stream decodes its own private object
        assert ev1.object is not ev2.object
        # but only ONE store-side watcher feeds them all
        assert len(store._watchers) == 1

    def test_compacted_window_answers_410_equivalent(self):
        store = MemoryStore(history_size=4)
        for i in range(12):
            store.create(f"/pods/default/x{i}", mkpod(f"x{i}"))
        cacher = Cacher(store, "/pods/")
        with pytest.raises(Compacted):
            cacher.watch("/pods/", from_rv=1)

    def test_pre_bootstrap_window_falls_back_to_store(self):
        store = self._store_with_pods(4)
        rv0 = store.current_rv
        store.create("/pods/default/after", mkpod("after"))
        cacher = Cacher(store, "/pods/")  # bootstraps at rv0+1
        # the cacher's ring starts after bootstrap; the store still has
        # this window — watch() must decline (None), not lie
        assert cacher.watch("/pods/", from_rv=rv0) is None
        got = drain(store.watch("/pods/", from_rv=rv0), 1)
        assert got[0].object.metadata.name == "after"

    def test_watch_from_rv_never_redelivers_under_feed_lag(self):
        """Review regression: a watch resuming from rv N while the feed
        is BEHIND N must not receive the pending backlog's events <= N
        once the feed catches up (the store's watch replays strictly
        > from_rv; the cache must too)."""
        store = MemoryStore()
        cacher = Cacher(store, "/pods/")
        # stall the feed by parking its apply under the cacher's cond
        release = threading.Event()
        orig_apply = cacher._apply_batch

        def slow_apply(batch):
            release.wait(5)
            orig_apply(batch)

        cacher._apply_batch = slow_apply
        rv1 = store.create("/pods/default/lagged", mkpod("lagged"))
        got = {}

        def register():
            # watch-from-rv1 must BLOCK until the feed processed rv1,
            # then deliver nothing (the client already has rv1)
            got["stream"] = cacher.watch("/pods/", from_rv=rv1)

        t = threading.Thread(target=register)
        t.start()
        time.sleep(0.3)
        release.set()
        t.join(5)
        stream = got["stream"]
        if stream is not None:  # None = honest fallback, also correct
            with pytest.raises(TimeoutError):
                stream.next_event(timeout=0.5)
            store.create("/pods/default/fresh", mkpod("fresh"))
            ev, = drain(stream, 1)
            assert ev.object.metadata.name == "fresh"
            stream.stop()

    def test_dead_feed_rebuilds_on_next_read(self):
        """Review regression: a cacher whose feed died must not revert
        the resource to the store path forever — the apiserver rebuilds
        it from a fresh bootstrap (with backoff)."""
        api = APIServer()
        client = RESTClient(LocalTransport(api))
        client.pods().create(mkpod("rb0"))
        info = api.resources["pods"]
        c1 = api._cacher_for(info)
        assert c1 is not None and c1.healthy
        c1._feed_stream.stop()  # simulate a store-watch break
        deadline = time.time() + 5
        while c1.healthy and time.time() < deadline:  # race: allow[test poll]
            time.sleep(0.02)
        assert not c1.healthy  # race: allow[test poll]
        # expire the backoff so the next read rebuilds immediately
        api._cacher_built[info.list_prefix("")] = 0.0
        c2 = api._cacher_for(info)
        assert c2 is not c1 and c2.healthy
        # and the rebuilt cache serves fresh, correct answers
        client.pods().create(mkpod("rb1"))
        items, _ = client.pods().list()
        assert {p.metadata.name for p in items} >= {"rb0", "rb1"}
        api.close_cachers()

    def test_fuzz_interleaved_writers_and_watchers(self):
        """Randomized writers race a cacher list/watch consumer; every
        list must equal the store's answer at that instant, and the
        watch stream must converge to the final store state."""
        rng = random.Random(1234)
        store = MemoryStore()
        cacher = Cacher(store, "/pods/")
        stream = cacher.watch("/pods/")
        stop = threading.Event()
        errs = []

        def writer(wid):
            try:
                for i in range(120):
                    key = f"/pods/default/w{wid}-{rng.randrange(20)}"
                    op = rng.random()
                    try:
                        if op < 0.5:
                            store.create(key, mkpod(key.rsplit("/", 1)[1]))
                        elif op < 0.8:
                            store.update(key, mkpod(key.rsplit("/", 1)[1],
                                                    labels={"i": str(i)}))
                        else:
                            store.delete(key)
                    except Exception:
                        pass  # create/update/delete races are expected
            except Exception as e:  # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=writer, args=(w,))
                   for w in range(4)]
        for t in threads:
            t.start()
        for _ in range(30):
            served = cacher.list_entries("/pods/default/")
            assert served is not None
            entries, rv = served
            names = sorted(e.obj.metadata.name for e in entries)
            # equivalence at an instant: the store may have moved on,
            # but the cache list must match the store list at a rv at
            # least as fresh as when the call started — replay the
            # check against the store ONLY when the store is idle
        for t in threads:
            t.join()
        stop.set()
        assert not errs
        # final convergence: cache snapshot == store content
        served = cacher.list_entries("/pods/")
        entries, rv = served
        objs, store_rv = store.list("/pods/")
        assert rv == store_rv
        assert sorted(e.obj.metadata.name for e in entries) == sorted(
            o.metadata.name for o in objs
        )
        # the watch stream saw every surviving object's latest state
        stream.stop()

    def test_apiserver_equivalence_cache_on_vs_off(self, monkeypatch):
        """End-to-end: the same request sequence answered with the
        watch cache enabled and disabled must produce identical wire
        payloads (lists, gets, selectors)."""
        def scrub(payload):
            """Drop per-run randomness (uid, timestamps) so two fresh
            servers' answers compare structurally."""
            if isinstance(payload, dict):
                return {
                    k: scrub(v) for k, v in payload.items()
                    if k not in ("uid", "creationTimestamp")
                }
            if isinstance(payload, (list, tuple)):
                return [scrub(v) for v in payload]
            return payload

        def run(flag):
            monkeypatch.setenv("KUBERNETES_TPU_WATCH_CACHE", flag)
            api = APIServer()
            client = RESTClient(LocalTransport(api, object_protocol=False))
            for i in range(6):
                client.pods().create(
                    mkpod(f"p{i}", labels={"par": str(i % 2)})
                )
            full = client.transport.request(
                "GET", "/api/v1/namespaces/default/pods"
            )
            sel = client.transport.request(
                "GET", "/api/v1/namespaces/default/pods",
                {"labelSelector": "par=1"},
            )
            one = client.transport.request(
                "GET", "/api/v1/namespaces/default/pods/p3"
            )
            missing = client.transport.request(
                "GET", "/api/v1/namespaces/default/pods/none"
            )
            api.close_cachers()
            return scrub([full, sel, one, missing])

        on = run("1")
        off = run("0")
        assert on == off


class TestBackpressure:
    def test_overflow_counts_drops_and_stops_with_error(self):
        from kubernetes_tpu_torch.metrics import storage_watch_events_dropped_total

        store = MemoryStore()
        stream = WatchStream(store, capacity=8)
        store._watchers.append(("/pods/", stream))
        before = storage_watch_events_dropped_total.get()
        for i in range(12):
            store.create(f"/pods/default/bp{i}", mkpod(f"bp{i}"))
        evs = []
        while True:
            ev = stream.next_event(timeout=1)
            if ev is None:
                break
            evs.append(ev)
        assert evs[-1].type == "ERROR"
        assert storage_watch_events_dropped_total.get() - before >= 8
        # the stream deregistered itself
        assert all(s is not stream for _p, s in store._watchers)

    def test_deliver_many_overflow_same_policy(self):
        from kubernetes_tpu_torch.metrics import storage_watch_events_dropped_total

        store = MemoryStore()
        stream = WatchStream(store, capacity=4)
        store._watchers.append(("/pods/", stream))
        before = storage_watch_events_dropped_total.get()
        ops = []
        for i in range(8):
            store.create(f"/pods/default/bm{i}", mkpod(f"bm{i}"))
        # the per-event path already overflowed; rebuild a fresh stream
        stream2 = WatchStream(store, capacity=4)
        store._watchers = [("/pods/", stream2)]
        ops = [(f"/pods/default/bm{i}", lambda p: p) for i in range(8)]
        errs = store.update_batch(ops)
        assert all(e is None for e in errs)
        evs = []
        while True:
            ev = stream2.next_event(timeout=1)
            if ev is None:
                break
            evs.append(ev)
        assert evs[-1].type == "ERROR"
        assert storage_watch_events_dropped_total.get() > before

    def test_reflector_relists_after_overflow(self):
        """End to end: a watcher that falls behind is terminated and
        the reflector recovers the full state via relist."""
        api = APIServer()
        client = RESTClient(LocalTransport(api))
        # shrink every new stream's capacity so the informer's watch
        # overflows under a burst
        orig_init = WatchStream.__init__

        def tiny_init(self, store, capacity=16):
            orig_init(self, store, capacity=capacity)

        WatchStream.__init__ = tiny_init
        try:
            from kubernetes_tpu_torch.client.informer import Informer

            inf = Informer(client.pods(""), name="bp-pods").run()
            assert inf.wait_for_sync(5)
            for i in range(200):
                client.pods().create(mkpod(f"ov{i:03d}"))
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                if len(inf.store.list_keys()) == 200:
                    break
                time.sleep(0.05)
            assert len(inf.store.list_keys()) == 200, (
                "reflector did not recover every pod after the "
                "overflow-triggered relist"
            )
            inf.stop()
        finally:
            WatchStream.__init__ = orig_init
            api.close_cachers()


class TestBatchCommit:
    def test_one_watch_burst_per_batch(self):
        """A batch commit reaches each watcher as ONE delivery (the
        whole burst lands before the watcher wakes once)."""
        store = MemoryStore()
        for i in range(50):
            store.create(f"/pods/default/b{i}", mkpod(f"b{i}"))
        stream = store.watch("/pods/")
        ops = []
        for i in range(50):
            def bump(p):
                p.metadata.labels["touched"] = "1"
                return p
            ops.append((f"/pods/default/b{i}", bump))
        errs = store.update_batch(ops)
        assert all(e is None for e in errs)
        # everything is already queued: one drain pass collects all 50
        evs = drain(stream, 50, timeout=2)
        assert len(evs) == 50
        assert all(ev.type == "MODIFIED" for ev in evs)
        stream.stop()

    def test_filestore_batch_single_wal_append(self, tmp_path):
        from kubernetes_tpu_torch.storage.durable import FileStore

        store = FileStore(str(tmp_path))
        for i in range(10):
            store.create(f"/pods/default/w{i}", mkpod(f"w{i}"))
        writes = []
        orig_write = store._wal.write

        def counting_write(data):
            writes.append(len(data))
            return orig_write(data)

        store._wal.write = counting_write
        ops = [(f"/pods/default/w{i}", lambda p: p) for i in range(10)]
        assert all(e is None for e in store.update_batch(ops))
        assert len(writes) == 1, (
            f"batch commit made {len(writes)} WAL writes, wanted 1"
        )
        store.close()
        # recovery replays the batched records exactly like sequential
        store2 = FileStore(str(tmp_path))
        objs, rv = store2.list("/pods/default/")
        assert len(objs) == 10 and rv == store.current_rv
        store2.close()

    def test_batch_endpoint_mixed_ops(self):
        api = APIServer()
        client = RESTClient(LocalTransport(api))
        client.nodes().create(mknode("n1"))
        for i in range(4):
            client.pods().create(mkpod(f"m{i}"))
        res = client.commit_batch([
            batch_bind_item("m0", "n1"),
            batch_bind_item("m1", "n1"),
            batch_status_item("pods", "m2", {"phase": "Running"}),
            batch_bind_item("ghost", "n1"),
        ])
        assert [r["status"] for r in res] == [
            "Success", "Success", "Success", "Failure"
        ]
        assert client.pods().get("m0").spec.node_name == "n1"
        assert client.pods().get("m2").status.phase == "Running"
        # a bound pod's PodScheduled condition flipped (bind semantics
        # identical to the single-binding endpoint)
        conds = {c.type: c.status
                 for c in client.pods().get("m1").status.conditions}
        assert conds.get("PodScheduled") == "True"
        api.close_cachers()

    def test_batch_audits_one_event_per_object(self):
        """Satellite: batch commits emit one audit event per contained
        object, all sharing the request id — `kubectl audit tail` can
        attribute every binding."""
        from kubernetes_tpu_torch import audit as audit_mod

        api = APIServer()
        client = RESTClient(LocalTransport(api))
        client.nodes().create(mknode("n1"))
        for i in range(3):
            client.pods().create(mkpod(f"a{i}"))
        client.commit_batch([
            batch_bind_item("a0", "n1"),
            batch_bind_item("a1", "n1"),
            batch_status_item("pods", "a2", {"phase": "Running"}),
        ])
        evs = audit_mod.render_audit({"limit": "50"})["items"]
        per_obj = [e for e in evs
                   if e.get("subresource") in ("binding", "status")
                   and e.get("name", "").startswith("a")]
        assert len(per_obj) == 3
        rids = {e.get("requestID") for e in per_obj}
        assert len(rids) == 1 and "" not in rids
        names = {e["name"] for e in per_obj}
        assert names == {"a0", "a1", "a2"}
        # kubectl audit tail renders them (the user-facing trail)
        from kubernetes_tpu_torch.kubectl.cmd import Kubectl

        out = Kubectl(client).audit_tail(limit=20)
        rid = per_obj[0]["requestID"]
        # the three per-object rows and the request row share the id
        assert "default/a0" in out
        assert out.count(rid) == 4
        api.close_cachers()


    def test_batch_endpoint_authorizes_as_batchcommits(self):
        """/api/v1/batch writes pods across namespaces in one request:
        it must authorize as its OWN resource ("batchcommits") — an
        unparsable path would deny every non-wildcard policy and hide
        the cross-resource writes from per-resource rules."""
        from kubernetes_tpu_torch.auth.authn import TokenAuthenticator, UserInfo

        seen = []

        class RecordingAuthorizer:
            def authorize(self, attrs):
                seen.append((attrs.resource, attrs.verb))
                return attrs.resource == "batchcommits"

        api = APIServer(
            authenticator=TokenAuthenticator(
                {"tok": UserInfo(name="scheduler")}
            ),
            authorizer=RecordingAuthorizer(),
        )
        host, port = api.serve_http(enable_binary=True)
        try:
            t = HTTPTransport(f"http://{host}:{port}", binary=True,
                              bearer_token="tok")
            # grantable: the batch path authorizes as batchcommits
            code, _ = t.request(
                "POST", "/api/v1/batch",
                body={"kind": "BatchRequest", "items": []},
            )
            assert code == 201
            assert ("batchcommits", "POST") in seen
            # and per-resource rules still deny it elsewhere
            code, _ = t.request(
                "GET", "/api/v1/namespaces/default/pods"
            )
            assert code == 403
            t.close()
        finally:
            api.shutdown_http()


class TestTransport:
    @pytest.fixture()
    def served(self):
        api = APIServer()
        host, port = api.serve_http(enable_binary=True)
        client = RESTClient(
            HTTPTransport(f"http://{host}:{port}", binary=True)
        )
        yield api, client
        client.transport.close()
        api.shutdown_http()

    def test_keepalive_connection_reuse(self, served):
        api, client = served
        client.pods().create(mkpod("ka0"))
        t = client.transport
        for _ in range(10):
            assert client.pods().get("ka0").metadata.name == "ka0"
        # one caller thread -> at most one pooled connection, reused
        assert sum(len(v) for v in t._pool.values()) == 1

    def test_stale_pooled_connection_retried(self, served):
        api, client = served
        client.pods().create(mkpod("stale0"))
        t = client.transport
        base = t.base_url
        # poison the pooled connection (server closed it server-side)
        conn, reused = t._checkout(base)
        assert reused
        conn.sock.close()
        t._checkin(base, conn)
        assert client.pods().get("stale0").metadata.name == "stale0"

    def test_eight_thread_hammer(self, served):
        """Regression for pooled-connection cross-talk: 8 threads share
        one transport; every response must match its request."""
        api, client = served
        for i in range(8):
            client.pods().create(mkpod(f"hm{i}"))
        errs = []

        def hammer(tid):
            try:
                for i in range(60):
                    name = f"hm{(tid + i) % 8}"
                    got = client.pods().get(name).metadata.name
                    assert got == name, f"wanted {name}, got {got}"
            except Exception as e:
                errs.append(e)

        threads = [threading.Thread(target=hammer, args=(k,))
                   for k in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert not errs

    def test_pipeline_roundtrip(self, served):
        api, client = served
        for i in range(3):
            client.pods().create(mkpod(f"pl{i}"))
        out = client.transport.pipeline([
            ("GET", "/api/v1/namespaces/default/pods/pl0", None, None),
            ("GET", "/api/v1/namespaces/default/pods", None, None),
            ("GET", "/healthz", None, None),
            ("GET", "/api/v1/namespaces/default/pods/pl2", None, None),
        ])
        assert [code for code, _ in out] == [200, 200, 200, 200]
        assert out[0][1].metadata.name == "pl0"
        assert len(out[1][1]["items"]) == 3
        assert out[3][1].metadata.name == "pl2"

    def test_raw_list_and_get_byte_equivalence(self, served):
        """Zero-re-encode: a binary GET's payload bytes are the stored
        commit bytes (the decode round-trips to the identical object)."""
        api, client = served
        client.pods().create(mkpod("raw0", labels={"x": "y"}))
        obj = client.pods().get("raw0")
        assert obj.metadata.labels == {"x": "y"}
        items, _rv = client.pods().list()
        assert any(p.metadata.name == "raw0" for p in items)


def mkboundpod(name: str, node: str, labels=None) -> Pod:
    p = mkpod(name, labels=labels)
    p.spec.node_name = node
    return p


class TestRound10Fanout:
    """Round 10: per-resource ring sizing + eviction accounting,
    interest-filtered fan-out, and coalesced-burst equivalence."""

    def test_ring_size_per_resource_config(self, monkeypatch):
        monkeypatch.setenv("KUBERNETES_TPU_WATCH_CACHE_SIZES",
                           "pods=16, nodes=32, default=8, junk, bad=x")
        api = APIServer()
        try:
            api.handle("POST", "/api/v1/namespaces/default/pods",
                       body=None) if False else None
            pods_cacher = api._cacher_for(api.resources["pods"])
            nodes_cacher = api._cacher_for(api.resources["nodes"])
            svc_cacher = api._cacher_for(api.resources["services"])
            assert pods_cacher._ring.maxlen == 16
            assert nodes_cacher._ring.maxlen == 32
            assert svc_cacher._ring.maxlen == 8  # default= fallback
        finally:
            api.close_cachers()

    def test_undersized_ring_evicts_counts_and_forces_relist(self):
        """A watch storm larger than the ring must EVICT (counted) and
        force a resuming watcher into the store fallback / relist path
        — never a silently truncated replay."""
        from kubernetes_tpu_torch.metrics import (
            storage_watch_cache_ring_evictions_total,
        )

        store = MemoryStore()
        store.create("/pods/default/seed", mkpod("seed"))
        cacher = Cacher(store, "/pods/", ring_size=8)
        assert cacher.list_entries("/pods/") is not None  # bootstrap
        rv0 = store.list("/pods/")[1]
        assert rv0 >= 1
        before = storage_watch_cache_ring_evictions_total.get()
        for i in range(40):
            store.create(f"/pods/default/storm-{i:03d}",
                         mkpod(f"storm-{i:03d}"))
        # wait for the feed to absorb the burst (read _rv under its
        # guard: the feed thread writes it under _cond)
        deadline = time.time() + 5
        while time.time() < deadline:
            with cacher._cond:
                if cacher._rv >= rv0 + 40:
                    break
            time.sleep(0.01)
        assert storage_watch_cache_ring_evictions_total.get() - before >= 32
        # resuming from before the evicted horizon: cacher refuses
        # (None -> store fallback), it must not replay a truncated ring
        assert cacher.watch("/pods/", from_rv=rv0) is None
        # the store fallback path surfaces Compacted when ITS window is
        # also gone -> the reflector relists; either way the final
        # state is complete
        try:
            stream = store.watch("/pods/", from_rv=rv0)
            got = drain(stream, 40)
            assert len(got) == 40
            stream.stop()
        except Compacted:
            pass
        objs, _rv = store.list("/pods/")
        assert len(objs) == 41
        cacher.stop()

    def _fuzz_ops(self, rng, client, nodes, serial):
        """One randomized writer step through the REAL doors: bulk
        create (bound or pending), batch status merge, batch delete."""
        from kubernetes_tpu_torch.client.rest import batch_delete_item

        op = rng.random()
        if op < 0.45:
            names = [f"fz-{serial:04d}-{j}" for j in range(rng.randrange(1, 4))]
            objs = []
            for nm in names:
                node = rng.choice(nodes + [""])
                objs.append(mkboundpod(nm, node) if node else mkpod(nm))
            client.pods().create_many(objs)
            return names
        existing, _rv = client.pods().list()
        if not existing:
            return []
        if op < 0.75:
            victims = rng.sample(existing, min(len(existing),
                                               rng.randrange(1, 3)))
            client.commit_batch([
                batch_status_item("pods", p.metadata.name,
                                  {"phase": rng.choice(["Running",
                                                        "Pending"])})
                for p in victims
            ])
        else:
            victims = rng.sample(existing, min(len(existing),
                                               rng.randrange(1, 3)))
            client.commit_batch([
                batch_delete_item("pods", p.metadata.name)
                for p in victims
            ])
        return []

    def _drain_to_sentinel(self, stream, sentinel):
        """Consume watch events into a name -> (phase, node) dict until
        the sentinel pod arrives; DELETED removes."""
        state = {}
        for ev_type, obj in stream:
            name = obj.metadata.name
            if ev_type == "DELETED":
                state.pop(name, None)
            else:
                state[name] = (obj.status.phase, obj.spec.node_name)
            if name == sentinel:
                break
        return state

    def test_fuzz_coalesced_vs_per_event_frames(self, monkeypatch):
        """Coalescing ON and OFF streams reconstruct IDENTICAL final
        states from an identical randomized writer interleaving — the
        burst envelope is transport, not semantics."""
        rng = random.Random(42)
        api = APIServer()
        host, port = api.serve_http(enable_binary=True)
        client = RESTClient(HTTPTransport(f"http://{host}:{port}",
                                          binary=True))
        try:
            from kubernetes_tpu_torch.metrics import (
                apiserver_watch_coalesced_frame_objects as _frames,
            )

            monkeypatch.setenv("KUBERNETES_TPU_WATCH_COALESCE", "1")
            w_on = client.pods().watch(resource_version="0")
            # prime w_on past the handler's env read: the server
            # evaluates KUBERNETES_TPU_WATCH_COALESCE on its own
            # thread after the response headers, so flipping the var
            # immediately could land before w_on's handler sampled it
            # (both streams would silently run uncoalesced). A priming
            # pod must produce a COALESCED frame (w_on is the only
            # watcher) before the flip; the prime event stays queued on
            # the stream — the drain consumes it later.
            c0 = _frames.count
            client.pods().create(mkpod("aa-prime"))
            deadline = time.time() + 10
            while _frames.count == c0 and time.time() < deadline:
                time.sleep(0.01)
            assert _frames.count > c0, (
                "w_on never emitted a coalesced frame — coalescing is "
                "off at the server or the handler has not sampled env"
            )
            monkeypatch.setenv("KUBERNETES_TPU_WATCH_COALESCE", "0")
            w_off = client.pods().watch(resource_version="0")
            # deleted before the fuzz: neither reconstruction nor the
            # server's final state should carry the priming pod (w_on
            # drains ADDED then DELETED — a net no-op; w_off sees at
            # most the DELETED, also a no-op)
            client.pods().delete("aa-prime")
            for step in range(40):
                self._fuzz_ops(rng, client, ["n1", "n2", "n3"], step)
            client.pods().create(mkpod("zz-sentinel"))
            import concurrent.futures as cf

            with cf.ThreadPoolExecutor(2) as ex:
                f_on = ex.submit(self._drain_to_sentinel, w_on,
                                 "zz-sentinel")
                f_off = ex.submit(self._drain_to_sentinel, w_off,
                                  "zz-sentinel")
                state_on = f_on.result(timeout=30)
                state_off = f_off.result(timeout=30)
            assert state_on == state_off
            # and both converge to the server's final state
            final = {
                p.metadata.name: (p.status.phase, p.spec.node_name)
                for p in client.pods().list()[0]
            }
            assert state_on == final
            w_on.stop()
            w_off.stop()
        finally:
            client.transport.close()
            api.shutdown_http()
            api.close_cachers()

    def test_fuzz_server_filtered_vs_client_filtered(self):
        """A spec.nodeName-in-(...) server-filtered stream must
        reconstruct exactly the state a client filtering the FULL
        stream reconstructs, across randomized interleavings that move
        pods in and out of the interest set."""
        rng = random.Random(7)
        api = APIServer()
        host, port = api.serve_http(enable_binary=True)
        client = RESTClient(HTTPTransport(f"http://{host}:{port}",
                                          binary=True))
        want = {"n1", "n2"}
        try:
            w_filt = client.pods().watch(
                resource_version="0",
                field_selector="spec.nodeName in (n1,n2)",
            )
            w_full = client.pods().watch(resource_version="0")
            for step in range(40):
                self._fuzz_ops(rng, client, ["n1", "n2", "n3", "n4"],
                               step)
            client.pods().create(mkboundpod("zz-sentinel", "n1"))
            import concurrent.futures as cf

            with cf.ThreadPoolExecutor(2) as ex:
                f_filt = ex.submit(self._drain_to_sentinel, w_filt,
                                   "zz-sentinel")
                f_full = ex.submit(self._drain_to_sentinel, w_full,
                                   "zz-sentinel")
                state_filt = f_filt.result(timeout=30)
                state_full = f_full.result(timeout=30)
            client_filtered = {
                nm: st for nm, st in state_full.items() if st[1] in want
            }
            assert state_filt == client_filtered
            final = {
                p.metadata.name: (p.status.phase, p.spec.node_name)
                for p in client.pods().list()[0]
                if p.spec.node_name in want
            }
            assert state_filt == final
            w_filt.stop()
            w_full.stop()
        finally:
            client.transport.close()
            api.shutdown_http()
            api.close_cachers()

    def test_burst_frame_roundtrip(self):
        """coalesce_burst/iter_burst invert each other and reject
        truncation/trailing garbage."""
        from kubernetes_tpu_torch.runtime import binary, tlv

        items = [
            ("ADDED", tlv.dumps({"metadata": {"name": "a"}})),
            ("MODIFIED", tlv.dumps({"metadata": {"name": "b"},
                                    "status": {"phase": "Running"}})),
            ("DELETED", tlv.dumps({"metadata": {"name": "c"}})),
        ]
        frame = binary.coalesce_burst(items)
        import struct

        (size,) = struct.unpack_from("<I", frame, 0)
        body = frame[4:]
        assert len(body) == size
        assert body.startswith(binary.MAGIC_BURST)
        evs = list(binary.iter_burst(body))
        assert [e["type"] for e in evs] == ["ADDED", "MODIFIED", "DELETED"]
        assert evs[1]["object"]["status"]["phase"] == "Running"
        with pytest.raises(binary.BinaryDecodeError):
            list(binary.iter_burst(body[:-3]))
        with pytest.raises(binary.BinaryDecodeError):
            list(binary.iter_burst(body + b"xx"))
