"""Audit subsystem tests: policy levels, the ring buffer, apiserver
integration (exactly-once per REST request, both doors), /debug/audit
on the muxes, and the kubectl surfaces (audit tail, top, get -w).

The cases of tests/test_audit.py, run against the port's copies
(kubernetes_tpu_torch), each with the mark it has there."""

import json
import threading
import urllib.request

import pytest

from kubernetes_tpu_torch import audit
from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client import LocalTransport, RESTClient


def make_api():
    audit.LOG.clear()
    return APIServer()


def pod_body(name, ns="default"):
    return {
        "kind": "Pod",
        "metadata": {"name": name, "namespace": ns},
        "spec": {"containers": [{"requests": {"cpu": "100m"}}]},
    }


class TestAuditPolicy:
    def test_levels_validate(self):
        assert audit.AuditPolicy("Metadata").level == "Metadata"
        with pytest.raises(ValueError):
            audit.AuditPolicy("Verbose")

    def test_none_drops_everything(self):
        p = audit.AuditPolicy("None")
        assert p.level_for("/api/v1/namespaces/default/pods") == "None"

    def test_observability_paths_exempt(self):
        p = audit.AuditPolicy("Metadata")
        for path in ("/healthz", "/metrics", "/debug/audit",
                     "/debug/traces", "/configz", "/ui", "/api",
                     "/apis/extensions/v1beta1", "/swaggerapi/foo"):
            assert p.level_for(path) == "None", path

    def test_resource_paths_audited(self):
        p = audit.AuditPolicy("Request")
        assert p.level_for("/api/v1/namespaces/default/pods") == "Request"
        assert p.level_for("/apis/extensions/v1beta1/jobs") == "Request"

    def test_from_env(self, monkeypatch):
        monkeypatch.setenv("KUBERNETES_TPU_AUDIT", "off")
        assert audit.AuditPolicy.from_env().level == "None"
        monkeypatch.setenv("KUBERNETES_TPU_AUDIT", "Request")
        assert audit.AuditPolicy.from_env().level == "Request"
        monkeypatch.delenv("KUBERNETES_TPU_AUDIT")
        assert audit.AuditPolicy.from_env().level == "Metadata"


class TestAuditLog:
    def test_ring_is_bounded_and_newest_first(self):
        log = audit.AuditLog(capacity=4)
        for i in range(10):
            log.record({"requestID": f"r{i}", "verb": "get"})
        items = log.snapshot(limit=10)
        assert [e["requestID"] for e in items] == ["r9", "r8", "r7", "r6"]
        assert log.total_recorded == 10

    def test_snapshot_filters(self):
        log = audit.AuditLog(capacity=16)
        log.record({"user": "alice", "verb": "create", "resource": "pods"})
        log.record({"user": "bob", "verb": "delete", "resource": "nodes"})
        assert len(log.snapshot(user="alice")) == 1
        assert log.snapshot(verb="delete")[0]["user"] == "bob"
        assert log.snapshot(resource="pods")[0]["verb"] == "create"

    def test_jsonl_sink(self, tmp_path):
        path = tmp_path / "audit.jsonl"
        log = audit.AuditLog(capacity=8, sink_path=str(path))
        log.record({"requestID": "r1", "verb": "create", "code": 201})
        log.record({"requestID": "r2", "verb": "delete", "code": 200})
        log.close()
        lines = [json.loads(l) for l in path.read_text().splitlines()]
        assert [e["requestID"] for e in lines] == ["r1", "r2"]


class TestAPIServerAudit:
    def test_mutating_request_audited_exactly_once(self):
        api = make_api()
        code, _ = api.handle(
            "POST", "/api/v1/namespaces/default/pods", None,
            pod_body("audit-p1"),
        )
        assert code == 201
        code, out = api.handle("GET", "/debug/audit", {}, None)
        assert code == 200
        evs = [e for e in out["items"] if e.get("name") == "audit-p1"]
        assert len(evs) == 1
        ev = evs[0]
        assert ev["verb"] == "create"
        assert ev["resource"] == "pods"
        assert ev["namespace"] == "default"
        assert ev["code"] == 201
        assert ev["latencySeconds"] >= 0
        assert ev["requestID"]

    def test_verbs_mapped_from_method_and_path(self):
        api = make_api()
        api.handle("POST", "/api/v1/namespaces/default/pods", None,
                   pod_body("vm1"))
        api.handle("GET", "/api/v1/namespaces/default/pods", {}, None)
        api.handle("GET", "/api/v1/namespaces/default/pods/vm1", {}, None)
        api.handle("DELETE", "/api/v1/namespaces/default/pods/vm1", {}, None)
        verbs = [e["verb"] for e in audit.LOG.snapshot(limit=10)]
        assert verbs[:4] == ["delete", "get", "list", "create"]

    def test_error_responses_audited_with_code(self):
        api = make_api()
        api.handle("GET", "/api/v1/namespaces/default/pods/ghost", {}, None)
        ev = audit.LOG.snapshot(limit=1)[0]
        assert ev["code"] == 404 and ev["verb"] == "get"

    def test_request_level_includes_body_summary(self):
        api = make_api()
        api.audit_policy = audit.AuditPolicy("Request")
        api.handle("POST", "/api/v1/namespaces/default/pods", None,
                   pod_body("req-lvl"))
        ev = audit.LOG.snapshot(limit=1)[0]
        assert ev["level"] == "Request"
        assert ev["requestObject"]["metadata"]["name"] == "req-lvl"

    def test_level_none_disables(self):
        api = make_api()
        api.audit_policy = audit.AuditPolicy("None")
        api.handle("POST", "/api/v1/namespaces/default/pods", None,
                   pod_body("quiet"))
        assert not any(
            e.get("name") == "quiet" for e in audit.LOG.snapshot(limit=50)
        )

    def test_observability_reads_not_audited(self):
        api = make_api()
        api.handle("GET", "/metrics", {}, None)
        api.handle("GET", "/debug/audit", {}, None)
        api.handle("GET", "/healthz", {}, None)
        assert audit.LOG.total_recorded == 0

    def test_audit_counter_increments(self):
        from kubernetes_tpu_torch.metrics import apiserver_audit_event_total

        api = make_api()
        before = apiserver_audit_event_total.get(
            level="Metadata", verb="create"
        )
        api.handle("POST", "/api/v1/namespaces/default/pods", None,
                   pod_body("ctr"))
        after = apiserver_audit_event_total.get(
            level="Metadata", verb="create"
        )
        assert after == before + 1


class TestAuditOverHTTP:
    def test_http_request_audited_once_with_user(self):
        from kubernetes_tpu_torch.apiserver.http_frontend import start_http_server
        from kubernetes_tpu_torch.auth.authn import TokenAuthenticator, UserInfo

        api = make_api()
        api.authenticator = TokenAuthenticator(
            {"tok1": UserInfo("alice", "u1", ())}
        )
        server, port = start_http_server(api, "127.0.0.1", 0)
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/api/v1/namespaces/default/pods",
                data=json.dumps(pod_body("http-p")).encode(),
                method="POST",
                headers={
                    "Content-Type": "application/json",
                    "Authorization": "Bearer tok1",
                    "X-Request-Id": "trail-42",
                },
            )
            with urllib.request.urlopen(req) as r:
                assert r.status == 201
            audit_req = urllib.request.Request(
                f"http://127.0.0.1:{port}/debug/audit",
                headers={"Authorization": "Bearer tok1"},
            )
            with urllib.request.urlopen(audit_req) as r:
                out = json.loads(r.read())
        finally:
            server.shutdown()
        evs = [e for e in out["items"] if e.get("name") == "http-p"]
        assert len(evs) == 1  # exactly once through the HTTP door
        assert evs[0]["user"] == "alice"
        assert evs[0]["requestID"] == "trail-42"

    def test_denied_requests_are_audited(self):
        from kubernetes_tpu_torch.apiserver.http_frontend import start_http_server
        from kubernetes_tpu_torch.auth.authn import TokenAuthenticator, UserInfo

        api = make_api()
        api.authenticator = TokenAuthenticator(
            {"good": UserInfo("alice", "u1", ())}
        )
        server, port = start_http_server(api, "127.0.0.1", 0)
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/api/v1/namespaces/default/pods",
                headers={"Authorization": "Bearer wrong"},
            )
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(req)
            assert exc.value.code == 401
        finally:
            server.shutdown()
        denied = [e for e in audit.LOG.snapshot(limit=10)
                  if e["code"] == 401]
        assert len(denied) == 1
        assert denied[0]["user"] == "system:anonymous"

    def test_component_mux_serves_audit(self):
        from kubernetes_tpu_torch.trace.httpd import start_component_server

        audit.LOG.clear()
        audit.record("Metadata", "carol", "delete", "nodes", "", "n1",
                     200, 0.002)
        server, port = start_component_server(name="test-mux")
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/debug/audit?user=carol"
            ) as r:
                out = json.loads(r.read())
        finally:
            server.shutdown()
        assert out["kind"] == "AuditEventList"
        assert out["items"][0]["verb"] == "delete"


class TestKubectlSurfaces:
    def test_audit_tail_renders_trail(self):
        from kubernetes_tpu_torch.kubectl.cmd import Kubectl

        api = make_api()
        client = RESTClient(LocalTransport(api))
        k = Kubectl(client)
        client.resource("pods", "default")  # no-op, path sanity
        api.handle("POST", "/api/v1/namespaces/default/pods", None,
                   pod_body("tail-p"))
        out = k.audit_tail(limit=5)
        assert "VERB" in out and "create" in out and "tail-p" in out
        as_json = json.loads(k.audit_tail(limit=5, output="json"))
        assert any(e.get("name") == "tail-p" for e in as_json)

    def test_audit_tail_filters_by_verb(self):
        from kubernetes_tpu_torch.kubectl.cmd import Kubectl

        api = make_api()
        client = RESTClient(LocalTransport(api))
        k = Kubectl(client)
        api.handle("POST", "/api/v1/namespaces/default/pods", None,
                   pod_body("f1"))
        api.handle("GET", "/api/v1/namespaces/default/pods", {}, None)
        filtered = json.loads(
            k.audit_tail(limit=10, output="json", verb="create")
        )
        assert filtered and all(e["verb"] == "create" for e in filtered)

    def test_get_events_watch_streams_rows(self):
        from kubernetes_tpu_torch.kubectl.cmd import Kubectl

        api = make_api()
        client = RESTClient(LocalTransport(api))
        k = Kubectl(client)

        def emit_later():
            ev = t.Event(
                metadata=t.ObjectMeta(name="we.1", namespace="default"),
                involved_object=t.ObjectReference(
                    kind="Pod", namespace="default", name="watched-pod"
                ),
                reason="Scheduled", message="bound", type="Normal",
                source_component="scheduler", count=1,
                first_timestamp="t", last_timestamp="t",
            )
            client.resource("events", "default").create(ev)

        timer = threading.Timer(0.2, emit_later)
        timer.start()
        lines = []
        out = k.get_watch("events", max_events=1, out=lines.append)
        timer.join()
        assert "LASTSEEN" in lines[0]  # header row
        assert any("watched-pod" in l and "Scheduled" in l for l in lines)
        assert out == "\n".join(lines)


class TestKubeletSummary:
    def _kubelet_stub(self):
        class Cfg:
            node_name = "node-a"

        class Runtime:
            def pod_stats(self, uid):
                return {
                    "main": {
                        "memory_rss_bytes": 1 << 20,
                        "cpu_jiffies": 250,
                    },
                }

        class KL:
            config = Cfg()
            runtime = Runtime()
            eviction_manager = None
            _lock = threading.Lock()
            _pods = {}

        kl = KL()
        p = t.Pod(
            metadata=t.ObjectMeta(
                name="sp", namespace="default", uid="u1"
            ),
            spec=t.PodSpec(containers=[t.Container(
                name="main",
                requests={"alpha.kubernetes.io/nvidia-gpu": 2},
            )]),
        )
        kl._pods = {"u1": p}
        return kl

    def test_summary_reports_cpu_memory_devices(self):
        from kubernetes_tpu_torch.kubelet.server import build_summary

        s = build_summary(self._kubelet_stub())
        assert s["node"]["nodeName"] == "node-a"
        pod = s["pods"][0]
        assert pod["podRef"]["name"] == "sp"
        assert pod["memory"]["rssBytes"] == 1 << 20
        assert pod["cpu"]["usageCoreSeconds"] > 0
        assert pod["devices"]["requested"] == 2
        assert pod["containers"][0]["name"] == "main"
        # node aggregates roll up the pods
        assert s["node"]["memory"]["workingSetBytes"] == 1 << 20
        assert s["node"]["devices"]["requested"] == 2

    def test_summary_tolerates_statless_runtime(self):
        from kubernetes_tpu_torch.kubelet.server import build_summary

        kl = self._kubelet_stub()
        kl.runtime = object()  # no pod_stats attr (FakeRuntime-like)
        s = build_summary(kl)
        assert s["pods"][0]["containers"] == []
        assert s["pods"][0]["devices"]["requested"] == 2


class TestControlLoopMetrics:
    def test_named_workqueue_exports_families(self):
        from kubernetes_tpu_torch.metrics import (
            workqueue_adds_total,
            workqueue_depth,
            workqueue_queue_duration_seconds,
            workqueue_work_duration_seconds,
        )
        from kubernetes_tpu_torch.utils.workqueue import RateLimitingQueue

        q = RateLimitingQueue(name="metrics-probe")
        before = workqueue_adds_total.get(name="metrics-probe")
        q.add("k1")
        assert workqueue_depth.values()["metrics-probe"] == 1
        item = q.get(timeout=1)
        assert workqueue_depth.values()["metrics-probe"] == 0
        q.done(item)
        q.shut_down()
        assert workqueue_adds_total.get(name="metrics-probe") == before + 1
        assert (
            workqueue_queue_duration_seconds.labels("metrics-probe").count
            >= 1
        )
        assert (
            workqueue_work_duration_seconds.labels("metrics-probe").count
            >= 1
        )

    def test_retries_counted(self):
        from kubernetes_tpu_torch.metrics import workqueue_retries_total
        from kubernetes_tpu_torch.utils.workqueue import RateLimitingQueue

        q = RateLimitingQueue(name="retry-probe", base_delay=0.001)
        before = workqueue_retries_total.get(name="retry-probe")
        q.add_rate_limited("k")
        assert workqueue_retries_total.get(name="retry-probe") == before + 1
        q.shut_down()

    def test_named_fifo_reports_depth(self):
        from kubernetes_tpu_torch.client.cache.fifo import FIFO
        from kubernetes_tpu_torch.metrics import workqueue_depth

        q = FIFO(name="fifo-probe")
        q.add(t.Pod(metadata=t.ObjectMeta(name="p", namespace="d")))
        assert workqueue_depth.values()["fifo-probe"] == 1
        q.pop(timeout=1)
        assert workqueue_depth.values()["fifo-probe"] == 0

    def test_named_fifo_delete_drops_enqueue_timestamp(self):
        from kubernetes_tpu_torch.client.cache.fifo import FIFO
        from kubernetes_tpu_torch.metrics import workqueue_depth

        q = FIFO(name="fifo-del-probe")
        p = t.Pod(metadata=t.ObjectMeta(name="p", namespace="d"))
        q.add(p)
        q.delete(p)
        # delete must clean the timestamp map (no leak, no phantom
        # queue-wait on a later re-add of the same key) and fix depth
        assert q._added_at == {}
        assert workqueue_depth.values()["fifo-del-probe"] == 0
        q.add(p)
        assert len(q._added_at) == 1
        q.pop(timeout=1)
        assert q._added_at == {}

    def test_reflector_and_watch_metrics(self):
        from kubernetes_tpu_torch.client.cache import Store
        from kubernetes_tpu_torch.client.cache.reflector import Reflector
        from kubernetes_tpu_torch.client.cache.store import (
            meta_namespace_key_func,
        )
        from kubernetes_tpu_torch.metrics import (
            reflector_lists_total,
            watch_events_total,
        )

        api = make_api()
        client = RESTClient(LocalTransport(api))
        store = Store(meta_namespace_key_func)
        refl = Reflector(
            client.resource("pods", "default"), store,
            name="probe-pods",
        ).run()
        try:
            assert refl.wait_for_sync(5)
            assert reflector_lists_total.get(name="probe-pods") >= 1
            api.handle("POST", "/api/v1/namespaces/default/pods", None,
                       pod_body("refl-p"))
            from tests.conftest import wait_until

            assert wait_until(
                lambda: watch_events_total.get(
                    name="probe-pods", type="ADDED"
                ) >= 1,
                timeout=5,
            )
        finally:
            refl.stop()


class TestMetricsEndpointIntegration:
    def test_controller_queue_renders_on_metrics(self):
        # a named controller-style queue that has seen work shows up in
        # the text exposition with depth + duration families
        from kubernetes_tpu_torch.controller.framework import QueueWorker
        from kubernetes_tpu_torch.metrics import registry

        done = threading.Event()

        def sync(key):
            done.set()

        w = QueueWorker("probe-controller", sync).run()
        w.enqueue("k")
        assert done.wait(5)
        w.stop()
        text = registry.render()
        assert 'workqueue_depth{name="probe-controller"}' in text
        assert 'workqueue_work_duration_seconds_count{name="probe-controller"}' in text
