"""The 1.3-window API resources absent until round 4: Ingress,
NetworkPolicy, PodDisruptionBudget, PodSecurityPolicy, ScheduledJob,
PodTemplate (stored; CRUD + watch round-trip over the real HTTP wire)
and ComponentStatus (virtual; live health probes).

Reference: pkg/registry/{ingress,networkpolicy,poddisruptionbudget,
podsecuritypolicy,scheduledjob,podtemplate,componentstatus}/.

The cases of tests/test_new_resources.py, run against the port's copies
(kubernetes_tpu_torch), each with the mark it has there."""

import threading
import time

import pytest

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.rest import APIStatusError, RESTClient
from kubernetes_tpu_torch.client.transport import HTTPTransport, LocalTransport
from kubernetes_tpu_torch.kubectl.cmd import Kubectl


@pytest.fixture()
def plane():
    server = APIServer()
    host, port = server.serve_http(enable_binary=True)
    client = RESTClient(HTTPTransport(f"http://{host}:{port}", binary=True))
    yield server, client


def mk_objects():
    """One instance of each new stored resource."""
    return [
        ("ingresses", t.Ingress(
            metadata=t.ObjectMeta(name="web"),
            spec=t.IngressSpec(rules=[t.IngressRule(
                host="foo.bar.com",
                http_paths=[t.HTTPIngressPath(
                    path="/app",
                    backend=t.IngressBackend(
                        service_name="app", service_port=80
                    ),
                )],
            )]),
        )),
        ("networkpolicies", t.NetworkPolicy(
            metadata=t.ObjectMeta(name="allow-frontend"),
            spec=t.NetworkPolicySpec(
                pod_selector={"tier": "backend"},
                ingress=[t.NetworkPolicyIngressRule(
                    ports=[t.NetworkPolicyPort(port=6379)],
                    from_peers=[t.NetworkPolicyPeer(
                        pod_selector={"tier": "frontend"}
                    )],
                )],
            ),
        )),
        ("poddisruptionbudgets", t.PodDisruptionBudget(
            metadata=t.ObjectMeta(name="zk-budget"),
            spec=t.PodDisruptionBudgetSpec(
                min_available=2, selector={"app": "zk"}
            ),
        )),
        ("podsecuritypolicies", t.PodSecurityPolicy(
            metadata=t.ObjectMeta(name="restricted", namespace=""),
            spec=t.PodSecurityPolicySpec(
                privileged=False, host_network=False,
                volumes=["emptyDir", "secret"],
                host_ports=[t.HostPortRange(min=8000, max=9000)],
                run_as_user_rule="MustRunAsNonRoot",
            ),
        )),
        ("scheduledjobs", t.ScheduledJob(
            metadata=t.ObjectMeta(name="nightly"),
            spec=t.ScheduledJobSpec(
                schedule="0 2 * * *",
                concurrency_policy="Forbid",
                job_template=t.JobTemplateSpec(
                    spec=t.JobSpec(template=t.PodTemplateSpec(
                        spec=t.PodSpec(containers=[
                            t.Container(name="c", image="backup")
                        ]),
                    )),
                ),
            ),
        )),
        ("podtemplates", t.PodTemplate(
            metadata=t.ObjectMeta(name="base"),
            template=t.PodTemplateSpec(
                metadata=t.ObjectMeta(labels={"app": "base"}),
                spec=t.PodSpec(containers=[
                    t.Container(name="c", image="nginx")
                ]),
            ),
        )),
    ]


class TestCRUDAndWatch:
    @pytest.mark.parametrize("resource,obj", mk_objects(),
                             ids=[r for r, _ in mk_objects()])
    def test_crud_watch_roundtrip(self, plane, resource, obj):
        server, client = plane
        rc = client.resource(resource, obj.metadata.namespace)
        events = []
        done = threading.Event()

        def watcher():
            w = rc.watch()
            for typ, o in w:
                events.append((typ, o.metadata.name))
                if typ == "DELETED":
                    done.set()
                    return

        th = threading.Thread(target=watcher, daemon=True)
        th.start()
        time.sleep(0.2)
        rc.create(obj)
        got = rc.get(obj.metadata.name)
        assert type(got) is type(obj)
        assert got.metadata.uid and got.metadata.resource_version
        # spec round-trips the wire exactly
        from kubernetes_tpu_torch.runtime.scheme import scheme
        stripped = scheme.encode(got)
        stripped.get("metadata", {}).pop("uid", None)
        want = scheme.encode(obj)
        for k in ("uid", "resourceVersion", "creationTimestamp"):
            stripped.get("metadata", {}).pop(k, None)
            want.get("metadata", {}).pop(k, None)
        assert stripped == want
        # update round-trips
        got.metadata.labels["touched"] = "yes"
        rc.update(got)
        assert rc.get(obj.metadata.name).metadata.labels["touched"] == "yes"
        # list sees it
        items, _rv = rc.list()
        assert [o.metadata.name for o in items] == [obj.metadata.name]
        rc.delete(obj.metadata.name)
        assert done.wait(5), f"watch never saw DELETED; got {events}"
        assert events[0] == ("ADDED", obj.metadata.name)
        assert ("DELETED", obj.metadata.name) in events

    def test_ingress_requires_backend_or_rules(self, plane):
        server, client = plane
        with pytest.raises(APIStatusError) as ei:
            client.resource("ingresses", "default").create(
                t.Ingress(metadata=t.ObjectMeta(name="empty")))
        assert ei.value.code == 422

    def test_scheduledjob_requires_valid_cron(self, plane):
        server, client = plane
        with pytest.raises(APIStatusError) as ei:
            client.resource("scheduledjobs", "default").create(
                t.ScheduledJob(metadata=t.ObjectMeta(name="bad"),
                               spec=t.ScheduledJobSpec(schedule="whenever")))
        assert ei.value.code == 422


class TestComponentStatus:
    def test_virtual_health_listing(self, plane):
        server, client = plane
        healthy = [True]
        server.register_component(
            "scheduler", lambda: (healthy[0], "ok")
        )
        server.register_component(
            "controller-manager", lambda: (True, "ok")
        )
        items, _ = client.resource("componentstatuses").list()
        names = {c.metadata.name for c in items}
        assert names == {"etcd-0", "scheduler", "controller-manager"}
        cs = client.resource("componentstatuses").get("scheduler")
        assert cs.conditions[0].status == "True"
        # component goes down: the NEXT get reflects it (live probe,
        # nothing cached or stored)
        healthy[0] = False
        cs = client.resource("componentstatuses").get("scheduler")
        assert cs.conditions[0].status == "False"
        assert cs.conditions[0].error

    def test_read_only(self, plane):
        server, client = plane
        with pytest.raises(APIStatusError) as ei:
            client.resource("componentstatuses").create(
                t.ComponentStatus(metadata=t.ObjectMeta(name="x")))
        assert ei.value.code == 405


class TestKubectl:
    def test_get_new_resources(self):
        server = APIServer()
        client = RESTClient(LocalTransport(server))
        for resource, obj in mk_objects():
            client.resource(resource, obj.metadata.namespace).create(obj)
        kc = Kubectl(client)
        out = kc.get("ing")
        assert "foo.bar.com" in out and "web" in out
        out = kc.get("pdb")
        assert "zk-budget" in out and "2" in out
        out = kc.get("scheduledjobs")
        assert "nightly" in out and "0 2 * * *" in out
        out = kc.get("netpol")
        assert "allow-frontend" in out
        out = kc.get("psp")
        assert "restricted" in out
        out = kc.get("podtemplates")
        assert "base" in out
        out = kc.get("cs")
        assert "etcd-0" in out and "Healthy" in out
        # describe works for each
        assert "foo.bar.com" not in kc.describe("pdb", "zk-budget")
        assert "zk-budget" in kc.describe("pdb", "zk-budget")


class TestDiscovery:
    """/apis group/version discovery (apiserver.go APIGroupVersion
    install; genericapiserver.go:332 swagger wiring)."""

    def test_apigrouplist(self, plane):
        server, client = plane
        body = client.do_raw("GET", "/apis")
        assert body["kind"] == "APIGroupList"
        names = {g["name"] for g in body["groups"]}
        assert {"extensions", "batch", "policy", "autoscaling"} <= names
        ext = next(g for g in body["groups"] if g["name"] == "extensions")
        assert ext["preferredVersion"]["groupVersion"].startswith(
            "extensions/"
        )

    def test_core_versions_and_resource_list(self, plane):
        server, client = plane
        assert client.do_raw("GET", "/api")["versions"] == ["v1"]
        rl = client.do_raw("GET", "/api/v1")
        assert rl["kind"] == "APIResourceList"
        byname = {r["name"]: r for r in rl["resources"]}
        assert byname["pods"]["namespaced"] is True
        assert byname["nodes"]["namespaced"] is False
        assert "pods/binding" in byname and "pods/status" in byname
        assert "componentstatuses" in byname

    def test_group_resource_list(self, plane):
        server, client = plane
        rl = client.do_raw("GET", "/apis/extensions/v1beta1")
        byname = {r["name"] for r in rl["resources"]}
        assert {"ingresses", "networkpolicies", "podsecuritypolicies",
                "replicasets", "deployments"} <= byname
        rl = client.do_raw("GET", "/apis/policy/v1alpha1")
        assert {r["name"] for r in rl["resources"]} >= {
            "poddisruptionbudgets", "poddisruptionbudgets/status"}
        # unknown version 404s like the reference's discovery-gated mux
        with pytest.raises(APIStatusError) as ei:
            client.do_raw("GET", "/apis/extensions/v9")
        assert ei.value.code == 404

    def test_swagger_index(self, plane):
        server, client = plane
        sw = client.do_raw("GET", "/swaggerapi")
        paths = {a["path"] for a in sw["apis"]}
        assert "/api/v1" in paths and "/apis/extensions/v1beta1" in paths

    def test_generic_client_can_enumerate_everything(self, plane):
        """The VERDICT bar: group list -> per-group resource lists."""
        server, client = plane
        groups = client.do_raw("GET", "/apis")["groups"]
        total = {
            r["name"] for r in client.do_raw("GET", "/api/v1")["resources"]
        }
        for g in groups:
            for v in g["versions"]:
                rl = client.do_raw("GET", f"/apis/{v['groupVersion']}")
                total |= {r["name"] for r in rl["resources"]}
        # every registered resource is discoverable somewhere
        for r in server.resources:
            assert r in total, f"{r} not discoverable"


class TestNewKubectlVerbs:
    def _plane(self):
        server = APIServer()
        client = RESTClient(LocalTransport(server))
        return server, client, Kubectl(client)

    def test_api_versions_and_cluster_info(self):
        server, client, kc = self._plane()
        out = kc.api_versions()
        assert "v1" in out.splitlines()
        assert "extensions/v1beta1" in out
        assert "policy/v1alpha1" in out
        info = kc.cluster_info()
        assert "Kubernetes master is running at" in info

    def test_replace(self, tmp_path):
        import json as jsonlib

        server, client, kc = self._plane()
        client.resource("configmaps", "default").create(
            t.ConfigMap(metadata=t.ObjectMeta(name="cfg"),
                        data={"a": "1"}))
        mf = tmp_path / "cm.json"
        mf.write_text(jsonlib.dumps({
            "kind": "ConfigMap",
            "metadata": {"name": "cfg", "namespace": "default"},
            "data": {"a": "2"},
        }))
        out = kc.replace(str(mf))
        assert "replaced" in out
        assert client.resource("configmaps", "default").get(
            "cfg").data["a"] == "2"
        # replace (unlike apply) demands existence
        mf2 = tmp_path / "cm2.json"
        mf2.write_text(jsonlib.dumps({
            "kind": "ConfigMap",
            "metadata": {"name": "absent", "namespace": "default"},
            "data": {},
        }))
        with pytest.raises(APIStatusError):
            kc.replace(str(mf2))
        # --force re-creates
        out = kc.replace(str(mf2), force=True)
        assert "replaced" in out

    def test_taint_add_and_remove(self):
        from kubernetes_tpu_torch.api.types import get_taints

        server, client, kc = self._plane()
        client.resource("nodes").create(
            t.Node(metadata=t.ObjectMeta(name="n1", namespace="")))
        kc.taint("n1", "dedicated=infra:NoSchedule")
        node = client.resource("nodes").get("n1")
        taints = get_taints(node)
        assert [(x.key, x.value, x.effect) for x in taints] == [
            ("dedicated", "infra", "NoSchedule")]
        # re-tainting the same key:effect overwrites, not duplicates
        kc.taint("n1", "dedicated=batch:NoSchedule")
        taints = get_taints(client.resource("nodes").get("n1"))
        assert [(x.key, x.value) for x in taints] == [("dedicated", "batch")]
        # removal via trailing dash
        kc.taint("n1", "dedicated:NoSchedule-")
        assert get_taints(client.resource("nodes").get("n1")) == []
        with pytest.raises(ValueError):
            kc.taint("n1", "keyonly")
        # a malformed add must not masquerade as a removal
        kc.taint("n1", "foo=x:NoSchedule")
        with pytest.raises(ValueError):
            kc.taint("n1", "foo=bar-")
        assert len(get_taints(client.resource("nodes").get("n1"))) == 1

    def test_taint_spec_field_form(self):
        """Nodes carrying spec.taints (the direct form get_taints
        prefers) get mutated IN that form."""
        from kubernetes_tpu_torch.api.types import get_taints

        server, client, kc = self._plane()
        client.resource("nodes").create(t.Node(
            metadata=t.ObjectMeta(name="n2", namespace=""),
            spec=t.NodeSpec(taints=[t.Taint(
                key="old", value="", effect="NoSchedule")]),
        ))
        kc.taint("n2", "extra=1:PreferNoSchedule")
        node = client.resource("nodes").get("n2")
        assert node.spec.taints is not None  # stayed in spec form
        assert {(x.key, x.effect) for x in get_taints(node)} == {
            ("old", "NoSchedule"), ("extra", "PreferNoSchedule")}
        kc.taint("n2", "old:NoSchedule-")
        assert {x.key for x in get_taints(
            client.resource("nodes").get("n2"))} == {"extra"}


class TestSwaggerModels:
    def test_model_schemas_served_per_group_version(self, plane):
        server, client = plane
        doc = client.do_raw("GET", "/swaggerapi/api/v1")
        assert doc["swaggerVersion"] == "1.2"
        models = doc["models"]
        pod = models["Pod"]
        assert pod["properties"]["metadata"] == {"$ref": "ObjectMeta"}
        spec = models["PodSpec"]["properties"]
        assert spec["containers"]["type"] == "array"
        assert spec["containers"]["items"] == {"$ref": "Container"}
        assert spec["nodeName"] == {"type": "string"}
        # transitively referenced models are present
        assert "Container" in models and "ObjectMeta" in models
        # extension group serves its own kinds
        ext = client.do_raw("GET", "/apis/extensions/v1beta1")
        assert ext["kind"] == "APIResourceList"
        doc2 = client.do_raw("GET", "/swaggerapi/apis/extensions/v1beta1")
        assert "Deployment" in doc2["models"]

    def test_unknown_swagger_path_404s(self, plane):
        server, client = plane
        from kubernetes_tpu_torch.client.rest import APIStatusError

        with pytest.raises(APIStatusError) as e:
            client.do_raw("GET", "/swaggerapi/apis/nope/v9")
        assert e.value.code == 404
