"""kubectl verbs against the in-process control plane (the reference's
hack/test-cmd.sh golden-output tier, reduced to assertions).

The cases of tests/test_kubectl.py, run against the port's copies
(kubernetes_tpu_torch), each with the mark it has there."""

import json
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
from kubernetes_tpu_torch.client.rest import RESTClient
from kubernetes_tpu_torch.client.transport import LocalTransport
from kubernetes_tpu_torch.kubectl import Kubectl, main


from conftest import wait_until  # noqa: E402


@pytest.fixture()
def kubectl():
    server = APIServer()
    client = RESTClient(LocalTransport(server))
    return Kubectl(client), client


def ready_node(name):
    return Node(
        metadata=ObjectMeta(name=name),
        status=NodeStatus(
            allocatable={"cpu": "4", "memory": "32Gi", "pods": "110"},
            conditions=[NodeCondition("Ready", "True")],
        ),
    )


def test_get_pods_table(kubectl):
    k, client = kubectl
    client.pods().create(
        Pod(metadata=ObjectMeta(name="web-1", labels={"app": "web"}),
            spec=PodSpec(containers=[Container(name="c")]))
    )
    out = k.get("pods")
    assert "NAME" in out and "STATUS" in out
    assert "web-1" in out and "Pending" in out
    # alias + selector + -o name
    assert k.get("po", selector="app=web", output="name") == "pods/web-1"
    assert k.get("po", selector="app=nope", output="name") == ""
    # -o json round-trips
    data = json.loads(k.get("pods", "web-1", output="json"))
    assert data["metadata"]["name"] == "web-1"


def test_run_expose_scale_rollout(kubectl):
    k, client = kubectl
    out = k.run("web", image="nginx", replicas=2)
    assert "created" in out
    rc = client.resource("replicationcontrollers", "default").get("web")
    assert rc.spec.replicas == 2
    assert rc.spec.template.spec.containers[0].image == "nginx"
    out = k.expose("rc", "web", port=80)
    svc = client.resource("services", "default").get("web")
    assert svc.spec.selector == {"run": "web"}
    assert svc.spec.ports[0].port == 80
    out = k.scale("rc", "web", 5)
    assert "scaled" in out
    assert client.resource("replicationcontrollers", "default").get("web").spec.replicas == 5


def test_label_annotate_describe(kubectl):
    k, client = kubectl
    client.pods().create(
        Pod(metadata=ObjectMeta(name="p1"), spec=PodSpec(containers=[Container(name="c", image="img")]))
    )
    k.label("pod", "p1", "tier=frontend")
    assert client.pods().get("p1").metadata.labels["tier"] == "frontend"
    k.label("pod", "p1", "tier-")
    assert "tier" not in client.pods().get("p1").metadata.labels
    k.annotate("pod", "p1", "note=hello")
    out = k.describe("pod", "p1")
    assert "Name:\tp1" in out
    assert "note=hello" in out
    assert "Image:\timg" in out


def test_cordon_drain_uncordon(kubectl):
    k, client = kubectl
    client.nodes().create(ready_node("n1"))
    client.pods().create(
        Pod(metadata=ObjectMeta(name="victim"),
            spec=PodSpec(node_name="n1", containers=[Container(name="c")]))
    )
    daemon = Pod(
        metadata=ObjectMeta(
            name="daemon-pod",
            annotations={"kubernetes.io/created-by": "DaemonSet/default/agent"},
        ),
        spec=PodSpec(node_name="n1", containers=[Container(name="c")]),
    )
    client.pods().create(daemon)
    out = k.drain("n1")
    assert "pod/victim evicted" in out
    assert "daemon-pod" not in out
    assert client.nodes().get("n1").spec.unschedulable is True
    names = {p.metadata.name for p in client.pods().list()[0]}
    assert names == {"daemon-pod"}
    k.uncordon("n1")
    assert client.nodes().get("n1").spec.unschedulable is False


def test_create_apply_delete_from_manifest(kubectl, tmp_path):
    k, client = kubectl
    manifest = tmp_path / "pod.json"
    manifest.write_text(json.dumps({
        "kind": "Pod", "apiVersion": "v1",
        "metadata": {"name": "from-file", "namespace": "default"},
        "spec": {"containers": [{"name": "c", "image": "img:v1"}]},
    }))
    assert "created" in k.create(str(manifest))
    assert client.pods().get("from-file").spec.containers[0].image == "img:v1"
    # apply updates the spec in place
    manifest.write_text(json.dumps({
        "kind": "Pod", "apiVersion": "v1",
        "metadata": {"name": "from-file", "namespace": "default"},
        "spec": {"containers": [{"name": "c", "image": "img:v2"}]},
    }))
    assert "configured" in k.apply(str(manifest))
    assert client.pods().get("from-file").spec.containers[0].image == "img:v2"
    assert "deleted" in k.delete(filename=str(manifest))
    with pytest.raises(Exception):
        client.pods().get("from-file")


def test_yaml_manifest_and_main_argv(kubectl, tmp_path, capsys):
    k, client = kubectl
    manifest = tmp_path / "svc.yaml"
    manifest.write_text(
        "kind: Service\napiVersion: v1\n"
        "metadata:\n  name: web\n  namespace: default\n"
        "spec:\n  selector:\n    app: web\n  ports:\n  - port: 80\n"
    )
    main(["create", "-f", str(manifest)], client=client)
    assert client.resource("services", "default").get("web").spec.ports[0].port == 80
    main(["get", "services"], client=client)
    out = capsys.readouterr().out
    assert "web" in out and "CLUSTER-IP" in out


def test_get_nodes_and_events(kubectl):
    k, client = kubectl
    client.nodes().create(ready_node("n1"))
    out = k.get("nodes")
    assert "n1" in out and "Ready" in out
    # version is a cheap sanity verb
    assert "kubernetes-tpu" in Kubectl(client).get("nodes") or True


def test_logs_and_exec_via_kubelet_api():
    """kubectl logs/exec resolve the pod's node to its kubelet API
    (pkg/kubelet/server) and fetch through /containerLogs and /exec."""
    from kubernetes_tpu_torch.apiserver.server import APIServer
    from kubernetes_tpu_torch.client.rest import RESTClient
    from kubernetes_tpu_torch.client.transport import LocalTransport
    from kubernetes_tpu_torch.kubectl.cmd import Kubectl
    from kubernetes_tpu_torch.kubelet import FakeRuntime, Kubelet, KubeletConfig
    from kubernetes_tpu_torch.api.types import Container, ObjectMeta, Pod, PodSpec
    import time

    server = APIServer()
    client = RESTClient(LocalTransport(server))
    runtime = FakeRuntime()
    kl = Kubelet(client, KubeletConfig(
        node_name="n1", serve_api=True,
        pleg_relist_period=0.05, status_sync_period=0.05,
        node_status_update_frequency=0.05,
    ), runtime).run()
    try:
        client.pods().create(Pod(
            metadata=ObjectMeta(name="web"),
            spec=PodSpec(node_name="n1",
                         containers=[Container(name="main")]),
        ))
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            p = client.pods().get("web")
            n = client.nodes().get("n1")
            if p.status.phase == "Running" and n.status.kubelet_port:
                break
            time.sleep(0.05)
        pod = client.pods().get("web")
        runtime.write_log(pod.metadata.uid, "main", "hello from main")
        runtime.write_log(pod.metadata.uid, "main", "second line")

        k = Kubectl(client)
        out = k.logs("web")
        assert out == "hello from main\nsecond line\n"
        assert k.logs("web", tail=1) == "second line\n"

        runtime.exec_replies[(pod.metadata.uid, "main")] = "root\n"
        assert k.exec("web", ["whoami"]) == "root\n"
        # default echo shape without an injected reply
        del runtime.exec_replies[(pod.metadata.uid, "main")]
        assert k.exec("web", ["echo", "hi"]) == "echo hi\n"
    finally:
        kl.stop()


def test_patch_and_edit(kubectl, tmp_path):
    k, client = kubectl
    client.pods().create(
        Pod(metadata=ObjectMeta(name="web-1", labels={"app": "web"}),
            spec=PodSpec(containers=[Container(name="c")]))
    )
    out = k.patch("pod", "web-1",
                  '{"metadata": {"labels": {"tier": "frontend"}}}')
    assert out == "pods/web-1 patched"
    p = client.pods().get("web-1")
    assert p.metadata.labels["tier"] == "frontend"
    assert p.metadata.labels["app"] == "web"  # merge, not replace

    # edit: a scripted "editor" rewrites a label in the YAML
    editor = tmp_path / "ed.sh"
    editor.write_text("#!/bin/sh\nsed -i 's/frontend/backend/' \"$1\"\n")
    editor.chmod(0o755)
    out = k.edit("pod", "web-1", editor=str(editor))
    assert out == "pods/web-1 edited"
    assert client.pods().get("web-1").metadata.labels["tier"] == "backend"

    # a no-op edit changes nothing
    noop = tmp_path / "noop.sh"
    noop.write_text("#!/bin/sh\ntrue\n")
    noop.chmod(0o755)
    assert "no changes" in k.edit("pod", "web-1", editor=str(noop))


def test_autoscale_and_explain(kubectl):
    k, client = kubectl
    k.run("web", image="nginx", replicas=2)
    out = k.autoscale("rc", "web", 2, 10, cpu_percent=70)
    assert out == "horizontalpodautoscaler/web autoscaled"
    hpa = client.resource("horizontalpodautoscalers", "default").get("web")
    assert hpa.spec.min_replicas == 2 and hpa.spec.max_replicas == 10
    assert hpa.spec.target_cpu_utilization_percentage == 70
    assert hpa.spec.scale_target_kind == "ReplicationController"

    out = k.explain("pods")
    assert "KIND:     Pod" in out and "spec" in out and "metadata" in out
    out = k.explain("pods.spec")
    assert "nodeName" in out and "containers" in out
    out = k.explain("pods.spec.containers")
    assert "image" in out
    with pytest.raises(ValueError):
        k.explain("pods.spec.nosuchfield")


def test_rolling_update(kubectl):
    import threading

    from kubernetes_tpu_torch.controller.manager import ControllerManager

    k, client = kubectl
    cm = ControllerManager(client).start()
    try:
        k.run("web", image="nginx:1.0", replicas=3)
        out = k.rolling_update("web", image="nginx:2.0", timeout=30)
        assert "rolling updated" in out
        rcs, _ = client.resource(
            "replicationcontrollers", "default"
        ).list()
        assert [r.metadata.name for r in rcs] == ["web-next"]
        new = rcs[0]
        assert new.spec.replicas == 3
        assert new.spec.template.spec.containers[0].image == "nginx:2.0"
        # every surviving pod is the new RC's
        assert wait_until(lambda: sum(
            1 for p in client.pods().list()[0]
            if p.metadata.labels.get("deployment") == "web-next"
            and not p.metadata.deletion_timestamp
        ) == 3)
    finally:
        cm.stop()


def test_proxy_and_config(kubectl, tmp_path):
    import json as jsonlib
    import urllib.request

    k, client = kubectl
    client.pods().create(
        Pod(metadata=ObjectMeta(name="via-proxy"),
            spec=PodSpec(containers=[Container(name="c")]))
    )
    handle = k.proxy(0)
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{handle.port}/api/v1/namespaces/default/pods"
        ) as r:
            payload = jsonlib.loads(r.read())
        names = [i["metadata"]["name"] for i in payload["items"]]
        assert "via-proxy" in names
    finally:
        handle.stop()

    cfg = tmp_path / "kubeconfig"
    assert "set" in Kubectl.config(
        str(cfg), ["set-cluster", "tpu", "--server=http://127.0.0.1:8080"])
    Kubectl.config(str(cfg), ["set-context", "dev", "--cluster=tpu",
                              "--namespace=default"])
    assert "Switched" in Kubectl.config(str(cfg), ["use-context", "dev"])
    assert Kubectl.config(str(cfg), ["current-context"]) == "dev"
    view = Kubectl.config(str(cfg), ["view"])
    assert "http://127.0.0.1:8080" in view
    with pytest.raises(ValueError):
        Kubectl.config(str(cfg), ["use-context", "nope"])


def test_attach_portforward_top_via_kubelet_api():
    """kubectl attach streams post-attach writes; port-forward relays
    raw TCP to the pod's port; top reads kubelet stats."""
    import socket
    import threading
    import time

    from kubernetes_tpu_torch.apiserver.server import APIServer
    from kubernetes_tpu_torch.client.rest import RESTClient
    from kubernetes_tpu_torch.client.transport import LocalTransport
    from kubernetes_tpu_torch.kubectl.cmd import Kubectl
    from kubernetes_tpu_torch.kubelet import FakeRuntime, Kubelet, KubeletConfig

    server = APIServer()
    client = RESTClient(LocalTransport(server))
    runtime = FakeRuntime()
    kl = Kubelet(client, KubeletConfig(
        node_name="n1", serve_api=True,
        pleg_relist_period=0.05, status_sync_period=0.05,
        node_status_update_frequency=0.05,
    ), runtime).run()
    try:
        client.pods().create(Pod(
            metadata=ObjectMeta(name="web"),
            spec=PodSpec(node_name="n1",
                         containers=[Container(name="main")]),
        ))
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            p = client.pods().get("web")
            n = client.nodes().get("n1")
            if p.status.phase == "Running" and n.status.kubelet_port:
                break
            time.sleep(0.05)
        pod = client.pods().get("web")
        k = Kubectl(client)

        # attach sees what the container writes AFTER attachment
        runtime.write_log(pod.metadata.uid, "main", "before attach")
        got = {}

        def do_attach():
            got["out"] = k.attach("web", timeout=2.0)

        th = threading.Thread(target=do_attach)
        th.start()
        time.sleep(0.4)
        runtime.write_log(pod.metadata.uid, "main", "during attach")
        th.join(timeout=5)
        assert "during attach" in got["out"]
        assert "before attach" not in got["out"]

        # port-forward: an in-process echo server stands in for the
        # container's listening socket (the hollow-node seam)
        echo = socket.socket()
        echo.bind(("127.0.0.1", 0))
        echo.listen(1)

        def echo_once():
            conn, _ = echo.accept()
            data = conn.recv(1024)
            conn.sendall(b"echo:" + data)
            conn.close()

        threading.Thread(target=echo_once, daemon=True).start()
        runtime.expose_port(pod.metadata.uid, 80, "127.0.0.1",
                            echo.getsockname()[1])
        handle = k.port_forward("web", 0, 80)
        try:
            c = socket.create_connection(
                ("127.0.0.1", handle.local_port), timeout=5
            )
            c.sendall(b"ping")
            c.shutdown(socket.SHUT_WR)
            reply = b""
            while True:
                chunk = c.recv(1024)
                if not chunk:
                    break
                reply += chunk
            assert reply == b"echo:ping"
            c.close()
        finally:
            handle.stop()
            echo.close()

        # top surfaces the kubelet's stats summary
        out = k.top("nodes")
        assert "n1" in out and "NAME" in out
        out = k.top("pods")
        assert "web" in out and "n1" in out
    finally:
        kl.stop()


def test_convert_between_versions(kubectl, tmp_path):
    """kubectl convert re-expresses a manifest at another wire version
    (cmd/convert.go): the legacy extensions/v1beta1 bare-map selector
    becomes the v1beta2 object form."""
    k, _client = kubectl
    src = tmp_path / "rs.json"
    src.write_text(json.dumps({
        "kind": "ReplicaSet", "apiVersion": "extensions/v1beta1",
        "metadata": {"name": "web"},
        "spec": {"replicas": 2, "selector": {"app": "web"}},
    }))
    out = json.loads(k.convert(str(src), "extensions/v1beta2"))
    assert out["apiVersion"] == "extensions/v1beta2"
    assert out["spec"]["selector"] == {"matchLabels": {"app": "web"}}
    assert out["spec"]["replicas"] == 2


def test_kubectl_set_image_and_resources(kubectl):
    k, client = kubectl
    k.run("web", image="app:v1", replicas=2)
    out = main(
        ["set", "image", "rc/web", "web=app:v2"], client=client)
    assert "image updated" in out
    rc = client.resource("replicationcontrollers", "default").get("web")
    assert rc.spec.template.spec.containers[0].image == "app:v2"
    out = main(
        ["set", "resources", "rc/web", "--requests", "cpu=250m,memory=1Gi"],
        client=client)
    assert "updated" in out
    rc = client.resource("replicationcontrollers", "default").get("web")
    assert rc.spec.template.spec.containers[0].requests == {
        "cpu": "250m", "memory": "1Gi"}
    # no matching container is an error, not a silent no-op
    with pytest.raises(ValueError):
        Kubectl(client).set_image("rc/web", ["ghost=x:1"])


def test_kubectl_typed_create_generators(kubectl, tmp_path):
    k, client = kubectl
    out = main(["create", "namespace", "staging"], client=client)
    assert out == "namespace/staging created"
    assert client.resource("namespaces").get("staging")

    out = main(["create", "serviceaccount", "robot"],
                       client=client)
    assert "created" in out

    f = tmp_path / "blob.txt"
    f.write_text("file-value")
    out = main(
        ["create", "secret", "generic", "creds",
         "--from-literal", "user=admin", "--from-file", f"blob={f}"],
        client=client)
    assert "secret/creds created" in out
    import base64
    sec = client.resource("secrets", "default").get("creds")
    assert base64.b64decode(sec.data["user"]).decode() == "admin"
    assert base64.b64decode(sec.data["blob"]).decode() == "file-value"

    out = main(
        ["create", "configmap", "conf", "--from-literal", "mode=fast"],
        client=client)
    assert "configmap/conf created" in out
    cm = client.resource("configmaps", "default").get("conf")
    assert cm.data == {"mode": "fast"}

    out = main(
        ["create", "service", "clusterip", "api", "--tcp", "80:8080"],
        client=client)
    assert "service/api created" in out
    svc = client.resource("services", "default").get("api")
    assert svc.spec.ports[0].port == 80
    assert svc.spec.ports[0].target_port == 8080


def test_kubectl_completion():
    out = main(["completion", "bash"], client=object())
    assert "complete -F" in out and "get" in out and "drain" in out
