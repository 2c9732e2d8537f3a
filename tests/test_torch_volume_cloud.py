"""Volume plugin registry, cloud provider fake, and the PV claim binder
(pkg/volume, pkg/cloudprovider, pkg/controller/persistentvolume).

The cases of tests/test_volume_cloud.py, run against the port's copies
(kubernetes_tpu_torch), each with the mark it has there."""

import time

import pytest

from kubernetes_tpu_torch.api.types import (
    AWSElasticBlockStore,
    GCEPersistentDisk,
    ObjectMeta,
    PersistentVolume,
    PersistentVolumeClaim,
    RBDVolume,
    Volume,
)
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.rest import RESTClient
from kubernetes_tpu_torch.client.transport import LocalTransport
from kubernetes_tpu_torch.cloudprovider import FakeCloud, get_cloud_provider
from kubernetes_tpu_torch.controller.framework import SharedInformerFactory
from kubernetes_tpu_torch.controller.pv_binder import PersistentVolumeClaimBinder
from kubernetes_tpu_torch.volume import FakeMounter, default_plugin_mgr
from kubernetes_tpu_torch.volume.plugins import VolumeSpec


from conftest import wait_until  # noqa: E402


def test_plugin_resolution_and_mount_cycle():
    mgr = default_plugin_mgr()
    mounter = FakeMounter()
    specs = {
        "kubernetes.io/gce-pd": VolumeSpec(
            volume=Volume(name="d", gce_persistent_disk=GCEPersistentDisk(pd_name="pd1"))
        ),
        "kubernetes.io/aws-ebs": VolumeSpec(
            volume=Volume(name="e", aws_elastic_block_store=AWSElasticBlockStore(volume_id="v1"))
        ),
        "kubernetes.io/rbd": VolumeSpec(
            volume=Volume(name="r", rbd=RBDVolume(monitors=("m",), pool="p", image="i"))
        ),
        "kubernetes.io/empty-dir": VolumeSpec(volume=Volume(name="scratch")),
    }
    for want, spec in specs.items():
        plugin = mgr.find_plugin_by_spec(spec)
        assert plugin.name == want
        path = plugin.setup(mounter, spec, pod_uid="u1")
        assert mounter.is_mounted(path)
        plugin.teardown(mounter, spec, pod_uid="u1")
        assert not mounter.is_mounted(path)
    # PV-backed spec resolves too
    pv_spec = VolumeSpec(
        pv=PersistentVolume(
            metadata=ObjectMeta(name="pv1"),
            gce_persistent_disk=GCEPersistentDisk(pd_name="pd9"),
        )
    )
    assert mgr.find_plugin_by_spec(pv_spec).name == "kubernetes.io/gce-pd"
    assert mgr.find_plugin_by_name("kubernetes.io/aws-ebs").attachable


def test_fake_cloud_provider():
    cloud = get_cloud_provider("fake")
    assert isinstance(cloud, FakeCloud)
    cloud.instances = ["n1", "n2"]
    assert cloud.external_id("n1") == "ext-n1"
    assert cloud.list_instances() == ["n1", "n2"]
    assert cloud.get_zone().region == "us-central1"
    lb = cloud.ensure_tcp_load_balancer("svc", "r1", (80,), ("n1",))
    assert cloud.get_tcp_load_balancer("svc", "r1") == lb
    cloud.ensure_tcp_load_balancer_deleted("svc", "r1")
    assert cloud.get_tcp_load_balancer("svc", "r1") is None
    assert "ensure-lb" in cloud.calls


def test_pv_claim_binder():
    server = APIServer()
    client = RESTClient(LocalTransport(server))
    informers = SharedInformerFactory(client)
    binder = PersistentVolumeClaimBinder(client, informers)
    pv_client = client.resource("persistentvolumes")
    pvc_client = client.resource("persistentvolumeclaims", "default")
    pv_client.create(PersistentVolume(
        metadata=ObjectMeta(name="small"), capacity={"storage": "1Gi"}))
    pv_client.create(PersistentVolume(
        metadata=ObjectMeta(name="big"), capacity={"storage": "100Gi"}))
    pvc_client.create(PersistentVolumeClaim(
        metadata=ObjectMeta(name="claim"), requests={"storage": "500Mi"}))
    informers.start()
    informers.wait_for_sync()
    assert wait_until(lambda: len(informers.informer("persistentvolumes").store.list()) == 2)
    assert binder.sync_once() == 1
    # smallest fitting PV wins; two-way binding recorded
    assert pvc_client.get("claim").volume_name == "small"
    assert pv_client.get("small").claim_ref == "default/claim"
    assert pv_client.get("big").claim_ref == ""
    # claim deleted -> PV released
    pvc_client.delete("claim")
    assert wait_until(
        lambda: len(informers.informer("persistentvolumeclaims").store.list()) == 0
    )
    binder.sync_once()
    assert pv_client.get("small").claim_ref == ""
    informers.stop()


def test_pv_binder_no_double_bind():
    """Review regression: two unbound PVCs and one PV must result in
    exactly one binding, not both claims sharing the volume."""
    server = APIServer()
    client = RESTClient(LocalTransport(server))
    informers = SharedInformerFactory(client)
    binder = PersistentVolumeClaimBinder(client, informers)
    client.resource("persistentvolumes").create(PersistentVolume(
        metadata=ObjectMeta(name="only"), capacity={"storage": "10Gi"}))
    pvc_client = client.resource("persistentvolumeclaims", "default")
    pvc_client.create(PersistentVolumeClaim(
        metadata=ObjectMeta(name="a"), requests={"storage": "1Gi"}))
    pvc_client.create(PersistentVolumeClaim(
        metadata=ObjectMeta(name="b"), requests={"storage": "1Gi"}))
    informers.start()
    informers.wait_for_sync()
    assert wait_until(
        lambda: len(informers.informer("persistentvolumeclaims").store.list()) == 2
    )
    assert binder.sync_once() == 1
    bound = [pvc_client.get(n).volume_name for n in ("a", "b")]
    assert sorted(bound) == ["", "only"]
    informers.stop()


class TestVolumePluginBreadth:
    """Every reference volume family routes to exactly one plugin
    (pkg/volume/plugins.go FindPluginBySpec)."""

    def test_all_sources_route(self):
        from kubernetes_tpu_torch.api import types as t
        from kubernetes_tpu_torch.volume.plugins import (
            VolumeSpec,
            default_plugin_mgr,
        )

        mgr = default_plugin_mgr()
        cases = [
            (t.Volume(name="v", gce_persistent_disk=t.GCEPersistentDisk(
                pd_name="d")), "kubernetes.io/gce-pd", "gce-pd/d"),
            (t.Volume(name="v", aws_elastic_block_store=t.AWSElasticBlockStore(
                volume_id="i")), "kubernetes.io/aws-ebs", "aws-ebs/i"),
            (t.Volume(name="v", rbd=t.RBDVolume(pool="p", image="im")),
             "kubernetes.io/rbd", "rbd/p/im"),
            (t.Volume(name="v", host_path=t.HostPathVolumeSource(path="/x")),
             "kubernetes.io/host-path", "/x"),
            (t.Volume(name="v"), "kubernetes.io/empty-dir", "tmpfs"),
            (t.Volume(name="v", nfs=t.NFSVolumeSource(server="s",
                                                      path="/e")),
             "kubernetes.io/nfs", "nfs/s/e"),
            (t.Volume(name="v", iscsi=t.ISCSIVolumeSource(
                target_portal="tp", iqn="iqn.x", lun=2)),
             "kubernetes.io/iscsi", "iscsi/tp/iqn.x/lun-2"),
            (t.Volume(name="v", glusterfs=t.GlusterfsVolumeSource(
                endpoints_name="ep", path="vol")),
             "kubernetes.io/glusterfs", "glusterfs/ep/vol"),
            (t.Volume(name="v", cephfs=t.CephFSVolumeSource(
                monitors=("m1", "m2"))), "kubernetes.io/cephfs",
             "cephfs/m1,m2/"),
            (t.Volume(name="v", cinder=t.CinderVolumeSource(
                volume_id="c1")), "kubernetes.io/cinder", "cinder/c1"),
            (t.Volume(name="v", fc=t.FCVolumeSource(
                target_wwns=("w1",), lun=1)), "kubernetes.io/fc",
             "fc/w1/lun-1"),
            (t.Volume(name="v", azure_file=t.AzureFileVolumeSource(
                share_name="sh")), "kubernetes.io/azure-file",
             "azure-file/sh"),
            (t.Volume(name="v", flocker=t.FlockerVolumeSource(
                dataset_name="ds")), "kubernetes.io/flocker", "flocker/ds"),
            (t.Volume(name="v", vsphere_volume=(
                t.VsphereVirtualDiskVolumeSource(volume_path="[ds] x"))),
             "kubernetes.io/vsphere-volume", "vsphere/[ds] x"),
            (t.Volume(name="v", secret=t.SecretVolumeSource(
                secret_name="tok")), "kubernetes.io/secret", "secret/tok"),
            (t.Volume(name="v", config_map=t.ConfigMapVolumeSource(
                name="cm")), "kubernetes.io/configmap", "configmap/cm"),
            (t.Volume(name="v", downward_api=t.DownwardAPIVolumeSource()),
             "kubernetes.io/downward-api", "downward-api"),
            (t.Volume(name="v", git_repo=t.GitRepoVolumeSource(
                repository="r")), "kubernetes.io/git-repo", "git/r@HEAD"),
        ]
        for vol, plugin_name, device in cases:
            spec = VolumeSpec(volume=vol)
            p = mgr.find_plugin_by_spec(spec)
            assert p.name == plugin_name, (vol, p.name)
            assert p.device_of(spec) == device

    def test_pv_sources_route(self):
        from kubernetes_tpu_torch.api import types as t
        from kubernetes_tpu_torch.volume.plugins import (
            VolumeSpec,
            default_plugin_mgr,
        )

        mgr = default_plugin_mgr()
        pv = t.PersistentVolume(
            metadata=t.ObjectMeta(name="pv1"),
            nfs=t.NFSVolumeSource(server="s", path="/e"),
        )
        p = mgr.find_plugin_by_spec(VolumeSpec(pv=pv))
        assert p.name == "kubernetes.io/nfs"


class TestAttachDetachController:
    def test_attach_then_detach_follows_pods(self):
        import time

        from kubernetes_tpu_torch.api import types as t
        from kubernetes_tpu_torch.apiserver.server import APIServer
        from kubernetes_tpu_torch.client.rest import RESTClient
        from kubernetes_tpu_torch.client.transport import LocalTransport
        from kubernetes_tpu_torch.controller.attach_detach import (
            AttachDetachController,
        )
        from kubernetes_tpu_torch.controller.framework import SharedInformerFactory

        server = APIServer()
        client = RESTClient(LocalTransport(server))
        client.nodes().create(t.Node(metadata=t.ObjectMeta(name="n1")))
        informers = SharedInformerFactory(client)
        ctrl = AttachDetachController(client, informers)
        informers.start()
        informers.wait_for_sync()
        # a scheduled pod with an attachable inline volume
        client.pods().create(t.Pod(
            metadata=t.ObjectMeta(name="p1"),
            spec=t.PodSpec(node_name="n1", containers=[
                t.Container(name="c")],
                volumes=[t.Volume(name="disk",
                                  gce_persistent_disk=t.GCEPersistentDisk(
                                      pd_name="data-1"))]),
        ))
        # and one with a PVC -> bound PV (attachable)
        client.resource("persistentvolumes", "").create(t.PersistentVolume(
            metadata=t.ObjectMeta(name="pv9", namespace=""),
            cinder=t.CinderVolumeSource(volume_id="vol-9"),
        ))
        client.resource("persistentvolumeclaims", "default").create(
            t.PersistentVolumeClaim(
                metadata=t.ObjectMeta(name="claim9"),
                volume_name="pv9",
            )
        )
        client.pods().create(t.Pod(
            metadata=t.ObjectMeta(name="p2"),
            spec=t.PodSpec(node_name="n1", containers=[
                t.Container(name="c")],
                volumes=[t.Volume(
                    name="pvc",
                    persistent_volume_claim=t.PersistentVolumeClaimSource(
                        claim_name="claim9"))]),
        ))

        def attached():
            return {v.name
                    for v in client.nodes().get("n1").status.volumes_attached}

        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            ctrl.sync_once()
            if attached() == {"gce-pd/data-1", "cinder/vol-9"}:
                break
            time.sleep(0.05)
        assert attached() == {"gce-pd/data-1", "cinder/vol-9"}
        # delete p1: its disk detaches, the PVC-backed one stays
        client.pods().delete("p1")
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            ctrl.sync_once()
            if attached() == {"cinder/vol-9"}:
                break
            time.sleep(0.05)
        assert attached() == {"cinder/vol-9"}


# -- the local cloud provider: a load balancer that forwards bytes -----------
# (providers/gce/gce.go capability, realized in-process: ServiceController
#  -> LocalCloud LB -> userspace proxy -> pod backend)


class TestLocalCloudLoadBalancer:
    def _echo_backend(self):
        import socketserver
        import threading

        class H(socketserver.BaseRequestHandler):
            def handle(self):
                data = self.request.recv(4096)
                if data:
                    self.request.sendall(b"pod:" + data)

        srv = socketserver.ThreadingTCPServer(("127.0.0.1", 0), H)
        srv.daemon_threads = True
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv

    def test_servicecontroller_provisions_working_lb(self):
        import socket

        from kubernetes_tpu_torch.api.types import (
            EndpointAddress,
            EndpointPort,
            Endpoints,
            EndpointSubset,
            Node,
            NodeStatus,
            Service,
            ServicePort,
            ServiceSpec,
        )
        from kubernetes_tpu_torch.cloudprovider import LocalCloud
        from kubernetes_tpu_torch.controller.cloud import ServiceController
        from kubernetes_tpu_torch.proxy.userspace import UserspaceProxier

        server = APIServer()
        client = RESTClient(LocalTransport(server))
        backend = self._echo_backend()
        proxier = UserspaceProxier(client, node_name="n1").run()
        cloud = LocalCloud()
        cloud.register_node("n1", proxier)
        client.resource("nodes").create(
            Node(metadata=ObjectMeta(name="n1"), status=NodeStatus())
        )
        # a LoadBalancer service + endpoints at the live backend
        sport = 18080
        client.resource("services", "default").create(Service(
            metadata=ObjectMeta(name="web", uid="uid-web-1"),
            spec=ServiceSpec(
                type="LoadBalancer",
                cluster_ip="10.0.0.20",
                ports=[ServicePort(name="http", port=sport)],
            ),
        ))
        client.resource("endpoints", "default").create(Endpoints(
            metadata=ObjectMeta(name="web"),
            subsets=[EndpointSubset(
                addresses=[EndpointAddress(ip="127.0.0.1")],
                ports=[EndpointPort(
                    name="http", port=backend.server_address[1]
                )],
            )],
        ))
        informers = SharedInformerFactory(client)
        ctrl = ServiceController(client, informers, cloud)
        informers.start()
        informers.wait_for_sync()
        # proxier must have its listener before the LB forwards
        assert wait_until(
            lambda: proxier.addr_for_port(sport) is not None
        )
        ctrl.sync_once()
        svc = client.resource("services", "default").get("web")
        # LB provisioned + address persisted in service status; node
        # ports were allocated by the apiserver (30000-32767)
        assert svc.status.load_balancer.ingress
        ingress_ip = svc.status.load_balancer.ingress[0].ip
        assert ingress_ip.startswith("127.200.")
        assert 30000 <= svc.spec.ports[0].node_port <= 32767
        # real-k8s dial semantics: ingress ip + the service's own port
        lb_addr = (ingress_ip, sport)
        assert cloud.lb_addr(ctrl._lb_name(svc), "local", sport) == lb_addr
        # real bytes: client -> cloud LB -> node proxy -> pod backend
        with socket.create_connection(lb_addr, timeout=5) as s:
            s.sendall(b"ping")
            assert s.recv(4096) == b"pod:ping"
        # service deleted -> balancer torn down
        client.resource("services", "default").delete("web")
        assert wait_until(lambda: not any(
            s.metadata.name == "web"
            for s in informers.informer("services").store.list()
        ))
        ctrl.sync_once()
        assert cloud.lb_addr(ctrl._lb_name(svc), "local", sport) is None

        def refused():
            try:
                socket.create_connection(lb_addr, timeout=1).close()
                return False
            except OSError:
                return True

        assert wait_until(refused)  # listener torn down
        proxier.stop()
        informers.stop()
        backend.shutdown()
        backend.server_close()


class TestCloudDiskAttachers:
    """The real attach state machines (gce_pd/attacher.go,
    aws_ebs/attacher.go) against the fake cloud — VERDICT r3 #9."""

    def _plane(self):
        from kubernetes_tpu_torch.cloudprovider import FakeCloud
        from kubernetes_tpu_torch.controller.attach_detach import (
            AttachDetachController,
        )

        server = APIServer()
        client = RESTClient(LocalTransport(server))
        informers = SharedInformerFactory(client)
        cloud = FakeCloud(instances=["n1", "n2"])
        ctrl = AttachDetachController(client, informers, cloud=cloud)
        return server, client, informers, cloud, ctrl

    @staticmethod
    def _pd_pod(name, node, pd="data-disk", read_only=False):
        from kubernetes_tpu_torch.api.types import (
            Container,
            GCEPersistentDisk,
            Pod,
            PodSpec,
            Volume,
        )

        return Pod(
            metadata=ObjectMeta(name=name),
            spec=PodSpec(
                node_name=node,
                containers=[Container(name="c")],
                volumes=[Volume(
                    name="v",
                    gce_persistent_disk=GCEPersistentDisk(
                        pd_name=pd, read_only=read_only),
                )],
            ),
        )

    def test_attach_goes_through_the_cloud(self):
        from kubernetes_tpu_torch.api.types import Node

        server, client, informers, cloud, ctrl = self._plane()
        client.resource("nodes").create(Node(
            metadata=ObjectMeta(name="n1", namespace="")))
        client.pods().create(self._pd_pod("p1", "n1"))
        informers.start()
        informers.wait_for_sync()
        wait_until(lambda: len(informers.pods().store.list()) == 1)
        ctrl.sync_once()
        # the cloud's attachment table is authoritative
        assert cloud.disk_is_attached("gce-pd/data-disk", "n1")
        node = client.resource("nodes").get("n1")
        assert [v.name for v in node.status.volumes_attached] == [
            "gce-pd/data-disk"]
        # pod gone -> cloud detach
        client.pods().delete("p1")
        wait_until(lambda: not informers.pods().store.list())
        ctrl.sync_once()
        assert not cloud.disk_is_attached("gce-pd/data-disk", "n1")
        informers.stop()

    def test_rw_disk_attaches_to_one_node_only(self):
        from kubernetes_tpu_torch.api.types import Node

        server, client, informers, cloud, ctrl = self._plane()
        for n in ("n1", "n2"):
            client.resource("nodes").create(Node(
                metadata=ObjectMeta(name=n, namespace="")))
        client.pods().create(self._pd_pod("p1", "n1"))
        client.pods().create(self._pd_pod("p2", "n2"))
        informers.start()
        informers.wait_for_sync()
        wait_until(lambda: len(informers.pods().store.list()) == 2)
        ctrl.sync_once()
        # exactly one node holds the RW disk; the other is refused
        holders = [n for n in ("n1", "n2")
                   if cloud.disk_is_attached("gce-pd/data-disk", n)]
        assert len(holders) == 1
        assert ctrl.conflicts >= 1
        # the holder's pod leaves -> next syncs flip the attachment
        holder = holders[0]
        client.pods().delete("p1" if holder == "n1" else "p2")
        wait_until(lambda: len(informers.pods().store.list()) == 1)
        ctrl.sync_once()  # detaches from the old holder
        ctrl.sync_once()  # attaches to the waiting node
        other = "n2" if holder == "n1" else "n1"
        assert cloud.disk_is_attached("gce-pd/data-disk", other)
        assert not cloud.disk_is_attached("gce-pd/data-disk", holder)
        informers.stop()

    def test_wait_for_attach_polls_the_cloud(self):
        from kubernetes_tpu_torch.cloudprovider import FakeCloud
        from kubernetes_tpu_torch.volume.attachers import CloudDiskAttacher
        from kubernetes_tpu_torch.volume.plugins import (
            VolumeSpec,
            default_plugin_mgr,
        )
        from kubernetes_tpu_torch.api.types import GCEPersistentDisk, Volume

        cloud = FakeCloud(instances=["n1"])
        spec = VolumeSpec(volume=Volume(
            name="v", gce_persistent_disk=GCEPersistentDisk(pd_name="d")))
        plugin = default_plugin_mgr().find_plugin_by_spec(spec)
        att = CloudDiskAttacher(plugin, cloud)
        assert att.wait_for_attach(spec, "n1", timeout=0.2) is None
        path = att.attach(spec, "n1")
        assert path == "/dev/disk/by-id/gce-pd/d"
        assert att.wait_for_attach(spec, "n1", timeout=1.0) == path
        # detach is idempotent
        att.detach("gce-pd/d", "n1")
        att.detach("gce-pd/d", "n1")


def test_localcloud_implements_disk_ops():
    """local-up wires cloud=LocalCloud into the attach/detach
    controller; the local provider must carry the same disk semantics
    as the fake (regression: it once inherited NotImplementedError)."""
    from kubernetes_tpu_torch.cloudprovider import LocalCloud
    from kubernetes_tpu_torch.cloudprovider.cloud import DiskConflict

    lc = LocalCloud()
    assert lc.attach_disk("d1", "n1") == "/dev/disk/by-id/d1"
    with pytest.raises(DiskConflict):
        lc.attach_disk("d1", "n2")
    assert lc.disks_attached_to("n1") == ["d1"]
    lc.detach_disk("d1", "n1")
    assert lc.all_disk_attachments() == {}


def test_startup_sweep_releases_holds_of_deleted_nodes():
    """A node deleted while the controller was DOWN must not leak its
    cloud holds: the first sync lists the cloud's attachment table and
    sweeps (reconciler.go actual-state at startup)."""
    from kubernetes_tpu_torch.api.types import Node
    from kubernetes_tpu_torch.cloudprovider import FakeCloud
    from kubernetes_tpu_torch.controller.attach_detach import (
        AttachDetachController,
    )

    server = APIServer()
    client = RESTClient(LocalTransport(server))
    informers = SharedInformerFactory(client)
    cloud = FakeCloud(instances=["n1"])
    # a hold left by a previous controller process on a node that no
    # longer exists
    cloud.attach_disk("gce-pd/orphan", "dead-node")
    client.resource("nodes").create(Node(
        metadata=ObjectMeta(name="n1", namespace="")))
    ctrl = AttachDetachController(client, informers, cloud=cloud)
    informers.start()
    informers.wait_for_sync()
    ctrl.sync_once()
    assert not cloud.disk_is_attached("gce-pd/orphan", "dead-node")
    informers.stop()


# -- the multizone cloud provider: regional semantics behind the same --------
# interface (providers/aws + providers/gce registry breadth)


class TestMultiZoneCloud:
    def test_instances_and_zones(self):
        from kubernetes_tpu_torch.cloudprovider import MultiZoneCloud, get_cloud_provider
        from kubernetes_tpu_torch.cloudprovider.cloud import InstanceNotFound

        assert isinstance(get_cloud_provider("multizone"), MultiZoneCloud)
        cloud = MultiZoneCloud()
        zones = {cloud.add_instance(f"n{i}") for i in range(6)}
        assert zones == set(cloud.zones)  # round-robin covers all zones
        assert cloud.instance_zone("n0").region == "us-sim1"
        with pytest.raises(InstanceNotFound):
            cloud.instance_zone("ghost")
        assert cloud.external_id("n1").startswith("mz-us-sim1-")

    def test_zonal_disk_placement_rule(self):
        from kubernetes_tpu_torch.cloudprovider import MultiZoneCloud
        from kubernetes_tpu_torch.cloudprovider.cloud import DiskConflict

        cloud = MultiZoneCloud()
        cloud.add_instance("a1", "us-sim1-a")
        cloud.add_instance("b1", "us-sim1-b")
        cloud.create_disk("pd-a", "us-sim1-a")
        # attach in-zone OK; cross-zone is the GCE/EBS placement error
        cloud.attach_disk("pd-a", "a1")
        assert cloud.disk_is_attached("pd-a", "a1")
        with pytest.raises(DiskConflict):
            cloud.attach_disk("pd-a", "b1")
        # rw-exclusivity still holds within the zone
        cloud.add_instance("a2", "us-sim1-a")
        with pytest.raises(DiskConflict):
            cloud.attach_disk("pd-a", "a2")
        cloud.detach_disk("pd-a", "a1")
        assert not cloud.disk_is_attached("pd-a", "a1")

    def test_async_attach_passes_through_attaching(self):
        import threading

        from kubernetes_tpu_torch.cloudprovider import MultiZoneCloud

        cloud = MultiZoneCloud(attach_latency=0.3)
        cloud.add_instance("n1", "us-sim1-a")
        done = threading.Event()

        def do():
            cloud.attach_disk("slow-pd", "n1")
            done.set()

        threading.Thread(target=do, daemon=True).start()
        # mid-flight: the cloud reports NOT attached yet
        time.sleep(0.1)
        assert not cloud.disk_is_attached("slow-pd", "n1")
        assert done.wait(5)
        assert cloud.disk_is_attached("slow-pd", "n1")

    def test_attach_detach_controller_against_multizone(self):
        """The SAME attach/detach controller drives the multizone cloud:
        async latency + zonal placement behind the shared interface."""
        from kubernetes_tpu_torch.api.types import Node
        from kubernetes_tpu_torch.cloudprovider import MultiZoneCloud
        from kubernetes_tpu_torch.controller.attach_detach import (
            AttachDetachController,
        )
        from kubernetes_tpu_torch.controller.framework import SharedInformerFactory
        from kubernetes_tpu_torch.apiserver.server import APIServer
        from kubernetes_tpu_torch.client.rest import RESTClient
        from kubernetes_tpu_torch.client.transport import LocalTransport

        server = APIServer()
        client = RESTClient(LocalTransport(server))
        cloud = MultiZoneCloud(attach_latency=0.05, detach_latency=0.05)
        cloud.add_instance("n1", "us-sim1-a")
        informers = SharedInformerFactory(client)
        ctrl = AttachDetachController(client, informers, cloud=cloud)
        informers.start()
        client.resource("nodes").create(Node(metadata=ObjectMeta(name="n1")))
        client.pods().create(TestCloudDiskAttachers._pd_pod("p1", "n1", pd="mz-pd"))
        informers.wait_for_sync()

        def attached():
            n = client.nodes().get("n1")
            return {v.name for v in n.status.volumes_attached}

        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            ctrl.sync_once()
            if attached() == {"gce-pd/mz-pd"}:
                break
            time.sleep(0.05)
        assert attached() == {"gce-pd/mz-pd"}
        assert cloud.disk_is_attached("gce-pd/mz-pd", "n1")
        client.pods().delete("p1")
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            ctrl.sync_once()
            if not attached() and not cloud.disk_is_attached(
                    "gce-pd/mz-pd", "n1"):
                break
            time.sleep(0.05)
        assert not cloud.disk_is_attached("gce-pd/mz-pd", "n1")

    def test_service_controller_regional_lb(self):
        """ServiceController provisions a REGIONAL LB with hosts across
        zones through the same interface the local provider serves."""
        from kubernetes_tpu_torch.api.types import (
            Node, NodeCondition, NodeStatus, Service, ServicePort,
            ServiceSpec,
        )
        from kubernetes_tpu_torch.apiserver.server import APIServer
        from kubernetes_tpu_torch.client.rest import RESTClient
        from kubernetes_tpu_torch.client.transport import LocalTransport
        from kubernetes_tpu_torch.cloudprovider import MultiZoneCloud
        from kubernetes_tpu_torch.controller.cloud import ServiceController
        from kubernetes_tpu_torch.controller.framework import SharedInformerFactory

        server = APIServer()
        client = RESTClient(LocalTransport(server))
        cloud = MultiZoneCloud()
        for i in range(3):
            cloud.add_instance(f"n{i}")
            client.nodes().create(Node(
                metadata=ObjectMeta(name=f"n{i}"),
                status=NodeStatus(conditions=[NodeCondition("Ready", "True")]),
            ))
        informers = SharedInformerFactory(client)
        ctrl = ServiceController(client, informers, cloud)
        informers.start()
        informers.wait_for_sync()
        client.resource("services", "default").create(Service(
            metadata=ObjectMeta(name="web"),
            spec=ServiceSpec(
                type="LoadBalancer", selector={"run": "web"},
                ports=[ServicePort(port=80)],
            ),
        ))
        deadline = time.monotonic() + 10
        ingress = None
        while time.monotonic() < deadline:
            ctrl.sync_once()
            svc = client.resource("services", "default").get("web")
            ing = svc.status.load_balancer.ingress
            if ing:
                ingress = ing[0].ip
                break
            time.sleep(0.05)
        assert ingress and ingress.startswith("203.0."), ingress
        lb = cloud.get_tcp_load_balancer(
            ctrl._lb_name(svc), cloud.region
        )
        assert lb is not None and set(lb.hosts) == {"n0", "n1", "n2"}
        assert lb.ports == (80,)
        # deleting the service tears the LB down
        client.resource("services", "default").delete("web")
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            ctrl.sync_once()
            if cloud.get_tcp_load_balancer("web", cloud.region) is None:
                break
            time.sleep(0.05)
