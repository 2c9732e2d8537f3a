"""Federation (multi-cluster) + DNS + hyperkube local-up pieces.

The cases of tests/test_federation_dns.py, run against the port's copies
(kubernetes_tpu_torch), each with the mark it has there."""

import time

import pytest

from kubernetes_tpu_torch.api.types import (
    Container,
    EndpointAddress,
    EndpointPort,
    Endpoints,
    EndpointSubset,
    ObjectMeta,
    PodSpec,
    PodTemplateSpec,
    ReplicationController,
    ReplicationControllerSpec,
    Service,
    ServicePort,
    ServiceSpec,
)
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.rest import RESTClient
from kubernetes_tpu_torch.client.transport import HTTPTransport, LocalTransport
from kubernetes_tpu_torch.dns import DNSRecords
from kubernetes_tpu_torch.federation import (
    Cluster,
    ClusterController,
    ClusterSpec,
    FederatedAPIServer,
    FederatedReplicationManager,
)
from kubernetes_tpu_torch.federation.federation import spread_replicas


from conftest import wait_until  # noqa: E402


def test_federation_health_and_spread():
    fed = FederatedAPIServer()
    fed_client = RESTClient(LocalTransport(fed))
    members = {f"c{i}": APIServer() for i in range(3)}
    clients = {n: RESTClient(LocalTransport(s)) for n, s in members.items()}

    def member_client(cluster):
        return clients.get(cluster.metadata.name)

    for name in members:
        fed_client.resource("clusters").create(
            Cluster(metadata=ObjectMeta(name=name),
                    spec=ClusterSpec(server_address=f"local://{name}"))
        )
    # an unreachable member
    fed_client.resource("clusters").create(
        Cluster(metadata=ObjectMeta(name="gone"),
                spec=ClusterSpec(server_address="local://gone"))
    )
    cc = ClusterController(fed_client, member_client)
    cc.sync_once()
    ready = {
        c.metadata.name: c.status.conditions[0].status
        for c in fed_client.resource("clusters").list()[0]
    }
    assert ready == {"c0": "True", "c1": "True", "c2": "True", "gone": "False"}

    # federated RC of 8 replicas spread 3/3/2 across ready clusters
    fed_client.resource("replicationcontrollers", "default").create(
        ReplicationController(
            metadata=ObjectMeta(name="web"),
            spec=ReplicationControllerSpec(
                replicas=8, selector={"app": "web"},
                template=PodTemplateSpec(
                    metadata=ObjectMeta(labels={"app": "web"}),
                    spec=PodSpec(containers=[Container(name="c")]),
                ),
            ),
        )
    )
    frm = FederatedReplicationManager(fed_client, member_client)
    frm.sync_once()
    shares = [
        clients[n].resource("replicationcontrollers", "default").get("web").spec.replicas
        for n in ("c0", "c1", "c2")
    ]
    assert shares == [3, 3, 2]
    # scaling the federated object rebalances members
    rc = fed_client.resource("replicationcontrollers", "default").get("web")
    rc.spec.replicas = 4
    fed_client.resource("replicationcontrollers", "default").update(rc)
    frm.sync_once()
    shares = [
        clients[n].resource("replicationcontrollers", "default").get("web").spec.replicas
        for n in ("c0", "c1", "c2")
    ]
    assert shares == [2, 1, 1]


def test_spread_replicas():
    assert spread_replicas(10, 3) == [4, 3, 3]
    assert spread_replicas(2, 3) == [1, 1, 0]
    assert spread_replicas(0, 2) == [0, 0]
    assert spread_replicas(5, 0) == []


def test_dns_records():
    server = APIServer()
    client = RESTClient(LocalTransport(server))
    dns = DNSRecords(client).run()
    try:
        client.resource("services", "default").create(
            Service(
                metadata=ObjectMeta(name="web"),
                spec=ServiceSpec(
                    selector={"app": "web"},
                    cluster_ip="10.0.0.10",
                    ports=[ServicePort(name="http", port=80)],
                ),
            )
        )
        client.resource("services", "default").create(
            Service(
                metadata=ObjectMeta(name="db"),
                spec=ServiceSpec(selector={"app": "db"}, cluster_ip="None"),
            )
        )
        client.resource("endpoints", "default").create(
            Endpoints(
                metadata=ObjectMeta(name="db"),
                subsets=[EndpointSubset(
                    addresses=[
                        EndpointAddress(ip="10.1.0.5", target_ref="default/db-0"),
                        EndpointAddress(ip="10.1.0.6", target_ref="default/db-1"),
                    ],
                    ports=[EndpointPort(port=5432)],
                )],
            )
        )
        assert wait_until(
            lambda: dns.resolve("web.default.svc.cluster.local") == ["10.0.0.10"]
        )
        # headless -> endpoint IPs; pet hostname -> its own IP
        assert wait_until(
            lambda: dns.resolve("db.default.svc.cluster.local")
            == ["10.1.0.5", "10.1.0.6"]
        )
        assert dns.resolve("db-1.db.default.svc.cluster.local") == ["10.1.0.6"]
        assert dns.resolve("nope.default.svc.cluster.local") == []
        srv = dns.resolve_srv("_http._tcp.web.default.svc.cluster.local")
        assert len(srv) == 1 and srv[0].port == 80
        assert srv[0].target == "web.default.svc.cluster.local"
    finally:
        dns.stop()


def _dns_query(name: str, qtype: int, txn: int = 0x1234) -> bytes:
    """A dig-equivalent raw query packet (RFC1035, RD set)."""
    import struct

    out = bytearray(struct.pack("!HHHHHH", txn, 0x0100, 1, 0, 0, 0))
    for label in name.rstrip(".").split("."):
        out.append(len(label))
        out += label.encode()
    out.append(0)
    out += struct.pack("!HH", qtype, 1)
    return bytes(out)


def _parse_answers(data: bytes, txn: int = 0x1234):
    """-> (rcode, [(type, rdata-bytes)]). Minimal independent parser."""
    import struct

    tid, flags, qd, an, _, _ = struct.unpack_from("!HHHHHH", data, 0)
    assert tid == txn and flags & 0x8000  # a response to our txn
    pos = 12
    while data[pos]:  # skip question name
        pos += 1 + data[pos]
    pos += 1 + 4
    out = []
    for _ in range(an):
        assert data[pos:pos + 2] == b"\xc0\x0c"  # name -> question
        rtype, _cls, _ttl, rdlen = struct.unpack_from("!HHIH", data, pos + 2)
        rdata = data[pos + 12:pos + 12 + rdlen]
        out.append((rtype, rdata))
        pos += 12 + rdlen
    return flags & 0xF, out


def test_dns_wire_protocol():
    """dig-style A and SRV queries over real UDP and TCP sockets resolve
    a service, a headless service, and a pet hostname (cmd/kube-dns)."""
    import socket
    import struct

    from kubernetes_tpu_torch.dns import DNSServer

    server = APIServer()
    client = RESTClient(LocalTransport(server))
    dns = DNSRecords(client).run()
    wire = DNSServer(dns)
    host, port = wire.serve()
    try:
        client.resource("services", "default").create(
            Service(
                metadata=ObjectMeta(name="web"),
                spec=ServiceSpec(
                    selector={"app": "web"},
                    cluster_ip="10.0.0.10",
                    ports=[ServicePort(name="http", port=80)],
                ),
            )
        )
        client.resource("services", "default").create(
            Service(
                metadata=ObjectMeta(name="db"),
                spec=ServiceSpec(selector={"app": "db"}, cluster_ip="None"),
            )
        )
        client.resource("endpoints", "default").create(
            Endpoints(
                metadata=ObjectMeta(name="db"),
                subsets=[EndpointSubset(
                    addresses=[
                        EndpointAddress(ip="10.1.0.5", target_ref="default/db-0"),
                        EndpointAddress(ip="10.1.0.6", target_ref="default/db-1"),
                    ],
                    ports=[EndpointPort(port=5432)],
                )],
            )
        )
        assert wait_until(
            lambda: dns.resolve("web.default.svc.cluster.local") == ["10.0.0.10"]
        )
        assert wait_until(
            lambda: len(dns.resolve("db.default.svc.cluster.local")) == 2
        )

        def udp_ask(name, qtype):
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.settimeout(5)
            s.sendto(_dns_query(name, qtype), (host, port))
            data, _ = s.recvfrom(4096)
            s.close()
            return _parse_answers(data)

        # A: cluster IP
        rcode, ans = udp_ask("web.default.svc.cluster.local", 1)
        assert rcode == 0
        assert [socket.inet_ntoa(r) for t, r in ans if t == 1] == ["10.0.0.10"]
        # A: headless -> both endpoint IPs
        rcode, ans = udp_ask("db.default.svc.cluster.local", 1)
        assert sorted(socket.inet_ntoa(r) for _t, r in ans) == [
            "10.1.0.5", "10.1.0.6"]
        # A: pet hostname
        rcode, ans = udp_ask("db-1.db.default.svc.cluster.local", 1)
        assert [socket.inet_ntoa(r) for _t, r in ans] == ["10.1.0.6"]
        # SRV: named port
        rcode, ans = udp_ask("_http._tcp.web.default.svc.cluster.local", 33)
        assert rcode == 0 and len(ans) == 1
        prio, weight, sport = struct.unpack_from("!HHH", ans[0][1], 0)
        assert sport == 80
        # NXDOMAIN
        rcode, ans = udp_ask("nope.default.svc.cluster.local", 1)
        assert rcode == 3 and ans == []

        # TCP path (2-byte length prefix)
        c = socket.create_connection((host, port), timeout=5)
        q = _dns_query("web.default.svc.cluster.local", 1)
        c.sendall(struct.pack("!H", len(q)) + q)
        hdr = c.recv(2)
        (n,) = struct.unpack("!H", hdr)
        data = b""
        while len(data) < n:
            data += c.recv(n - len(data))
        c.close()
        rcode, ans = _parse_answers(data)
        assert [socket.inet_ntoa(r) for _t, r in ans] == ["10.0.0.10"]

        # hostile input: garbage and a compression-pointer loop are
        # dropped without killing the server
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.settimeout(0.3)
        s.sendto(b"\x00" * 5, (host, port))
        loop = bytearray(_dns_query("a.b", 1))
        loop[12] = 0xC0
        loop[13] = 0x0C  # name points at itself
        s.sendto(bytes(loop), (host, port))
        import pytest as _pytest

        with _pytest.raises(socket.timeout):
            s.recvfrom(4096)
        s.close()
        rcode, ans = udp_ask("web.default.svc.cluster.local", 1)
        assert rcode == 0  # still serving
    finally:
        wire.shutdown()
        dns.stop()


def test_federation_controller_manager_join_flow():
    """The kubefed-join flow through the federation-controller-manager
    process: join two member clusters by endpoint, watch health flip
    Ready, services and replicas propagate; unjoin stops propagation."""
    from kubernetes_tpu_torch.federation import (
        FederatedAPIServer,
        FederationControllerManager,
        join_cluster,
        unjoin_cluster,
    )

    fed_server = FederatedAPIServer()
    fed = RESTClient(LocalTransport(fed_server))
    members = {}
    for name in ("east", "west"):
        srv = APIServer()
        host, port = srv.serve_http(port=0)
        members[name] = (srv, f"http://{host}:{port}")
    try:
        for name, (_srv, url) in members.items():
            join_cluster(fed, name, url)
        mgr = FederationControllerManager(
            fed, cluster_sync_period=0.1, workload_sync_period=0.1
        ).start()
        try:
            def ready_count():
                clusters, _ = fed.resource("clusters").list()
                return sum(
                    1 for c in clusters
                    if any(cond.type == "Ready" and cond.status == "True"
                           for cond in c.status.conditions)
                )

            assert wait_until(lambda: ready_count() == 2)
            # a federated service propagates to every member
            fed.resource("services", "default").create(Service(
                metadata=ObjectMeta(name="web"),
                spec=ServiceSpec(selector={"app": "web"},
                                 ports=[ServicePort(port=80)]),
            ))
            east = RESTClient(HTTPTransport(members["east"][1]))
            west = RESTClient(HTTPTransport(members["west"][1]))
            assert wait_until(lambda: all(
                _has_service(c, "web") for c in (east, west)
            ))
            # a federated RC spreads 5 replicas 3/2 across members
            from kubernetes_tpu_torch.api.types import (
                Container,
                Pod,
                PodSpec,
                PodTemplateSpec,
                ReplicationController,
                ReplicationControllerSpec,
            )

            fed.resource("replicationcontrollers", "default").create(
                ReplicationController(
                    metadata=ObjectMeta(name="app"),
                    spec=ReplicationControllerSpec(
                        replicas=5, selector={"run": "app"},
                        template=PodTemplateSpec(
                            metadata=ObjectMeta(labels={"run": "app"}),
                            spec=PodSpec(containers=[Container(name="c")]),
                        ),
                    ),
                )
            )

            def shares():
                out = []
                for c in (east, west):
                    try:
                        rc = c.resource(
                            "replicationcontrollers", "default").get("app")
                        out.append(rc.spec.replicas)
                    except Exception:
                        out.append(None)
                return out

            assert wait_until(lambda: shares() == [3, 2])
            # unjoin west: its propagated workloads are DELETED (the
            # kubefed cleanup) and reconcile concentrates on east
            unjoin_cluster(fed, "west")
            assert wait_until(lambda: shares() == [5, None])
            assert not _has_service(west, "web")
            assert _has_service(east, "web")
        finally:
            mgr.stop()
    finally:
        for srv, _url in members.values():
            srv.shutdown_http()


def _has_service(client, name):
    try:
        client.resource("services", "default").get(name)
        return True
    except Exception:
        return False
