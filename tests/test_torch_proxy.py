"""kube-proxy: rule compilation from service/endpoints watches and the
round-robin/session-affinity dataplane (pkg/proxy).

The cases of tests/test_proxy.py, run against the port's copies
(kubernetes_tpu_torch), each with the mark it has there."""

import time

import pytest

from kubernetes_tpu_torch.api.types import (
    EndpointAddress,
    EndpointPort,
    Endpoints,
    EndpointSubset,
    ObjectMeta,
    Service,
    ServicePort,
    ServiceSpec,
)
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.rest import RESTClient
from kubernetes_tpu_torch.client.transport import LocalTransport
from kubernetes_tpu_torch.proxy import Proxier


from conftest import wait_until  # noqa: E402


@pytest.fixture()
def plane():
    server = APIServer()
    client = RESTClient(LocalTransport(server))
    proxier = Proxier(client, node_name="n1").run()
    yield server, client, proxier
    proxier.stop()


def _mk_service(client, affinity="None", port=80):
    client.resource("services", "default").create(
        Service(
            metadata=ObjectMeta(name="web"),
            spec=ServiceSpec(
                selector={"app": "web"},
                cluster_ip="10.0.0.10",
                session_affinity=affinity,
                ports=[ServicePort(name="http", port=port, target_port=8080)],
            ),
        )
    )


def _free_port():
    """A fresh port per dataplane test: sequential tests reusing one
    service port trip over TIME_WAIT leftovers from the previous
    test's connections."""
    import socket as _socket

    s = _socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _mk_endpoints(client, ips):
    eps = Endpoints(
        metadata=ObjectMeta(name="web"),
        subsets=[
            EndpointSubset(
                addresses=[EndpointAddress(ip=ip) for ip in ips],
                ports=[EndpointPort(name="http", port=8080)],
            )
        ],
    )
    rc = client.resource("endpoints", "default")
    try:
        cur = rc.get("web")
        cur.subsets = eps.subsets
        rc.update(cur)
    except Exception:
        rc.create(eps)


def test_rules_follow_endpoints(plane):
    server, client, proxier = plane
    _mk_service(client)
    _mk_endpoints(client, ["10.1.0.1", "10.1.0.2"])

    def rule():
        for spn, r in proxier.rules.items():
            if spn.name == "web" and spn.port == "http":
                return r
        return None

    assert wait_until(lambda: rule() is not None and len(rule().endpoints) == 2)
    r = rule()
    assert r.cluster_ip == "10.0.0.10" and r.port == 80
    assert r.endpoints == (("10.1.0.1", 8080), ("10.1.0.2", 8080))
    # endpoint removal propagates
    _mk_endpoints(client, ["10.1.0.2"])
    assert wait_until(lambda: rule().endpoints == (("10.1.0.2", 8080),))


def test_round_robin_and_session_affinity(plane):
    server, client, proxier = plane
    _mk_service(client)
    _mk_endpoints(client, ["10.1.0.1", "10.1.0.2"])
    assert wait_until(
        lambda: any(
            len(r.endpoints) == 2 for r in proxier.rules.values()
        )
    )
    picks = {proxier.route("default", "web", "http")[0] for _ in range(4)}
    assert picks == {"10.1.0.1", "10.1.0.2"}  # round-robin alternates

    # ClientIP affinity pins a client to one endpoint
    svc = client.resource("services", "default").get("web")
    svc.spec.session_affinity = "ClientIP"
    client.resource("services", "default").update(svc)
    assert wait_until(
        lambda: any(
            r.session_affinity == "ClientIP" for r in proxier.rules.values()
        )
    )
    first = proxier.route("default", "web", "http", client_ip="1.2.3.4")
    for _ in range(5):
        assert proxier.route("default", "web", "http", client_ip="1.2.3.4") == first


def test_service_delete_drops_rules(plane):
    server, client, proxier = plane
    _mk_service(client)
    _mk_endpoints(client, ["10.1.0.1"])
    assert wait_until(lambda: len(proxier.rules) == 1)
    client.resource("services", "default").delete("web")
    assert wait_until(lambda: len(proxier.rules) == 0)
    with pytest.raises(LookupError):
        proxier.route("default", "web", "http")


# -- the userspace dataplane (pkg/proxy/userspace/proxier.go) ----------------


import socket
import socketserver
import threading

from kubernetes_tpu_torch.proxy.userspace import UserspaceProxier


class _Echo(socketserver.BaseRequestHandler):
    def handle(self):
        while True:
            data = self.request.recv(4096)
            if not data:
                return
            self.request.sendall(b"%s:%s" % (
                self.server.tag.encode(), data))


def _backend(tag):
    srv = socketserver.ThreadingTCPServer(("127.0.0.1", 0), _Echo)
    srv.daemon_threads = True
    srv.tag = tag
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _mk_endpoints_ports(client, backends):
    """One subset per backend so each address can carry its own port
    (real local listeners sit on distinct ephemeral ports)."""
    eps = Endpoints(
        metadata=ObjectMeta(name="web"),
        subsets=[
            EndpointSubset(
                addresses=[EndpointAddress(ip=ip)],
                ports=[EndpointPort(name="http", port=port)],
            )
            for ip, port in backends
        ],
    )
    rc = client.resource("endpoints", "default")
    try:
        cur = rc.get("web")
        cur.subsets = eps.subsets
        rc.update(cur)
    except Exception:
        rc.create(eps)




def _ready(proxier, n_eps=1):
    """Listener exists AND its rule has endpoints (the service event can
    land a beat before the endpoints event)."""
    addr = proxier.proxy_addr("default", "web", "http")
    if addr is None:
        return False
    return any(
        spn.name == "web" and len(r.endpoints) >= n_eps
        for spn, r in proxier.rules.items()
    )


@pytest.fixture()
def dataplane():
    server = APIServer()
    client = RESTClient(LocalTransport(server))
    proxier = UserspaceProxier(client, node_name="n1").run()
    backends = [_backend("a"), _backend("b")]
    yield server, client, proxier, backends
    proxier.stop()
    for b in backends:
        b.shutdown()
        b.server_close()


def _call(addr, payload=b"ping"):
    with socket.create_connection(addr, timeout=5) as s:
        s.sendall(payload)
        return s.recv(4096)


def test_bytes_flow_client_vip_backend(dataplane):
    server, client, proxier, backends = dataplane
    _mk_service(client, port=_free_port())
    _mk_endpoints_ports(
        client, [("127.0.0.1", b.server_address[1]) for b in backends]
    )
    assert wait_until(lambda: _ready(proxier, 2))
    addr = proxier.proxy_addr("default", "web", "http")
    # the proxy claims the service's own port when free
    # (no NAT layer to translate), else an ephemeral one
    got = {_call(addr), _call(addr), _call(addr), _call(addr)}
    # real bytes flowed and round-robin hit both backends
    assert got == {b"a:ping", b"b:ping"}


def test_session_affinity_pins_backend(dataplane):
    server, client, proxier, backends = dataplane
    _mk_service(client, affinity="ClientIP", port=_free_port())
    _mk_endpoints_ports(
        client, [("127.0.0.1", b.server_address[1]) for b in backends]
    )
    assert wait_until(lambda: _ready(proxier, 2))
    addr = proxier.proxy_addr("default", "web", "http")
    got = {_call(addr) for _ in range(4)}
    assert len(got) == 1  # same client ip -> same endpoint every time


def test_endpoint_update_reroutes_live(dataplane):
    server, client, proxier, backends = dataplane
    _mk_service(client, port=_free_port())
    _mk_endpoints_ports(
        client, [("127.0.0.1", backends[0].server_address[1])]
    )
    assert wait_until(lambda: _ready(proxier))
    addr = proxier.proxy_addr("default", "web", "http")
    assert _call(addr) == b"a:ping"
    # endpoints change from watch: new connections reach the new backend
    _mk_endpoints_ports(
        client, [("127.0.0.1", backends[1].server_address[1])]
    )
    assert wait_until(lambda: any(
        r.endpoints == (("127.0.0.1", backends[1].server_address[1]),)
        for r in proxier.rules.values()
    ))
    assert _call(addr) == b"b:ping"


def test_no_endpoints_refuses_cleanly(dataplane):
    server, client, proxier, backends = dataplane
    _mk_service(client, port=_free_port())
    _mk_endpoints_ports(client, [])
    assert wait_until(
        lambda: proxier.proxy_addr("default", "web", "http") is not None
    )
    addr = proxier.proxy_addr("default", "web", "http")
    with socket.create_connection(addr, timeout=5) as s:
        s.sendall(b"ping")
        try:
            assert s.recv(4096) == b""  # dropped like a REJECT
        except ConnectionResetError:
            pass  # RST is the other honest REJECT shape


def _refused(addr, deadline=10.0):
    """True once a fresh connect to addr fails. Listener teardown is
    asynchronous in the kernel (gVisor's netstack especially): a connect
    racing close() can still complete the handshake and then see a FIN
    or RST, so a single immediate probe flakes — poll with a deadline
    until the refusal is observable."""
    end = time.time() + deadline
    while time.time() < end:
        try:
            with socket.create_connection(addr, timeout=5) as s:
                s.sendall(b"ping")
                s.recv(4096)  # half-open leftover: drain and re-probe
        except (socket.timeout, TimeoutError):
            pass  # accepting-but-silent is NOT refusal: keep probing
        except OSError:
            return True
        time.sleep(0.05)
    return False


def test_service_delete_closes_listener(dataplane):
    server, client, proxier, backends = dataplane
    _mk_service(client, port=_free_port())
    _mk_endpoints_ports(
        client, [("127.0.0.1", backends[0].server_address[1])]
    )
    assert wait_until(lambda: _ready(proxier))
    addr = proxier.proxy_addr("default", "web", "http")
    client.resource("services", "default").delete("web")
    assert wait_until(
        lambda: proxier.proxy_addr("default", "web", "http") is None
    )
    # the listener must become unreachable (not merely be unreachable on
    # the first probe — that races the kernel's asynchronous close)
    assert _refused(addr), "deleted service's listener still accepting"


def test_udp_echo_through_proxy():
    server = APIServer()
    client = RESTClient(LocalTransport(server))
    proxier = UserspaceProxier(client, udp_idle_timeout=0.25).run()
    try:
        usock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        usock.bind(("127.0.0.1", 0))

        def udp_echo():
            while True:
                try:
                    data, addr = usock.recvfrom(4096)
                except OSError:
                    return
                usock.sendto(b"u:" + data, addr)

        threading.Thread(target=udp_echo, daemon=True).start()
        client.resource("services", "default").create(
            Service(
                metadata=ObjectMeta(name="dns"),
                spec=ServiceSpec(
                    cluster_ip="10.0.0.53",
                    ports=[ServicePort(name="dns", port=10053,
                                       protocol="UDP")],
                ),
            )
        )
        eps = Endpoints(
            metadata=ObjectMeta(name="dns"),
            subsets=[EndpointSubset(
                addresses=[EndpointAddress(ip="127.0.0.1")],
                ports=[EndpointPort(name="dns", port=usock.getsockname()[1],
                                    protocol="UDP")],
            )],
        )
        client.resource("endpoints", "default").create(eps)
        assert wait_until(
            lambda: proxier.proxy_addr("default", "dns", "dns") is not None
        )
        addr = proxier.proxy_addr("default", "dns", "dns")
        c = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        # UDP: no delivery guarantee even on loopback — under full-suite
        # load a 1-core box can starve the relay thread past a single
        # receive window, so retry the datagram a few times
        c.settimeout(5)
        data = None
        for _ in range(4):
            c.sendto(b"hello", addr)
            try:
                data, _ = c.recvfrom(4096)
                break
            except socket.timeout:
                continue
        assert data == b"u:hello"
        c.close()
        usock.close()
    finally:
        proxier.stop()
