"""Userspace service proxy — a dataplane that forwards real bytes.

Reference: pkg/proxy/userspace/proxier.go (1,050 ln). The reference's
userspace proxier opens one listening socket per service port
(addServiceOnPort), iptables REDIRECTs VIP traffic to it, and each
accepted connection picks an endpoint through the LoadBalancer
(TryConnectEndpoints, with dial retries) and splices bytes both ways
(ProxyTCP: two io.Copy goroutines). UDP is proxied with a timed
client->backend socket map (udp activeClients, stale-entry sweep).

Here there is no iptables layer, so the proxy socket IS the service
access point: `UserspaceProxier` listens on a host port per service
port (the service's own port when free, else an ephemeral one — the
reference's proxyPort is ephemeral too, proxier.go claimNextPort), and
`proxy_addr()` is the discovery seam (what the REDIRECT rule encodes in
the reference; the "local" cloud provider's LoadBalancer fronts it).

The rule table + balancer come from Proxier (the iptables-shaped rule
compiler, proxier.py); this subclass reconciles real sockets against
that table on every sync — the syncProxyRules analogue over live
listeners.

Copy of kubernetes_tpu/proxy/userspace.py: only the import package differs.
"""

from __future__ import annotations

import logging
import select
import socket
import threading
from typing import Dict, Optional, Tuple

from kubernetes_tpu_torch.proxy.proxier import Proxier, Rule, ServicePortName

log = logging.getLogger(__name__)

# proxier.go endpointDialTimeout: retried dial budget per connection
_DIAL_TIMEOUTS = (0.25, 1.0, 2.0)
_UDP_IDLE = 10.0  # udp.go udpIdleTimeout flag default (250ms in tests)


class _ServicePortSocket:
    """One service port's live listener + accept loop
    (proxier.go serviceInfo + ProxyLoop)."""

    def __init__(self, owner: "UserspaceProxier", spn: ServicePortName,
                 rule: Rule, host: str):
        self.owner = owner
        self.spn = spn
        self.rule = rule
        self.protocol = (rule.protocol or "TCP").upper()
        self.stopped = threading.Event()
        if self.protocol == "UDP":
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        else:
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # prefer the service's own port (no NAT layer to translate);
        # fall back to an ephemeral proxyPort exactly like the
        # reference's claimNextPort when the range is exhausted
        try:
            self.sock.bind((host, rule.port))
        except OSError:
            self.sock.bind((host, 0))
        self.addr = self.sock.getsockname()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"proxy-{spn.namespace}/{spn.name}:{spn.port}",
        )

    def start(self) -> None:
        if self.protocol != "UDP":
            self.sock.listen(64)
        self._thread.start()

    def close(self) -> None:
        self.stopped.set()
        try:
            self.sock.close()
        except OSError:
            pass

    # -- accept/forward loops ------------------------------------------------

    def _loop(self) -> None:
        try:
            if self.protocol == "UDP":
                self._udp_loop()
            else:
                self._tcp_loop()
        except Exception:
            if not self.stopped.is_set():
                log.exception("proxy loop for %s died", self.spn)

    def _tcp_loop(self) -> None:
        """ProxyLoop + one ProxyConnection thread per accept
        (proxier.go tcpProxySocket.ProxyLoop)."""
        while not self.stopped.is_set():
            try:
                conn, client = self.sock.accept()
            except OSError:
                return  # closed
            threading.Thread(
                target=self._proxy_connection, args=(conn, client),
                daemon=True,
            ).start()

    def _proxy_connection(self, inbound: socket.socket, client) -> None:
        backend = self.owner._try_connect(self.spn, client[0])
        if backend is None:
            inbound.close()
            return
        try:
            _splice(inbound, backend, self.stopped)
        finally:
            for s in (inbound, backend):
                try:
                    s.close()
                except OSError:
                    pass

    def _udp_loop(self) -> None:
        """udpProxySocket.ProxyLoop: per-client backend socket, expired
        by its reply pump's recv timeout (the activeClients analogue)."""
        clients: Dict[Tuple[str, int], socket.socket] = {}
        lock = threading.Lock()

        def reply_pump(client_addr, back: socket.socket) -> None:
            while not self.stopped.is_set():
                try:
                    back.settimeout(self.owner.udp_idle_timeout)
                    data = back.recv(65536)
                except (socket.timeout, OSError):
                    break
                if not data:
                    break
                try:
                    self.sock.sendto(data, client_addr)
                except OSError:
                    break
            with lock:
                clients.pop(client_addr, None)
            try:
                back.close()
            except OSError:
                pass

        while not self.stopped.is_set():
            try:
                data, client_addr = self.sock.recvfrom(65536)
            except OSError:
                return
            with lock:
                back = clients.get(client_addr)
            if back is None:
                ep = self.owner._pick_endpoint(self.spn, client_addr[0])
                if ep is None:
                    continue  # no endpoints: drop like a REJECT rule
                back = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                try:
                    back.connect(ep)
                except OSError:
                    # one bad endpoint must not kill the listener —
                    # drop this datagram; the next one re-picks
                    back.close()
                    continue
                with lock:
                    clients[client_addr] = back
                threading.Thread(
                    target=reply_pump, args=(client_addr, back),
                    daemon=True,
                ).start()
            try:
                back.send(data)
            except OSError:
                with lock:
                    clients.pop(client_addr, None)


def _splice(a: socket.socket, b: socket.socket, stopped=None) -> None:
    """Bidirectional byte copy until either side closes (ProxyTCP's two
    io.Copy goroutines, flattened onto one select loop). Idle periods
    never terminate a healthy connection — the reference's io.Copy pair
    doesn't either; the select timeout only exists to notice the proxy
    shutting down."""
    socks = [a, b]
    peer = {a: b, b: a}
    half_closed = set()
    while len(half_closed) < 2:
        readable, _, _ = select.select(socks, [], [], 5.0)
        if not readable:
            if stopped is not None and stopped.is_set():
                return
            continue  # idle is not an error
        for s in readable:
            try:
                data = s.recv(65536)
            except OSError:
                return
            if not data:
                half_closed.add(s)
                try:
                    peer[s].shutdown(socket.SHUT_WR)
                except OSError:
                    return
                socks = [x for x in socks if x is not s]
                continue
            try:
                peer[s].sendall(data)
            except OSError:
                return


class UserspaceProxier(Proxier):
    """Proxier whose rule table drives live listening sockets."""

    def __init__(self, client, node_name: str = "",
                 host: str = "127.0.0.1", udp_idle_timeout: float = _UDP_IDLE):
        self.host = host
        self.udp_idle_timeout = udp_idle_timeout
        self._socks: Dict[ServicePortName, _ServicePortSocket] = {}
        self._sock_lock = threading.Lock()
        self._stopped = False
        super().__init__(client, node_name=node_name)

    # -- socket reconciliation (syncProxyRules over live listeners) ----------

    def sync_rules(self) -> None:
        super().sync_rules()
        with self._sock_lock:
            if self._stopped:
                # a watch event racing stop() must not resurrect
                # listeners after they were closed and cleared
                return
            want = dict(self.rules)
            # close listeners whose service port vanished or changed
            for spn in list(self._socks):
                rule = want.get(spn)
                cur = self._socks[spn]
                if rule is None or (rule.port, (rule.protocol or "TCP").upper()) != (
                    cur.rule.port, cur.protocol
                ):
                    cur.close()
                    del self._socks[spn]
                else:
                    cur.rule = rule  # endpoints refresh in place
            for spn, rule in want.items():
                if spn in self._socks or rule.port == 0:
                    continue
                try:
                    ps = _ServicePortSocket(self, spn, rule, self.host)
                except OSError:
                    log.warning("cannot open proxy socket for %s", spn)
                    continue
                ps.start()
                self._socks[spn] = ps

    def proxy_addr(self, namespace: str, name: str,
                   port_name: str = "") -> Optional[Tuple[str, int]]:
        """Where this service port answers on this node — the discovery
        seam the reference encodes in its REDIRECT rule."""
        with self._sock_lock:
            ps = self._socks.get(ServicePortName(namespace, name, port_name))
            return ps.addr if ps is not None else None

    def addr_for_port(self, port: int) -> Optional[Tuple[str, int]]:
        """Resolve a service's listener by port — node ports first
        (cluster-unique, what a cloud LB targets: the KUBE-NODEPORTS
        idiom), then plain service ports (which services may share;
        ambiguity there is inherent and first-match)."""
        with self._sock_lock:
            for ps in self._socks.values():
                if ps.rule.node_port and ps.rule.node_port == port:
                    return ps.addr
            for ps in self._socks.values():
                if ps.rule.port == port:
                    return ps.addr
        return None

    # -- per-connection endpoint selection -----------------------------------

    def _pick_endpoint(self, spn: ServicePortName,
                       client_ip: str) -> Optional[Tuple[str, int]]:
        rule = self.rules.get(spn)
        if rule is None or not rule.endpoints:
            return None
        try:
            ip, port = self.balancer.next_endpoint(
                spn, rule.endpoints, client_ip, rule.session_affinity
            )
        except LookupError:
            return None
        return (ip or "127.0.0.1", port)

    def _try_connect(self, spn: ServicePortName,
                     client_ip: str) -> Optional[socket.socket]:
        """TryConnectEndpoints (proxier.go): retry the dial across
        endpoints with growing timeouts before giving up."""
        for timeout in _DIAL_TIMEOUTS:
            ep = self._pick_endpoint(spn, client_ip)
            if ep is None:
                return None
            try:
                return socket.create_connection(ep, timeout=timeout)
            except OSError:
                log.debug("dial %s for %s failed", ep, spn)
                continue
        return None

    def stop(self) -> None:
        super().stop()
        with self._sock_lock:
            self._stopped = True
            for ps in self._socks.values():
                ps.close()
            self._socks.clear()
