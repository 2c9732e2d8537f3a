"""DNS wire protocol server: RFC1035 A/SRV over UDP and TCP.

The reference's kube-dns serves real DNS (skydns + miekg/dns under
cmd/kube-dns/app/server.go and pkg/dns/dns.go); round 2's DNSRecords
resolved only in-process. This module puts DNSRecords on the wire: a
UDP listener (the normal resolver path) and a TCP listener (2-byte
length-prefixed, for truncation fallback), answering

    A    <svc>.<ns>.svc.<domain>             -> clusterIP / headless IPs
    A    <pod-hostname>.<svc>.<ns>.svc.<domain> -> pet identity IP
    SRV  _<port>._<proto>.<svc>.<ns>.svc.<domain> -> port + target

Unknown names answer NXDOMAIN; unsupported opcodes/types answer empty
NOERROR. Parsing is defensive: malformed packets are dropped (UDP) or
close the connection (TCP) — never an exception escaping to the server
loop. Compression pointers are emitted for the answer name (0xC00C),
and accepted in queries.

Copy of kubernetes_tpu/dns/wire.py: only the import package differs.
"""

from __future__ import annotations

import socket
import socketserver
import struct
import threading
from typing import List, Optional, Tuple

QTYPE_A = 1
QTYPE_SRV = 33
QCLASS_IN = 1
_RCODE_NXDOMAIN = 3


class DNSWireError(Exception):
    pass


def _read_name(data: bytes, pos: int, depth: int = 0) -> Tuple[str, int]:
    """-> (dotted name, next position). Follows compression pointers
    with a hop limit (a pointer loop must not hang the server)."""
    if depth > 16:
        raise DNSWireError("compression pointer loop")
    labels = []
    while True:
        if pos >= len(data):
            raise DNSWireError("truncated name")
        n = data[pos]
        if n == 0:
            return ".".join(labels), pos + 1
        if n & 0xC0 == 0xC0:
            if pos + 1 >= len(data):
                raise DNSWireError("truncated pointer")
            target = ((n & 0x3F) << 8) | data[pos + 1]
            if target >= pos:
                raise DNSWireError("forward compression pointer")
            suffix, _ = _read_name(data, target, depth + 1)
            if suffix:
                labels.append(suffix)
            return ".".join(labels), pos + 2
        if n > 63:
            raise DNSWireError(f"label length {n} > 63")
        pos += 1
        if pos + n > len(data):
            raise DNSWireError("truncated label")
        labels.append(data[pos:pos + n].decode("ascii", errors="strict"))
        pos += n


def _write_name(name: str) -> bytes:
    name = name.rstrip(".")
    if not name:  # the root name is just the null label
        return b"\x00"
    out = bytearray()
    for label in name.split("."):
        b = label.encode("ascii")
        if not 0 < len(b) < 64:
            raise DNSWireError(f"bad label {label!r}")
        out.append(len(b))
        out += b
    out.append(0)
    return bytes(out)


def parse_query(data: bytes) -> Tuple[int, str, int, int]:
    """-> (txn_id, qname, qtype, qclass). Raises DNSWireError on
    malformed input, non-query packets, or multi-question packets."""
    if len(data) < 12:
        raise DNSWireError("packet shorter than header")
    txn_id, flags, qd, an, ns, ar = struct.unpack_from("!HHHHHH", data, 0)
    if flags & 0x8000:
        raise DNSWireError("not a query (QR=1)")
    if (flags >> 11) & 0xF != 0:
        raise DNSWireError("unsupported opcode")
    if qd != 1:
        raise DNSWireError(f"expected 1 question, got {qd}")
    qname, pos = _read_name(data, 12)
    if pos + 4 > len(data):
        raise DNSWireError("truncated question")
    qtype, qclass = struct.unpack_from("!HH", data, pos)
    return txn_id, qname, qtype, qclass


def build_response(
    txn_id: int,
    qname: str,
    qtype: int,
    *,
    a_records: Optional[List[str]] = None,
    srv_records=None,
    rcode: int = 0,
    ttl: int = 30,
    truncated: bool = False,
) -> bytes:
    """One answer packet; the question is echoed and answers point at it
    via the 0xC00C compression pointer."""
    answers = []
    if qtype == QTYPE_A:
        for ip in a_records or []:
            try:
                rdata = socket.inet_aton(ip)
            except OSError:
                continue
            answers.append(
                b"\xc0\x0c"
                + struct.pack("!HHIH", QTYPE_A, QCLASS_IN, ttl, 4)
                + rdata
            )
    elif qtype == QTYPE_SRV:
        for rec in srv_records or []:
            target = _write_name(rec.target)
            answers.append(
                b"\xc0\x0c"
                + struct.pack(
                    "!HHIH", QTYPE_SRV, QCLASS_IN, ttl, 6 + len(target)
                )
                + struct.pack("!HHH", 0, 0, rec.port)  # prio, weight, port
                + target
            )
    if truncated:
        answers = []
    flags = 0x8180 | (rcode & 0xF)  # QR=1, RD+RA echoed set
    if truncated:
        flags |= 0x0200  # TC: retry over TCP
    header = struct.pack(
        "!HHHHHH", txn_id, flags, 1, len(answers), 0, 0
    )
    question = _write_name(qname) + struct.pack("!HH", qtype, QCLASS_IN)
    return header + question + b"".join(answers)


def answer(records, data: bytes,
           max_size: Optional[int] = None) -> Optional[bytes]:
    """Resolve one query packet against a DNSRecords table; None for
    packets that deserve silence (malformed). max_size (UDP: 512) caps
    the response — an overflow answers with the TC bit set and no
    records so the client retries over TCP. Any unexpected failure also
    answers None rather than escaping into a serving loop."""
    try:
        txn_id, qname, qtype, qclass = parse_query(data)
        lname = qname.lower()  # RFC 1035: names compare case-insensitively
        if qclass != QCLASS_IN:
            return build_response(
                txn_id, qname, qtype, rcode=_RCODE_NXDOMAIN
            )
        if qtype == QTYPE_A:
            ips = records.resolve(lname)
            resp = build_response(
                txn_id, qname, qtype, a_records=ips,
                rcode=0 if ips else _RCODE_NXDOMAIN,
            )
        elif qtype == QTYPE_SRV:
            srvs = records.resolve_srv(lname)
            resp = build_response(
                txn_id, qname, qtype, srv_records=srvs,
                rcode=0 if srvs else _RCODE_NXDOMAIN,
            )
        else:
            # unsupported type for a known protocol: empty NOERROR
            resp = build_response(txn_id, qname, qtype)
        if max_size is not None and len(resp) > max_size:
            resp = build_response(txn_id, qname, qtype, truncated=True)
        return resp
    except DNSWireError:
        return None
    except Exception:
        return None  # a serving loop must never die on one packet


class _TCPServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


def _make_tcp_handler(records):
    class TCPHandler(socketserver.BaseRequestHandler):
        def handle(self):
            try:
                self.request.settimeout(10)
                hdr = self._read_exact(2)
                (n,) = struct.unpack("!H", hdr)
                data = self._read_exact(n)
                resp = answer(records, data)
                if resp is not None:
                    self.request.sendall(
                        struct.pack("!H", len(resp)) + resp
                    )
            except OSError:
                pass

        def _read_exact(self, n: int) -> bytes:
            buf = b""
            while len(buf) < n:
                chunk = self.request.recv(n - len(buf))
                if not chunk:
                    raise OSError("peer closed")
                buf += chunk
            return buf

    return TCPHandler


class DNSServer:
    """UDP + TCP wire frontends over a DNSRecords table."""

    def __init__(self, records):
        self.records = records
        self._udp_sock: Optional[socket.socket] = None
        self._tcp_srv: Optional[socketserver.ThreadingTCPServer] = None
        self._stop = threading.Event()

    def serve(self, host: str = "127.0.0.1", port: int = 0):
        """Bind UDP and TCP on the same port; returns (host, port)."""
        records = self.records
        stop = self._stop

        # a UDP bind does not reserve the TCP port: pick the pair
        # together, retrying fresh ephemeral ports on collision, and
        # never leak a half-bound socket on failure
        udp = None
        tcp_srv = None
        last_err: Optional[OSError] = None
        for _ in range(1 if port else 10):
            tcp_srv = None
            udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            try:
                udp.bind((host, port))
                actual_port = udp.getsockname()[1]
                tcp_srv = _TCPServer(
                    (host, actual_port), _make_tcp_handler(records)
                )
                break
            except OSError as e:
                last_err = e
                udp.close()
                udp = None
        if udp is None or tcp_srv is None:
            raise last_err or OSError("could not bind DNS port pair")
        udp.settimeout(0.5)
        self._udp_sock = udp
        self._tcp_srv = tcp_srv

        def udp_loop():
            while not stop.is_set():
                try:
                    data, addr = udp.recvfrom(4096)
                except socket.timeout:
                    continue
                except OSError:
                    return
                # 512-byte plain-DNS cap: larger answers go out with TC
                # set so the client retries on the TCP listener
                resp = answer(records, data, max_size=512)
                if resp is not None:
                    try:
                        udp.sendto(resp, addr)
                    except OSError:
                        pass

        threading.Thread(target=udp_loop, daemon=True,
                         name="kube-dns-udp").start()

        threading.Thread(
            target=self._tcp_srv.serve_forever, daemon=True,
            name="kube-dns-tcp",
        ).start()
        return host, actual_port

    def shutdown(self) -> None:
        self._stop.set()
        if self._udp_sock is not None:
            self._udp_sock.close()
            self._udp_sock = None
        if self._tcp_srv is not None:
            self._tcp_srv.shutdown()
            self._tcp_srv.server_close()
            self._tcp_srv = None
