"""Framed TLV request/response RPC between quorum peers.

One persistent TCP connection per (caller, peer) pair, strictly
serial request -> response (raft's RPCs are idempotent and carry
terms, so a lost reply is handled by re-sending — no correlation ids
needed). Every message is one length+CRC+TLV frame, the same framing
the raft WAL uses, so a nemesis shim between peers can parse and
reorder whole protocol messages without corrupting the byte stream.

The transport is deliberately dumb: connect on demand, one in-flight
call, close on any error and let the caller retry. All the cleverness
(elections, backoff, snapshot fallback) lives in node.py where it is
testable against injected faults.

Copy of kubernetes_tpu/storage/quorum/rpc.py: only the import package differs.
"""

from __future__ import annotations

import socket
import threading
import zlib
from typing import Any, Callable, Optional, Tuple

from kubernetes_tpu_torch.runtime import tlv
from kubernetes_tpu_torch.storage.durable import _CRC, _LEN
from kubernetes_tpu_torch.storage.quorum.log import frame

_HDR = _LEN.size + _CRC.size
_MAGIC = b"KTQRPC01"


class RPCError(Exception):
    """Transport-level failure (peer unreachable, stream broke,
    timeout). The caller treats the peer as down for this round."""


class RPCConnectError(RPCError):
    """The failure happened BEFORE the request left this host: the
    peer cannot have processed it, so retrying is always safe. Any
    other RPCError is indeterminate — the request may have been
    received and acted on even though the reply never arrived."""


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except (socket.timeout, OSError) as e:
            raise RPCError(f"peer read failed: {e}") from e
        if not chunk:
            raise RPCError("peer closed")
        buf += chunk
    return buf


def read_message(sock: socket.socket) -> Any:
    hdr = _read_exact(sock, _HDR)
    (n,) = _LEN.unpack_from(hdr, 0)
    (crc,) = _CRC.unpack_from(hdr, _LEN.size)
    body = _read_exact(sock, n)
    if zlib.crc32(body) != crc:
        raise RPCError("frame failed CRC")
    with tlv.allow_dynamic():
        return tlv.loads(body)


def write_message(sock: socket.socket, msg: Any) -> None:
    try:
        sock.sendall(frame(tlv.dumps(msg)))
    except (socket.timeout, OSError) as e:
        raise RPCError(f"peer write failed: {e}") from e


class PeerClient:
    """Caller side: one lazily-(re)connected socket to a peer, calls
    serialized by a lock (raft sends to one peer from one replicator
    thread; the lock covers election-time vote calls riding the same
    client)."""

    def __init__(self, address: Tuple[str, int], timeout: float = 2.0):
        self.address = tuple(address)
        self.timeout = timeout
        self._mu = threading.Lock()
        self._sock: Optional[socket.socket] = None  # guarded-by: self._mu

    def call(self, msg: Any, timeout: Optional[float] = None) -> Any:
        """One request -> one response. Raises RPCError on any
        transport fault (the connection is torn down; the next call
        reconnects)."""
        with self._mu:
            deadline_t = self.timeout if timeout is None else timeout
            sock = self._sock
            if sock is None:
                # connect phase: a failure here is definitively
                # before the request existed on the wire — retryable
                try:
                    sock = socket.create_connection(
                        self.address, timeout=deadline_t)
                    sock.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                    sock.sendall(_MAGIC)
                    self._sock = sock
                except OSError as e:
                    try:
                        if sock is not None:
                            sock.close()
                    except OSError:
                        pass
                    raise RPCConnectError(
                        f"peer {self.address} unreachable: {e}") from e
            try:
                sock.settimeout(deadline_t)
                write_message(sock, msg)
                return read_message(sock)
            except (RPCError, OSError) as e:
                self._sock = None
                try:
                    sock.close()
                except OSError:
                    pass
                if isinstance(e, RPCError):
                    raise
                raise RPCError(f"peer {self.address} call failed: {e}") \
                    from e

    def close(self) -> None:
        with self._mu:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None


class PeerServer:
    """Callee side: accept loop + one thread per peer connection, each
    looping read -> handler(msg) -> write. The handler runs quorum
    logic (vote/append/snapshot/forward) and must never block
    indefinitely — a wedged handler wedges only its own connection,
    and the caller's timeout recovers it."""

    def __init__(self, handler: Callable[[Any], Any],
                 host: str = "127.0.0.1", port: int = 0):
        self.handler = handler
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.address = self._srv.getsockname()
        self._stopped = threading.Event()
        self._conns_mu = threading.Lock()
        self._conns: set = set()  # guarded-by: self._conns_mu
        # bind-now, serve-later: the address is known at construction
        # (peers need it to wire the cluster) but no handler thread
        # may run until the OWNER finished ITS construction — serve()
        # is the owner's start() saying so
        self._thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"quorum-rpc-{self.address[1]}")

    def serve(self) -> None:
        if not self._thread.is_alive() and not self._stopped.is_set():
            self._thread.start()

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                conn, _addr = self._srv.accept()
            except OSError:
                return
            with self._conns_mu:
                if self._stopped.is_set():
                    try:
                        conn.close()
                    except OSError:
                        pass
                    return
                self._conns.add(conn)
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True,
                name=f"quorum-rpc-conn-{self.address[1]}").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn.settimeout(30.0)
            if _read_exact(conn, len(_MAGIC)) != _MAGIC:
                return
            while not self._stopped.is_set():
                msg = read_message(conn)
                reply = self.handler(msg)
                write_message(conn, reply)
        except (RPCError, OSError):
            pass  # peer went away / stream broke: the caller retries
        finally:
            with self._conns_mu:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        self._stopped.set()
        try:
            self._srv.close()
        except OSError:
            pass
        with self._conns_mu:
            conns, self._conns = list(self._conns), set()
        for c in conns:
            try:
                c.close()
            except OSError:
                pass


class Transport:
    """Peer-communication seam: how a node listens and how it reaches
    a peer. Production is framed TCP (below); the deterministic
    simulator (``analysis/sim``) substitutes in-memory per-edge
    queues so message delivery, loss, duplication, reorder, and
    partitions happen exactly when a schedule says so."""

    def listen(self, handler: Callable[[Any], Any], host: str,
               port: int):
        """Return a server object exposing ``.address``, ``.serve()``
        and ``.close()`` (the PeerServer surface)."""
        raise NotImplementedError

    def connect(self, address: Tuple[Any, Any], timeout: float):
        """Return a client object exposing ``.call(msg, timeout=None)``
        and ``.close()`` (the PeerClient surface)."""
        raise NotImplementedError


class TCPTransport(Transport):
    """Production transport: the framed TCP client/server above."""

    def listen(self, handler: Callable[[Any], Any], host: str,
               port: int) -> PeerServer:
        return PeerServer(handler, host=host, port=port)

    def connect(self, address: Tuple[Any, Any],
                timeout: float) -> PeerClient:
        return PeerClient(address, timeout=timeout)


TCP_TRANSPORT = TCPTransport()
