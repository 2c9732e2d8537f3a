"""In-memory network for the simulator.

``SimTransport`` satisfies the ``rpc.Transport`` seam: ``listen``
returns an inert server (it records the handler and hands out a
unique virtual address; ``serve()`` starts nothing) and ``connect``
returns an inert client whose ``call`` raises ``RPCError`` — the sim
cluster never starts the node's background threads, so any in-process
path that tries a direct synchronous RPC fails the way an unreachable
peer would, and the harness drives all real traffic through
``SimNet``.

``SimNet`` owns the in-flight protocol messages. Each message is a
record with a stable id on a per-(src, dst) edge queue; the schedule
decides which one is delivered, dropped, or duplicated next. Standing
faults (PARTITION / ISOLATE / HEAL, shared vocabulary with
``harness.faults``) gate which edges can deliver at all. Delay and
jitter faults are vacuous here by design: delivery *order and time*
are already entirely schedule-controlled, so every delay/reorder the
nemesis can produce is expressible as (and explored through) a
delivery order.

Copy of kubernetes_tpu/analysis/sim/net.py: only the import package differs.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.harness.faults import FaultKind, FaultSpec
from kubernetes_tpu_torch.storage.quorum.rpc import RPCError, Transport


def _freeze(x: Any) -> Any:
    """Canonical hashable form of a TLV-style message payload."""
    if isinstance(x, (list, tuple)):
        return tuple(_freeze(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in x.items()))
    if isinstance(x, bytearray):
        return bytes(x)
    return x


class Msg:
    """One in-flight protocol message plus the context the harness
    needs to route its reply back into the sender's state machine:
    ``reply_kind`` names the reply handler (prevote / vote / append /
    snap) and ``ctx`` carries its extra arguments (round id, term,
    send time, snapshot index)."""

    __slots__ = ("mid", "src", "dst", "payload", "reply_kind", "ctx",
                 "ctx_fp")

    def __init__(self, mid: int, src: str, dst: str, payload: Any,
                 reply_kind: str, ctx: Tuple, ctx_fp: Tuple):
        self.mid = mid
        self.src = src
        self.dst = dst
        self.payload = payload
        self.reply_kind = reply_kind
        self.ctx = ctx
        #: the logical subset of ctx — send timestamps excluded so two
        #: schedules reaching the same protocol state fingerprint
        #: identically
        self.ctx_fp = ctx_fp

    def logical(self) -> Tuple:
        """Fingerprint form: excludes the mid (schedule-local) and
        clock-valued ctx elements."""
        return (self.src, self.dst, self.reply_kind, self.ctx_fp,
                _freeze(self.payload))


class SimNet:
    """Per-edge FIFO queues of ``Msg`` + the standing fault matrix."""

    def __init__(self):
        self._mids = itertools.count(1)
        self.edges: Dict[Tuple[str, str], List[Msg]] = {}
        self.blocked: set = set()  # ordered (src, dst) pairs
        self.by_mid: Dict[int, Msg] = {}

    # -- traffic -------------------------------------------------------------

    def send(self, src: str, dst: str, payload: Any, reply_kind: str,
             ctx: Tuple = (),
             ctx_fp: Optional[Tuple] = None) -> Msg:
        m = Msg(next(self._mids), src, dst, payload, reply_kind, ctx,
                ctx if ctx_fp is None else ctx_fp)
        self.edges.setdefault((src, dst), []).append(m)
        self.by_mid[m.mid] = m
        return m

    def take(self, mid: int) -> Msg:
        """Remove and return an in-flight message (delivery or drop)."""
        m = self.by_mid.pop(mid)
        self.edges[(m.src, m.dst)].remove(m)
        return m

    def duplicate(self, mid: int) -> Msg:
        """Clone an in-flight message onto the tail of its edge with a
        fresh mid (the original stays in flight)."""
        m = self.by_mid[mid]
        return self.send(m.src, m.dst, m.payload, m.reply_kind, m.ctx,
                         m.ctx_fp)

    def in_flight(self) -> List[Msg]:
        out: List[Msg] = []
        for edge in sorted(self.edges):
            out.extend(self.edges[edge])
        return out

    def deliverable(self, head_only: bool) -> List[Msg]:
        """Messages a schedule may deliver now: edge not blocked; in
        exhaustive mode only the head of each edge queue (FIFO links —
        reorder is explored via explicit drop/duplicate instead of a
        factorially larger delivery choice)."""
        out: List[Msg] = []
        for edge in sorted(self.edges):
            if edge in self.blocked:
                continue
            q = self.edges[edge]
            if not q:
                continue
            out.extend(q[:1] if head_only else q)
        return out

    def drop_node(self, node_id: str) -> None:
        """Crash cleanup: messages to/from a dead process vanish."""
        for edge in list(self.edges):
            if node_id in edge:
                for m in self.edges.pop(edge):
                    self.by_mid.pop(m.mid, None)

    # -- standing faults (shared FaultSpec vocabulary) -----------------------

    def apply(self, spec: FaultSpec, all_nodes: List[str]) -> None:
        if spec.kind is FaultKind.PARTITION:
            for a in spec.a_side:
                for b in spec.b_side:
                    self.blocked.add((a, b))
                    self.blocked.add((b, a))
        elif spec.kind is FaultKind.ISOLATE:
            n = spec.a_side[0]
            for other in all_nodes:
                if other != n:
                    self.blocked.add((n, other))
                    self.blocked.add((other, n))
        elif spec.kind is FaultKind.HEAL:
            self.blocked.clear()
        elif spec.kind in (FaultKind.ONE_WAY_DELAY, FaultKind.JITTER):
            pass  # subsumed by schedule-controlled delivery order
        else:
            raise ValueError(
                f"fault kind {spec.kind.value!r} is not a standing "
                "network fault (use a schedule event)")

    def fingerprint(self) -> Tuple:
        return (tuple(m.logical() for m in self.in_flight()),
                tuple(sorted(self.blocked)))


class _SimServer:
    """What ``SimTransport.listen`` hands the node: a recorded handler
    plus a unique virtual address. Nothing runs."""

    def __init__(self, handler: Callable[[Any], Any],
                 address: Tuple[str, int]):
        self.handler = handler
        self.address = address
        self.closed = False

    def serve(self) -> None:
        pass

    def close(self) -> None:
        self.closed = True


class _SimClient:
    """Inert peer client: the sim never performs synchronous in-line
    RPCs (all traffic is explicit SimNet events), so a direct call
    behaves like an unreachable peer."""

    def __init__(self, address: Tuple[Any, Any]):
        self.address = tuple(address)

    def call(self, msg: Any, timeout: Optional[float] = None) -> Any:
        raise RPCError(f"sim transport: no synchronous path to "
                       f"{self.address}")

    def close(self) -> None:
        pass


class SimTransport(Transport):
    """The transport seam for simulated nodes. One instance per
    cluster; it allocates unique virtual ports and remembers each
    listener's handler (the harness prefers calling node._dispatch
    directly, but the registry keeps the seam honest)."""

    def __init__(self):
        self._ports = itertools.count(1)
        self.servers: Dict[Tuple[str, int], _SimServer] = {}

    def listen(self, handler: Callable[[Any], Any], host: str,
               port: int) -> _SimServer:
        addr = ("sim", port if port else next(self._ports))
        srv = _SimServer(handler, addr)
        self.servers[addr] = srv
        return srv

    def connect(self, address: Tuple[Any, Any],
                timeout: float) -> _SimClient:
        return _SimClient(address)
