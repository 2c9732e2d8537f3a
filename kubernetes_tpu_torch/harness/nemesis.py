"""Socket-level nemesis: a proxying shim between quorum peers that
injects partitions, one-way delays, and message reordering.

The kill -9 chaos tier (tests/test_chaos.py) exercises crash faults;
the failures that actually break replicated stores are the OTHER kind
— the network lying. Each quorum edge (an ordered (src, dst) pair) is
fronted by a ``_EdgeProxy``: src dials the proxy instead of dst, and
two pump threads ferry bytes while consulting the edge's fault state:

  * **partition** — the pump stalls (a blackhole, NOT a connection
    reset: the victim sees silence and timeouts, exactly what a
    dropped route looks like; closing the socket would look like a
    crash instead and let the peer fail fast).
  * **delay** — every chunk is held `delay` seconds before
    forwarding, one direction only (the asymmetric-link case: A hears
    B fine, B hears A late).
  * **jitter/reorder** — chunks are released through a per-direction
    holdback queue with randomized extra latency; because the quorum
    RPC layer reconnects on timeout and retries idempotent messages,
    randomized holdback reorders *protocol messages* across
    connection generations while keeping each TCP stream internally
    intact (reordering bytes inside one stream would just be
    corruption, which CRC framing already covers).

``Nemesis`` manages the full edge matrix for a cluster and exposes the
Jepsen-style verbs: ``partition(a_side, b_side)``, ``isolate(node)``,
``one_way_delay(src, dst, s)``, ``jitter(src, dst, s)``, ``heal()``.
Faults apply to live connections mid-flight — flipping a partition on
stalls established pumps, and healing releases them.

Copy of kubernetes_tpu/harness/nemesis.py: only the import package differs.
"""

from __future__ import annotations

import random
import socket
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple


class _EdgeState:
    """Mutable fault knobs for one direction of one edge; shared by
    every pump thread on that edge."""

    def __init__(self):
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self.dropped = False  # guarded-by: self._mu
        self.delay = 0.0  # guarded-by: self._mu
        self.jitter = 0.0  # guarded-by: self._mu

    def set(self, dropped: Optional[bool] = None,
            delay: Optional[float] = None,
            jitter: Optional[float] = None) -> None:
        with self._cv:
            if dropped is not None:
                self.dropped = dropped
            if delay is not None:
                self.delay = delay
            if jitter is not None:
                self.jitter = jitter
            self._cv.notify_all()

    def gate(self, rng: random.Random) -> bool:
        """Block while the direction is partitioned; then serve the
        configured latency. False = the proxy is shutting down."""
        with self._cv:
            while self.dropped:
                self._cv.wait(0.05)
            if self.dropped is None:  # closed sentinel
                return False
            hold = self.delay + (rng.random() * self.jitter
                                 if self.jitter else 0.0)
        if hold > 0:
            time.sleep(hold)
        return True


class _EdgeProxy:
    """One listener fronting one (src -> dst) edge. src connects here;
    every accepted connection gets a fresh upstream connection to the
    real dst and two pump threads."""

    def __init__(self, target: Tuple[str, int], state_fwd: _EdgeState,
                 state_rev: _EdgeState, host: str = "127.0.0.1"):
        self.target = tuple(target)
        self.state_fwd = state_fwd  # src -> dst direction
        self.state_rev = state_rev  # dst -> src direction
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, 0))
        self._srv.listen(16)
        self.address = self._srv.getsockname()
        self._stopped = threading.Event()
        self._conns_mu = threading.Lock()
        self._conns: List[socket.socket] = []  # guarded-by: self._conns_mu
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=f"nemesis-{self.address[1]}").start()

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                downstream, _ = self._srv.accept()
            except OSError:
                return
            # connection ESTABLISHMENT through a partitioned edge must
            # also hang, not refuse: defer the upstream dial into the
            # pump thread behind the same gate
            threading.Thread(target=self._bridge, args=(downstream,),
                             daemon=True,
                             name=f"nemesis-conn-{self.address[1]}"
                             ).start()

    def _bridge(self, downstream: socket.socket) -> None:
        rng = random.Random()
        if not self.state_fwd.gate(rng):
            self._close(downstream)
            return
        try:
            upstream = socket.create_connection(self.target, timeout=5)
        except OSError:
            self._close(downstream)
            return
        for s in (downstream, upstream):
            try:
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
        with self._conns_mu:
            if self._stopped.is_set():
                self._close(downstream)
                self._close(upstream)
                return
            self._conns += [downstream, upstream]
        threading.Thread(
            target=self._pump, args=(downstream, upstream,
                                     self.state_fwd, rng),
            daemon=True, name="nemesis-fwd").start()
        threading.Thread(
            target=self._pump, args=(upstream, downstream,
                                     self.state_rev,
                                     random.Random()),
            daemon=True, name="nemesis-rev").start()

    def _pump(self, src: socket.socket, dst: socket.socket,
              state: _EdgeState, rng: random.Random) -> None:
        try:
            while not self._stopped.is_set():
                data = src.recv(65536)
                if not data:
                    break
                if not state.gate(rng):
                    break
                dst.sendall(data)
        except OSError:
            pass
        finally:
            self._close(src)
            self._close(dst)

    @staticmethod
    def _close(s: socket.socket) -> None:
        try:
            s.close()
        except OSError:
            pass

    def close(self) -> None:
        self._stopped.set()
        try:
            self._srv.close()
        except OSError:
            pass
        with self._conns_mu:
            conns, self._conns = list(self._conns), []
        for c in conns:
            self._close(c)


class Nemesis:
    """The fault matrix for a named set of endpoints. Build it over
    the cluster's REAL listener addresses, then hand each node the
    proxied view of its peers (`peer_view`)."""

    def __init__(self, targets: Dict[str, Tuple[str, int]]):
        self.targets = {k: tuple(v) for k, v in targets.items()}
        self._states: Dict[Tuple[str, str], _EdgeState] = {}
        self._proxies: Dict[Tuple[str, str], _EdgeProxy] = {}
        ids = sorted(self.targets)
        for src in ids:
            for dst in ids:
                if src == dst:
                    continue
                self._states[(src, dst)] = _EdgeState()
        for src in ids:
            for dst in ids:
                if src == dst:
                    continue
                self._proxies[(src, dst)] = _EdgeProxy(
                    self.targets[dst],
                    self._states[(src, dst)],
                    self._states[(dst, src)],
                )

    def peer_view(self, src: str) -> Dict[str, Tuple[str, int]]:
        """The address map `src` should dial: every peer behind its
        (src, peer) proxy."""
        return {
            dst: self._proxies[(src, dst)].address
            for dst in self.targets if dst != src
        }

    # -- fault verbs ---------------------------------------------------------

    def partition(self, a_side: Iterable[str],
                  b_side: Iterable[str]) -> None:
        """Symmetric partition: no bytes flow between the two sides in
        either direction (links within each side stay healthy)."""
        for a in a_side:
            for b in b_side:
                self._states[(a, b)].set(dropped=True)
                self._states[(b, a)].set(dropped=True)

    def isolate(self, node: str) -> None:
        """Cut `node` off from everyone else, both directions."""
        others = [n for n in self.targets if n != node]
        self.partition([node], others)

    def one_way_delay(self, src: str, dst: str, seconds: float) -> None:
        """Asymmetric link: src's bytes reach dst `seconds` late;
        dst's bytes reach src on time."""
        self._states[(src, dst)].set(delay=seconds)

    def jitter(self, src: str, dst: str, seconds: float) -> None:
        """Random per-chunk holdback in [0, seconds) on src -> dst:
        reorders protocol messages across retries/reconnects."""
        self._states[(src, dst)].set(jitter=seconds)

    def heal(self) -> None:
        """Lift every fault; stalled pumps resume."""
        for st in self._states.values():
            st.set(dropped=False, delay=0.0, jitter=0.0)

    def apply(self, spec) -> None:
        """Apply one shared-vocabulary ``harness.faults.FaultSpec`` —
        the same spec the sim checker's schedules are written in — by
        dispatching to the verbs above. Sim-only discrete kinds
        (DROP/DUPLICATE/CRASH/RECOVER act on one protocol message or
        one process, which a byte-stream proxy cannot address) raise
        ValueError rather than silently approximating."""
        from kubernetes_tpu_torch.harness.faults import FaultKind

        if spec.kind is FaultKind.PARTITION:
            self.partition(list(spec.a_side), list(spec.b_side))
        elif spec.kind is FaultKind.ISOLATE:
            self.isolate(spec.a_side[0])
        elif spec.kind is FaultKind.ONE_WAY_DELAY:
            self.one_way_delay(spec.a_side[0], spec.b_side[0],
                               spec.magnitude)
        elif spec.kind is FaultKind.JITTER:
            self.jitter(spec.a_side[0], spec.b_side[0], spec.magnitude)
        elif spec.kind is FaultKind.HEAL:
            self.heal()
        else:
            raise ValueError(
                f"fault kind {spec.kind.value!r} has no socket-level "
                "interpretation (sim-only)")

    def close(self) -> None:
        for st in self._states.values():
            with st._cv:
                st.dropped = None  # closed sentinel unblocks gates
                st._cv.notify_all()
        for p in self._proxies.values():
            p.close()
