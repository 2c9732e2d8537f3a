"""API priority and fairness at the apiserver door (the reference's
pkg/util/flowcontrol token buckets generalized into APF-shaped
queue/dispatch machinery).

Every resource request is classified by its authenticated identity into
a **flow schema**, each schema maps to a **priority level** with a
bounded concurrency share (seats), and within a level requests are
**shuffle-sharded** into per-flow fair queues (flow key = user, or
namespace for anonymous traffic) so N well-behaved flows are isolated
from one noisy one: a hot flow can only ever occupy its own hand of
``hand_size`` queues out of ``queues``, and round-robin dispatch across
queues gives every active flow's queue equal service. When a flow's
hand is full the request is shed with 429 + Retry-After instead of
queueing unboundedly; a queued request that outlives ``queue_wait``
seconds is shed the same way. The ``exempt`` level (system users:
scheduler, kubelet/node fleet, controller-manager, loopback) never
queues — control-plane traffic must not wait behind tenants.

Default-on at the apiserver (server.handle is the single choke point
both doors funnel through); ``KUBERNETES_TPU_APF=0`` is the kill
switch. Per-level live state is served on ``/debug/flowcontrol`` and
the ``apiserver_flowcontrol_*`` metric family tracks wait durations,
queue depths, sheds, and dispatches.

Copy of kubernetes_tpu/apiserver/flowcontrol.py: only the import package differs.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.analysis import races as _races
from kubernetes_tpu_torch.metrics import (
    apiserver_flowcontrol_current_inqueue_requests,
    apiserver_flowcontrol_dispatched_requests_total,
    apiserver_flowcontrol_rejected_requests_total,
    apiserver_flowcontrol_request_wait_duration_seconds,
)

#: identities whose traffic is the control plane itself — never queued
#: behind tenants. "system:unsecured" is the in-process/loopback
#: identity (integration-test masters and the insecure-port idiom both
#: run as cluster-admin in the reference).
EXEMPT_USERS = frozenset({
    "system:kube-scheduler",
    "system:kube-controller-manager",
    "system:kube-proxy",
    "system:apiserver",
    "system:unsecured",
})
EXEMPT_USER_PREFIXES = ("system:node:",)
EXEMPT_GROUPS = frozenset({"system:masters", "system:nodes"})


class Rejected(Exception):
    """Request shed at the apiserver door: the caller should answer 429
    with Retry-After and the client should back off and retry."""

    def __init__(self, level: str, reason: str, retry_after: int):
        super().__init__(
            f"too many requests for priority level {level!r} ({reason}); "
            f"retry after {retry_after}s"
        )
        self.level = level
        self.reason = reason
        self.retry_after = retry_after


@dataclass(frozen=True)
class FlowSchema:
    """One row of the classification table: the first schema whose
    ``match`` has an opinion wins (flowschema matchingPrecedence)."""

    name: str
    priority_level: str
    #: (user, groups, verb, path) -> bool
    match: Callable[[str, Sequence[str], str, str], bool]
    #: flow distinguisher: "user" keys queues by caller identity,
    #: "none" collapses the schema into a single flow
    distinguisher: str = "user"

    def flow_key(self, user: str) -> str:
        if self.distinguisher == "user" and user:
            return f"{self.name}:{user}"
        return self.name


class _Waiter:
    """One queued request. ``dispatched`` is written by the dispatcher
    and read back by the waiting thread — both under the level lock;
    ``queue_index`` lets a timed-out waiter withdraw from its one queue
    instead of scanning the whole bank; ``width`` is the seats this
    request occupies while dispatched."""

    __slots__ = ("flow", "ready", "dispatched", "enqueued_at",
                 "queue_index", "width")

    def __init__(self, flow: str, enqueued_at: float, queue_index: int,
                 width: int = 1):
        self.flow = flow
        self.ready = threading.Event()
        self.dispatched = False
        self.enqueued_at = enqueued_at
        self.queue_index = queue_index
        self.width = width


class PriorityLevel:
    """Seats + shuffle-sharded fair queues for one priority level.

    Invariant: a request is queued only while every seat is busy, and
    whenever a seat frees the longest-waiting queue (round-robin
    cursor) dispatches first — so queues drain fairly across flows no
    matter how deep one flow's queues are.
    """

    #: per-flow hand-memo entries retained (flow keys derive from
    #: caller-controlled identity; the memo must not grow unboundedly)
    HAND_MEMO_MAX = 1024

    #: fraction of a level's nominal seats it may lend to saturated
    #: siblings while idle (the reference's lendablePercent)
    LENDABLE_PCT = 0.5

    def __init__(
        self,
        name: str,
        seats: int,
        queues: int = 64,
        queue_length: int = 128,
        hand_size: int = 8,
        exempt: bool = False,
        queue_wait: float = 15.0,
    ):
        self.name = name
        self.seats = max(1, int(seats))
        self.exempt = exempt
        # seat borrowing between sibling levels (the reference's
        # lendable/borrowing concurrency limits): `exchange` is wired
        # by the controller; a level may lend up to LENDABLE_PCT of its
        # seats while it has no waiters, and borrow up to its own seat
        # count (2x nominal ceiling). Leases are per-request: every
        # release returns borrowed seats first, so a lender under
        # contention gets them back as fast as the borrower's requests
        # complete.
        self.exchange = None
        self.borrow_limit = self.seats
        self._lent_out = 0  # guarded-by: self._mu
        self._borrowed_in = 0  # guarded-by: self._mu
        # in-flight borrow reservations: counted against borrow_limit
        # (so concurrent saturated acquires cannot overshoot the 2x
        # ceiling) but NOT in capacity until a lender actually grants
        self._borrow_pending = 0  # guarded-by: self._mu
        self._borrow_ledger: Dict[str, int] = {}  # guarded-by: self._mu
        self.queue_length = max(1, int(queue_length))
        self.hand_size = max(1, min(int(hand_size), max(1, int(queues))))
        self.queue_wait = queue_wait  # guarded-by: self._mu
        self._mu = threading.Lock()
        self._queues: List[deque] = [
            deque() for _ in range(max(1, int(queues)))
        ]  # guarded-by: self._mu
        # flow -> dealt hand, memoized: the hand is a pure function of
        # (level, flow) and flows are few and stable (one per tenant),
        # so the blake2b deal runs once per flow, not per enqueue
        self._hands: Dict[str, List[int]] = {}  # guarded-by: self._mu
        self._seats_in_use = 0  # guarded-by: self._mu
        self._waiting = 0  # guarded-by: self._mu
        self._rr = 0  # guarded-by: self._mu  (round-robin dispatch cursor)
        # pre-bound metric children (hot path: one dict op per event)
        self._m_wait = (
            apiserver_flowcontrol_request_wait_duration_seconds.labels(name)
        )
        self._m_inqueue = (
            apiserver_flowcontrol_current_inqueue_requests.labels(name)
        )
        self._m_dispatched = (
            apiserver_flowcontrol_dispatched_requests_total.child(
                priority_level=name
            )
        )
        _races.track(self, f"apiserver.flowcontrol.{name}")

    # -- shuffle sharding ----------------------------------------------------

    def hand_for(self, flow: str) -> List[int]:
        """The flow's deterministic hand of queue indices: dealt without
        replacement from a hash of (level, flow), so one hot flow can
        never occupy more than ``hand_size`` of the level's queues.
        acquire() memoizes the dealt hand per flow."""
        n = len(self._queues)
        h = int.from_bytes(
            hashlib.blake2b(
                f"{self.name}/{flow}".encode(), digest_size=16
            ).digest(),
            "big",
        )
        avail = list(range(n))
        hand: List[int] = []
        for _ in range(min(self.hand_size, n)):
            i = h % len(avail)
            h //= max(len(avail), 1)
            hand.append(avail.pop(i))
        return hand

    def set_queue_wait(self, seconds: float) -> None:
        """Change the queue-wait budget (tests, reconfiguration).
        Locked: acquire() captures its budget under the same lock at
        enqueue time, so a waiter honors either the old value or the
        new one — never a torn read; already-parked waiters keep the
        budget they enqueued under."""
        with self._mu:
            self.queue_wait = float(seconds)

    # -- admission -----------------------------------------------------------

    def acquire(self, flow: str, width: int = 1) -> float:
        """Take `width` seats (possibly after queueing); returns
        seconds waited. Raises Rejected on queue-full or queue-wait
        timeout. Width > 1 is the cost classification for expensive
        requests (selector LISTs, bulk batch bodies): one heavy
        request occupies several seats so a stream of them cannot
        soak up the level's whole nominal concurrency while costing
        like singletons."""
        width = max(1, min(int(width), self.seats))
        if self.exempt:
            # the system level never waits: unbounded immediate
            # dispatch, by design (its wait histogram staying ~0 is the
            # measurable contract)
            with self._mu:
                self._seats_in_use += width
            self._m_dispatched()
            self._m_wait.observe(0.0)
            return 0.0
        w: Optional[_Waiter] = None
        with self._mu:
            if (self._seats_in_use + width <= self._capacity_locked()
                    and self._waiting == 0):
                self._seats_in_use += width
                self._m_dispatched()
                self._m_wait.observe(0.0)
                return 0.0
        # saturated: try to borrow a sibling level's idle seats before
        # queueing (outside our lock; the exchange locks one lender at
        # a time, so there is no lock-order cycle)
        if self.exchange is not None:
            lender = self.exchange.borrow(self, width)
            if lender is not None:
                # the exchange already moved the lease into
                # _borrowed_in under our lock; record who to repay
                with self._mu:
                    self._borrow_ledger[lender.name] = (
                        self._borrow_ledger.get(lender.name, 0) + width
                    )
                    if (self._waiting == 0 and self._seats_in_use
                            + width <= self._capacity_locked()):
                        self._seats_in_use += width
                        self._m_dispatched()
                        self._m_wait.observe(0.0)
                        return 0.0
                    # waiters exist: the borrowed capacity serves the
                    # queue head (FIFO fairness), this request queues
                    self._dispatch_locked()
        with self._mu:
            if (self._seats_in_use + width <= self._capacity_locked()
                    and self._waiting == 0):
                self._seats_in_use += width
                self._m_dispatched()
                self._m_wait.observe(0.0)
                return 0.0
            hand = self._hands.get(flow)
            if hand is None:
                # dealt once per flow (memoized), so the blake2b deal
                # is not a per-enqueue cost under the lock. BOUNDED:
                # flow keys derive from caller-controlled identity
                # (X-Remote-User), so an unbounded memo would be a
                # remote memory leak — past the cap, deal per call
                hand = self.hand_for(flow)
                if len(self._hands) < self.HAND_MEMO_MAX:
                    self._hands[flow] = hand
            qi = min(hand, key=lambda i: len(self._queues[i]))
            if len(self._queues[qi]) >= self.queue_length:
                apiserver_flowcontrol_rejected_requests_total.inc(
                    priority_level=self.name, reason="queue-full"
                )
                raise Rejected(self.name, "queue-full",
                               self._retry_after_locked())
            w = _Waiter(flow, time.monotonic(), qi, width)
            self._queues[qi].append(w)
            self._waiting += 1
            self._m_inqueue.inc()
            # the wait budget is captured under the lock: a concurrent
            # set_queue_wait() must not race this read (the timeout a
            # request enqueued under is the timeout it honors)
            wait_budget = self.queue_wait
        w.ready.wait(wait_budget)
        with self._mu:
            if w.dispatched:
                waited = time.monotonic() - w.enqueued_at
            else:
                # timed out in queue: withdraw from the one queue it
                # was appended to (the dispatcher can no longer pick
                # this waiter once it leaves the deque), then re-run
                # dispatch — if THIS waiter was a wide head holding
                # the dispatcher while seats accumulated for it, its
                # departure may unblock narrower waiters behind it
                self._queues[w.queue_index].remove(w)
                self._waiting -= 1
                self._m_inqueue.dec()
                self._dispatch_locked()
                apiserver_flowcontrol_rejected_requests_total.inc(
                    priority_level=self.name, reason="time-out"
                )
                raise Rejected(self.name, "time-out",
                               self._retry_after_locked())
        self._m_dispatched()
        self._m_wait.observe(waited)
        return waited

    def release(self, width: int = 1) -> None:
        width = max(1, min(int(width), self.seats))
        give = None
        with self._mu:
            self._seats_in_use -= width
            if self._borrow_ledger:
                # return borrowed seats FIRST: a lender that became
                # contended while we held its seats gets them back as
                # soon as any of our requests completes
                name = next(iter(self._borrow_ledger))
                back = min(width, self._borrow_ledger[name])
                self._borrow_ledger[name] -= back
                if not self._borrow_ledger[name]:
                    del self._borrow_ledger[name]
                self._borrowed_in -= back
                give = (name, back)
            if not self.exempt:
                self._dispatch_locked()
        if give is not None and self.exchange is not None:
            self.exchange.give_back(*give)

    def _capacity_locked(self) -> int:
        """Effective seats: nominal, plus leases borrowed in, minus
        seats currently lent to sibling levels."""
        return self.seats + self._borrowed_in - self._lent_out

    def _dispatch_locked(self) -> None:
        """Fill freed seats round-robin across non-empty queues — each
        active flow's queue gets equal service regardless of depth. A
        wide head-of-queue request that does not fit yet HOLDS the
        dispatcher (seats accumulate for it as they free) instead of
        being skipped — jumping past it would starve wide requests
        behind an endless stream of narrow ones."""
        n = len(self._queues)
        while True:
            for off in range(n):
                qi = (self._rr + off) % n
                if self._queues[qi]:
                    break
            else:
                return
            w = self._queues[qi][0]
            if self._seats_in_use + w.width > self._capacity_locked():
                return  # not enough seats yet: wait for more releases
            self._rr = qi + 1
            self._queues[qi].popleft()
            self._seats_in_use += w.width
            self._waiting -= 1
            self._m_inqueue.dec()
            w.dispatched = True
            w.ready.set()

    def _retry_after_locked(self) -> int:
        """Congestion-scaled Retry-After: roughly how many dispatch
        generations stand between the caller and a seat."""
        return max(1, min(30, self._waiting // max(1, self.seats)))

    # -- introspection (/debug/flowcontrol) ----------------------------------

    def state(self) -> Dict[str, object]:
        with self._mu:
            depths = [len(q) for q in self._queues]
            seats_in_use = self._seats_in_use
            waiting = self._waiting
        with self._mu:
            borrowed_in = self._borrowed_in
            lent_out = self._lent_out
        rejected = apiserver_flowcontrol_rejected_requests_total
        return {
            "exempt": self.exempt,
            "seats": self.seats,
            "seats_in_use": seats_in_use,
            "borrowed_in": borrowed_in,
            "lent_out": lent_out,
            "waiting": waiting,
            "queues": len(depths),
            "queue_length_limit": self.queue_length,
            "hand_size": self.hand_size,
            "nonempty_queues": {
                str(i): d for i, d in enumerate(depths) if d
            },
            "dispatched": self._m_dispatched_total(),
            "rejected_queue_full": rejected.get(
                priority_level=self.name, reason="queue-full"
            ),
            "rejected_time_out": rejected.get(
                priority_level=self.name, reason="time-out"
            ),
        }

    def _m_dispatched_total(self) -> float:
        return apiserver_flowcontrol_dispatched_requests_total.get(
            priority_level=self.name
        )


class SeatExchange:
    """Seat lending between sibling priority levels (the reference's
    lendable/borrowing concurrency limits). A level may lend only while
    it is IDLE (no waiters) and only up to LENDABLE_PCT of its nominal
    seats; leases return on the borrower's next releases, so a lender
    that becomes contended recovers its seats at the borrower's request
    completion rate, never waiting on a timer.

    Locking: borrow()/give_back() hold at most ONE level lock at a
    time (never the borrower's and a lender's together), so there is
    no lock-order cycle with acquire/release."""

    def __init__(self, levels: Sequence[PriorityLevel]):
        self._levels = sorted(
            (l for l in levels if not l.exempt), key=lambda l: l.name
        )
        self._by_name = {l.name: l for l in self._levels}

    def borrow(self, borrower: PriorityLevel,
               width: int) -> Optional[PriorityLevel]:
        # reserve against the borrow limit UNDER the borrower's lock
        # (a check-then-act across lock drops would let concurrent
        # saturated acquires overshoot the 2x ceiling); the
        # reservation is excluded from capacity until a lender grants
        with borrower._mu:
            if (borrower._borrowed_in + borrower._borrow_pending
                    + width > borrower.borrow_limit):
                return None
            borrower._borrow_pending += width
        lender_found = None
        for lender in self._levels:
            if lender is borrower:
                continue
            with lender._mu:
                idle = (lender.seats - lender._seats_in_use
                        - lender._lent_out)
                lendable_left = int(
                    lender.seats * lender.LENDABLE_PCT
                ) - lender._lent_out
                if (lender._waiting == 0 and idle >= width
                        and lendable_left >= width):
                    lender._lent_out += width
                    lender_found = lender
                    break
        with borrower._mu:
            borrower._borrow_pending -= width
            if lender_found is not None:
                borrower._borrowed_in += width
        return lender_found

    def give_back(self, lender_name: str, width: int) -> None:
        lender = self._by_name.get(lender_name)
        if lender is None:
            return
        with lender._mu:
            lender._lent_out -= width
            # returned seats dispatch the lender's waiters immediately
            lender._dispatch_locked()


class _Ticket:
    """Context manager holding one dispatched request's seats."""

    __slots__ = ("level", "schema", "flow", "waited", "width")

    def __init__(self, level: PriorityLevel, schema: FlowSchema,
                 flow: str, waited: float, width: int = 1):
        self.level = level
        self.schema = schema
        self.flow = flow
        self.waited = waited
        self.width = width

    def __enter__(self) -> "_Ticket":
        return self

    def __exit__(self, *exc) -> None:
        self.level.release(self.width)


#: seats a selector LIST occupies: the label/field filter runs in-seat
#: over the whole collection (the raw-splice fast path cannot serve it)
WIDTH_SELECTOR_LIST = 2
#: one extra seat per this many items in a bulk body (a 1000-item
#: /api/v1/batch decodes+validates+commits every item inside its seat)
WIDTH_ITEMS_PER_SEAT = 200
#: widest any single request can be classified (further capped at the
#: level's total seats at acquire time so it can always dispatch)
WIDTH_MAX = 4


def request_width(verb: str, path: str, query=None, body=None) -> int:
    """Cost-classify one request into the seats it occupies — decided
    AT CLASSIFY TIME from the request shape alone, so one heavy
    request cannot masquerade as a singleton and starve a level that
    nominally has free seats:

      * selector LISTs (labelSelector/fieldSelector, non-watch) run
        the filter in-seat over the whole collection -> 2 seats;
      * bulk bodies (``/api/v1/batch``, bulk-create Lists) cost one
        extra seat per WIDTH_ITEMS_PER_SEAT items, capped at
        WIDTH_MAX;
      * everything else is 1.
    """
    if verb in ("GET", "HEAD"):
        # same watch detection as the router (`watch=false` is a LIST,
        # not a watch — a truthy-string check would let selector LISTs
        # masquerade as width-1 watches)
        is_watch = query is not None and \
            query.get("watch") in ("true", "1")
        if query and not is_watch and (
                query.get("labelSelector") or query.get("fieldSelector")):
            return WIDTH_SELECTOR_LIST
        return 1
    items = body.get("items") if isinstance(body, dict) else None
    if isinstance(items, (list, tuple)) and \
            len(items) >= WIDTH_ITEMS_PER_SEAT:
        return min(WIDTH_MAX, 1 + len(items) // WIDTH_ITEMS_PER_SEAT)
    return 1


def is_exempt_identity(user: str, groups: Sequence[str]) -> bool:
    if user in EXEMPT_USERS or user.startswith(EXEMPT_USER_PREFIXES):
        return True
    return any(g in EXEMPT_GROUPS for g in groups)


def default_levels(
    total_seats: int = 32, queue_wait: float = 15.0,
    queues: int = 64, queue_length: int = 128, hand_size: int = 8,
) -> Dict[str, PriorityLevel]:
    """exempt + three shared-concurrency levels. Shares (6:3:1) carve
    ``total_seats`` the way the reference's assuredConcurrencyShares
    carve --max-requests-inflight."""
    shares = {"workload-high": 6, "workload-low": 3, "catch-all": 1}
    total_shares = sum(shares.values())
    levels: Dict[str, PriorityLevel] = {
        "exempt": PriorityLevel("exempt", seats=1, exempt=True),
    }
    for name, share in shares.items():
        levels[name] = PriorityLevel(
            name,
            seats=max(1, round(total_seats * share / total_shares)),
            queues=queues if name != "catch-all" else max(4, queues // 4),
            queue_length=(queue_length if name != "catch-all"
                          else max(4, queue_length // 2)),
            hand_size=hand_size if name != "catch-all" else max(
                1, hand_size // 2),
            queue_wait=queue_wait,
        )
    return levels


def default_schemas() -> List[FlowSchema]:
    """The classification table, in matching order:

    ========================  ==============  ===========================
    flow schema               priority level  matches
    ========================  ==============  ===========================
    system                    exempt          system users (scheduler,
                                              controller-manager, nodes,
                                              loopback/unsecured) and
                                              system:masters/nodes groups
    workload-low              workload-low    callers in group
                                              ``workload:low``
    workload-high             workload-high   any other named caller
                                              (per-user flows)
    catch-all                 catch-all       everything else (anonymous)
    ========================  ==============  ===========================
    """
    return [
        FlowSchema(
            "system", "exempt",
            match=lambda u, g, v, p: is_exempt_identity(u, g),
            distinguisher="none",
        ),
        FlowSchema(
            "workload-low", "workload-low",
            match=lambda u, g, v, p: "workload:low" in g,
        ),
        FlowSchema(
            "workload-high", "workload-high",
            match=lambda u, g, v, p: bool(u)
            and u != "system:anonymous",
        ),
        FlowSchema(
            "catch-all", "catch-all",
            match=lambda u, g, v, p: True,
            distinguisher="none",
        ),
    ]


def enabled_in_env() -> bool:
    """The one parse of the KUBERNETES_TPU_APF kill switch (bench and
    from_env must agree on what counts as off)."""
    return os.environ.get("KUBERNETES_TPU_APF", "1").lower() not in (
        "0", "false", "off"
    )


class APFController:
    """Classification + admission for one apiserver. ``admit`` returns
    a context manager holding the seat; it raises Rejected when the
    request should be shed with 429 + Retry-After."""

    def __init__(
        self,
        levels: Optional[Dict[str, PriorityLevel]] = None,
        schemas: Optional[List[FlowSchema]] = None,
    ):
        self.levels = levels or default_levels()
        self.schemas = schemas or default_schemas()
        for s in self.schemas:
            if s.priority_level not in self.levels:
                raise ValueError(
                    f"flow schema {s.name!r} names unknown priority "
                    f"level {s.priority_level!r}"
                )
        # seat borrowing between the shared-concurrency levels
        # (KUBERNETES_TPU_APF_BORROW=0 disables)
        if os.environ.get("KUBERNETES_TPU_APF_BORROW", "1").lower() \
                not in ("0", "false", "off"):
            exchange = SeatExchange(list(self.levels.values()))
            for lvl in self.levels.values():
                if not lvl.exempt:
                    lvl.exchange = exchange
        _races.track(self, "apiserver.APFController")

    @classmethod
    def from_env(cls) -> Optional["APFController"]:
        """Default-on; ``KUBERNETES_TPU_APF=0`` disables (the kill
        switch). ``KUBERNETES_TPU_APF_SEATS`` scales the shared seat
        pool and ``KUBERNETES_TPU_APF_QUEUE_WAIT`` bounds queue time."""
        if not enabled_in_env():
            return None
        try:
            seats = int(os.environ.get("KUBERNETES_TPU_APF_SEATS", "32"))
        except ValueError:
            seats = 32
        try:
            wait = float(os.environ.get(
                "KUBERNETES_TPU_APF_QUEUE_WAIT", "15"))
        except ValueError:
            wait = 15.0
        return cls(levels=default_levels(seats, wait))

    def classify(
        self, user: str, groups: Sequence[str], verb: str, path: str
    ) -> Tuple[FlowSchema, PriorityLevel, str]:
        for s in self.schemas:
            if s.match(user, groups, verb, path):
                return s, self.levels[s.priority_level], s.flow_key(user)
        # default_schemas ends in a match-all; a custom table without
        # one falls through to the last level rather than crashing
        s = self.schemas[-1]
        return s, self.levels[s.priority_level], s.flow_key(user)

    def admit(self, user: str, groups: Sequence[str], verb: str,
              path: str, width: int = 1) -> _Ticket:
        schema, level, flow = self.classify(user, groups, verb, path)
        width = max(1, min(int(width), level.seats))
        waited = level.acquire(flow, width)  # may raise Rejected
        return _Ticket(level, schema, flow, waited, width)

    def state(self) -> Dict[str, object]:
        """The /debug/flowcontrol payload."""
        return {
            "enabled": True,
            "priority_levels": {
                name: lvl.state() for name, lvl in self.levels.items()
            },
            "flow_schemas": [
                {
                    "name": s.name,
                    "priority_level": s.priority_level,
                    "distinguisher": s.distinguisher,
                }
                for s in self.schemas
            ],
        }
