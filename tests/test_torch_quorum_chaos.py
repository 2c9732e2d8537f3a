"""Quorum fault-injection gates: under each injected single fault —
kill -9 of the leader or a follower, a symmetric partition, an
asymmetric one-way delay with message-reordering jitter — a 3-member
quorum must lose ZERO acknowledged writes, elect at most one leader
per term, and produce an op history the Jepsen-lite linearizability
checker accepts (storage/quorum/linearize.py) — an assertion, not a
log line. The lock-order sanitizer is armed over every scenario.

The cases of tests/test_quorum_chaos.py, run against the port's copies
(kubernetes_tpu_torch), each with the mark it has there."""

import random
import threading
import time

import pytest

from conftest import wait_until  # noqa: E402

from kubernetes_tpu_torch.analysis import locks as lock_sanitizer
from kubernetes_tpu_torch.harness.nemesis import Nemesis
from kubernetes_tpu_torch.metrics import (
    quorum_lease_reads_total,
    quorum_prevote_rounds_total,
    quorum_readindex_rounds_total,
)
from kubernetes_tpu_torch.storage.quorum import NodeConfig, QuorumStore
from kubernetes_tpu_torch.storage.quorum import linearize
from kubernetes_tpu_torch.storage.replicated import NotPrimary
from kubernetes_tpu_torch.storage.store import KeyExists, KeyNotFound, Conflict


@pytest.fixture(autouse=True)
def _lock_order_sanitizer():
    with lock_sanitizer.instrumented():
        yield
    lock_sanitizer.assert_no_cycles("(quorum chaos suite)")


KEYS = [f"/reg/k{i:02d}" for i in range(12)]


@pytest.fixture
def chaos_cluster(tmp_path):
    stores = [QuorumStore(
        NodeConfig(
            node_id=f"q{i}",
            data_dir=str(tmp_path / f"q{i}"),
            election_timeout=0.2,
        ),
        write_timeout=3.0, read_timeout=3.0,
    ) for i in range(3)]
    nem = Nemesis({s.node_id: s.address for s in stores})
    for s in stores:
        s.set_peers(nem.peer_view(s.node_id))
        s.start()
    try:
        yield stores, nem
    finally:
        for s in stores:
            s.close()
        nem.close()


def wait_leader(stores, exclude=(), timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for s in stores:
            if s not in exclude and s.node.is_leader():
                return s
        time.sleep(0.02)
    raise AssertionError("no leader within %ss" % timeout)


class Workload:
    """Writer + reader threads against random members, every op
    recorded in the linearizability history. Indeterminate outcomes
    (unavailable/timeout) are `info`; definite store errors are
    `fail`."""

    def __init__(self, stores, writers=3, readers=2):
        self.stores = stores
        self.history = linearize.HistoryRecorder()
        self.stop = threading.Event()
        self._serial = [0] * writers
        self.threads = [
            threading.Thread(target=self._writer, args=(i,),
                             daemon=True, name=f"chaos-writer-{i}")
            for i in range(writers)
        ] + [
            threading.Thread(target=self._reader, args=(i,),
                             daemon=True, name=f"chaos-reader-{i}")
            for i in range(readers)
        ]

    def start(self):
        for t in self.threads:
            t.start()
        return self

    def finish(self):
        self.stop.set()
        for t in self.threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in self.threads), (
            "workload thread wedged past the write deadline")

    def _writer(self, wid):
        rng = random.Random(1000 + wid)
        h = self.history
        proc = f"w{wid}"
        while not self.stop.is_set():
            store = rng.choice(self.stores)
            key = rng.choice(KEYS)
            self._serial[wid] += 1
            value = f"{proc}:{self._serial[wid]}"
            op = h.invoke(proc, "write", key, value)
            try:
                try:
                    rv = store.update(key, value)
                except KeyNotFound:
                    rv = store.create(key, value)
                h.ok(op, rv=rv)
            except (KeyExists, KeyNotFound, Conflict):
                h.fail(op)  # definite non-occurrence
            except Exception:
                h.info(op)  # unavailable/timeout: outcome unknown
            time.sleep(rng.uniform(0.002, 0.02))

    def _reader(self, rid):
        rng = random.Random(2000 + rid)
        h = self.history
        proc = f"r{rid}"
        while not self.stop.is_set():
            store = rng.choice(self.stores)
            key = rng.choice(KEYS)
            op = h.invoke(proc, "read", key)
            try:
                # get() returns the object's own mod-rv — the read's
                # serialization point for its key
                obj, rv = store.get(key)
                h.ok(op, rv=rv, value=obj)
            except KeyNotFound:
                h.fail(op)  # negative reads stay out of the model
            except Exception:
                h.info(op)
            time.sleep(rng.uniform(0.002, 0.02))


def assert_chaos_gates(stores, history, live=None, fault=""):
    """The three chaos acceptance gates: convergence + at most one
    leader per term + a linearizable history with zero lost acks."""
    live = [s for s in (live or stores)]
    lead = wait_leader(live)
    # quiesce: a final barrier so the leader's applied state is the
    # full committed history
    lead.read_index()
    assert wait_until(
        lambda: all(
            s.node.status()["applied_index"]
            >= lead.node.status()["commit_index"]
            for s in live),
        timeout=20), "members never converged after heal"
    # gate: at most one leader per term, across every member that
    # ever lived (killed members' claims count too)
    claimed = {}
    for s in stores:
        for t in s.node.terms_led:
            claimed.setdefault(t, []).append(s.node_id)
    double = {t: who for t, who in claimed.items() if len(who) > 1}
    assert not double, f"[{fault}] two leaders in one term: {double}"
    # gate: linearizable history, zero lost acknowledged writes
    with lead._lock:
        final = {k: (v, rv) for k, (v, rv) in lead._data.items()
                 if k.startswith("/reg/")}
    res = linearize.check(history, final_state=final)
    assert res.ok, (
        f"[{fault}] linearizability violations "
        f"({res.checked_writes} writes, {res.checked_reads} reads): "
        + "; ".join(res.errors))
    assert res.checked_writes > 0, "workload recorded no writes"


def test_chaos_kill_leader(chaos_cluster):
    """kill -9 the LEADER mid-traffic: a new leader takes over, no
    acknowledged write is lost, history stays linearizable."""
    stores, _nem = chaos_cluster
    lead = wait_leader(stores)
    w = Workload(stores).start()
    try:
        time.sleep(1.0)
        lead.kill()
        wait_leader(stores, exclude=(lead,))
        time.sleep(1.5)
    finally:
        w.finish()
    live = [s for s in stores if s is not lead]
    assert_chaos_gates(stores, w.history, live=live,
                       fault="kill-leader")


def test_chaos_kill_follower(chaos_cluster):
    """kill -9 a FOLLOWER: the majority keeps acking writes
    throughout (no availability cliff), nothing is lost."""
    stores, _nem = chaos_cluster
    lead = wait_leader(stores)
    victim = next(s for s in stores if s is not lead)
    w = Workload(stores).start()
    try:
        time.sleep(0.8)
        before = w.history.ops()
        victim.kill()
        time.sleep(1.5)
        # liveness through the fault: acked writes kept flowing
        after = [o for o in w.history.ops()[len(before):]
                 if o.kind == "write" and o.status == linearize.OK]
        assert len(after) > 0, "no write acked with one follower down"
    finally:
        w.finish()
    live = [s for s in stores if s is not victim]
    assert_chaos_gates(stores, w.history, live=live,
                       fault="kill-follower")


def test_chaos_symmetric_partition(chaos_cluster):
    """Partition the leader away from both followers: the majority
    side elects (one leader per term — the deposed leader can commit
    nothing), heals, and the stitched history is linearizable."""
    stores, nem = chaos_cluster
    lead = wait_leader(stores)
    others = [s.node_id for s in stores if s is not lead]
    w = Workload(stores).start()
    try:
        time.sleep(0.8)
        nem.partition([lead.node_id], others)
        wait_leader(stores, exclude=(lead,))
        time.sleep(1.5)
        nem.heal()
        # old leader rejoins as follower
        assert wait_until(lambda: not lead.node.is_leader(),
                          timeout=10)
        time.sleep(1.0)
    finally:
        w.finish()
    assert_chaos_gates(stores, w.history, fault="symmetric-partition")


def test_lease_holder_partitioned_stops_lease_reads(chaos_cluster):
    """The lease-safety gate: a lease-holding leader cut off from the
    quorum must STOP serving linearizable reads within the lease
    window — by the time the majority side can elect (>= one election
    timeout of silence, which the lease window is a strict fraction
    of), the old leader already refuses, so NO read it ever served can
    be stale. The Jepsen-lite checker gates the full history too."""
    stores, nem = chaos_cluster
    lead = wait_leader(stores)
    # probe key OUTSIDE the workload's key space: the checker's
    # sequential model only knows workload-recorded ops
    l0 = quorum_lease_reads_total.get()
    lead.create("/probe/lease", "v0")  # the append round just acked...
    lead.get("/probe/lease")  # ...so this read rides the live lease
    assert quorum_lease_reads_total.get() > l0, \
        "steady read did not ride the lease"
    w = Workload(stores).start()
    try:
        time.sleep(0.5)
        others = [s.node_id for s in stores if s is not lead]
        t_part = time.monotonic()
        nem.partition([lead.node_id], others)
        window = (lead.node.config.election_timeout
                  * lead.node.config.lease_factor)
        # the old leader refuses once the lease runs out (observed
        # with a generous poll margin for a loaded 1-core box; the
        # STRONG ordering claim is the probe after the new election)
        refused_at = None
        while time.monotonic() < t_part + window + 5.0:
            try:
                lead.node.read_barrier(timeout=0.05)
            except NotPrimary:
                refused_at = time.monotonic()
                break
            time.sleep(0.02)
        assert refused_at is not None, \
            "partitioned lease holder kept serving reads"
        assert refused_at - t_part <= window + 1.0, (
            f"lease read served {refused_at - t_part:.2f}s after the "
            f"partition (window {window:.2f}s)")
        # the majority elects and commits NEW state; the old leader —
        # whose lease expired strictly before that election could
        # begin — must still refuse (the no-stale-read ordering)
        new = wait_leader(stores, exclude=(lead,))
        new.update("/probe/lease", "v1")
        with pytest.raises(NotPrimary):
            lead.node.read_barrier(timeout=0.3)
        nem.heal()
        assert wait_until(lambda: not lead.node.is_leader(), timeout=10)
        time.sleep(0.8)
    finally:
        w.finish()
    assert_chaos_gates(stores, w.history, fault="lease-partition")


def test_prevote_rejoining_member_never_bumps_term(chaos_cluster):
    """Pre-vote: a member partitioned through MANY election timeouts
    probes electability instead of bumping its term, so after it
    heals the cluster's max term is exactly what it was — the healthy
    leader is never deposed by a flapping replica."""
    stores, nem = chaos_cluster
    lead = wait_leader(stores)
    lead.create("/reg/k00", "v0")
    victim = next(s for s in stores if s is not lead)
    term_before = max(s.node.status()["term"] for s in stores)
    p0 = quorum_prevote_rounds_total.get()
    nem.isolate(victim.node_id)
    # many election timeouts of isolation: pre-prevote raft would
    # have bumped the victim's term once per timeout
    time.sleep(8 * victim.node.config.election_timeout)
    assert quorum_prevote_rounds_total.get() > p0, \
        "the isolated member never even probed (prevote not running)"
    assert victim.node.status()["term"] == term_before, \
        "isolated member bumped its own term despite pre-vote"
    nem.heal()
    # the healed member rejoins as follower; writes flow; nobody's
    # term moved and the leader was never deposed
    lead.create("/reg/k01", "v1")
    assert wait_until(
        lambda: victim.node.status()["applied_index"]
        >= lead.node.status()["commit_index"], timeout=10)
    terms_after = [s.node.status()["term"] for s in stores]
    assert max(terms_after) == term_before, terms_after
    assert lead.node.is_leader(), "healthy leader was deposed"


def test_membership_change_under_traffic(chaos_cluster, tmp_path):
    """Dynamic membership mid-traffic: add a 4th member through the
    replicated config entry while the workload writes, verify it
    catches up and participates, then remove it — zero lost acks, at
    most one leader per term, checker-accepted history throughout."""
    stores, _nem = chaos_cluster
    lead = wait_leader(stores)
    w = Workload(stores).start()
    s3 = None
    try:
        time.sleep(0.7)
        s3 = QuorumStore(NodeConfig(
            node_id="q3",
            data_dir=str(tmp_path / "member-q3"),
            election_timeout=0.2,
        ), write_timeout=3.0, read_timeout=3.0)
        # the joiner dials the EXISTING members directly (it is not
        # part of the nemesis matrix; these edges stay healthy)
        s3.set_peers({s.node_id: s.address for s in stores})
        s3.start()
        lead = wait_leader(stores)
        lead.add_member("q3", s3.address)
        # the new member catches up (snapshot or log replay) and then
        # tracks the commit frontier under live traffic
        assert wait_until(
            lambda: s3.node.status()["applied_index"] > 0
            and s3.node.status()["applied_index"]
            >= wait_leader(stores).node.status()["commit_index"] - 50,
            timeout=15), s3.node.status()
        assert wait_leader(stores).node.status()["peers"] == 3
        time.sleep(0.7)
        lead = wait_leader(stores)
        lead.remove_member("q3")
        # the SURVIVORS shrink their majority math; the removed member
        # itself may never learn (the leader stops replicating to it
        # the moment the remove applies — the classic raft property;
        # pre-vote keeps its orphaned probing from disturbing anyone)
        assert wait_until(
            lambda: all(s.node.status()["peers"] == 2 for s in stores),
            timeout=10)
        time.sleep(0.7)
    finally:
        w.finish()
        if s3 is not None:
            s3.close()
    assert_chaos_gates(stores, w.history, fault="membership-change")


def test_chaos_asymmetric_delay_and_reorder(chaos_cluster):
    """Asymmetric one-way delay (the leader's bytes reach one
    follower late; the reverse path is fast) plus reordering jitter
    on the other edge: terms may churn, but nothing acked is lost and
    the history stays linearizable."""
    stores, nem = chaos_cluster
    lead = wait_leader(stores)
    followers = [s for s in stores if s is not lead]
    w = Workload(stores).start()
    try:
        time.sleep(0.8)
        nem.one_way_delay(lead.node_id, followers[0].node_id, 0.4)
        nem.jitter(followers[1].node_id, lead.node_id, 0.2)
        time.sleep(2.0)
        nem.heal()
        time.sleep(1.0)
    finally:
        w.finish()
    assert_chaos_gates(stores, w.history, fault="asymmetric-delay")
