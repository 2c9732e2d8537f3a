"""The port's deterministic-simulation model checker
(kubernetes_tpu_torch/analysis/sim, a verbatim copy of the JAX
package's) against the JAX package's: the clean tree checks quiet in
both, the seeded-bug corpus is re-found in both with equal schedules,
and tests/test_sim.py's checker-internals cases run against the port's
copy (its slow case stays marked slow, as there)."""

import pytest

from kubernetes_tpu_torch.analysis.sim import corpus
from kubernetes_tpu_torch.analysis.sim.disk import SimDisk
from kubernetes_tpu_torch.analysis.sim.explore import (explore_bfs,
                                                 explore_random)
from kubernetes_tpu_torch.analysis.sim.harness import SimCluster, _PendingOp
from kubernetes_tpu_torch.analysis.sim.invariants import (STEP_CHECKS,
                                                    acked_durability,
                                                    check_step,
                                                    config_serialization,
                                                    election_safety,
                                                    leader_completeness,
                                                    log_matching,
                                                    state_machine_safety)
from kubernetes_tpu_torch.analysis.sim.net import SimNet
from kubernetes_tpu_torch.analysis.sim.schedule import Schedule, replay, run
from kubernetes_tpu_torch.harness.faults import FaultKind, FaultSpec
from kubernetes_tpu_torch.storage.quorum import linearize
from kubernetes_tpu_torch.storage.quorum.log import (KIND_CONFIG, KIND_DATA,
                                               Entry)

ELECT_A = corpus.ELECT_A


def _healthy_cluster():
    """Elected leader a, one committed+applied write on every node."""
    c = SimCluster(n=3, seed=0)
    for ev in ELECT_A + [
        ["propose", "a", "x", "v1"],
        ["replicate", "a", "b"], ["deliver", 5],
        ["replicate", "a", "c"], ["deliver", 6],
        ["replicate", "a", "b"], ["deliver", 7],
        ["replicate", "a", "c"], ["deliver", 8],
        ["apply", "a"], ["apply", "a"],
        ["apply", "b"], ["apply", "b"],
        ["apply", "c"], ["apply", "c"],
    ]:
        c.step(ev)
    assert c.nodes["a"].role == "leader"
    assert c.committed, "healthy prelude must commit"
    return c


# -- seeded-bug corpus (the checker's own regression gate) -------------------


class TestSeededBugCorpus:
    def test_quick_budget_finds_every_historical_bug(self):
        found = corpus.find_seeded_bugs()
        assert set(found) == {corpus.COMMIT_PAST_MATCH,
                              corpus.ACK_WITHOUT_ENTRY_CHECK,
                              corpus.BARRIER_BYPASS}
        missed = [n for n, s in found.items() if s is None]
        assert not missed, f"checker went blind to: {missed}"
        for name, sched in found.items():
            assert sched.violation, name

    def test_counterexamples_replay_deterministically(self):
        for name, sched in corpus.find_seeded_bugs().items():
            with corpus.mutate(name):
                first = replay(sched)
                second = replay(sched)
            assert first == second, name
            # every violation the finder recorded is re-found
            assert set(sched.violation) <= set(first), name

    def test_triggers_are_quiet_without_their_mutations(self):
        for name, events in corpus._TARGETED.items():
            assert run(Schedule(events=events)) == [], name

    def test_clean_tree_model_checks_quiet(self):
        assert corpus.check_clean() == []

    def test_mutation_restores_original_method(self):
        from kubernetes_tpu_torch.storage.quorum.node import QuorumNode
        orig = QuorumNode._barrier_ready_locked
        with corpus.mutate(corpus.BARRIER_BYPASS):
            assert QuorumNode._barrier_ready_locked is not orig
        assert QuorumNode._barrier_ready_locked is orig

    @pytest.mark.slow
    def test_deep_budget_model_checks_quiet(self):
        # CI invocation (see build/ci.sh): the widened explorer pass
        assert corpus.check_clean(deep=True) == []
        assert explore_random(schedules=60, steps=100, seed=7) is None


# -- schedule files ----------------------------------------------------------


class TestScheduleFiles:
    def test_round_trip_preserves_everything(self, tmp_path):
        sched = Schedule(events=corpus.COMMIT_PAST_MATCH_EVENTS,
                         n=3, seed=4, replication_batch=2,
                         violation=["witness text"])
        path = sched.dump(str(tmp_path / "counterexample.json"))
        loaded = Schedule.load(path)
        assert loaded == sched

    def test_unknown_version_is_rejected(self):
        with pytest.raises(ValueError):
            Schedule.from_json('{"version": 99, "events": []}')

    def test_replay_is_bit_deterministic(self):
        sched = Schedule(events=corpus.ACK_WITHOUT_ENTRY_CHECK_EVENTS)
        assert run(sched) == run(sched) == []
        with corpus.mutate(corpus.ACK_WITHOUT_ENTRY_CHECK):
            a, b = run(sched), run(sched)
        assert a == b and a


# -- fingerprint soundness ---------------------------------------------------


class TestFingerprints:
    def test_convergent_paths_fingerprint_identically(self):
        # path B detours through duplicate-then-drop-the-duplicate,
        # which burns different message ids: the fingerprint must see
        # through schedule-local identifiers to the logical state
        a = SimCluster(n=3, seed=0)
        for ev in ELECT_A:
            a.step(ev)
        b = SimCluster(n=3, seed=0)
        for ev in [["tick", "a"], ["dup", 2], ["drop", 3],
                   ["deliver", 1], ["deliver", 4]]:
            b.step(ev)
        assert a.fingerprint() == b.fingerprint()
        a.close(), b.close()

    def test_distinct_states_fingerprint_differently(self):
        a = SimCluster(n=3, seed=0)
        b = SimCluster(n=3, seed=0)
        for ev in ELECT_A:
            a.step(ev)
        for ev in ELECT_A[:-1]:  # b's vote never delivered
            b.step(ev)
        assert a.fingerprint() != b.fingerprint()
        a.close(), b.close()

    def test_virtual_time_is_excluded(self):
        a = SimCluster(n=3, seed=0)
        fp = a.fingerprint()
        a.clock.advance(1000.0)
        assert a.fingerprint() == fp
        a.close()


# -- explorer bounding -------------------------------------------------------


class TestExplorer:
    def test_bfs_respects_depth_and_state_budget(self, monkeypatch):
        import kubernetes_tpu_torch.analysis.sim.explore as ex
        seen = {"n": 0, "deepest": 0}
        orig = ex._run_prefix

        def spy(sched, events):
            seen["n"] += 1
            seen["deepest"] = max(seen["deepest"], len(events))
            return orig(sched, events)

        monkeypatch.setattr(ex, "_run_prefix", spy)
        assert ex.explore_bfs(max_depth=2, max_states=30) is None
        assert seen["deepest"] <= 2
        # every execution past the budget is one frontier drain, so
        # the count stays within budget * max branching, far from
        # unbounded
        assert seen["n"] < 30 * 20

    def test_bfs_counterexample_is_minimal(self):
        with corpus.mutate(corpus.BARRIER_BYPASS):
            found = explore_bfs(
                base=Schedule(events=[list(e) for e in ELECT_A]),
                max_depth=3, max_states=500)
        assert found is not None
        # depth 1 past the prelude: the barrier probe itself
        assert len(found.events) == len(ELECT_A) + 1

    def test_random_explorer_reaches_committed_writes(self):
        # a random explorer that never commits anything would check
        # nothing; the progress bias must keep walks productive
        sched = Schedule()
        cluster = sched.build_cluster()
        cluster.close()
        assert explore_random(schedules=6, steps=60, seed=3) is None


# -- fabricated violations: every invariant must actually fire ---------------


class TestInvariantSensitivity:
    def test_healthy_cluster_passes_every_check(self):
        c = _healthy_cluster()
        for chk in STEP_CHECKS:
            assert chk(c) == [], chk.__name__
        c.close()

    def test_election_safety_fires(self):
        c = _healthy_cluster()
        c.leaders_by_term.setdefault(1, set()).update({"a", "b"})
        assert election_safety(c)
        c.close()

    def test_log_matching_fires(self):
        c = _healthy_cluster()
        rl = c.nodes["b"].raft_log
        e = rl._entries[-1]
        rl._entries[-1] = Entry(e.term, e.index, b"tampered", e.kind)
        assert log_matching(c)
        c.close()

    def test_leader_completeness_fires(self):
        c = _healthy_cluster()
        idx = max(c.committed)
        c.committed[idx] = (c.committed[idx][0], b"ghost-write",
                            KIND_DATA)
        assert leader_completeness(c)
        c.close()

    def test_state_machine_safety_fires(self):
        c = _healthy_cluster()
        idx, payload = c.machines["b"].applied[-1]
        c.machines["b"].applied[-1] = (idx, payload + b"-forked")
        assert state_machine_safety(c)
        c.close()

    def test_acked_durability_fires(self):
        c = _healthy_cluster()
        op = linearize.Op(op_id=99, process="client-a", kind="write",
                          key="x", value="never-committed",
                          status=linearize.OK)
        fake = _PendingOp(op, "a", max(c.committed), 1)
        fake.done = True
        c.pending.append(fake)
        assert acked_durability(c)
        c.close()

    def test_config_serialization_fires(self):
        c = _healthy_cluster()
        rl = c.nodes["a"].raft_log
        nxt = rl.last_index
        rl._entries.extend([
            Entry(1, nxt + 1, b"cfg1", KIND_CONFIG),
            Entry(1, nxt + 2, b"cfg2", KIND_CONFIG),
        ])
        assert config_serialization(c)
        c.close()

    def test_commit_bound_witness_drains_once(self):
        c = _healthy_cluster()
        c.witnesses.append("fabricated: witness")
        found = check_step(c)
        assert "fabricated: witness" in found
        assert check_step(c) == []  # drained, not re-reported
        c.close()


# -- shared fault vocabulary -------------------------------------------------


class TestFaultVocabulary:
    def test_simnet_applies_standing_faults(self):
        net = SimNet()
        net.apply(FaultSpec(FaultKind.PARTITION, ("a",), ("b", "c")),
                  ["a", "b", "c"])
        assert ("a", "b") in net.blocked and ("c", "a") in net.blocked
        net.apply(FaultSpec(FaultKind.HEAL, (), ()), ["a", "b", "c"])
        assert not net.blocked

    def test_simnet_rejects_non_network_faults(self):
        with pytest.raises(ValueError):
            SimNet().apply(FaultSpec(FaultKind.CRASH, ("a",), ()),
                           ["a", "b", "c"])

    def test_schedule_fault_events_use_the_shared_enum(self):
        # every fault verb a schedule may carry parses as a FaultKind
        for ev in (corpus.ACK_WITHOUT_ENTRY_CHECK_EVENTS):
            if ev[0] == "fault":
                assert FaultKind(ev[1]) in FaultKind

    def test_crash_and_recover_round_trip(self):
        c = _healthy_cluster()
        committed_before = dict(c.committed)
        c.step(["fault", "crash", ["b"], [], 0.0])
        assert "b" in c.crashed and "b" not in c.nodes
        c.step(["fault", "recover", ["b"], [], 0.0])
        assert "b" in c.nodes
        assert check_step(c) == []
        # b recovered from its fsync'd disk: no committed entry lost
        rl = c.nodes["b"].raft_log
        for idx, (term, payload, kind) in committed_before.items():
            e = rl.entry(idx)
            assert e is not None and e.term == term \
                and bytes(e.payload) == payload
        c.close()


# -- sim disk crash model ----------------------------------------------------


class TestSimDiskCrash:
    def test_buffered_flushed_synced_layers(self):
        disk = SimDisk()
        disk.makedirs("/d")
        h = disk.open("/d/f", "wb")
        h.write(b"AAAA")
        h.flush()
        disk.fsync(h)      # synced: 4
        h.write(b"BBBB")
        h.flush()          # flushed but unsynced: torn region
        h.write(b"CC")     # buffered: always lost
        disk.crash("/d/", torn=0.5)
        data = disk.read_bytes("/d/f")
        assert data == b"AAAABB"  # synced + half the torn region
        assert disk._synced["/d/f"] == 4

    def test_replace_is_atomic_and_durable(self):
        disk = SimDisk()
        disk.makedirs("/d")
        with disk.open("/d/tmp", "wb") as h:
            h.write(b"NEW")
            disk.fsync(h)
        disk.replace("/d/tmp", "/d/f")
        disk.crash("/d/", torn=0.0)
        assert disk.read_bytes("/d/f") == b"NEW"
        assert not disk.exists("/d/tmp")


# -- parity with the JAX package's checker -----------------------------------


def test_clean_check_equals_the_jax_checkers():
    from kubernetes_tpu.analysis.sim import corpus as jax_corpus

    assert corpus.check_clean() == jax_corpus.check_clean() == []


def test_seeded_bugs_are_found_with_the_jax_checkers_schedules():
    from kubernetes_tpu.analysis.sim import corpus as jax_corpus

    mine = corpus.find_seeded_bugs()
    theirs = jax_corpus.find_seeded_bugs()
    assert set(mine) == set(theirs)
    for name in mine:
        assert mine[name] is not None and theirs[name] is not None, name
        assert mine[name].to_json() == theirs[name].to_json(), name
