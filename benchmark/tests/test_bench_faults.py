"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have; a sound run comes out correct.
Each drives run_cell on the CPU at a small size, past the harness's look
for a card."""

import time

import pytest

from benchmark import run, sut
from benchmark.reference.scheduler import Cluster
from conftest import BENCH_DIR, tiny_cell

SECONDS = 1.5


def run_tiny(tmp_path, seed=7, **kw):
    root, manifest, cell = tiny_cell(tmp_path, **kw)
    return run.run_cell(root, BENCH_DIR, manifest, cell, seed, SECONDS,
                        False, "cpu", time.perf_counter())


def test_sound_run_is_correct(tmp_path):
    res = run_tiny(tmp_path)
    assert res["correct"] is True
    assert res["checks"]["mismatched_pods"]["value"] == 0
    assert res["checks"]["unplaced_pods"]["value"] == 0
    assert res["calls"] >= 2
    assert set(res["checked_calls"]) <= set(range(res["calls"]))


def break_call(monkeypatch, fault):
    real = sut.System.call

    def call(self, g):
        if fault == "state_unchanged":
            # the call leaves the round-robin state where it found it
            last = self.algo._last_node_index
            names = real(self, g)
            self.algo._last_node_index = last
            return names
        names = real(self, g)
        if fault == "answer_altered":
            i = len(names) // 2
            names[i] = next(n for n in names if n != names[i])
        elif fault == "half_batch":
            # the second half of the backlog left out, its answers taken
            # from the first half
            half = len(names) // 2
            names[half:2 * half] = names[:half]
        elif fault == "piled" and g % 3 == 0:
            # every third call's answers piled onto one node
            names[:] = [names[0]] * len(names)
        return names

    monkeypatch.setattr(sut.System, "call", call)


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch",
                                   "state_unchanged"])
def test_fault_is_not_correct(tmp_path, monkeypatch, fault):
    break_call(monkeypatch, fault)
    res = run_tiny(tmp_path)
    assert res["correct"] is False
    assert res["checks"]["mismatched_pods"]["value"] > 0


def test_overfull_call_outside_the_sample_is_not_correct(tmp_path,
                                                         monkeypatch):
    """Answers piled onto one node in calls that the reference does not
    re-derive still fail the run, by the capacity check of every call."""
    break_call(monkeypatch, "piled")
    monkeypatch.setattr(run, "CHECK_PODS", 1)
    res = run_tiny(tmp_path)
    assert res["correct"] is False
    assert res["checks"]["overfull_nodes"]["value"] > 0


def test_each_call_gets_fresh_pod_names(tmp_path):
    root, manifest, cell = tiny_cell(tmp_path, nodes=8)
    from benchmark import traffic

    desc = traffic.describe(run.load_config(root, manifest, "tiny"),
                            run.load_traffic(BENCH_DIR, cell["traffic"]), 1)
    system = sut.System(desc, "cpu")
    seen = []
    for g in range(3):
        system.call(g)
        seen.append({(p.metadata.name, p.metadata.uid)
                     for p in system.backlog})
    assert len(seen[0]) == len(system.backlog)
    assert not seen[0] & seen[1] and not seen[1] & seen[2]


def test_control_in_the_programs_place_is_not_correct(tmp_path,
                                                     monkeypatch):
    """The control: the reference with its float32 spread steps in
    bfloat16, put where the program runs."""

    def control(self, g):
        d = self.desc
        c = Cluster(d["states"][g % len(self.states)], d["services"],
                    d["controllers"], d["namespace"])
        names, _last, _ = c.schedule(d["groups"], g * len(self.backlog),
                                     bf16=True)
        return names

    real_init = sut.System.__init__

    def init(self, desc, device):
        real_init(self, desc, device)
        self.desc = desc

    monkeypatch.setattr(sut.System, "__init__", init)
    monkeypatch.setattr(sut.System, "call", control)
    res = run_tiny(tmp_path, nodes=150)
    assert res["correct"] is False
    assert res["checks"]["mismatched_pods"]["value"] > 0


def test_unplaced_pod_is_not_correct(tmp_path, monkeypatch):
    real = sut.System.call

    def call(self, g):
        names = real(self, g)
        names[-1] = None
        return names

    monkeypatch.setattr(sut.System, "call", call)
    res = run_tiny(tmp_path)
    assert res["correct"] is False
    assert res["checks"]["unplaced_pods"]["value"] == res["calls"]
    assert res["failed"] == res["calls"]


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 7])
def test_control_script_reads_a_departure(tmp_path, monkeypatch, seed):
    from benchmark import control

    root, manifest, cell = tiny_cell(tmp_path, nodes=150)
    monkeypatch.setattr(run, "CHECK_PODS", 3000)
    out = control.control(root, manifest, cell, seed)
    assert out["correct"] is False
    assert out["checks"]["mismatched_pods"]["value"] > 0
