"""Chaos-scenario smokes over the wire-soak harness (harness/soak.py).

Each named ``--wire-soak`` scenario runs here as its tier-1 fast-smoke
variant — the SAME config and gates bench.py runs, at CI-sized
seconds/nodes/rates — so a scenario that rots fails the suite, not an
operator's overnight run. The production-realism (hours-long / A/B)
forms are ``slow``-marked below and excluded from ``-m 'not slow'``.

The cases of tests/test_scenarios.py, run against the port's copies
(kubernetes_tpu_torch), each with the mark it has there.
Each soak runs its daemon with device="cpu" (the port's entry points take
the card unless asked).
"""

import dataclasses
import json
import os
import sys

import pytest

from kubernetes_tpu_torch.harness.soak import (
    SCENARIOS,
    SoakConfig,
    run_wire_soak,
    scenario_config,
)


# the smokes gate on latency/recompile/RSS budgets; an armed sanitizer
# adds ~27% instrumentation overhead, so a failure there would indict
# the overhead, not a regression. The witness invocation covers the
# APF queue/dispatch machinery through tests/test_flowcontrol.py.
pytestmark = pytest.mark.skipif(
    bool(os.environ.get("KUBERNETES_TPU_RACE_SANITIZER"))
    or bool(os.environ.get("KUBERNETES_TPU_LOCK_SANITIZER")),
    reason="perf-gated soak smokes are not valid under armed sanitizers",
)


def _run(cfg):
    rec = run_wire_soak(dataclasses.replace(cfg, device="cpu"))
    if not rec["ok"]:
        breached = [k for k, v in rec["gates"].items() if not v]
        print(json.dumps(rec, indent=1), file=sys.stderr)
        pytest.fail(f"scenario gate breach: {breached}")
    return rec


def test_scenario_table_is_complete():
    assert set(SCENARIOS) == {
        "noisy-neighbor", "rack-failure", "rolling-update", "burst",
        "process-kill"}
    for name, forms in SCENARIOS.items():
        assert set(forms) == {"full", "smoke"}, name
    with pytest.raises(ValueError):
        scenario_config("no-such-scenario", 30)


def test_noisy_neighbor_smoke():
    """1 abusive flow + N well-behaved flows: the abuser eats 429s,
    the well-behaved flows shed nothing, the (exempt) scheduler's p99
    holds, and exempt traffic measurably never queued."""
    cfg = scenario_config("noisy-neighbor", 40, smoke=True,
                          num_nodes=50, rate=30.0)
    rec = _run(cfg)
    assert rec["scenario_accounting"]["throttled"] > 0
    assert rec["creator_sheds"] == 0
    assert rec["flowcontrol"]["exempt_wait_sum_seconds"] <= 1e-3
    assert rec["flowcontrol"]["rejected_requests_total"] > 0


@pytest.mark.slow
def test_rack_failure_smoke():
    """A rack of hollow nodes vanishes mid-soak: the node-lifecycle
    controller completes the eviction wave under the declared SLO, the
    pow2 node bucket holds (zero recompiles), and arrivals keep
    binding to the survivors.

    Slow-marked (round 14 tier-1 budget reclaim): the 45s soak rides
    the slow lane with the full forms; tier-1 keeps the
    noisy-neighbor + burst smokes for the APF/soak interplay."""
    cfg = scenario_config("rack-failure", 45, smoke=True)
    rec = _run(cfg)
    acct = rec["scenario_accounting"]
    assert acct["nodes_failed"] == 30
    assert acct["eviction_wave_seconds"] is not None
    assert acct["stranded_pods_at_stop"] == 0
    assert rec["steady_state_compiles"] == 0


@pytest.mark.slow
def test_rolling_update_smoke():
    """A multi-step RC roll v1->v2 through the real ReplicationManager
    completes under its SLO with every v2 replica bound, while soak
    traffic keeps meeting the p99 gate.

    Slow-marked (round 14 tier-1 budget reclaim): the 60s soak was the
    heaviest tier-1 smoke; it rides the slow lane with the full
    forms."""
    cfg = scenario_config("rolling-update", 60, smoke=True)
    rec = _run(cfg)
    acct = rec["scenario_accounting"]
    assert acct["v2_bound_at_finish"] == acct["replicas"]
    assert acct["rolling_update_seconds"] is not None


def test_burst_smoke():
    """A 10x Poisson spike: the queues absorb it (zero sheds, zero
    drops) and p99 recovers to the SLO after the burst drains."""
    cfg = scenario_config("burst", 38, smoke=True)
    rec = _run(cfg)
    acct = rec["scenario_accounting"]
    assert acct["burst_window_binds"] > 0
    assert acct["p99_recovered_seconds"] is not None
    assert rec["creator_sheds"] == 0
    assert rec["watch_events_dropped"] == 0


# -- production-realism forms (excluded from tier-1 via -m 'not slow') --------


@pytest.mark.slow
def test_noisy_neighbor_full_with_ab_protection_proof():
    """The full unpaced flood, twice: APF on must hold the SLO while
    the abuser eats 429s, and the APF-off control arm must demonstrably
    breach — the gate proves APF causes the protection."""
    cfg = scenario_config("noisy-neighbor", 300, ab_compare=True)
    rec = _run(cfg)
    assert rec["gates"]["apf_protection_demonstrated"]


@pytest.mark.slow
def test_rack_failure_full():
    """500 of 2000 hollow nodes vanish (same pow2 bucket by design)."""
    _run(scenario_config("rack-failure", 600))


@pytest.mark.slow
def test_rolling_update_full():
    """A 1k-replica RC rolls v1->v2 in 100-replica steps."""
    _run(scenario_config("rolling-update", 900))


@pytest.mark.slow
def test_burst_full():
    """10x of 300/s for 10s: ~30k extra pods absorbed, p99 recovers."""
    _run(scenario_config("burst", 300))
