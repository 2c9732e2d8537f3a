"""The port's serial scan (models/batch.BatchScheduler) against the JAX
package's and the oracle, on the CPU: the chosen node of every pod and
the whole final carry, exactly."""

import numpy as np
import pytest

from kubernetes_tpu.models import batch as JB
from kubernetes_tpu.oracle import GenericScheduler

from kubernetes_tpu_torch.models import batch as TB

from tests.test_torch_ops import assert_same, encode, scenario


def _oracle_ids(state, pending, snap):
    names = GenericScheduler().schedule_backlog(pending, state.clone())
    ids = {n: i for i, n in enumerate(snap.node_names)}
    return np.array([ids[n] if n is not None else -1 for n in names])


@pytest.mark.parametrize("seed,interpod_p,volumes_p", [
    (0, 0.0, 0.0), (1, 0.4, 0.0), (2, 0.0, 0.4), (3, 0.4, 0.4)])
def test_scan_matches_jax_and_oracle(seed, interpod_p, volumes_p):
    state, pending = scenario(300 + seed, interpod_p=interpod_p,
                              volumes_p=volumes_p, n_pending=30)
    snap, batch, psnap, pbatch = encode(state, pending)
    chosen_j, carry_j = JB.BatchScheduler().schedule(snap, batch,
                                                     last_node_index=3)
    chosen, carry = TB.BatchScheduler(device="cpu").schedule(
        psnap, pbatch, last_node_index=3)
    assert_same(chosen_j, chosen, "chosen")
    assert list(carry) == list(TB.CARRY_FIELDS)
    for key, jv in zip(TB.CARRY_FIELDS, carry_j):
        assert_same(jv, carry[key], key)
    if seed == 0:
        # the oracle's round-robin counter starts at 0
        chosen0, _ = TB.BatchScheduler(device="cpu").schedule(psnap, pbatch)
        assert np.array_equal(chosen0, _oracle_ids(state, pending, snap))


def test_scan_empty_cluster():
    state, pending = scenario(9, interpod_p=0.0, volumes_p=0.0, n_nodes=0,
                              n_existing=0)
    _snap, _batch, psnap, pbatch = encode(state, pending)
    chosen, carry = TB.BatchScheduler(device="cpu").schedule(psnap, pbatch)
    assert (chosen == -1).all() and int(carry["last_idx"]) == 0


def test_service_policies_are_not_ported():
    """Kept under its first name, from when the port raised on these
    entries: a config naming ServiceAffinity and ServiceAntiAffinity now
    schedules, equal to the JAX package's scan (tests/
    test_torch_services.py holds the whole service path to it)."""
    entries = dict(
        predicates=(TB.GENERAL_PREDICATES, (TB.SERVICE_AFFINITY, ("zone",))),
        priorities=((TB.LEAST_REQUESTED, 1),
                    ((TB.SERVICE_ANTI_AFFINITY, "zone"), 2)))
    state, pending = scenario(11, interpod_p=0.0, volumes_p=0.0)
    cfg = JB.SchedulerConfig(**entries)
    snap, batch, psnap, pbatch = encode(state, pending, config=cfg)
    chosen_j, _ = JB.BatchScheduler(cfg).schedule(snap, batch)
    chosen, _ = TB.BatchScheduler(TB.SchedulerConfig(**entries),
                                  device="cpu").schedule(psnap, pbatch)
    assert_same(chosen_j, chosen, "chosen")
