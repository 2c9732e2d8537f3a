"""TorchScheduleAlgorithm against TPUScheduleAlgorithm and the oracle, on
the CPU: the same node name for every pod, across successive waves."""

import pytest
import torch

import kubernetes_tpu.api.types as JT
from kubernetes_tpu.oracle import ClusterState as JaxState
from kubernetes_tpu.scheduler.tpu_algorithm import TPUScheduleAlgorithm

import kubernetes_tpu_torch.api.types as TT
from kubernetes_tpu_torch.harness import scenarios as S
from kubernetes_tpu_torch.oracle import ClusterState as PortState
from kubernetes_tpu_torch.oracle import GenericScheduler
from kubernetes_tpu_torch.oracle.scheduler import FitError
from kubernetes_tpu_torch.scheduler.algorithm import TorchScheduleAlgorithm


def mixed(T, CS, n_nodes=64, seed=0):
    nodes, services = S.mixed_cluster(T, n_nodes, seed=seed)
    return CS.build(nodes, services=services), S.mixed_backlog(T, seed=seed)


@pytest.mark.parametrize("seed", range(2))
def test_mixed_backlog_matches_jax_and_oracle(seed):
    pstate, ppods = mixed(TT, PortState, seed=seed)
    jstate, jpods = mixed(JT, JaxState, seed=seed)
    want = GenericScheduler().schedule_backlog(ppods, pstate.clone())
    got = TorchScheduleAlgorithm(device="cpu").schedule_backlog(ppods, pstate)
    assert got == want
    assert TPUScheduleAlgorithm().schedule_backlog(jpods, jstate) == want


def test_successive_waves_thread_the_round_robin_counter():
    """Two waves against the state the first one produced: the second
    wave's ties break on the counter the first left behind, as the
    oracle's single serial pass does."""
    nodes = S.density_nodes(TT, 7)
    first, second = S.pause_pods(TT, 40), S.pause_pods(TT, 30, name0=40)
    state = PortState.build(nodes)
    want = GenericScheduler().schedule_backlog(first + second, state.clone())
    algo = TorchScheduleAlgorithm(device="cpu")
    got = algo.schedule_backlog(first, state)
    for pod, host in zip(first, got):
        pod.spec.node_name = host
        state.assign(pod)
    got += algo.schedule_backlog(second, state)
    assert got == want


def test_schedule_one_pod_and_fit_error():
    state = PortState.build(S.density_nodes(TT, 3, cpu="1"))
    algo = TorchScheduleAlgorithm(device="cpu")
    [pod] = S.pause_pods(TT, 1)
    assert algo.schedule(pod, state) in {"node-0000", "node-0001",
                                         "node-0002"}
    [big] = S.pause_pods(TT, 1, requests={"cpu": "2"})
    with pytest.raises(FitError):
        algo.schedule(big, state)
    assert algo.schedule_backlog([], state) == []
    assert algo.schedule_backlog([pod], PortState.build([])) == [None]


def test_no_silent_cpu():
    """The default device is CUDA: without a card the constructor raises
    instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        assert TorchScheduleAlgorithm().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            TorchScheduleAlgorithm()
