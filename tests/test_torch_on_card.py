"""The port on the card: the CUDA kernels (the probe kernel K1, the
zoned pick loop K3) against their plain versions, and the scheduler on
CUDA against the same call on the CPU and the port's oracle copy. Each test skips where there is no CUDA device.

This module imports only torch and the port, so it also runs on a
machine without JAX:

    python -m pytest --noconftest tests/test_torch_on_card.py -q
"""

import pytest
import torch

import kubernetes_tpu_torch.api.types as T
from kubernetes_tpu_torch.harness import scenarios as S
from kubernetes_tpu_torch.oracle import ClusterState, GenericScheduler
from kubernetes_tpu_torch.ops import probe_kernel as PK
from kubernetes_tpu_torch.ops import zreplay_kernel as ZK
from kubernetes_tpu_torch.scheduler.algorithm import TorchScheduleAlgorithm

TERMS = (("lr", 1), ("ba", 1))


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the probe kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("case", S.PROBE_CASES,
                         ids=[c[0] for c in S.PROBE_CASES])
def test_kernel_matches_plain_on_card(case, cuda_device):
    label, J, N, opts = case
    opts = dict(opts)
    wants_res = opts.pop("wants_res", True)
    alloc, usage, pod = S.probe_case(N, 2, **opts)

    def put(a):
        return torch.tensor(a, dtype=torch.int64, device=cuda_device)

    alloc, usage = tuple(map(put, alloc)), tuple(map(put, usage))
    pod = {k: put(v) for k, v in pod.items()}
    launches = PK.LAUNCHES
    by_shape = PK.LAUNCHES_BY_SHAPE.get((J, N), 0)
    fr, tab = PK.resource_probe(J, alloc, usage, pod, TERMS,
                                wants_res=wants_res)
    assert PK.LAUNCHES == launches + 1
    assert PK.LAUNCHES_BY_SHAPE[(J, N)] == by_shape + 1
    fr_p, tab_p = PK.resource_probe_plain(J, alloc, usage, pod, TERMS,
                                          wants_res=wants_res)
    torch.cuda.synchronize()
    assert torch.equal(fr, fr_p) and torch.equal(tab, tab_p), label


def test_launch_grid_covers_the_plane(cuda_device):
    """Node tiles cover N and j chunks cover J, each with less than one
    tile or chunk to spare; a chunk is whole steps of the j lanes; the
    main path's shapes give every SM a block at least."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for _, J, N, _ in S.PROBE_CASES:
        g = PK.launch_grid(J, N)
        (gx, gy), (bx, by), chunk = g["grid"], g["block"], g["j_chunk"]
        assert (gx - 1) * bx < N <= gx * bx, g
        assert (gy - 1) * chunk < J <= gy * chunk, g
        assert chunk % by == 0, g
        if (J, N) in ((128, 8192), (1024, 1024)):
            assert gx * gy >= sms, g


def test_scheduler_on_card_matches_cpu_and_oracle(cuda_device):
    nodes, services = S.mixed_cluster(T, 96)
    pods = S.mixed_backlog(T)
    state = ClusterState.build(nodes, services=services)
    launches = PK.LAUNCHES
    got = TorchScheduleAlgorithm(device=cuda_device).schedule_backlog(
        pods, state)
    assert PK.LAUNCHES > launches
    assert got == TorchScheduleAlgorithm(device="cpu").schedule_backlog(
        pods, state)
    assert got == GenericScheduler().schedule_backlog(pods, state.clone())


def zreplay_inputs(case, device):
    """scenarios.zreplay_case on the device: -> (nodes, scalars, kw)."""
    nodes = {k: torch.from_numpy(v).to(device)
             for k, v in case["nodes"].items()}
    veto = torch.from_numpy(case["veto"]).to(device)
    nodes["frontier"] = torch.where(veto, nodes["frontier"].clamp(max=1),
                                    nodes["frontier"])
    sc = case["scalars"]
    scalars = torch.tensor([sc["nz_mcpu"], sc["nz_mem"], sc["selfmatch"],
                            sc["L0"], 1], device=device)
    kw = {k: case[k] for k in ("K", "k_real", "rows_dyn", "num_zones",
                               "has_selectors")}
    return nodes, scalars, kw


@pytest.mark.parametrize("case", S.ZREPLAY_CASES,
                         ids=[c[0] for c in S.ZREPLAY_CASES])
def test_zreplay_kernel_matches_plain_on_card(case, cuda_device):
    label, N, K, opts = case
    c = S.zreplay_case(N, 5, K=K, **opts)
    nodes, scalars, kw = zreplay_inputs(c, cuda_device)
    launches = ZK.LAUNCHES
    got = ZK.replay_picks(nodes, scalars, c["weights"], **kw)
    assert ZK.LAUNCHES == launches + 1
    want = ZK.replay_picks_plain(nodes, scalars, c["weights"], **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b), label


def test_zoned_scheduler_on_card_matches_cpu_and_oracle(cuda_device):
    # a selector run alone (the next run has no selector: host path), then
    # a group of selector templates
    nodes = S.zoned_density_nodes(T, 40, unzoned_every=5, pods_cap="20")
    state = ClusterState.build(nodes, services=[
        S.service(T, "svc", {"name": "sched-perf"})])
    pods = (S.pause_pods(T, 300)
            + S.template_pods(T, 2, 20, labels={"app": "x"}, name0="x")
            + S.template_pods(T, 6, 30))
    launches = ZK.LAUNCHES
    algo = TorchScheduleAlgorithm(device=cuda_device, min_run=1)
    got = algo.schedule_backlog(pods, state)
    assert ZK.LAUNCHES > launches
    assert algo._wave.dispatches.get("zreplay", 0) >= 1
    assert algo._wave.dispatches.get("zreplay_group", 0) >= 1
    assert got == TorchScheduleAlgorithm(device="cpu", min_run=1) \
        .schedule_backlog(pods, state)
    assert got == GenericScheduler().schedule_backlog(pods, state.clone())
