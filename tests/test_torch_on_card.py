"""The port on the card: the CUDA kernels (the probe kernel K1, the
zoned pick loop K3, the victim scorer K6) against their plain versions;
the service ops, a Policy document and the extender service's verbs
against the same calls on the CPU; the scheduler on CUDA against the same
call on the CPU and the port's oracle copy; a gang director cycle with
preemption on CUDA against the same cycle on the CPU; and the daemon's
scheduling core (cache, incremental encoder, resident tables,
core.Scheduler), with and without gangs, against the same flow on the
CPU; and the daemon on the wire (the port's apiserver, informers and
SchedulerServer through harness/perf.schedule_pods) against the same run
on the CPU. Each test skips where there is no CUDA device.

This module imports only torch and the port, so it also runs on a
machine without JAX:

    python -m pytest --noconftest tests/test_torch_on_card.py -q
"""

import pytest
import torch

import kubernetes_tpu_torch.api.types as T
from kubernetes_tpu_torch.harness import scenarios as S
from kubernetes_tpu_torch.oracle import ClusterState, GenericScheduler
from kubernetes_tpu_torch.ops import preempt_kernel as VK
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


def test_service_ops_on_card_match_cpu(cuda_device):
    """The four ops/services functions on the card against the same calls
    on the CPU (the CPU side is held to the JAX package in
    tests/test_torch_services.py)."""
    import numpy as np

    from kubernetes_tpu_torch.ops import services as SV

    rng = np.random.default_rng(7)
    G, L, N = 5, 2, 4096
    tables = {
        "first_peer": rng.integers(0, N, G), "lbl_val": rng.integers(-1, 3,
                                                                     (L, N)),
        "ord_node": np.concatenate([rng.permutation(N), [-1]]),
        "pod_fixed": np.array([-1, 1]),
        "peer_node_count": rng.integers(0, 4, (G, N)),
        "peer_total": rng.integers(0, 4, (G, N)).sum(1) + 3,
        "fit": rng.random(N) < 0.8, "node_ord": rng.permutation(N),
        "member": rng.integers(0, 2, G), "counts": rng.integers(0, 3, N),
    }

    def on(device):
        t = {k: torch.from_numpy(np.asarray(v)).to(device)
             for k, v in tables.items()}
        g = torch.tensor(2, device=device)
        out = [SV.service_affinity(t["first_peer"], t["lbl_val"],
                                   t["ord_node"], g, t["pod_fixed"],
                                   (0, 1), N),
               SV.service_anti_affinity(t["peer_node_count"],
                                        t["peer_total"], t["lbl_val"][0],
                                        g, t["fit"], 3, N)]
        state = (t["first_peer"].clone(), t["peer_node_count"].clone(),
                 t["peer_total"].clone())
        SV.service_commit(*state, t["node_ord"], t["member"],
                          torch.tensor(17, device=device),
                          torch.tensor(True, device=device))
        SV.service_commit_bulk(*state, t["node_ord"], t["member"],
                               t["counts"])
        return [x.cpu() for x in out + list(state)]

    for a, b in zip(on(cuda_device), on("cpu")):
        assert torch.equal(a, b)


def test_policy_on_card_matches_cpu_and_oracle(cuda_device):
    """A Policy document with ServiceAffinity and ServiceAntiAffinity,
    loaded through the port's load_policy -> create_from_config, on the
    card: K1 launched, decisions equal to the CPU run and to the oracle
    copy resolved from the same document."""
    import json

    from kubernetes_tpu_torch.scheduler.factory import create_from_config
    from kubernetes_tpu_torch.scheduler.plugins import PluginFactoryArgs
    from kubernetes_tpu_torch.scheduler.policy import (
        load_policy, resolve_policy,
    )

    svcs, pods = S.service_backlog(T, 3, 24)
    state = ClusterState.build(S.policy_nodes(T, 60), services=svcs)
    for doc in S.POLICY_DOCUMENTS.values():
        policy = load_policy(json.dumps(doc))
        algo = create_from_config(policy)
        assert algo._wave.device.type == "cuda"
        launches = PK.LAUNCHES
        got = algo.schedule_backlog(pods, state)
        assert PK.LAUNCHES > launches
        assert got == create_from_config(policy, device="cpu") \
            .schedule_backlog(pods, state)
        preds, prios = resolve_policy(policy, PluginFactoryArgs())
        assert got == GenericScheduler(
            predicates=list(preds.items()), priorities=prios
        ).schedule_backlog(pods, state.clone())


def test_extender_verbs_on_card_match_cpu(cuda_device):
    import json

    from kubernetes_tpu_torch.runtime import scheme
    from kubernetes_tpu_torch.scheduler.extender_server import (
        TorchExtenderServer,
    )

    card, cpu = TorchExtenderServer(), TorchExtenderServer(device="cpu")
    for verb, body in S.extender_bodies(T, scheme, 300, 200, 32).items():
        text = json.dumps(body)
        got = card.handle(verb, json.loads(text))
        assert got[0] == 200
        assert json.dumps(got, sort_keys=True) == json.dumps(
            cpu.handle(verb, json.loads(text)), sort_keys=True)


@pytest.mark.parametrize("case", S.VICTIM_CASES,
                         ids=[c[0] for c in S.VICTIM_CASES])
def test_victim_kernel_matches_plain_on_card(case, cuda_device):
    from kubernetes_tpu_torch.ops.preempt import victim_score_plain

    label, N, C, kind = case
    c = S.victim_case(N, C, 4, kind)
    args = [torch.as_tensor(c[k]).to(cuda_device)
            for k in ("prio", "ord", "res", "free", "req")]
    launches = VK.LAUNCHES
    got = VK.victim_score(*args, c["gang_prio"])
    assert VK.LAUNCHES == launches + 1
    want = victim_score_plain(*args, c["gang_prio"])
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), label


def test_gang_cycle_on_card_matches_cpu(cuda_device):
    """A director cycle with a parked high-priority gang: the same hosts,
    parks, statuses and victims on the card (K1 and K6 launched) as on
    the CPU; after the evictions the gang binds whole."""
    from kubernetes_tpu_torch.scheduler import gang as G

    def cycle(device):
        nodes, bound = S.bound_cluster(T, 24, per_node=6, cpu="500m")
        wave, groups = S.gang_wave(T, singles=20, gangs=8, members=4,
                                   big=6, big_cpu="2", short=2)
        state = ClusterState.build(nodes, assigned_pods=bound)
        statuses, evicted = [], []
        d = S.gang_director(G, groups, statuses, evicted, device=device)
        algo = TorchScheduleAlgorithm(device=device)
        out = S.director_wave(d, algo, wave, state)
        big = [p for p in wave
               if p.metadata.labels.get(T.POD_GROUP_LABEL) == "big"]
        again = S.director_wave(d, algo, big, S.evict(state, evicted))
        return out, again, statuses, [v.metadata.name for v in evicted]

    k1, k6 = PK.LAUNCHES, VK.LAUNCHES
    got = cycle(cuda_device)
    assert PK.LAUNCHES > k1 and VK.LAUNCHES == k6 + 1
    assert got == cycle("cpu")
    assert got[3] and None not in got[1]["hosts"]


def daemon_flow_on(device, nodes, backlog, bound=(), groups=None, **kw):
    """scenarios.daemon_flow with the port's modules, the algorithm
    warmed up on `device`. -> (the flow's outcome, the algorithm)."""
    from kubernetes_tpu_torch.scheduler import cache as C
    from kubernetes_tpu_torch.scheduler import core
    from kubernetes_tpu_torch.scheduler import gang as G

    algos = []

    def algorithm(cache):
        algos.append(TorchScheduleAlgorithm(device=device, cache=cache))
        algos[0].warmup(len(nodes))
        return algos[0]

    out = S.daemon_flow(C, core, G, algorithm, nodes, bound, backlog,
                        groups=groups, director_kw={"device": device}, **kw)
    return out, algos[0]


def test_daemon_core_on_card_matches_cpu(cuda_device):
    """The scheduling core (cache -> incremental encoder -> resident
    tables -> core.Scheduler) in waves of 256 on the card: the binds of
    the same flow on the CPU and of one schedule_backlog call, K1
    launched, every wave from the incremental view."""
    nodes = S.density_nodes(T, 64)
    pods = S.pause_pods(T, 900) + S.template_pods(T, 4, 30)
    k1 = PK.LAUNCHES
    got, algo = daemon_flow_on(cuda_device, nodes, pods, max_batch=256)
    assert PK.LAUNCHES > k1
    assert got == daemon_flow_on("cpu", nodes, pods, max_batch=256)[0]
    one = TorchScheduleAlgorithm(device="cpu").schedule_backlog(
        pods, ClusterState.build(nodes))
    assert [got["binds"][p.metadata.name] for p in pods] == one
    assert got["cycles"] == 4
    assert algo._wave._dev_source == algo._inc.source_token


def test_daemon_gang_flow_on_card_matches_cpu(cuda_device):
    """The gang director wired into the scheduling loop on the card: the
    big gang preempts (K6), is queued again and binds whole; binds,
    errors, statuses and victims equal the same flow on the CPU."""
    nodes, bound = S.bound_cluster(T, 24, per_node=6, cpu="500m")
    wave, groups = S.gang_wave(T, singles=20, gangs=8, members=4, big=6,
                               big_cpu="2", short=2)
    k6 = VK.LAUNCHES
    got, _ = daemon_flow_on(cuda_device, nodes, wave, bound, groups,
                            retries=2)
    assert VK.LAUNCHES > k6
    assert got == daemon_flow_on("cpu", nodes, wave, bound, groups,
                                 retries=2)[0]
    assert got["victims"]
    assert all(got["binds"].get(f"big-{i:06d}") for i in range(6))


def wire_run_on(device, n_nodes, n_pods):
    """harness/perf.schedule_pods through the port's apiserver on
    `device` -> (the hosts in the order the loop bound them, {node: pods}
    read back from the apiserver, K1 launches while the pods bound)."""
    import io

    from kubernetes_tpu_torch.harness import perf

    order, seen = [], {}

    def on_ready(sched, client):
        loop = sched.scheduler
        orig = loop._assume_and_bind_wave

        def recorded(pairs, cycle_start):
            order.extend(h for _, h in pairs)
            return orig(pairs, cycle_start)

        loop._assume_and_bind_wave = recorded
        seen["k1"] = PK.LAUNCHES

    def after(sched, client):
        seen["k1"] = PK.LAUNCHES - seen["k1"]
        hosts = [p.spec.node_name for p in client.pods().list()[0]]
        seen["per_node"] = {h: hosts.count(h) for h in set(hosts)}

    perf.schedule_pods(n_nodes, n_pods, device=device, out=io.StringIO(),
                       on_ready=on_ready, after=after)
    return order, seen["per_node"], seen["k1"]


def test_wire_daemon_on_card_matches_cpu(cuda_device):
    """scheduler_perf through the port's control plane, in process, at a
    small size: every pod bound, the hosts in the loop's order equal to
    the same run on the CPU and to one schedule_backlog call, K1
    launched."""
    order, per_node, k1 = wire_run_on("cuda", 100, 1000)
    assert k1 > 0
    assert len(order) == 1000 and set(per_node.values()) == {10}
    cpu_order, cpu_per_node, _ = wire_run_on("cpu", 100, 1000)
    assert order == cpu_order and per_node == cpu_per_node
    nodes = S.density_nodes(T, 100)
    one = TorchScheduleAlgorithm(device="cuda").schedule_backlog(
        S.pause_pods(T, 1000), ClusterState.build(nodes))
    # harness nodes are named node-00000.., the scenario's node-0000..
    assert [h.replace("node-", "node-0") for h in one] == order
