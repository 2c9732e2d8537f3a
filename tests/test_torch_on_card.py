"""The port on the card: the CUDA kernels (the probe kernel K1, the
zoned pick loop K3, the victim scorer K6) against their plain versions;
the service ops, a Policy document and the extender service's verbs
against the same calls on the CPU; the scheduler on CUDA against the same
call on the CPU and the port's oracle copy; a gang director cycle with
preemption on CUDA against the same cycle on the CPU; and the daemon's
scheduling core (cache, incremental encoder, resident tables,
core.Scheduler), with and without gangs, against the same flow on the
CPU; the daemon on the wire (the port's apiserver, informers and
SchedulerServer through harness/perf.schedule_pods) against the same run
on the CPU; K1's bf16 mode against its plain version; and the
kernel-path profiles (narrowed tables, the pipeline, the bf16 profile
with its shadow) on the card against the same calls on the CPU; the
joint-assignment kernel K7 (auction and beam) against its plain
version, and the optimizing profile on the pack configs against the
same calls on the CPU; the resident row scatter K8 against its plain
version, and the mesh drivers (four shards on the card) against the
single-device driver, a mesh on the CPU and the port's oracle copy; and
the contract audit's program registry run on the card (chip_smoke.py
phase 15 (a)); and the mesh churn soak on the card against the same soak
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
    by_shape = PK.LAUNCHES_BY_SHAPE.get((J, N, "i64"), 0)
    fr, tab = PK.resource_probe(J, alloc, usage, pod, TERMS,
                                wants_res=wants_res)
    assert PK.LAUNCHES == launches + 1
    assert PK.LAUNCHES_BY_SHAPE[(J, N, "i64")] == by_shape + 1
    fr_p, tab_p = PK.resource_probe_plain(J, alloc, usage, pod, TERMS,
                                          wants_res=wants_res)
    torch.cuda.synchronize()
    assert torch.equal(fr, fr_p) and torch.equal(tab, tab_p), label


@pytest.mark.parametrize("case", S.PROBE_CASES,
                         ids=[c[0] for c in S.PROBE_CASES])
def test_bf16_kernel_matches_plain_on_card(case, cuda_device):
    """K1's bf16 mode on every probe case and term list (the default
    profile, and two past bfloat16's exact integers): frontier and
    j-table equal to the plain version's bf16 computation, each launch
    counted under (J, N, "bf16")."""
    label, J, N, opts = case
    opts = dict(opts)
    wants_res = opts.pop("wants_res", True)
    alloc, usage, pod = S.probe_case(N, 3, **opts)

    def put(a):
        return torch.tensor(a, dtype=torch.int64, device=cuda_device)

    alloc, usage = tuple(map(put, alloc)), tuple(map(put, usage))
    pod = {k: put(v) for k, v in pod.items()}
    for name, terms in S.BF16_TERM_LISTS:
        by_shape = PK.LAUNCHES_BY_SHAPE.get((J, N, "bf16"), 0)
        fr, tab = PK.resource_probe(J, alloc, usage, pod, terms,
                                    wants_res=wants_res, bf16=True)
        assert PK.LAUNCHES_BY_SHAPE[(J, N, "bf16")] == by_shape + 1
        fr_p, tab_p = PK.resource_probe_plain(J, alloc, usage, pod, terms,
                                              wants_res=wants_res,
                                              bf16=True)
        torch.cuda.synchronize()
        assert torch.equal(fr, fr_p) and torch.equal(tab, tab_p), (label,
                                                                   name)


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


@pytest.mark.parametrize("kernel,J,N", [("probe", 0, 1024),
                                         ("probe", 8, 0), ("victim", 0, 0)])
def test_empty_shape_counts_no_launch_on_card(kernel, J, N, cuda_device):
    """Where a launcher launches nothing (K1 at J = 0 or N = 0, K6 at
    N = 0), the wrapper counts no launch; its outputs equal the plain
    version's."""
    from kubernetes_tpu_torch.ops.preempt import victim_score_plain

    if kernel == "probe":
        alloc, usage, pod = S.probe_case(1024, 2)

        def put(a):
            return torch.tensor(a, dtype=torch.int64, device=cuda_device)[:N]

        alloc, usage = tuple(map(put, alloc)), tuple(map(put, usage))
        pod = {k: torch.tensor(v, dtype=torch.int64, device=cuda_device)
               for k, v in pod.items()}
        launches = PK.LAUNCHES
        got = PK.resource_probe(J, alloc, usage, pod, TERMS)
        assert PK.LAUNCHES == launches
        want = PK.resource_probe_plain(J, alloc, usage, pod, TERMS)
    else:
        label, n, C, kind = S.VICTIM_CASES[0]
        c = S.victim_case(n, C, 4, kind)
        args = [torch.as_tensor(c[k]).to(cuda_device)
                for k in ("prio", "ord", "res", "free", "req")]
        args = [a[:N] for a in args[:4]] + args[4:]
        launches = VK.LAUNCHES
        got = VK.victim_score(*args, c["gang_prio"])
        assert VK.LAUNCHES == launches
        want = victim_score_plain(*args, c["gang_prio"])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


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


@pytest.mark.parametrize("N,C", S.VICTIM_TAILS,
                         ids=[f"N={n} C={c}" for n, c in S.VICTIM_TAILS])
def test_victim_kernel_row_tails_on_card(N, C, cuda_device):
    """Rows that end inside a warp of K6's segment path."""
    from kubernetes_tpu_torch.ops.preempt import victim_score_plain

    c = S.victim_case(N, C, 6, "fuzz")
    args = [torch.as_tensor(c[k]).to(cuda_device)
            for k in ("prio", "ord", "res", "free", "req")]
    got = VK.victim_score(*args, c["gang_prio"])
    want = victim_score_plain(*args, c["gang_prio"])
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), (N, C)


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


def test_kernel_path_profiles_on_card_match_cpu(cuda_device, monkeypatch):
    """The multi-template backlog (every run impure: the per-run probe)
    under the narrowed tables with the pipeline on, and under the bf16
    profile with its shadow checking every wave, on the card: names
    equal to the same call on the CPU (the serial oracle takes minutes
    on this backlog's inter-pod terms; tests/test_torch_pipeline.py holds
    the CPU run to it on smaller backlogs of the same scenario), the
    pipeline staged, narrowed tables on the device, K1 launched in both
    modes."""
    nodes, services, pods = S.multi_template_backlog(T, 40, 600,
                                                     templates=4, block=60)
    state = ClusterState.build(nodes, services=services)
    monkeypatch.setenv("KUBERNETES_TPU_QUANT", "int")
    monkeypatch.setenv("KUBERNETES_TPU_PIPELINE", "1")
    want = TorchScheduleAlgorithm(device="cpu").schedule_backlog(
        pods, state.clone())
    k1 = PK.LAUNCHES
    algo = TorchScheduleAlgorithm(device=cuda_device)
    got = algo.schedule_backlog(pods, state.clone())
    assert PK.LAUNCHES > k1
    assert algo._wave.dispatches.get("stage", 0) > 0
    assert algo._wave._dev["zone_id"][2].dtype == torch.int8
    assert got == want
    monkeypatch.setenv("KUBERNETES_TPU_QUANT", "bf16")
    monkeypatch.setenv("KUBERNETES_TPU_QUANT_SHADOW", "1")
    bf16 = sum(v for k, v in PK.LAUNCHES_BY_SHAPE.items() if k[2] == "bf16")
    algo = TorchScheduleAlgorithm(device=cuda_device)
    got = algo.schedule_backlog(pods, state.clone())
    assert sum(v for k, v in PK.LAUNCHES_BY_SHAPE.items()
               if k[2] == "bf16") > bf16
    assert algo._shadow_gate.checked == 1
    assert algo._shadow_gate.divergence == 0
    assert got == want


# -- the optimizing profile: the joint-assignment solve K7 --------------------


def assign_inputs(case, device):
    """A scenarios.ASSIGN_CASES entry's tables on `device`, with the
    solver's own arguments: -> (tables, prio, order, eps0, rounds)."""
    from kubernetes_tpu_torch.scheduler.optimizer.ops import assign as A

    label, P, N, kind, live, _solver = case
    c = S.assign_case(P, N, 5, kind, live)
    t = {k: torch.as_tensor(v).to(device) for k, v in c.items()}
    tabs = [t[k] for k in ("fit", "score", "req", "commit", "check", "cap")]
    return (tabs, t["prio"].to(torch.int32), t["order"].to(torch.int32),
            A.auction_eps0(c["score"], N), A.auction_rounds(P, N))


@pytest.mark.parametrize(
    "case", S.ASSIGN_CASES + S.ASSIGN_WIDE_CASES,
    ids=[c[0] for c in S.ASSIGN_CASES + S.ASSIGN_WIDE_CASES])
def test_assign_kernel_matches_plain_on_card(case, cuda_device):
    """K7 (the auction, K7a, and the beam, K7b) against its plain version
    on every ASSIGN_CASES and ASSIGN_WIDE_CASES entry: equal owners,
    dtype and values; each solve one launch, counted under (solver, P,
    N)."""
    from kubernetes_tpu_torch.scheduler.optimizer.ops import assign as A
    from kubernetes_tpu_torch.scheduler.optimizer.ops import (
        assign_kernel as AK,
    )

    label, P, N, _kind, _live, solver = case
    tabs, prio, order, eps0, rounds = assign_inputs(case, cuda_device)
    before = AK.LAUNCHES_BY_SHAPE.get((solver, P, N), 0)
    if solver == "auction":
        got = AK.auction_assign(*tabs, prio, order, eps0, rounds)
        want = A._auction_assign_fn(rounds, *tabs, prio, order, eps0)
    else:
        got = AK.beam_assign(*tabs)
        want = A._beam_assign_fn(4, 4, *tabs)
    torch.cuda.synchronize()
    assert AK.LAUNCHES_BY_SHAPE[(solver, P, N)] == before + 1
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want), label


def test_assign_auction_path_follows_the_ranks_on_card(cuda_device):
    """K7a takes the unique-key path where clip(P - order) is distinct
    (the pack solve) and the general claim path where it repeats
    ("ranks", clipped ranks), each equal to its plain version."""
    from kubernetes_tpu_torch.scheduler.optimizer.ops import assign as A
    from kubernetes_tpu_torch.scheduler.optimizer.ops import (
        assign_kernel as AK,
    )

    cases = {c[0]: c for c in S.ASSIGN_CASES}
    for label, general in (("pack P=2048 N=1024", False),
                           ("ranks P=96 N=24", True),
                           ("clip P=48 N=16", True)):
        tabs, prio, order, eps0, rounds = assign_inputs(cases[label],
                                                        cuda_device)
        got, bids, flag = AK._launch_auction(*tabs, prio, order, eps0,
                                             rounds, bids=True)
        want = A._auction_assign_fn(rounds, *tabs, prio, order, eps0)
        torch.cuda.synchronize()
        assert bool(int(flag[0])) == general, label
        assert 1 <= AK.rounds_run(bids) <= rounds
        assert torch.equal(got, want), label


def test_assign_auction_keeps_node_state_in_device_memory_past_the_smem_tiles(
        cuda_device):
    """K7a keeps a tile of at most 2,048 nodes a block in shared memory
    while the tiles fit the co-resident blocks (one an SM); one node more
    and each block's tile lies in device memory (no dynamic shared
    memory), and the solve still equals its plain version."""
    from kubernetes_tpu_torch.scheduler.optimizer.ops import assign as A
    from kubernetes_tpu_torch.scheduler.optimizer.ops import (
        assign_kernel as AK,
    )

    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    edge = sms * 2048
    assert AK.auction_smem_bytes(edge) == 2048 * 104
    assert AK.auction_smem_bytes(edge + 1) == 0
    assert 1 <= AK.auction_grid(64, edge + 1) <= sms
    case = ("edge", 24, edge + 1, "fuzz", None, "auction")
    tabs, prio, order, eps0, rounds = assign_inputs(case, cuda_device)
    got = AK.auction_assign(*tabs, prio, order, eps0, rounds)
    want = A._auction_assign_fn(rounds, *tabs, prio, order, eps0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_assign_beam_launches_on_two_streams_at_once(cuda_device):
    """Two K7b launches in flight on two streams each take their own
    phase-A ticket (in their launch's scratch): both equal the plain
    version."""
    from kubernetes_tpu_torch.scheduler.optimizer.ops import assign as A
    from kubernetes_tpu_torch.scheduler.optimizer.ops import (
        assign_kernel as AK,
    )

    cases = [("a", 32, 1024, "fuzz", None, "beam"),
             ("b", 64, 128, "ties", None, "beam")]
    inputs = [assign_inputs(c, cuda_device)[0] for c in cases]
    want = [A._beam_assign_fn(4, 4, *tabs) for tabs in inputs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda_device) for _ in cases]
    for _ in range(20):
        got = []
        for st, tabs in zip(streams, inputs):
            with torch.cuda.stream(st):
                got.append(AK.beam_assign(*tabs))
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_assign_beam_refuses_more_slots_than_it_takes(cuda_device):
    """K7b takes at most beam_max_slots() (64) slots; the wrapper raises
    above it and launches nothing."""
    from kubernetes_tpu_torch.scheduler.optimizer.ops import (
        assign_kernel as AK,
    )

    assert AK.beam_max_slots() == 64
    P = AK.beam_max_slots() + 1
    c = S.assign_case(P, 16, 0, "fuzz")
    t = {k: torch.as_tensor(v).to(cuda_device) for k, v in c.items()}
    tabs = [t[k] for k in ("fit", "score", "req", "commit", "check", "cap")]
    before = AK.LAUNCHES
    with pytest.raises(ValueError):
        AK.beam_assign(*tabs)
    assert AK.LAUNCHES == before


@pytest.mark.parametrize("key", sorted(S.PACK_CONFIGS))
def test_optimizing_profile_on_card_matches_cpu(key, cuda_device):
    """A pack config (smoke size) in the greedy and the optimizing
    profile on the card: names equal to the same call on the CPU, the
    optimizing arm strictly above greedy in pods scheduled and in
    utilization, at most 6 dispatches each; the optimizing arm launches
    K1 and K7."""
    from kubernetes_tpu_torch.models import batch as B
    from kubernetes_tpu_torch.scheduler.optimizer.ops import (
        assign_kernel as AK,
    )

    cfg = S.PACK_CONFIGS[key](T, smoke=True)
    arms = {}
    for prof in ("greedy", "optimizing"):
        def run(device):
            algo = TorchScheduleAlgorithm(
                device=device, profile=prof,
                config=S.pack_scheduler_config(B, cfg))
            return algo, algo.schedule_backlog(
                cfg["pods"], S.pack_state(ClusterState, cfg))

        k1, k7 = PK.LAUNCHES, AK.LAUNCHES
        algo, got = run(cuda_device)
        if prof == "optimizing":
            assert PK.LAUNCHES > k1 and AK.LAUNCHES > k7
        _cpu, want = run("cpu")
        assert got == want
        d = (algo._opt or algo._wave).dispatches
        assert sum(v for k, v in d.items() if k != "scan_pods") <= 6
        arms[prof] = S.pack_outcome(cfg["pods"], got, cfg["alloc_mcpu"])
    assert arms["optimizing"]["scheduled"] > arms["greedy"]["scheduled"]
    assert arms["optimizing"]["utilization"] > arms["greedy"]["utilization"]


@pytest.mark.parametrize("case", S.SCATTER_CASES,
                         ids=[c[0] for c in S.SCATTER_CASES])
def test_scatter_kernel_matches_plain_on_card(case, cuda_device):
    """K8 on every dtype pair, the node axis first and second, off-shard
    and padded rows: one launch a shard, then one device-wide launch of
    every shard (and one of the even shards, which leaves the odd ones as
    they were); each shard's tables equal to its plain version's and to
    the expected update."""
    import numpy as np

    from kubernetes_tpu_torch.parallel import resident_kernel as RK

    label, shards, n, M, k, fields = case
    c = S.scatter_case(shards, n, M, k, seed=11, fields=fields)
    names = [f[0] for f in c["fields"]]
    axes = [f[1] for f in c["fields"]]
    narrowed = frozenset(f[0] for f in c["fields"] if f[2])
    buf = torch.from_numpy(c["buf"]).to(cuda_device)

    def fresh():
        return [{nm: torch.from_numpy(v).to(cuda_device)
                 for nm, v in S.scatter_shard_tables(c, s).items()}
                for s in range(shards)]

    def check(tabs, done):
        torch.cuda.synchronize()
        for s in range(shards):
            for nm, ax in zip(names, axes):
                got = tabs[s][nm].cpu().numpy()
                src = c["expected"] if s in done else c["old"]
                window = [slice(None)] * src[nm].ndim
                window[ax] = slice(s * n, (s + 1) * n)
                nan = got.dtype.kind == "f"
                assert np.array_equal(got, src[nm][tuple(window)],
                                      equal_nan=nan), (label, nm, s)

    tabs, plain = fresh(), fresh()
    for s in range(shards):
        launches = RK.LAUNCHES
        RK.scatter_rows(c["layout"], buf, names, axes,
                        [tabs[s][nm] for nm in names], n, s * n, narrowed)
        assert RK.LAUNCHES == launches + 1
        RK.scatter_rows_plain(c["layout"], buf, names, axes,
                              [plain[s][nm] for nm in names], n, s * n,
                              narrowed)
    check(tabs, range(shards))
    check(plain, range(shards))
    for part in (range(0, shards, 2), range(shards)):
        tabs = fresh()
        ids = list(part)
        launches = RK.LAUNCHES
        RK.scatter_shipment(c["layout"], buf, names, axes,
                            [[tabs[s][nm] for nm in names] for s in ids],
                            ids, n, narrowed)
        assert RK.LAUNCHES == launches + 1
        check(tabs, ids)


def test_scatter_shipment_checks_its_table_on_card(cuda_device):
    """A device-wide launch through a destination table: it raises on a
    tensor placed anew (the table points at the old one) and on a shard
    outside the table's mesh, and launches once with the right one."""
    import numpy as np

    from kubernetes_tpu_torch.parallel import resident_kernel as RK

    c = S.scatter_case(4, 256, 64, 30, seed=3, fields="update")
    names = [f[0] for f in c["fields"]]
    axes = [f[1] for f in c["fields"]]
    buf = torch.from_numpy(c["buf"]).to(cuda_device)
    tabs = [{nm: torch.from_numpy(v).to(cuda_device)
             for nm, v in S.scatter_shard_tables(c, s).items()}
            for s in range(4)]
    table = RK.DestTable(cuda_device, 4, {
        nm: {s: tabs[s][nm] for s in range(4)} for nm in names})
    dests = [[tb[nm] for nm in names] for tb in tabs]
    moved = [list(d) for d in dests]
    moved[2][0] = moved[2][0].clone()
    with pytest.raises(ValueError, match="not the tensor"):
        RK.scatter_shipment(c["layout"], buf, names, axes, moved, range(4),
                            256, table=table)
    with pytest.raises(ValueError, match="outside a mesh of 4"):
        RK.scatter_shipment(c["layout"], buf, names, axes, dests + dests[:1],
                            range(5), 256, table=table)
    launches = RK.LAUNCHES
    RK.scatter_shipment(c["layout"], buf, names, axes, dests, range(4), 256,
                        table=table)
    torch.cuda.synchronize()
    assert RK.LAUNCHES == launches + 1
    for nm, ax in zip(names, axes):
        got = np.concatenate([tb[nm].cpu().numpy() for tb in tabs], axis=ax)
        assert np.array_equal(got, c["expected"][nm],
                              equal_nan=got.dtype.kind == "f"), nm


def test_mesh_on_card_matches_single_device_and_cpu(cuda_device):
    """The mixed scenario through TorchScheduleAlgorithm(mesh=...) at
    four shards on the card: names equal to the single-device driver on
    the card, the same mesh on the CPU and the oracle; K1 launched at the
    shard width; the dispatch tally equal to the CPU mesh's."""
    from kubernetes_tpu_torch.parallel.shard import DeviceMesh

    nodes, services = S.mixed_cluster(T, 250)
    pods = S.mixed_backlog(T)
    state = ClusterState.build(nodes, services=services)
    shapes = dict(PK.LAUNCHES_BY_SHAPE)
    card = TorchScheduleAlgorithm(
        mesh=DeviceMesh([cuda_device] * 4), device=cuda_device)
    got = card.schedule_backlog(pods, state)
    widths = {N for (_J, N, _m), v in PK.LAUNCHES_BY_SHAPE.items()
              if v > shapes.get((_J, N, _m), 0)}
    assert widths == {256 // 4}
    cpu = TorchScheduleAlgorithm(mesh=DeviceMesh(["cpu"] * 4),
                                 device="cpu")
    assert got == cpu.schedule_backlog(pods, state)
    assert card._mesh_sched.dispatches == cpu._mesh_sched.dispatches
    assert got == TorchScheduleAlgorithm(
        device=cuda_device).schedule_backlog(pods, state)
    assert got == GenericScheduler().schedule_backlog(pods, state.clone())


def test_mesh_resident_churn_on_card(cuda_device):
    """Resident waves at four shards on the card: a steady wave ships no
    table bytes; a label and allocatable change on a few nodes and a
    node removal scatter through K8 (one launch: the four shards share
    the card), and the names equal a reship run's and the single-device
    driver's."""
    from kubernetes_tpu_torch.parallel import resident_kernel as RK
    from kubernetes_tpu_torch.parallel.shard import DeviceMesh

    nodes = S.density_nodes(T, 200)
    mesh = DeviceMesh([cuda_device] * 4)
    algo = TorchScheduleAlgorithm(mesh=mesh, device=cuda_device)
    reship = TorchScheduleAlgorithm(mesh=mesh, device=cuda_device)
    reship._mesh_sched.reuse_default = "reship"
    single = TorchScheduleAlgorithm(device=cuda_device)
    state = ClusterState.build(nodes)
    bound = []
    for w in range(3):
        pods = S.pause_pods(T, 300, name0=1000 * w)
        got = algo.schedule_backlog(pods, state)
        assert got == reship.schedule_backlog(pods, state)
        assert got == single.schedule_backlog(pods, state)
        bound += S.bind_hosts(state, pods, got)
    assert algo._mesh_sched.resident.stats["wave_table_bytes"] == 0
    changed = S.density_nodes(T, 199)
    for i in (3, 77, 150):
        changed[i].metadata.labels = {"disktype": "ssd"}
        changed[i].status.allocatable = dict(
            changed[i].status.allocatable, cpu="8")
    state = ClusterState.build(
        changed, assigned_pods=[q for q in bound
                                if q.spec.node_name != "node-0199"])
    launches = RK.LAUNCHES
    pods = S.pause_pods(T, 300, name0=5000)
    got = algo.schedule_backlog(pods, state)
    assert RK.LAUNCHES - launches == 1
    assert algo._mesh_sched.resident.stats["scatters"] == 1
    assert got == reship.schedule_backlog(pods, state)
    assert got == single.schedule_backlog(pods, state)


def test_mesh_scan_on_card_matches_single_device(cuda_device):
    """MeshBatchScheduler at four shards on the card gives the names of
    the single-device scan on a small mixed scenario."""
    from kubernetes_tpu_torch.models.batch import BatchScheduler
    from kubernetes_tpu_torch.parallel.mesh import MeshBatchScheduler
    from kubernetes_tpu_torch.parallel.shard import DeviceMesh
    from kubernetes_tpu_torch.snapshot.encode import SnapshotEncoder

    nodes, services = S.mixed_cluster(T, 60)
    pods = S.mixed_backlog(T)[:48]
    state = ClusterState.build(nodes, services=services)
    enc = SnapshotEncoder(state, pods)
    snap, batch = enc.encode_nodes(), enc.encode_pods()
    got = MeshBatchScheduler(DeviceMesh([cuda_device] * 4)).schedule_names(
        snap, batch)
    assert got == BatchScheduler(device=cuda_device).schedule_names(
        snap, batch)


def test_contract_audit_on_card(cuda_device):
    """chip_smoke.py phase 15 (a) alone: every registered program run on
    the card with its dispatch under the sync debug mode "error", its
    device-to-host copies equal to the declaration and to the fake
    trace's, its kernels launched as often as the fake trace reached
    them."""
    import chip_smoke

    rows = chip_smoke.phase_contract_audit(
        chip_smoke.fake_audit_result(chip_smoke.start_fake_audit()))
    assert len(rows) == 22
    assert all(r["d2h"] == r["declared_d2h"] and not r["syncs"]
               for r in rows)


def test_mesh_soak_on_card_matches_cpu(cuda_device):
    """harness/mesh_soak at 4 shards on the card for 6 churn waves binds
    every wave's pods where the same soak on the CPU binds them, with
    K1 launched on every shard of every wave, no build or load after the
    warm-up and no table bytes on a quiet wave."""
    from kubernetes_tpu_torch.harness import mesh_soak

    def run(device):
        waves = []
        rec = mesh_soak.run_mesh_soak(
            shards=4, device=device, waves=6,
            on_wave=lambda pods, hosts, ev: waves.append(list(hosts)))
        return rec, waves

    PK.LAUNCHES = 0
    rec, card = run("cuda")
    launches = PK.LAUNCHES
    cpu_rec, cpu = run("cpu")
    assert card == cpu
    assert launches == 4 * 8
    assert rec["steady_state_compiles"] == 0
    assert rec["quiet_wave_table_bytes_max"] == 0
    assert rec["resident_stats"] == cpu_rec["resident_stats"]
