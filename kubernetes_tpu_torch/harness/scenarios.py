"""Cluster and backlog builders shared by the tests and chip_smoke.py.

Every builder takes the `types` module of the package whose objects it
should build (kubernetes_tpu_torch.api.types, or the JAX package's
kubernetes_tpu.api.types in the parity tests), so one description makes
the same scenario in both packages. The shapes follow the
scheduler_perf density test (nodes: 4 CPU / 32Gi / 110 pods; pods:
100m / 500Mi pause containers) and the JAX package's wave tests.
"""

from __future__ import annotations

import json
import random

ZONE = "failure-domain.beta.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"
AFFINITY_ANNOTATION = "scheduler.alpha.kubernetes.io/affinity"


def density_nodes(T, n, pods_cap="110", cpu="4", mem="32Gi", taint_every=0):
    """n Ready nodes named node-0000.. (PreferNoSchedule taint on every
    taint_every-th node when set)."""
    nodes = []
    for i in range(n):
        spec = T.NodeSpec()
        if taint_every and i % taint_every == 0:
            spec = T.NodeSpec(taints=[T.Taint(
                key="dedicated", value="a", effect="PreferNoSchedule")])
        nodes.append(T.Node(
            metadata=T.ObjectMeta(name=f"node-{i:04d}"),
            spec=spec,
            status=T.NodeStatus(
                allocatable={"cpu": cpu, "memory": mem, "pods": pods_cap},
                conditions=[T.NodeCondition("Ready", "True")],
            ),
        ))
    return nodes


def zoned_density_nodes(T, n, zones=("a", "b", "c"), unzoned_every=0,
                        pods_cap="110"):
    """density_nodes with round-robin zone labels (every
    unzoned_every-th node left without one)."""
    nodes = density_nodes(T, n, pods_cap=pods_cap)
    for i, node in enumerate(nodes):
        if unzoned_every and i % unzoned_every == 0:
            continue
        node.metadata.labels[ZONE] = zones[i % len(zones)]
    return nodes


def hostname_nodes(T, n, **kw):
    """density_nodes carrying the hostname label (a topology domain per
    node)."""
    nodes = density_nodes(T, n, **kw)
    for node in nodes:
        node.metadata.labels[HOSTNAME] = node.metadata.name
    return nodes


def pause_pods(T, k, labels=None, requests=None, name0=0, prefix="pod"):
    """k identical pause pods (one RC template)."""
    labels = labels or {"name": "sched-perf"}
    requests = requests or {"cpu": "100m", "memory": "500Mi"}
    return [
        T.Pod(
            metadata=T.ObjectMeta(name=f"{prefix}-{name0 + i:06d}",
                                  labels=dict(labels)),
            spec=T.PodSpec(containers=[T.Container(requests=dict(requests))]),
        )
        for i in range(k)
    ]


def template_pods(T, num_templates, per, labels=None, cpu0=50, mem_step=50,
                  name0="", host_port=None):
    """num_templates RC templates of `per` identical pods each, template
    t requesting cpu0 + 5t millicores and 100 + (t % 7)*mem_step MiB
    (distinct templates, so distinct runs), each pod holding host_port
    when set (tests/test_wave.py template_pods)."""
    pods = []
    for t in range(num_templates):
        ports = ([T.ContainerPort(host_port=host_port)]
                 if host_port is not None else [])
        for i in range(per):
            pods.append(T.Pod(
                metadata=T.ObjectMeta(
                    name=f"{name0}tpl{t:03d}-{i:03d}",
                    labels=dict(labels or {"name": "sched-perf"})),
                spec=T.PodSpec(containers=[T.Container(
                    requests={"cpu": f"{cpu0 + t * 5}m",
                              "memory": f"{100 + (t % 7) * mem_step}Mi"},
                    ports=list(ports))]),
            ))
    return pods


def port_pods(T, k, host_port=8080, name0=0):
    """k identical pods holding one host port (one copy per node)."""
    return [
        T.Pod(
            metadata=T.ObjectMeta(name=f"port-{name0 + i:05d}",
                                  labels={"app": "p"}),
            spec=T.PodSpec(containers=[T.Container(
                requests={"cpu": "100m"},
                ports=[T.ContainerPort(host_port=host_port)])]),
        )
        for i in range(k)
    ]


def anti_pods(T, k, labels, topo=HOSTNAME, name0=0, requests=None,
              sel_labels=None):
    """k identical pods with hard pod anti-affinity (alpha annotation)
    against `sel_labels` (their own labels by default) over `topo`."""
    out = []
    for i in range(k):
        p = T.Pod(
            metadata=T.ObjectMeta(name=f"anti-{name0 + i:05d}",
                                  labels=dict(labels)),
            spec=T.PodSpec(containers=[T.Container(
                requests=dict(requests or {"cpu": "100m"}))]),
        )
        p.metadata.annotations = {AFFINITY_ANNOTATION: json.dumps({
            "podAntiAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [{
                    "labelSelector": {
                        "matchLabels": sel_labels or dict(labels)},
                    "topologyKey": topo,
                    "namespaces": [],
                }],
            },
        })}
        out.append(p)
    return out


def service(T, name, selector):
    return T.Service(metadata=T.ObjectMeta(name=name),
                     spec=T.ServiceSpec(selector=dict(selector)))


def mixed_cluster(T, n_nodes, seed=0):
    """-> (nodes, services): a heterogeneous cluster. Nodes mix sizes,
    four zones (a tenth unzoned), a disktype label on half, a
    PreferNoSchedule taint on every 10th, a NoSchedule gpu taint on
    every 25th, and memory pressure on every 17th."""
    rng = random.Random(seed)
    nodes = []
    for i in range(n_nodes):
        name = f"node-{i:05d}"
        labels = {HOSTNAME: name}
        if i % 10:
            labels[ZONE] = "abcd"[rng.randrange(4)]
        if rng.random() < 0.5:
            labels["disktype"] = rng.choice(["ssd", "hdd"])
        taints = []
        if i % 10 == 3:
            taints.append(T.Taint(key="dedicated", value="infra",
                                  effect="PreferNoSchedule"))
        if i % 25 == 7:
            taints.append(T.Taint(key="gpu", value="true",
                                  effect="NoSchedule"))
        conds = [T.NodeCondition("Ready", "True")]
        if i % 17 == 5:
            conds.append(T.NodeCondition("MemoryPressure", "True"))
        nodes.append(T.Node(
            metadata=T.ObjectMeta(name=name, labels=labels),
            spec=T.NodeSpec(taints=taints or None),
            status=T.NodeStatus(
                allocatable={
                    "cpu": rng.choice(["2", "4", "8"]),
                    "memory": rng.choice(["8Gi", "16Gi", "32Gi"]),
                    "pods": rng.choice(["30", "110", "110"]),
                },
                conditions=conds,
            ),
        ))
    services = [service(T, "web", {"app": "web"}),
                service(T, "api", {"app": "api"})]
    return nodes, services


def mixed_backlog(T, scale=1, seed=0):
    """A FIFO backlog of RC templates (runs of >= 16 identical pods: a
    zone-spread web tier, an api tier pinned to ssd nodes, a host-port
    agent, best-effort batch pods, gpu-tolerating pods) interleaved with
    runs shorter than the wave's min_run and singletons, which take the
    serial scan. `scale` multiplies the template runs."""
    rng = random.Random(seed)

    def pod(name, labels, requests, **spec_kw):
        return T.Pod(
            metadata=T.ObjectMeta(name=name, labels=dict(labels)),
            spec=T.PodSpec(
                containers=[T.Container(requests=dict(requests),
                                        ports=spec_kw.pop("ports", []))],
                **spec_kw),
        )

    def run(prefix, k, labels, requests, **spec_kw):
        return [pod(f"{prefix}-{i:05d}", labels, requests, **dict(spec_kw))
                for i in range(k)]

    def singles(prefix, k):
        return [pod(f"{prefix}-{i:03d}", {"app": "misc"},
                    {"cpu": f"{110 + 7 * rng.randrange(40)}m",
                     "memory": f"{64 * (1 + rng.randrange(16))}Mi"})
                for i in range(k)]

    def short_runs(prefix, k):
        out = []
        for r in range(k):
            req = {"cpu": f"{300 + 50 * r}m", "memory": "256Mi"}
            out += run(f"{prefix}{r}", rng.randint(2, 6), {"app": "job"}, req)
        return out

    web = {"cpu": "250m", "memory": "512Mi"}
    backlog = []
    backlog += run("web-a", 60 * scale, {"app": "web"}, web)
    backlog += singles("single-a", 8)
    backlog += run("api", 40 * scale, {"app": "api"},
                   {"cpu": "500m", "memory": "1Gi"},
                   node_selector={"disktype": "ssd"})
    backlog += short_runs("job-a", 4)
    backlog += run("agent", 24 * scale, {"app": "agent"},
                   {"cpu": "100m", "memory": "128Mi"},
                   ports=[T.ContainerPort(host_port=9100)])
    backlog += run("web-b", 60 * scale, {"app": "web"}, web)
    backlog += run("batch", 20 * scale, {"app": "batch"}, {})
    backlog += singles("single-b", 8)
    backlog += run("gpu", 16 * scale, {"app": "gpu"}, {"cpu": "1"},
                   tolerations=[T.Toleration(key="gpu", operator="Equal",
                                             value="true",
                                             effect="NoSchedule")])
    backlog += short_runs("job-b", 3)
    return backlog


#: (cap / 10) of the LR quotient boundary case: small, typical, 2^40-
#: scale and up to the largest multiple of 10 under 2^59 (the top of the
#: kernel's division-free range)
LR_BOUND_TENTHS = (1, 7, 400, 3_276_800, 2**30 + 3, 2**36, 2**52 + 1,
                   2**55 + 12_345, (2**59 - 1) // 10)


def probe_case(N, seed, *, alloc_zero=False, zero_req=False,
               integer_ba=False, lr_bounds=False, big_mem=False,
               zero_commit=False, huge_cap=False):
    """-> (alloc, usage, pod): numpy inputs of one probe resource sweep
    (ops/probe_kernel.resource_probe): alloc = (alloc_mcpu, alloc_mem,
    alloc_gpu, alloc_pods) i64[N]; usage = the carry's (req_mcpu,
    req_mem, req_gpu, nz_mcpu, nz_mem, pod_count) i64[N]; pod = the nine
    pod scalars as ints. The edge cases: alloc_zero zeroes a third of the
    allocations (BalancedAllocation's fraction is then 1.0, and nothing
    fits); zero_req makes a zero-request pod (it skips cpu/mem/gpu but not
    the pod count); integer_ba puts the cpu and mem fractions on
    multiples of 0.01, so 10 - 10*|diff| often lands on an integer and a
    fused multiply-add or a wrong truncation would move it by one.

    lr_bounds puts LeastRequested's quotient (cap - total)*10 / cap on
    its boundaries: for node n, each of cpu and mem has cap = 10*m (m from
    LR_BOUND_TENTHS) and a target k in 0..10, and the totals step by 1
    per depth from a start that makes some j give (cap - total)*10 ==
    k*cap and the next j k*cap - 10, the largest numerator below it (the
    numerator is always a multiple of 10); for k == 0 the next j has
    total > cap. big_mem puts memory capacities at 2^40-2^42 bytes.
    zero_commit gives a zero commit vector and room for any pod count, so
    each node's frontier is 0 or J (a third of the nodes lack cpu room).
    huge_cap puts some cpu and mem capacities above 2^59, where
    (cap - total)*10 wraps in int64 as it does in the reference."""
    import numpy as np

    rng = np.random.default_rng(seed)
    a_cpu = rng.choice([2000, 4000, 8000], N)
    a_mem = rng.choice([8, 16, 32], N) * 2**30
    a_gpu = rng.choice([0, 0, 1, 2], N)
    a_pods = rng.choice([30, 110], N)
    if alloc_zero:
        for a in (a_cpu, a_mem, a_pods):
            a[rng.random(N) < 0.3] = 0
    u_cpu = (a_cpu * rng.random(N) * 0.9).astype(np.int64)
    u_mem = (a_mem * rng.random(N) * 0.9).astype(np.int64)
    u_gpu = np.minimum(rng.integers(0, 2, N), a_gpu)
    u_cnt = (a_pods * rng.random(N) * 0.5).astype(np.int64)
    u_nzc = u_cpu + 100 * rng.integers(0, 3, N)
    u_nzm = u_mem + 200 * 2**20 * rng.integers(0, 3, N)
    pod = dict(req_mcpu=100, req_mem=500 * 2**20, req_gpu=0, zero_req=0,
               commit_mcpu=100, commit_mem=500 * 2**20, commit_gpu=0,
               nz_mcpu=100, nz_mem=500 * 2**20)
    if zero_req:
        pod.update(req_mcpu=0, req_mem=0, zero_req=1, commit_mcpu=0,
                   commit_mem=0, nz_mcpu=100, nz_mem=200 * 2**20)
    if integer_ba:
        a_cpu[:] = 1000
        a_mem[:] = 1000
        u_nzc = 10 * rng.integers(0, 50, N)
        u_nzm = 10 * rng.integers(0, 50, N)
        pod.update(nz_mcpu=10, nz_mem=20)
    if lr_bounds:
        # every (cap, k) pair for cpu, and for mem, within 99 nodes
        tenths = np.asarray(LR_BOUND_TENTHS, np.int64)
        n = np.arange(N)
        a_cpu = 10 * tenths[n % len(tenths)]
        a_mem = 10 * tenths[(n + 3) % len(tenths)]
        period = n // len(tenths)
        u_nzc = _lr_bound_usage(rng, a_cpu, period % 11)
        u_nzm = _lr_bound_usage(rng, a_mem, (period + 5) % 11)
        u_cpu = (a_cpu * rng.random(N) * 0.9).astype(np.int64)
        u_mem = (a_mem * rng.random(N) * 0.9).astype(np.int64)
        pod.update(nz_mcpu=1, nz_mem=1)
    if big_mem:
        a_mem = rng.choice([1, 2, 4], N) * 2**40
        u_mem = (a_mem * rng.random(N) * 0.9).astype(np.int64)
        u_nzm = u_mem + 200 * 2**20 * rng.integers(0, 3, N)
        pod.update(req_mem=64 * 2**30, commit_mem=64 * 2**30,
                   nz_mem=64 * 2**30)
    if zero_commit:
        a_pods = np.full(N, 10**6)
        u_cpu[::3] = a_cpu[::3] - 50
        pod.update(commit_mcpu=0, commit_mem=0, commit_gpu=0)
    if huge_cap:
        a_cpu[1::3] = 2**59 + 10 * rng.integers(1, 2**40, len(a_cpu[1::3]))
        a_mem[::2] = 2**60 + rng.integers(0, 2**50, len(a_mem[::2]))
    alloc = tuple(np.asarray(a, np.int64) for a in (a_cpu, a_mem, a_gpu,
                                                    a_pods))
    usage = tuple(np.asarray(a, np.int64)
                  for a in (u_cpu, u_mem, u_gpu, u_nzc, u_nzm, u_cnt))
    return alloc, usage, pod


#: (label, J, N, options) of the probe kernel's checks: the main path's
#: shapes (J = the pick_j floor of 128 and the max_j of 1024; N = nodes
#: padded to a power of two) and the edge inputs
PROBE_CASES = (
    ("main J=128 N=1024", 128, 1024, {}),
    ("main J=128 N=8192", 128, 8192, {}),
    ("main J=1024 N=1024", 1024, 1024, {}),
    ("edge alloc 0", 128, 1024, {"alloc_zero": True}),
    ("edge zero-request pod", 128, 1024, {"zero_req": True}),
    ("edge wants_res=False", 128, 1024, {"wants_res": False}),
    ("edge integer BA", 128, 1024, {"integer_ba": True}),
    ("edge J=16", 16, 1024, {}),
    ("edge J=200 N=1000", 200, 1000, {}),
    ("edge LR quotient bounds", 128, 1024, {"lr_bounds": True}),
    ("edge mem 2^40", 128, 1024, {"big_mem": True}),
    ("edge zero commit", 128, 1024, {"zero_commit": True}),
    ("edge cap > 2^59", 128, 1024, {"huge_cap": True}),
    # the grouped header probe launches K1 at J=1, 7 of its 8 j lanes idle
    ("edge J=1", 1, 1024, {}),
    ("edge J=1 N=8192", 1, 8192, {}),
)


def _lr_bound_usage(rng, cap, k):
    """Usage whose totals usage + (j+1) hit (cap - total)*10 == k*cap at
    some depth j < 15 (at j == 0 for k == 10, whose target total is 0, so
    the usage is -1 there)."""
    import numpy as np

    target = cap * (10 - k) // 10
    j = np.minimum(rng.integers(0, 15, len(cap)), np.maximum(target - 1, 0))
    return target - 1 - j


def zreplay_case(N, seed, *, K=256, k_real=None, num_zones=4,
                 unzoned_every=4, zero_spread=False, tt_20_18=False,
                 veto=False, rows_dyn=None, cap=(2, 12), has_selectors=True,
                 selfmatch=1, weights=None):
    """-> numpy inputs of one run's pick loop (ops/zreplay_kernel.
    replay_picks; models/zreplay._replay_run of the JAX package), in
    permuted node space: {"nodes": NODE_INPUTS name -> array (frontier
    NOT vetoed), "veto": bool[N], "scalars": {nz_mcpu, nz_mem,
    selfmatch, L0}, "weights": {w_lr, ..., w_ip}, "K", "k_real",
    "rows_dyn", "num_zones", "has_selectors"}.

    Zones round-robin over 1..num_zones-1, every unzoned_every-th node
    unzoned (0); frontiers (commits a node takes) drawn from `cap`;
    rows_dyn defaults to the table depth pick_j gives (the largest
    frontier + 2), so no pick bails. The edge cases: zero_spread gives
    every node spread count 0 and no self-match, so the zone maximum is
    0 and the zone score 0/0 = NaN (INT64_MIN in the score); tt_20_18
    puts TaintToleration counts at 18 and 20 only, where (1 - 18/20)*10
    truncates to 0 in float64 and an integer rewrite gives 1; veto marks
    a third of the nodes (one copy each)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = np.arange(N)
    alloc_cpu = rng.choice([2000, 4000, 8000], N)
    alloc_mem = rng.choice([8, 16, 32], N) * 2**30
    zone = np.where(n % unzoned_every == 0, 0,
                    1 + n % max(num_zones - 1, 1)) if unzoned_every \
        else 1 + n % max(num_zones - 1, 1)
    if num_zones <= 1:
        zone = np.zeros(N, np.int64)
    nodes = {
        "fit_static": (rng.random(N) < 0.9).astype(np.uint8),
        "frontier": rng.integers(cap[0], cap[1] + 1, N),
        "static_add": rng.integers(0, 12, N),
        "spread_base": (np.zeros(N, np.int64) if zero_spread
                        else rng.integers(0, 6, N)),
        "na_counts": rng.integers(0, 30, N),
        "tt_counts": (rng.choice([18, 20], N) if tt_20_18
                      else rng.integers(0, 20, N)),
        "ip_totals": rng.integers(-50, 51, N),
        "nz_cpu0": (alloc_cpu * rng.random(N) * 0.6).astype(np.int64),
        "nz_mem0": (alloc_mem * rng.random(N) * 0.6).astype(np.int64),
        "alloc_cpu": alloc_cpu,
        "alloc_mem": alloc_mem,
        "zone_id": zone,
    }
    nodes = {k: np.asarray(v, np.uint8 if k == "fit_static" else
                           np.int32 if k == "zone_id" else np.int64)
             for k, v in nodes.items()}
    w = dict(w_lr=1, w_ba=1, w_spread=1, w_na=1, w_tt=1, w_ip=1)
    if weights:
        w.update(weights)
    return {
        "nodes": nodes,
        "veto": (n % 3 == 1) if veto else np.zeros(N, bool),
        "scalars": {"nz_mcpu": 100, "nz_mem": 500 * 2**20,
                    "selfmatch": 0 if zero_spread else selfmatch,
                    "L0": int(rng.integers(0, 1000))},
        "weights": w,
        "K": K,
        "k_real": K if k_real is None else k_real,
        "rows_dyn": (int(nodes["frontier"].max()) + 2 if rows_dyn is None
                     else rows_dyn),
        "num_zones": num_zones,
        "has_selectors": has_selectors,
    }


#: (label, N, K, options) of K3's checks: the main path's shape (5,000
#: nodes padded to 8,192; a 50,000-pod run in a 65,536-step bucket) and
#: the edge inputs where bit identity can break
ZREPLAY_CASES = (
    ("main N=8192 K=65536", 8192, 65536,
     {"k_real": 50000, "cap": (4, 10), "num_zones": 4,
      "unzoned_every": 0}),
    ("edge max_zone == 0 (NaN)", 1024, 256, {"zero_spread": True}),
    ("edge TaintToleration mx=20 c=18", 1024, 256, {"tt_20_18": True}),
    ("edge unzoned mixed with zoned", 1024, 256, {"unzoned_every": 2}),
    ("edge veto", 1024, 256, {"veto": True}),
    ("edge bail at rows_dyn", 1024, 4096, {"rows_dyn": 3}),
    ("edge steps with no fit", 1024, 4096, {"cap": (0, 3)}),
    ("edge k_real < K_bucket", 1024, 256, {"k_real": 100}),
    ("edge N=1500", 1500, 1024, {}),
    ("edge no selectors, one zone", 1024, 256,
     {"has_selectors": False, "num_zones": 1}),
    ("edge N=16384 (state in device memory)", 16384, 4096, {}),
)
