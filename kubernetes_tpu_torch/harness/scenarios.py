"""Cluster and backlog builders shared by the tests and chip_smoke.py.

Every builder takes the `types` module of the package whose objects it
should build (kubernetes_tpu_torch.api.types, or the JAX package's
kubernetes_tpu.api.types in the parity tests), so one description makes
the same scenario in both packages. The shapes follow the
scheduler_perf density test (nodes: 4 CPU / 32Gi / 110 pods; pods:
100m / 500Mi pause containers) and the JAX package's wave tests.
"""

from __future__ import annotations

import collections
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
                 selfmatch=1, weights=None, pad_tail=0.0, m_moves=False,
                 sole_na=False):
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
    a third of the nodes (one copy each); pad_tail makes the last
    fraction of the nodes statically unfit, as padding is; m_moves gives
    spread counts of 0 or 1 and static scores far apart, so one node takes
    many picks in a row and the spread maximum M moves at each; sole_na
    gives one fit node the only large NodeAffinity count and a frontier
    of 1, so the normalizer's sole holder leaves the fit set after its
    first pick."""
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
    if pad_tail:
        nodes["fit_static"][int(N * (1 - pad_tail)):] = 0
    if m_moves:
        nodes["spread_base"] = rng.integers(0, 2, N)
        nodes["static_add"] = rng.permutation(N) * 20
    if sole_na:
        h = int(np.flatnonzero(nodes["fit_static"] != 0)[0])
        nodes["na_counts"][h] = 1000
        nodes["frontier"][h] = 1
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
    ("edge padded tail (last 40% statically unfit)", 2048, 1024,
     {"pad_tail": 0.4, "num_zones": 4, "unzoned_every": 0}),
    ("edge M moves often", 1024, 512, {"m_moves": True, "cap": (20, 40)}),
    ("edge sole NodeAffinity holder leaves", 1024, 256, {"sole_na": True}),
    ("edge ragged N=1999", 1999, 512, {}),
    ("edge weights other than 1", 1024, 256,
     {"weights": {"w_spread": 3, "w_lr": 2, "w_na": 2, "w_ip": 5}}),
    ("edge N=200", 200, 256, {}),
    ("edge N=300", 300, 256, {}),
    ("edge N=3000", 3000, 512, {}),
)


# -- Policy files with services, and the extender service ---------------------

#: the node label the Policy documents name (ServiceAffinity /
#: ServiceAntiAffinity on `zone`, LabelsPresence on `disktype`,
#: LabelPreference on `memtype`)
POLICY_ZONE = "zone"

#: tests/test_policy_tpu.py POLICY: ServiceAffinity on zone,
#: LabelsPresence, ServiceAntiAffinity on zone with weight 2,
#: LabelPreference, LeastRequested and BalancedAllocation
POLICY_SERVICES = {
    "kind": "Policy",
    "apiVersion": "v1",
    "predicates": [
        {"name": "GeneralPredicates"},
        {"name": "PodToleratesNodeTaints"},
        {"name": "ZoneAffinity",
         "argument": {"serviceAffinity": {"labels": [POLICY_ZONE]}}},
        {"name": "RequireSSD",
         "argument": {"labelsPresence": {"labels": ["disktype"],
                                         "presence": True}}},
    ],
    "priorities": [
        {"name": "LeastRequestedPriority", "weight": 1},
        {"name": "BalancedResourceAllocation", "weight": 1},
        {"name": "ZoneSpread", "weight": 2,
         "argument": {"serviceAntiAffinity": {"label": POLICY_ZONE}}},
        {"name": "PreferDDR", "weight": 1,
         "argument": {"labelPreference": {"label": "memtype",
                                          "presence": True}}},
    ],
}

#: ServiceAntiAffinity alone: each Service's pods spread over the zones
POLICY_SAA = {
    "kind": "Policy",
    "apiVersion": "v1",
    "predicates": [
        {"name": "GeneralPredicates"},
        {"name": "PodToleratesNodeTaints"},
    ],
    "priorities": [
        {"name": "LeastRequestedPriority", "weight": 1},
        {"name": "BalancedResourceAllocation", "weight": 1},
        {"name": "ZoneSpread", "weight": 2,
         "argument": {"serviceAntiAffinity": {"label": POLICY_ZONE}}},
    ],
}

POLICY_DOCUMENTS = {"services": POLICY_SERVICES, "saa": POLICY_SAA}


def policy_nodes(T, n, zones=("a", "b", "c"), seed=0, pods_cap="110"):
    """density_nodes labelled for the Policy documents and for a
    multi-zone cluster: the hostname, `zone` and the failure-domain zone
    round-robin over `zones`, disktype=ssd on all but about one node in
    twenty (LabelsPresence excludes those), memtype=ddr on about half
    (LabelPreference)."""
    rng = random.Random(seed)
    nodes = density_nodes(T, n, pods_cap=pods_cap)
    for i, node in enumerate(nodes):
        labels = node.metadata.labels
        labels[HOSTNAME] = node.metadata.name
        labels[POLICY_ZONE] = labels[ZONE] = zones[i % len(zones)]
        if rng.random() >= 0.05:
            labels["disktype"] = "ssd"
        if rng.random() < 0.5:
            labels["memtype"] = "ddr"
    return nodes


def service_backlog(T, services=64, per=128, name0=""):
    """-> (Services, pods): `services` RC templates of `per` pause pods
    each, in FIFO order, every RC's pods selected by one Service of their
    own (the multi-tenant shape in which operators use the service
    policy entries)."""
    svcs = [service(T, f"{name0}svc-{s:03d}", {"app": f"{name0}app-{s:03d}"})
            for s in range(services)]
    pods = []
    for s in range(services):
        pods += pause_pods(T, per, labels={"app": f"{name0}app-{s:03d}"},
                           prefix=f"{name0}rc-{s:03d}")
    return svcs, pods


def extender_bodies(T, scheme, n_nodes=5000, existing=2000, pending=256,
                    seed=0):
    """-> {verb: body}: the extender service's request bodies (JSON
    objects, encoded with `scheme`) over a policy_nodes cluster with four
    Services: `existing` assigned pods on random nodes (members of the
    Services and others), one member pod for filter and prioritize, and
    `pending` pods of four RC templates for scheduleBacklog."""
    rng = random.Random(seed)
    nodes = policy_nodes(T, n_nodes, seed=seed)
    svcs = [service(T, f"svc-{s}", {"app": f"app-{s}"}) for s in range(4)]
    placed = []
    for i in range(existing):
        app = rng.choice(["app-0", "app-1", "app-2", "app-3", "other"])
        cpu = rng.choice(["100m", "100m", "200m"])
        p = pause_pods(T, 1, labels={"app": app}, name0=i, prefix="ex",
                       requests={"cpu": cpu, "memory": "500Mi"})[0]
        p.spec.node_name = nodes[rng.randrange(n_nodes)].metadata.name
        placed.append(p)
    cluster = {
        "nodes": {"kind": "NodeList",
                  "items": [scheme.encode(n) for n in nodes]},
        "existingPods": [scheme.encode(p) for p in placed],
        "services": {"items": [scheme.encode(s) for s in svcs]},
    }
    pod = pause_pods(T, 1, labels={"app": "app-1"}, prefix="new")[0]
    backlog = []
    for s in range(4):
        backlog += pause_pods(T, pending // 4, labels={"app": f"app-{s}"},
                              prefix=f"rc-{s}",
                              requests={"cpu": f"{100 + 50 * s}m",
                                        "memory": "500Mi"})
    one = dict(cluster, pod=scheme.encode(pod))
    return {
        "filter": one,
        "prioritize": one,
        "scheduleBacklog": dict(
            cluster, pending={"items": [scheme.encode(p) for p in backlog]},
            lastNodeIndex=0),
    }


# -- gangs and priority preemption --------------------------------------------

def pod_group(T, name, min_member=1, priority=0, workload_class=""):
    """A PodGroup (the gang's object) in the default namespace."""
    return T.PodGroup(
        metadata=T.ObjectMeta(name=name),
        spec=T.PodGroupSpec(min_member=min_member, priority=priority,
                            workload_class=workload_class))


def gang_members(T, group, n, cpu="100m", mem="500Mi", name0=0, ts=None):
    """n identical members of gang `group` (the pod-group label, and app
    = the group's name), creation timestamp ts when given."""
    pods = pause_pods(T, n, labels={T.POD_GROUP_LABEL: group, "app": group},
                      requests={"cpu": cpu, "memory": mem}, name0=name0,
                      prefix=group)
    for p in pods:
        p.metadata.creation_timestamp = ts
    return pods


def bound_cluster(T, n_nodes, per_node=24, cpu="150m", mem="500Mi",
                  group=None):
    """-> (nodes, bound pods): density_nodes, each holding `per_node`
    bound pods of cpu / mem (members of `group` when given, else
    priority-0 pods of no gang), with creation timestamps that do not
    follow their names, so that the director's newest-first order is
    not the name order."""
    nodes = density_nodes(T, n_nodes)
    labels = ({T.POD_GROUP_LABEL: group, "app": group} if group
              else {"app": "filler"})
    bound = []
    for i, node in enumerate(nodes):
        for k in range(per_node):
            p = pause_pods(T, 1, labels=labels,
                           requests={"cpu": cpu, "memory": mem},
                           name0=i * per_node + k, prefix="bound")[0]
            s = (i * 7919 + k * 104729) % 86400
            p.metadata.creation_timestamp = (
                f"2026-01-01T{s // 3600:02d}:{s // 60 % 60:02d}:"
                f"{s % 60:02d}Z")
            p.spec.node_name = node.metadata.name
            bound.append(p)
    return nodes, bound


def gang_wave(T, singles=4096, gangs=256, members=16, big=256,
              big_cpu="1", big_priority=10, short=12):
    """-> (wave, pod groups): a wave of `singles` pause pods (100m /
    500Mi), `gangs` gangs of `members` (minMember = members) in four
    request templates of 100-250m, priorities 1-4, one gang `short` of
    `short` members against a minMember of `members` (it parks before
    the wave), and one gang `big` of `big` members of big_cpu at
    big_priority (minMember = big). Gang members arrive after the
    singletons, the big gang in the middle of the gangs."""
    wave = pause_pods(T, singles, prefix="single")
    groups = []
    for g in range(gangs):
        name = f"gang-{g:04d}"
        groups.append(pod_group(T, name, members, 1 + (g // 4) % 4))
        wave += gang_members(T, name, members, cpu=f"{100 + 50 * (g % 4)}m")
        if g == gangs // 2 and big:
            groups.append(pod_group(T, "big", big, big_priority))
            wave += gang_members(T, "big", big, cpu=big_cpu)
    if short:
        groups.append(pod_group(T, "short", members, 5))
        wave += gang_members(T, "short", short)
    return wave, groups


def gang_director(G, pod_groups, statuses, evicted, **kw):
    """A GangDirector of the gang module G (either package's) over a
    fixed PodGroup list, appending (namespace, name, status) to statuses
    and its victims to evicted."""
    return G.GangDirector(
        pod_group_lister=lambda: list(pod_groups),
        status_updater=lambda ns, name, st: statuses.append(
            (ns, name, dict(st))),
        preemptor=evicted.extend, **kw)


def director_wave(director, algo, wave, state) -> dict:
    """One scheduling cycle as the scheduler's control loop runs it
    (kubernetes_tpu/scheduler/core.py): plan_wave, the wave with its
    gang layout, after_wave. -> {"backlog": names, "layout": [(start,
    length, key, priority)], "parked": [(name, reason)], "hosts",
    "errors": {backlog index: reason}}."""
    backlog, layout, parked = director.plan_wave(wave, state)
    hosts = (algo.schedule_backlog(backlog, state, gangs=layout or None)
             if backlog else [])
    errors = {}
    if layout:
        hosts, errors = director.after_wave(backlog, list(hosts), layout,
                                            state)
    return {
        "backlog": [p.metadata.name for p in backlog],
        "layout": [(g["start"], g["length"], g["key"], g["priority"])
                   for g in layout],
        "parked": [(p.metadata.name, str(e)) for p, e in parked],
        "hosts": list(hosts),
        "errors": {i: str(e) for i, e in sorted(errors.items())},
    }


def evict(state, victims):
    """A clone of state without the victims (their nodes' accounting
    released)."""
    out = state.clone()
    for v in victims:
        out.node_infos[v.spec.node_name].remove_pod(v)
    return out


def victim_case(N, C, seed, kind="fuzz"):
    """-> {"prio", "ord", "res", "free", "req", "gang_prio"}: numpy
    inputs of the victim scorer (ops/preempt.py) at (N, C). Kinds:
    fuzz (random tiers, 30% unused slots, random ordinals); all_invalid
    (every slot unused or at the gang's priority or above); fits_now
    (every node fits a member already); evict_all (a node fits only
    after evicting all of its candidates); none_fit (no node fits even
    evicting everything); negative (negative priorities and a gang
    priority at or below 1); ties (one tier, ordinals repeated: the
    column order breaks ties); density (the director's table of
    bound_cluster nodes, 24 priority-0 pods of 150m / 500Mi each,
    against a 1-CPU member at priority 10; the rows past 5,000 of 8,192,
    in proportion, left as pack_candidates pads them)."""
    import numpy as np

    from kubernetes_tpu_torch.ops.preempt import INVALID_PRIO

    rng = np.random.RandomState(seed)
    prio = rng.randint(0, 5, (N, C)).astype(np.int32)
    ordn = rng.permutation(N * C).reshape(N, C).astype(np.int32)
    res = rng.randint(0, 4, (N, C, 4)).astype(np.int64) * 250
    free = rng.randint(0, 4, (N, 4)).astype(np.int64) * 250
    req = np.array([500, 250, 0, 1], np.int64)
    gang_prio = int(rng.randint(1, 6))
    if kind == "fuzz":
        prio[rng.rand(N, C) < 0.3] = INVALID_PRIO
        ordn = rng.randint(-2**31, 2**31 - 1, (N, C)).astype(np.int32)
    elif kind == "all_invalid":
        prio = np.where(rng.rand(N, C) < 0.5, INVALID_PRIO,
                        gang_prio + rng.randint(0, 3, (N, C))).astype(
                            np.int32)
    elif kind == "fits_now":
        free = req[None, :] + rng.randint(0, 3, (N, 4)) * 100
    elif kind == "evict_all":
        res = rng.randint(1, 5, (N, C, 4)).astype(np.int64) * 100
        prio = np.minimum(prio, gang_prio - 1).astype(np.int32)
        free = req[None, :] - res.sum(axis=1)
    elif kind == "none_fit":
        req = np.array([1 << 40, 250, 0, 1], np.int64)
    elif kind == "negative":
        prio = rng.randint(-100, 0, (N, C)).astype(np.int32)
        prio[rng.rand(N, C) < 0.2] = INVALID_PRIO
        gang_prio = int(rng.randint(-50, 2))
    elif kind == "ties":
        prio[:] = 1
        gang_prio = 2
        ordn = rng.randint(0, 3, (N, C)).astype(np.int32)
    elif kind == "density":
        per = min(24, C)
        prio = np.full((N, C), INVALID_PRIO, np.int32)
        prio[:, :per] = 0
        ordn = np.zeros((N, C), np.int32)
        ordn[:, :per] = rng.permutation(N * per).reshape(N, per)
        res = np.zeros((N, C, 4), np.int64)
        res[:, :per] = (150, 500 << 20, 0, 1)
        free = np.tile(np.array([4000 - 150 * per, (32 << 30) -
                                 per * (500 << 20), 0, 110 - per],
                                np.int64), (N, 1))
        req = np.array([1000, 500 << 20, 0, 1], np.int64)
        gang_prio = 10
        real = max(1, N * 5000 // 8192)
        prio[real:] = INVALID_PRIO
        ordn[real:] = 0
        res[real:] = 0
        free[real:] = 0
    else:
        raise ValueError(f"victim_case: unknown kind {kind!r}")
    return {"prio": prio, "ord": ordn, "res": res.astype(np.int64),
            "free": free.astype(np.int64), "req": req,
            "gang_prio": gang_prio}


#: (label, N, C, kind) of the victim scorer's checks: the kernel against
#: its plain version on the card (chip_smoke phase 3c), the plain version
#: against the JAX package's on the CPU (tests, N cut to 256). The gang
#: phase's shape comes twice: as the director builds it (every real row
#: alike) and as a fuzz, so that varied rows meet the kernel there too
VICTIM_CASES = (
    ("fuzz C=8", 64, 8, "fuzz"),
    ("fuzz C=32", 1024, 32, "fuzz"),
    ("fuzz C=128", 256, 128, "fuzz"),
    ("fuzz C=1024", 64, 1024, "fuzz"),
    ("all invalid", 64, 8, "all_invalid"),
    ("fits now", 64, 8, "fits_now"),
    ("evict all", 128, 32, "evict_all"),
    ("no node fits", 64, 32, "none_fit"),
    ("negative priorities", 256, 32, "negative"),
    ("ties", 64, 16, "ties"),
    ("gang phase N=8192 C=32", 8192, 32, "density"),
    ("fuzz at the gang shape N=8192 C=32", 8192, 32, "fuzz"),
)


# -- the daemon core: the scheduler cache and the scheduling loop -------------

def scheduler_cache(C, nodes, bound=()):
    """A SchedulerCache of the cache module C (either package's
    scheduler/cache.py) holding `nodes` and the bound pods `bound`, the
    latter watch-confirmed (add_pod), as the informers would fill it."""
    cache = C.SchedulerCache()
    for n in nodes:
        cache.add_node(n)
    for p in bound:
        cache.add_pod(p)
    return cache


def daemon_config(core, cache, algorithm, backlog, director=None, **kw):
    """A core.SchedulerConfig (core: either package's scheduler/core.py)
    over a pre-queued backlog, in place of the factory's informers, FIFO
    and binder: next_pod and drain_waiting pop a deque, binder_many and
    binder record (pod, host) and report success, error records (pod,
    error). -> (config, {"queue": the deque, "binds": [(pod, host)],
    "errors": [(pod, error)]}); put pods back on the queue to schedule
    them again."""
    queue = collections.deque(backlog)
    binds, errors = [], []

    def next_pod():
        return queue.popleft() if queue else None

    def drain_waiting(n):
        return [queue.popleft() for _ in range(min(n, len(queue)))]

    def binder_many(pairs):
        binds.extend(pairs)
        return [{"status": "Success"}] * len(pairs)

    cfg = core.SchedulerConfig(
        scheduler_cache=cache, algorithm=algorithm,
        binder=lambda pod, host: binds.append((pod, host)),
        binder_many=binder_many, next_pod=next_pod,
        drain_waiting=drain_waiting,
        error=lambda pod, err: errors.append((pod, err)),
        gang_director=director, **kw)
    return cfg, {"queue": queue, "binds": binds, "errors": errors}


def daemon_director(G, cache, pod_groups, statuses, evicted, **kw):
    """A GangDirector of the gang module G wired as the JAX factory wires
    it from its informers (kubernetes_tpu/scheduler/factory.py
    _make_config), over lists: pod_group_lister lists `pod_groups`,
    status_updater appends (namespace, name, status) to statuses, and the
    preemptor appends its victims to evicted and removes them from the
    cache, as the pod informer's delete events would."""
    def preempt(victims):
        evicted.extend(victims)
        for v in victims:
            cache.remove_pod(v)

    return G.GangDirector(
        pod_group_lister=lambda: list(pod_groups),
        status_updater=lambda ns, name, st: statuses.append(
            (ns, name, dict(st))),
        preemptor=preempt, **kw)


def daemon_flow(C, core, G, algorithm, nodes, bound=(), backlog=(),
                groups=None, retries=0, on_wave=None, director_kw=None,
                **cfg_kw) -> dict:
    """A backlog through the scheduling core of either package (C, core,
    G: its scheduler/cache.py, core.py and gang.py): a scheduler_cache of
    `nodes` and `bound`, the algorithm algorithm(cache) subscribed to it,
    a daemon_config over `backlog` (cfg_kw: SchedulerConfig fields such
    as max_batch) and, when `groups` (PodGroups) is given, a
    daemon_director. Scheduler.schedule_one runs until the queue is empty,
    called directly, not through Scheduler.run's loop, which logs and
    swallows an exception: here one propagates; then the bind pool is
    waited for. A gang parked for preemption is queued again, up to
    `retries` times, as the factory's error handler re-queues it.
    on_wave(), when given, is called after each cycle. -> {"binds": {pod
    name: host}, "errors": [(pod name, error text)], "statuses":
    [(namespace, name, status)], "victims": [pod name], "cycles": n}."""
    cache = scheduler_cache(C, nodes, bound)
    algo = algorithm(cache)
    statuses, evicted = [], []
    director = None
    if groups is not None:
        director = daemon_director(G, cache, groups, statuses, evicted,
                                   **(director_kw or {}))
    cfg, out = daemon_config(core, cache, algo, backlog, director=director,
                             **cfg_kw)
    sched = core.Scheduler(cfg)
    errors, cycles = [], 0
    for _ in range(retries + 1):
        while out["queue"]:
            sched.schedule_one()
            cycles += 1
            if on_wave is not None:
                on_wave()
        sched._bind_pool.shutdown(wait=True)
        retry = [p for p, e in out["errors"] if "preempting" in str(e)]
        errors += [(p.metadata.name, str(e)) for p, e in out["errors"]]
        out["errors"].clear()
        if not retry:
            break
        out["queue"].extend(retry)
    return {"binds": {p.metadata.name: h for p, h in out["binds"]},
            "errors": errors, "statuses": statuses,
            "victims": [v.metadata.name for v in evicted],
            "cycles": cycles}
