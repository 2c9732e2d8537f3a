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

#: the default provider's predicates and priorities with
#: LeastRequestedPriority at weight 30: the summed |weight| * 10 bound of
#: the LR/BA terms is 310, past bfloat16's exact integers (256), so the
#: KUBERNETES_TPU_QUANT=bf16 profile rounds under it
POLICY_LR30 = {
    "kind": "Policy",
    "apiVersion": "v1",
    "predicates": [{"name": n} for n in (
        "NoDiskConflict", "NoVolumeZoneConflict", "MaxEBSVolumeCount",
        "MaxGCEPDVolumeCount", "GeneralPredicates", "PodToleratesNodeTaints",
        "CheckNodeMemoryPressure", "MatchInterPodAffinity")],
    "priorities": [{"name": n, "weight": w} for n, w in (
        ("LeastRequestedPriority", 30), ("BalancedResourceAllocation", 1),
        ("SelectorSpreadPriority", 1), ("NodeAffinityPriority", 1),
        ("TaintTolerationPriority", 1), ("InterPodAffinityPriority", 1))],
}

#: K1's bf16 mode's term lists: the default profile (bound 20, exact) and
#: two whose bound passes 256, in both declaration orders
BF16_TERM_LISTS = (
    ("default", (("lr", 1), ("ba", 1))),
    ("LR 30 + BA 1", (("lr", 30), ("ba", 1))),
    ("BA 7 + LR 40", (("ba", 7), ("lr", 40))),
)


def multi_template_backlog(T, num_nodes, num_pods, templates=8, block=512):
    """-> (nodes, services, pods): the kernel-path profiles' backlog, the
    counterpart of the JAX package's bench.py build_multi. Pods come in
    `block`-sized runs cycling `templates` groups (100m / 500Mi), each
    group carrying a PREFERRED anti-affinity term against the NEXT
    group's labels and one Service selecting it: a soft non-self term
    never blocks placement but makes the run impure, so every run takes
    the per-run probe, the shape the double-buffered pipeline stages
    across. Nodes: density_nodes' shape named node-00000.. with their
    hostname label."""
    nodes = [
        T.Node(
            metadata=T.ObjectMeta(name=f"node-{i:05d}",
                                  labels={HOSTNAME: f"node-{i:05d}"}),
            status=T.NodeStatus(
                allocatable={"cpu": "4", "memory": "32Gi", "pods": "110"},
                conditions=[T.NodeCondition("Ready", "True")],
            ),
        )
        for i in range(num_nodes)
    ]

    def pod(i):
        t = (i // block) % templates
        p = T.Pod(
            metadata=T.ObjectMeta(name=f"pod-{i:06d}",
                                  labels={"group": f"g{t:02d}"}),
            spec=T.PodSpec(containers=[T.Container(
                requests={"cpu": "100m", "memory": "500Mi"})]),
        )
        p.metadata.annotations = {AFFINITY_ANNOTATION: json.dumps({
            "podAntiAffinity": {
                "preferredDuringSchedulingIgnoredDuringExecution": [{
                    "weight": 1,
                    "podAffinityTerm": {
                        "labelSelector": {"matchLabels": {
                            "group": f"g{(t + 1) % templates:02d}"}},
                        "topologyKey": HOSTNAME,
                        "namespaces": [],
                    },
                }],
            },
        })}
        return p

    services = [service(T, f"svc-{t:02d}", {"group": f"g{t:02d}"})
                for t in range(templates)]
    return nodes, services, [pod(i) for i in range(num_pods)]


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
    against a 1-CPU member at priority 10; the first min(24, C) of them
    are the row's candidates, the free row counts all 24; the rows past
    5,000 of 8,192, in proportion, left as pack_candidates pads them)."""
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
        free = np.tile(np.array([4000 - 150 * 24, (32 << 30) -
                                 24 * (500 << 20), 0, 110 - 24],
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
#: against the JAX package's on the CPU (tests, N cut to 256), and the
#: kernel's lane emulation against both (tests/test_torch_preempt_lanes).
#: The gang phase's shape comes twice: as the director builds it (every
#: real row alike) and as a fuzz, so that varied rows meet the kernel
#: there too; at C = 8 the director's table for nodes of at most 8
#: lower-priority pods; C = 128 at N = 8,192 times the block path at the
#: width of nodes holding 65-110 candidates; N = 100 at C = 8 ends in a
#: part-filled block
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
    ("gang phase N=8192 C=8", 8192, 8, "density"),
    ("fuzz N=8192 C=128", 8192, 128, "fuzz"),
    ("tail N=100 C=8", 100, 8, "fuzz"),
)

#: (N, C) of the victim scorer's row tails: rows that end inside a warp
#: of the segment path (4 and 2 rows a warp at C = 8 and 16); checked
#: exactly, not timed
VICTIM_TAILS = tuple((N, C) for C in (8, 16) for N in (1, 3, 65))


# -- the resident row scatter K8 ----------------------------------------------

#: K8's fields: (name, host dtype, shape(N), node axis, narrowed), every
#: dtype pair the snapshot's tables place: int64 kept, int32 and uint8
#: widened (sign- and zero-extended), a uint32 bitset widened with its top
#: bit set, bool, float64 with NaN, float32, narrowed int8/int16 tables
#: kept narrow; the node axis first (1-D and 2-D rows) and second
#: (__res__'s (6, N), a (2, N, 3) block)
SCATTER_FIELDS = (
    ("alloc_i64", "int64", lambda n: (n,), 0, False),
    ("count_i32", "int32", lambda n: (n,), 0, False),
    ("bits_u32", "uint32", lambda n: (n, 3), 0, False),
    ("flag_bool", "bool", lambda n: (n,), 0, False),
    ("numval_f64", "float64", lambda n: (n, 2), 0, False),
    ("ratio_f32", "float32", lambda n: (n,), 0, False),
    ("zone_i8", "int8", lambda n: (n,), 0, True),
    ("taint_i16", "int16", lambda n: (n, 4), 0, True),
    ("vocab_u8", "uint8", lambda n: (n,), 0, False),
    ("res_axis1", "int64", lambda n: (6, n), 1, False),
    ("grid_axis1", "int32", lambda n: (2, n, 3), 1, False),
)

#: the fields a node's label and allocatable update changes, at the
#: widths the snapshot encodes them (label bitsets of a few words)
SCATTER_UPDATE_FIELDS = (
    ("alloc_mcpu", "int64", lambda n: (n,), 0, False),
    ("alloc_mem", "int64", lambda n: (n,), 0, False),
    ("alloc_pods", "int64", lambda n: (n,), 0, False),
    ("label_kv", "uint32", lambda n: (n, 4), 0, False),
    ("label_key", "uint32", lambda n: (n, 2), 0, False),
    ("numval", "float64", lambda n: (n, 2), 0, False),
)

#: (label, shards, n_per_shard, M, changed rows, fields) of chip_smoke's
#: K8 equality cases: every dtype pair at M = 64 and 1,024, 4 shards x
#: 2,048 and 1 x 8,192 nodes, and the fields of a node update at host
#: widths (K8 is timed on the churn wave's own shipment instead)
SCATTER_CASES = (
    ("all fields 4x2048 M=64", 4, 2048, 64, 50, "all"),
    ("all fields 4x2048 M=1024", 4, 2048, 1024, 1000, "all"),
    ("all fields 1x8192 M=64", 1, 8192, 64, 64, "all"),
    ("all fields 1x8192 M=1024", 1, 8192, 1024, 700, "all"),
    ("node update 4x2048 M=64", 4, 2048, 64, 50, "update"),
)
#: the same at CPU-test sizes
SCATTER_CPU_CASES = (
    ("all fields 2x64 M=64", 2, 64, 64, 20, "all"),
    ("all fields 8x16 M=64", 8, 16, 64, 40, "all"),
    ("all fields 1x128 M=128", 1, 128, 128, 100, "all"),
    ("all fields 4x32 M=64 every row", 4, 32, 64, 64, "all"),
    ("node update 4x32 M=64", 4, 32, 64, 9, "update"),
)


def _placed_np(a, narrow: bool):
    """The host array at the dtype the port places it at (ints as
    int64 unless narrowed; bool and float as they are)."""
    import numpy as np

    if a.dtype.kind in "iu" and not narrow:
        return a.astype(np.int64)
    return a.copy()


def scatter_case(shards: int, n_per_shard: int, M: int, n_rows: int,
                 seed: int, fields="all") -> dict:
    """One K8 input made from a numpy seed: -> {"fields": [(name, axis,
    narrowed)], "old": name -> the placed resident table before (global
    node axis), "new": name -> the new HOST table, "expected": name ->
    the placed table after, "rows": the changed global rows, "layout",
    "buf": the packed shipment (__idx__ i64[M] padded with -1, each
    field's changed rows with the node axis moved first, at host
    widths), "shards", "n_per_shard"}."""
    import numpy as np

    from kubernetes_tpu_torch.models.pack import pack_arrays

    spec = SCATTER_FIELDS if fields == "all" else SCATTER_UPDATE_FIELDS
    rng = np.random.default_rng(seed)
    N = shards * n_per_shard
    rows = np.sort(rng.choice(N, size=min(n_rows, N, M), replace=False))

    def draw(dt, shape):
        dt = np.dtype(dt)
        if dt == np.bool_:
            return rng.random(shape) < 0.5
        if dt.kind == "f":
            a = rng.normal(size=shape).astype(dt)
            a[rng.random(shape) < 0.1] = np.nan
            return a
        info = np.iinfo(dt)
        lo, hi = max(info.min, -(2**40)), min(info.max, 2**40)
        a = rng.integers(lo, hi, size=shape, endpoint=True).astype(dt)
        if dt == np.uint32:
            a |= np.uint32(1 << 31) * (rng.random(shape) < 0.5)
        return a

    old, new, expected, meta = {}, {}, {}, []
    packed = {"__idx__": np.full(M, -1, np.int64)}
    packed["__idx__"][: len(rows)] = rows
    for name, dt, shape_of, ax, narrow in spec:
        shape = shape_of(N)
        before = draw(dt, shape)
        after = before.copy()
        moved = np.moveaxis(after, ax, 0)
        moved[rows] = draw(dt, (len(rows),) + moved.shape[1:])
        old[name] = _placed_np(before, narrow)
        new[name] = after
        expected[name] = _placed_np(after, narrow)
        r = np.moveaxis(after, ax, 0)[rows]
        pad = np.zeros((M - len(rows),) + r.shape[1:], r.dtype)
        packed[name] = np.concatenate([r, pad])
        meta.append((name, ax, narrow))
    layout, buf = pack_arrays(packed)
    return {"fields": meta, "old": old, "new": new, "expected": expected,
            "rows": rows, "layout": layout, "buf": buf, "shards": shards,
            "n_per_shard": n_per_shard, "M": M}


def bind_hosts(state, pods, hosts) -> list:
    """Assign each pod to its chosen node in `state` (the binds a daemon
    makes between waves; None stays pending). -> the bound copies."""
    import copy

    bound = []
    for p, h in zip(pods, hosts):
        if h is None:
            continue
        q = copy.copy(p)
        q.spec = copy.copy(p.spec)
        q.spec.node_name = h
        state.assign(q)
        bound.append(q)
    return bound


def scatter_shard_tables(case: dict, s: int) -> dict:
    """Shard s's slice of a scatter_case's placed tables before the
    scatter (fresh contiguous numpy copies, one per field)."""
    import numpy as np

    n = case["n_per_shard"]
    out = {}
    for name, ax, _narrow in case["fields"]:
        a = case["old"][name]
        window = [slice(None)] * a.ndim
        window[ax] = slice(s * n, (s + 1) * n)
        out[name] = np.ascontiguousarray(a[tuple(window)])
    return out


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


# -- the optimizing profile's packing configs ---------------------------------

#: the SchedulerConfig of bench.py's pack_config2, as (predicates,
#: priorities): PodFitsResources, LeastRequested + BalancedAllocation
PACK_LRBA = (("PodFitsResources",),
             (("LeastRequestedPriority", 1),
              ("BalancedResourceAllocation", 1)))


def pack_config2(T, smoke=False, n_nodes=None) -> dict:
    """bench.py _pack_config2 for package T, the packed heterogeneous-
    request config: 64 nodes (smoke) or 1,000 (or n_nodes), each 4 CPU /
    32Gi / 110 pods (bench.py build), and per node a 1-CPU pod (1Gi or
    2Gi, alternating: two small templates) and a 3-CPU / 3Gi pod,
    interleaved, so demand equals capacity; greedy FIFO + LeastRequested
    strands the big tail. -> {"nodes", "pods", "services",
    "controllers", "config": PACK_LRBA, "alloc_mcpu": the cluster's
    allocatable millicores}."""
    if n_nodes is None:
        n_nodes = 64 if smoke else 1000
    nodes = [
        T.Node(
            metadata=T.ObjectMeta(name=f"node-{i:05d}"),
            status=T.NodeStatus(
                allocatable={"cpu": "4", "memory": "32Gi", "pods": "110"},
                conditions=[T.NodeCondition("Ready", "True")],
            ),
        )
        for i in range(n_nodes)
    ]

    def het(name, cpu, mem):
        return T.Pod(
            metadata=T.ObjectMeta(name=name),
            spec=T.PodSpec(containers=[T.Container(requests={
                "cpu": cpu, "memory": mem})]),
        )

    pods = []
    for i in range(n_nodes):
        pods.append(het(f"small-{i:05d}", "1000m",
                        "1Gi" if i % 2 else "2Gi"))
        pods.append(het(f"big-{i:05d}", "3000m", "3Gi"))
    services = [T.Service(metadata=T.ObjectMeta(name="sched-perf"),
                          spec=T.ServiceSpec(selector={"name": "sched-perf"}))]
    return {"nodes": nodes, "pods": pods, "services": services,
            "controllers": [], "config": PACK_LRBA,
            "alloc_mcpu": n_nodes * 4000}


def pack_config4(T, smoke=False) -> dict:
    """bench.py _pack_config4 for package T, the packed zoned-spread
    config: 48 nodes (smoke) or 999 over zones a/b/c (hostname and zone
    labels, 4 CPU / 32Gi / 110 pods) and two RC templates of complementary
    sizes (1 CPU / 1Gi, 3 CPU / 3Gi), a pod of each per node, interleaved,
    under the default provider (SelectorSpread active). -> pack_config2's
    dict, "config" None (the default provider)."""
    n_nodes = 48 if smoke else 999
    zones = ("a", "b", "c")
    nodes = [
        T.Node(
            metadata=T.ObjectMeta(
                name=f"znode-{i:05d}",
                labels={HOSTNAME: f"znode-{i:05d}", ZONE: zones[i % 3]},
            ),
            status=T.NodeStatus(
                allocatable={"cpu": "4", "memory": "32Gi", "pods": "110"},
                conditions=[T.NodeCondition("Ready", "True")],
            ),
        )
        for i in range(n_nodes)
    ]
    rcs = [T.ReplicationController(
        metadata=T.ObjectMeta(name=f"rc-{tag}"),
        spec=T.ReplicationControllerSpec(selector={"rc": f"rc-{tag}"}))
        for tag in ("small", "big")]
    pods = []
    for i in range(n_nodes):
        pods.append(T.Pod(
            metadata=T.ObjectMeta(name=f"rcs-{i:05d}",
                                  labels={"rc": "rc-small"}),
            spec=T.PodSpec(containers=[T.Container(requests={
                "cpu": "1000m", "memory": "1Gi"})]),
        ))
        pods.append(T.Pod(
            metadata=T.ObjectMeta(name=f"rcb-{i:05d}",
                                  labels={"rc": "rc-big"}),
            spec=T.PodSpec(containers=[T.Container(requests={
                "cpu": "3000m", "memory": "3Gi"})]),
        ))
    return {"nodes": nodes, "pods": pods, "services": [],
            "controllers": rcs, "config": None,
            "alloc_mcpu": n_nodes * 4000}


#: the pack configs by the keys of bench.py run_pack's record
PACK_CONFIGS = {"pack_config2": pack_config2, "pack_config4": pack_config4}


def pack_state(CS, cfg: dict):
    """A pack config's cluster as package CS's (oracle.ClusterState)."""
    return CS.build(cfg["nodes"], services=cfg["services"],
                    controllers=cfg["controllers"])


def pack_scheduler_config(B, cfg: dict):
    """A pack config's SchedulerConfig of package B's models/batch, or
    None for the default provider."""
    if cfg["config"] is None:
        return None
    predicates, priorities = cfg["config"]
    return B.SchedulerConfig(predicates=predicates, priorities=priorities)


def pack_outcome(pods, hosts, alloc_mcpu: int) -> dict:
    """bench.py run_pack's arm figures: pods scheduled, and the packed
    utilization (the placed pods' CPU requests over the cluster's
    allocatable CPU, rounded to 4 places as there)."""
    placed_mcpu = sum(
        int(str(p.spec.containers[0].requests["cpu"]).rstrip("m"))
        for p, h in zip(pods, hosts) if h is not None)
    return {"scheduled": sum(1 for h in hosts if h is not None),
            "pods": len(pods),
            "utilization": round(placed_mcpu / alloc_mcpu, 4)}


def pack_gang_wave(T, members, cpu="3000m", singles=0, name="gang"):
    """A gang of `members` pods of `cpu` / 1Gi at the head of a backlog,
    then `singles` 1-CPU pods: -> (backlog, the wave driver's gang layout
    [{"start", "length", "score_by_name"}])."""
    pods = [T.Pod(metadata=T.ObjectMeta(name=f"{name}-{i:05d}",
                                        labels={"app": name}),
                  spec=T.PodSpec(containers=[T.Container(requests={
                      "cpu": cpu, "memory": "1Gi"})]))
            for i in range(members)]
    pods += [T.Pod(metadata=T.ObjectMeta(name=f"{name}-single-{i:05d}",
                                         labels={"app": "single"}),
                   spec=T.PodSpec(containers=[T.Container(requests={
                       "cpu": "1000m", "memory": "1Gi"})]))
             for i in range(singles)]
    return pods, [{"start": 0, "length": members, "score_by_name": None}]


# -- the joint-assignment solve K7 --------------------------------------------

def assign_case(P, N, seed, kind="fuzz", n_live=None):
    """One joint-assignment problem (scheduler/optimizer/ops/assign.py's
    tables, numpy): -> {"fit" bool[P, N], "score" i64[P, N], "req",
    "commit" i64[P, 4], "check" bool[P, 4], "cap" i64[N, 4], "prio",
    "order" i32[P]}. Kinds:
      * "fuzz": tests/test_optimizer.py's solver fuzz (a fit mask of ~80 %,
        scores 0-39, requests of 0.5-3 CPU and 1-3 GiB, a tenth of the
        slots zero-request, capacities of 2-8 CPU, 4-32 GiB, 2-110 pods),
        with priority tiers 0-2 and FIFO ranks in order;
      * "ties": the fuzz with every score equal;
      * "ranks": the fuzz with repeated FIFO ranks (order drawn with
        repeats) and tiers 0-3: slots share winner keys;
      * "long": P >> N uncontended, each node seating P / N equal slots
        (tests/test_optimizer.py's long run when P = 256, N = 16);
      * "pack": the profile's tables on pack_config2's cluster, empty:
        n_live live nodes (4 CPU / 32Gi / 110 pods; the rest padding,
        fit False) and three templates interleaved (1 CPU / 1Gi, 1 CPU /
        2Gi, 3 CPU / 3Gi), each scoring every live node alike;
      * "clip": the fuzz with every even slot's order far below 0, so
        P - order clips at 2^16 - 1 and those slots share the key's low
        bits (the auction's general path);
      * "edge": "ties" where slots 0-2 are set up so that slot 2's best
        two nodes tie in round 1 on either side of the K7 auction
        kernel's first node-tile edge (columns e - 1 and e, e = 1,088 at
        N = 2,049; N // 2 when N fits one tile): slots 0 and 1 take them
        in round 0 with bids one apart, and no other slot fits them;
      * "long_ranks": "long" with each FIFO rank held by two slots;
      * "wide": the fuzz with memory requests of 2^61 - 3 x 2^61 bytes on
        nodes of 2^62 bytes to 2^63 - 1, so that used + req wraps in the
        int64 arithmetic the solvers share (the auction kernel's tiles
        then hold used and cap, not their difference);
      * "negcommit": the fuzz on nodes of 2-4 CPU where every third slot
        commits the negative of its request, so a placement can make a
        node feasible that was not (the beam's touched nodes);
      * "onenode": every node fits, one node (N // 3) scores 100 for
        every slot and holds them all, the rest score 0-39: the best
        beam lands every step on that node.
    The last P // 8 slots of "fuzz", "ties", "ranks", "clip", "negcommit",
    "edge" and "wide" are padding (all-False fit rows), as the profile's pow2
    slot bucket leaves them."""
    import numpy as np

    rng = np.random.RandomState(seed)
    gib = 1 << 30
    req = np.zeros((P, 4), np.int64)
    check = np.ones((P, 4), bool)
    cap = np.zeros((N, 4), np.int64)
    prio = np.zeros(P, np.int32)
    order = np.arange(P, dtype=np.int32)
    if kind in ("fuzz", "ties", "ranks", "clip", "negcommit", "edge",
                "wide"):
        fit = rng.rand(P, N) > 0.2
        fit[P - P // 8:] = False
        score = rng.randint(0, 40, size=(P, N)).astype(np.int64)
        if kind in ("ties", "edge"):
            score[:] = 7
        req[:, 0] = rng.choice([500, 1000, 2000, 3000], size=P)
        req[:, 1] = rng.choice([1, 2, 3], size=P) * gib
        req[:, 3] = 1
        zero = rng.rand(P) < 0.1
        check[zero, :3] = False
        req[zero, :3] = 0
        cap[:, 0] = rng.choice([2000, 4000, 8000], size=N)
        cap[:, 1] = rng.choice([4, 8, 32], size=N) * gib
        cap[:, 3] = rng.choice([2, 5, 110], size=N)
        prio = rng.randint(0, 3, size=P).astype(np.int32)
        if kind == "ranks":
            prio = rng.randint(0, 4, size=P).astype(np.int32)
            order = rng.randint(0, max(P // 4, 1), size=P).astype(np.int32)
        if kind == "clip":
            order[::2] = -70000 - order[::2]
        if kind == "negcommit":
            cap[:, 0] = 2000
        if kind == "wide":
            req[:, 1] = rng.choice([1, 2, 3], size=P) * (1 << 61)
            req[zero, 1] = 0
            cap[:, 1] = rng.choice([1 << 62, 3 << 61,
                                    np.iinfo(np.int64).max], size=N)
        if kind == "edge":
            tiles = -(-N // 2048)
            e = -(-(-(-N // tiles)) // 64) * 64 if tiles > 1 else N // 2
            a, b, z = e - 1, e, 5
            fit[:, [a, b]] = False
            fit[:3] = False
            fit[0, [a, z]] = fit[1, [b, z]] = fit[2, [a, b]] = True
            score[:3] = 0
            score[0, a] = score[1, b] = 1
            req[:3] = [500, gib, 0, 1]
            check[:3] = True
            cap[[a, b, z]] = [8000, 32 * gib, 0, 110]
            prio[:3] = 0
    elif kind in ("long", "long_ranks"):
        fit = np.ones((P, N), bool)
        score = np.zeros((P, N), np.int64)
        req[:, 0] = 250
        req[:, 3] = 1
        cap[:, 0] = 250 * (P // N)
        cap[:, 3] = 110
        if kind == "long_ranks":
            order = order // 2
    elif kind == "onenode":
        fit = np.ones((P, N), bool)
        score = rng.randint(0, 40, size=(P, N)).astype(np.int64)
        score[:, N // 3] = 100
        req[:, 0] = rng.choice([500, 1000, 2000], size=P)
        req[:, 1] = gib
        req[:, 3] = 1
        cap[:, 0] = 4000
        cap[:, 1] = 32 * gib
        cap[:, 3] = 110
        cap[N // 3, 0] = 2000 * P
        cap[N // 3, 1] = P * gib
    elif kind == "pack":
        n_live = N if n_live is None else n_live
        fit = np.zeros((P, N), bool)
        fit[:, :n_live] = True
        tpl = np.arange(P) % 3
        reqs = np.array([[1000, 1 * gib, 0, 1], [1000, 2 * gib, 0, 1],
                         [3000, 3 * gib, 0, 1]], np.int64)
        req[:] = reqs[tpl]
        score = np.zeros((P, N), np.int64)
        score[:, :n_live] = np.array([19, 19, 17])[tpl][:, None]
        cap[:n_live] = [4000, 32 * gib, 0, 110]
    else:
        raise ValueError(f"assign_case: unknown kind {kind!r}")
    commit = req.copy()
    if kind == "negcommit":
        commit[::3] = -req[::3]
    return {"fit": fit, "score": score, "req": req, "commit": commit,
            "check": check, "cap": cap, "prio": prio, "order": order}


#: (label, P, N, kind, live nodes or None, solver) of the K7 checks: the
#: solver fuzz's shapes (P of 8, 24 and 48 over 8 and 16 nodes, not
#: powers of two), ties, repeated ranks, a run past 64 rounds, and the
#: shapes of the optimizing profile's solves on the card: pack_config2's
#: full solve (2,000 slots in a 2,048 bucket over 1,000 of 1,024 nodes),
#: the largest solve under the default slot cap at the density node count
#: (4,096 slots over 5,000 of 8,192 nodes), and beams of 24 and 16 slots;
#: then an auction over two node tiles of the kernel (N = 2,049, equal
#: scores, a tie across the tile edge), clipped FIFO ranks and a long run
#: with repeated ranks (the general path), a beam whose placements free
#: capacity, one whose every step lands on one node, a beam at the
#: kernel's largest P, 64, and both solvers where used + req wraps
ASSIGN_CASES = (
    ("fuzz P=8 N=8", 8, 8, "fuzz", None, "beam"),
    ("fuzz P=24 N=16", 24, 16, "fuzz", None, "beam"),
    ("fuzz P=48 N=16", 48, 16, "fuzz", None, "auction"),
    ("fuzz P=48 N=8", 48, 8, "fuzz", None, "auction"),
    ("fuzz P=100 N=37", 100, 37, "fuzz", None, "auction"),
    ("ties P=64 N=16", 64, 16, "ties", None, "auction"),
    ("ties P=24 N=16", 24, 16, "ties", None, "beam"),
    ("ranks P=96 N=24", 96, 24, "ranks", None, "auction"),
    ("ranks P=32 N=8", 32, 8, "ranks", None, "beam"),
    ("long P=256 N=16", 256, 16, "long", None, "auction"),
    ("pack P=2048 N=1024", 2048, 1024, "pack", 1000, "auction"),
    ("pack P=4096 N=8192", 4096, 8192, "pack", 5000, "auction"),
    ("beam P=32 N=1024", 32, 1024, "pack", 1000, "beam"),
    ("beam P=16 N=8192", 16, 8192, "pack", 5000, "beam"),
    ("fuzz beam P=32 N=1024", 32, 1024, "fuzz", None, "beam"),
    ("edge P=40 N=2049", 40, 2049, "edge", None, "auction"),
    ("clip P=48 N=16", 48, 16, "clip", None, "auction"),
    ("long ranks P=256 N=16", 256, 16, "long_ranks", None, "auction"),
    ("negcommit P=24 N=16", 24, 16, "negcommit", None, "beam"),
    ("onenode P=32 N=64", 32, 64, "onenode", None, "beam"),
    ("fuzz beam P=64 N=128", 64, 128, "fuzz", None, "beam"),
    ("wide P=48 N=16", 48, 16, "wide", None, "auction"),
    ("wide beam P=24 N=16", 24, 16, "wide", None, "beam"),
)

#: auctions wider than ASSIGN_CASES, checked on the card only: past 32
#: node tiles (a row's partials folded several to a lane) and past the
#: tiles an H100 holds in shared memory (132 SMs x 2,048 nodes; beyond,
#: one tile a co-resident block, its node state in device memory)
ASSIGN_WIDE_CASES = (
    ("tiles P=64 N=100000", 64, 100000, "fuzz", None, "auction"),
    ("slab P=64 N=270337", 64, 270337, "fuzz", None, "auction"),
)
