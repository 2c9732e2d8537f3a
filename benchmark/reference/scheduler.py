"""A plain NumPy scheduler for a FIFO backlog of pod templates.

It follows the decision rules of the 1.2/1.3 default provider as the
Go scheduler (plugin/pkg/scheduler) states them:

- predicates: PodFitsResources (pod count, CPU, memory, with the
  zero-request shortcut); the description carries nothing that the
  other default predicates read (host name, ports, node selector,
  volumes, taints, affinity), and a field the reference does not
  implement is refused as input;
- priorities, each weight 1, over the nodes that fit:
  LeastRequestedPriority (int64, truncating), BalancedResourceAllocation
  (float64 fractions), SelectorSpreadPriority (float32, zones weighted
  2/3, 0/0 giving NaN and int(NaN) the smallest int64 as on amd64),
  NodeAffinityPriority (0: no preferred terms), TaintTolerationPriority
  (10: no taints), InterPodAffinityPriority (0: no affinity);
- selectHost: the highest score, ties ordered by node name descending,
  the tie lastNodeIndex % ties chosen, lastNodeIndex advanced once a
  scheduled pod;
- each scheduled pod assumed onto its node before the next.

It reads the plain cluster description of benchmark/traffic.py and
nothing that the program computed.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import quantity

#: SelectorSpreadPriority's zone weighting (selector_spreading.go) and
#: the maximum priority
ZONE_WEIGHTING = 2.0 / 3.0
MAX_PRIORITY = 10
#: Go's int(NaN) on amd64
INT64_MIN = np.iinfo(np.int64).min
#: the nonzero defaults a container without a request counts in the
#: priorities (priorities.go getNonzeroRequests)
DEFAULT_MILLI_CPU = 100
DEFAULT_MEMORY = 200 * 1024 * 1024
ZONE_LABEL = "failure-domain.beta.kubernetes.io/zone"
REGION_LABEL = "failure-domain.beta.kubernetes.io/region"


def round_bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even),
    kept in float32; NaN stays NaN."""
    x = np.asarray(x, np.float32)
    bits = x.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    out = bits.astype(np.uint32).view(np.float32)
    return np.where(np.isnan(x), np.float32(np.nan), out)


def _selects(selector: dict, labels: dict) -> bool:
    return all(labels.get(k) == v for k, v in selector.items())


def container_requests(containers) -> tuple:
    """-> (requested milli-CPU, requested bytes, nonzero milli-CPU,
    nonzero bytes) summed over containers."""
    cpu = mem = nz_cpu = nz_mem = 0
    for c in containers:
        if set(c) - {"requests"} or set(c.get("requests", {})) - {"cpu",
                                                                  "memory"}:
            raise ValueError(f"container fields the reference does not "
                             f"implement: {c}")
        req = c.get("requests", {})
        c_cpu = quantity.milli(req["cpu"]) if "cpu" in req else 0
        c_mem = quantity.units(req["memory"]) if "memory" in req else 0
        cpu += c_cpu
        mem += c_mem
        nz_cpu += c_cpu if "cpu" in req else DEFAULT_MILLI_CPU
        nz_mem += c_mem if "memory" in req else DEFAULT_MEMORY
    return cpu, mem, nz_cpu, nz_mem


def _zone_key(labels: dict) -> str:
    region = labels.get(REGION_LABEL, "")
    zone = labels.get(ZONE_LABEL, "")
    if not region and not zone:
        return ""
    return region + ":\x00:" + zone


class Cluster:
    """One cluster state of the description, as arrays over its nodes in
    descending name order (the order selectHost breaks ties in). The
    pods on each node are kept as resource sums and as counts by label
    set, which is all SelectorSpread reads of them."""

    def __init__(self, state: dict, services=(), controllers=(),
                 namespace: str = "default"):
        nodes = sorted(state["nodes"], key=lambda n: n["name"], reverse=True)
        for n in nodes:
            unknown = set(n) - {"name", "allocatable", "labels"}
            if unknown:
                raise ValueError(f"node fields the reference does not "
                                 f"implement: {sorted(unknown)}")
        self.names = np.array([n["name"] for n in nodes], dtype=object)
        self.pos = {n["name"]: i for i, n in enumerate(nodes)}
        N = len(nodes)
        alloc = [n["allocatable"] for n in nodes]
        self.alloc_cpu = np.array([quantity.milli(a.get("cpu", 0))
                                   for a in alloc], np.int64)
        self.alloc_mem = np.array([quantity.units(a.get("memory", 0))
                                   for a in alloc], np.int64)
        self.alloc_pods = np.array([quantity.units(a.get("pods", 0))
                                    for a in alloc], np.int64)
        keys = [_zone_key(n.get("labels", {})) for n in nodes]
        zones = sorted({k for k in keys if k})
        self.num_zones = len(zones)
        zid = {k: i for i, k in enumerate(zones)}
        # nodes without a zone take the row past the last zone
        self.zone = np.array([zid.get(k, len(zones)) for k in keys], np.int64)
        self.all_selectors = [s["selector"]
                              for s in (*services, *controllers)
                              if s.get("namespace", namespace) == namespace]
        if any(not s for s in self.all_selectors):
            raise ValueError("an empty selector: the reference does not "
                             "implement it")
        # SelectorSpread's node terms by (max_count, bf16)
        self._node_terms = {}

        self.req_cpu = np.zeros(N, np.int64)
        self.req_mem = np.zeros(N, np.int64)
        self.nz_cpu = np.zeros(N, np.int64)
        self.nz_mem = np.zeros(N, np.int64)
        self.npods = np.zeros(N, np.int64)
        # {label items: pods with those labels on each node}
        self.by_labels = {}
        for b in state["bound"]:
            unknown = set(b) - {"name", "node", "labels", "containers"}
            if unknown:
                raise ValueError(f"bound pod fields the reference does not "
                                 f"implement: {sorted(unknown)}")
            placed = np.zeros(N, np.int64)
            placed[self.pos[b["node"]]] = 1
            self._add(placed, b.get("labels", {}),
                      container_requests(b["containers"]))

    def _add(self, placed: np.ndarray, labels: dict, requests) -> None:
        """Assume `placed` more pods of one template on each node."""
        cpu, mem, nz_cpu, nz_mem = requests
        self.req_cpu += placed * cpu
        self.req_mem += placed * mem
        self.nz_cpu += placed * nz_cpu
        self.nz_mem += placed * nz_mem
        self.npods += placed
        key = tuple(sorted(labels.items()))
        if key not in self.by_labels:
            self.by_labels[key] = np.zeros(len(self.names), np.int64)
        self.by_labels[key] += placed

    def _use(self, group: dict) -> None:
        """Make `group` the template the per-node terms are for."""
        unknown = set(group) - {"name", "labels", "containers", "count"}
        if unknown:
            raise ValueError(f"pod fields the reference does not "
                             f"implement: {sorted(unknown)}")
        self.pod_labels = group.get("labels", {})
        self.pod_requests = container_requests(group["containers"])
        (self.pod_cpu, self.pod_mem, self.pod_nz_cpu,
         self.pod_nz_mem) = self.pod_requests
        self.selectors = [s for s in self.all_selectors
                          if _selects(s, self.pod_labels)]
        self.self_match = int(bool(self.selectors))
        # pods on each node that one of the template's selectors selects
        self.match = np.zeros(len(self.names), np.int64)
        for key, counts in self.by_labels.items():
            if any(_selects(s, dict(key)) for s in self.selectors):
                self.match += counts

    # -- the per-node terms, for k more pods of the template on each node --

    def fits(self, k) -> np.ndarray:
        """PodFitsResources of one more pod of the template on each node
        that already holds k more of them ([N] or [N, K])."""
        k = np.asarray(k)
        idx = (slice(None),) + (None,) * (k.ndim - 1)
        ok = self.npods[idx] + k + 1 <= self.alloc_pods[idx]
        if self.pod_cpu == 0 and self.pod_mem == 0:
            return ok
        return (ok & (self.alloc_cpu[idx]
                      >= self.pod_cpu * (k + 1) + self.req_cpu[idx])
                & (self.alloc_mem[idx]
                   >= self.pod_mem * (k + 1) + self.req_mem[idx]))

    def resource_scores(self, k) -> np.ndarray:
        """LeastRequestedPriority + BalancedResourceAllocation of one
        more pod of the template on each node that already holds k more
        of them ([N] or [N, K])."""
        k = np.asarray(k)
        idx = (slice(None),) + (None,) * (k.ndim - 1)
        cpu = self.nz_cpu[idx] + self.pod_nz_cpu * (k + 1)
        mem = self.nz_mem[idx] + self.pod_nz_mem * (k + 1)
        cap_cpu, cap_mem = self.alloc_cpu[idx], self.alloc_mem[idx]

        def least(req, cap):
            safe = np.where(cap == 0, 1, cap)
            s = ((cap - req) * 10) // safe
            return np.where((cap == 0) | (req > cap), 0, s)

        lr = (least(cpu, cap_cpu) + least(mem, cap_mem)) // 2
        cpu_frac = np.where(cap_cpu == 0, 1.0,
                            cpu / np.where(cap_cpu == 0, 1, cap_cpu))
        mem_frac = np.where(cap_mem == 0, 1.0,
                            mem / np.where(cap_mem == 0, 1, cap_mem))
        diff = np.abs(cpu_frac - mem_frac)
        ba = np.trunc(10 - diff * 10).astype(np.int64)
        ba = np.where((cpu_frac >= 1) | (mem_frac >= 1), 0, ba)
        return lr + ba

    def spread_scores(self, max_count: int, zone_counts: np.ndarray,
                      have_zones: bool, bf16: bool = False) -> np.ndarray:
        """SelectorSpreadPriority as a table [zone row, pods of the
        template's selectors on the node] -> int64 score, for counts
        0..max_count; the last row is for nodes without a zone.
        bf16=True rounds each float32 operation to bfloat16 (the
        control)."""
        r = round_bf16 if bf16 else (lambda x: x)
        f32 = np.float32
        ten = f32(MAX_PRIORITY)
        key = (max_count, bf16)
        if key not in self._node_terms:
            c = np.arange(max_count + 1).astype(f32)
            if max_count > 0:
                node = r(ten * r(r(f32(max_count) - c) / r(f32(max_count))))
            else:
                node = np.full(1, ten, f32)
            self._node_terms[key] = (
                np.trunc(node).astype(np.int64),
                r(node * r(f32(1.0 - ZONE_WEIGHTING))))
        node_score, node_part = self._node_terms[key]
        rows = np.empty((self.num_zones + 1, max_count + 1), np.int64)
        rows[self.num_zones] = node_score
        if not have_zones:
            rows[:self.num_zones] = node_score
            return rows
        max_zone = f32(zone_counts.max())
        if max_zone == 0:
            # 0/0: NaN, and int(NaN) on amd64
            rows[:self.num_zones] = INT64_MIN
            return rows
        zs = r(ten * r(r(max_zone - zone_counts.astype(f32)) / r(max_zone)))
        zone_part = r(r(f32(ZONE_WEIGHTING)) * zs)
        # both terms are >= 0, so the cast truncates as int() does
        rows[:self.num_zones] = r(node_part[None, :]
                                  + zone_part[:, None]).astype(np.int64)
        return rows

    # -- the backlog ----------------------------------------------------------

    def _tables(self, count: int):
        """Each node's fit and resource scores with 0..K-1 more pods of
        the template on it, K past the most any node can take or past
        count. -> (fit [N, K], scores [N, K])."""
        K = int(min(count, max(int((self.alloc_pods - self.npods).max()),
                               0))) + 1
        ks = np.broadcast_to(np.arange(K), (len(self.names), K))
        return self.fits(ks), self.resource_scores(ks)

    def room(self, groups) -> int:
        """Pods that the nodes take whatever the picks: each node as many
        as fit there with the largest request of the groups in every
        resource. A backlog of at most this many has every pod placed."""
        reqs = [container_requests(g["containers"]) for g in groups]
        cpu = max(r[0] for r in reqs)
        mem = max(r[1] for r in reqs)
        free = self.alloc_pods - self.npods
        if cpu or mem:
            if cpu:
                free = np.minimum(free, (self.alloc_cpu - self.req_cpu) // cpu)
            if mem:
                free = np.minimum(free, (self.alloc_mem - self.req_mem) // mem)
        return int(np.maximum(free, 0).sum())

    def schedule(self, groups, last_node_index: int, bf16: bool = False):
        """Schedule the groups' pods in FIFO order, each assumed before
        the next. The cluster itself is left as it was. -> (chosen node
        name per pod, None where nothing fits; lastNodeIndex after; the
        sum over the picks of the nodes that fit at each)."""
        saved = ([a.copy() for a in (self.req_cpu, self.req_mem,
                                     self.nz_cpu, self.nz_mem, self.npods)],
                 {k: v.copy() for k, v in self.by_labels.items()})
        out, node_picks = [], 0
        try:
            for g in groups:
                self._use(g)
                names, placed, last_node_index, picks = self._run(
                    g["count"], last_node_index, bf16)
                self._add(placed, self.pod_labels, self.pod_requests)
                out.extend(names)
                node_picks += picks
        finally:
            ((self.req_cpu, self.req_mem, self.nz_cpu, self.nz_mem,
              self.npods), self.by_labels) = saved
        return out, last_node_index, node_picks

    def _run(self, count: int, last_node_index: int, bf16: bool):
        """`count` pods of the current template. -> (names, pods placed
        on each node, lastNodeIndex after, node picks)."""
        N = len(self.names)
        fit_k, base_k = self._tables(count)
        K = fit_k.shape[1]
        placed = np.zeros(N, np.int64)
        match = self.match.copy()
        fit = fit_k[:, 0].copy()
        base = base_k[:, 0].copy()
        # NodeAffinity 0 + TaintToleration 10 + InterPodAffinity 0
        const = 10
        width = int(match.max()) + count + 1
        table = np.zeros((self.num_zones + 1, width), np.int64)
        zone = self.zone
        out = [None] * count
        node_picks = 0
        idx = None  # the nodes that fit, when not all do
        stale = True
        for p in range(count):
            if stale:
                idx = None if fit.all() else np.flatnonzero(fit)
                if idx is not None and len(idx) == 0:
                    break
                z_fit = zone if idx is None else zone[idx]
                m_fit = match if idx is None else match[idx]
                zone_counts = np.bincount(
                    z_fit, weights=m_fit, minlength=self.num_zones + 1
                )[:self.num_zones].astype(np.int64)
                have_zones = bool(self.selectors) and bool(
                    (z_fit < self.num_zones).any())
                max_count = int(m_fit.max()) if self.selectors else 0
                lin = zone * width + (match if self.selectors else 0)
                stale = False
            table[:, :max_count + 1] = self.spread_scores(
                max_count, zone_counts, have_zones, bf16=bf16)
            if idx is None:
                total = base + table.ravel().take(lin) + const
                ties = np.flatnonzero(total == total.max())
                i = int(ties[last_node_index % len(ties)])
                node_picks += N
            else:
                total = base[idx] + table.ravel().take(lin[idx]) + const
                ties = np.flatnonzero(total == total.max())
                i = int(idx[ties[last_node_index % len(ties)]])
                node_picks += len(idx)
            last_node_index += 1
            out[p] = self.names[i]
            placed[i] += 1
            if self.self_match:
                match[i] += 1
                lin[i] += 1
                if zone[i] < self.num_zones:
                    zone_counts[zone[i]] += 1
                max_count = max(max_count, int(match[i]))
            if placed[i] < K:
                base[i] = base_k[i, placed[i]]
                still = bool(fit_k[i, placed[i]])
            else:
                still = False
            if not still:
                fit[i] = False
                stale = True
        return out, placed, last_node_index, node_picks
