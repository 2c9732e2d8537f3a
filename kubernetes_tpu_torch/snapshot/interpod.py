"""Inter-pod (anti-)affinity compilation: terms -> counting tables.

The reference's MatchInterPodAffinity predicate (predicates.go:754-947) and
InterPodAffinityPriority (interpod_affinity.go:86-216) are O(nodes x pods x
terms) scans over object graphs. The tensor formulation observes that every
check is a *pair count*: "how many assigned pods match term T's
(namespace-set, selector) and are co-located with node n under T's
topology key". We therefore compile:

- **specs** `s`: distinct (namespace-set, label-selector) pairs. Whether a
  pod matches a spec is computed host-side (same code path as the oracle,
  so semantics are bit-identical) into per-pod bitmaps.
- **topology combos** `q`: conjunctions of topology keys. Each node gets a
  dense domain id per combo (`topo_dom[q, n]`, -1 when any key is missing:
  NodesHaveSameTopologyKey requires non-empty equal values,
  util/non_zero.go:97-113). Two nodes are co-located under the combo iff
  their domain ids are equal and valid.
- **term classes** `u = (s, q)`: the unit of counting. The scheduler carry
  holds `count[u, domain]` tables; committing a pod to node n scatter-adds
  its spec-match bits at `topo_dom[q(u), n]`.
- **logical terms** `lt = (s, topology_key)`: what pods reference. A term
  with a non-empty key expands to one (u, +1). The empty key means "any
  default failure domain" (an OR), which we count exactly by
  inclusion-exclusion over the 2^3-1 key subsets with alternating signs —
  `count(A or B or C) = sum_singles - sum_pairs + triple`.

Five carry tables cover every direction the reference checks:
  term_count  — `(U, D)`: assigned pods *matching* spec(u), at their
                node's domain (forward hard affinity / own anti-affinity /
                fwd priority). Keyed by term class u=(s,q): a pod's match
                depends only on the spec, so sharing u between logical
                terms is sound here.
  own_anti    — `(LT, E, D)`: assigned pods *owning* a hard anti-affinity
                term (the symmetric check, predicates.go:858-921)
  rev_hard    — `(LT, E, D)`: assigned pods owning a hard affinity term
                (priority reverse pass, hardPodAffinityWeight)
  rev_pref    — `(LT, E, D)`: summed weights of owned preferred terms
  rev_anti    — `(LT, E, D)`: same for preferred anti-affinity
plus `spec_total[s]` — assigned pods matching spec s anywhere (topology
ignored), for the first-pod-of-collection escape (predicates.go:819-843).

Owned-term tables are keyed per LOGICAL term with one domain column per
expansion slot, NOT per (spec, combo) class: two terms sharing a class
(say a zone-key term and an empty-key term over the same selector) would
otherwise pollute each other's inclusion-exclusion sums.

Copy of kubernetes_tpu/snapshot/interpod.py: only the import package differs.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kubernetes_tpu_torch.api.types import Pod, get_affinity
from kubernetes_tpu_torch.oracle.predicates import (
    DEFAULT_FAILURE_DOMAINS,
    get_namespaces_from_term,
    label_selector_as_selector,
)
from kubernetes_tpu_torch.oracle.state import ClusterState


def _selector_canon(sel) -> object:
    if sel is None:
        return None
    return (
        tuple(sorted((sel.match_labels or {}).items())),
        tuple(
            (e.key, e.operator, tuple(e.values or ()))
            for e in (sel.match_expressions or ())
        ),
    )


@dataclass
class InterPodProgram:
    """Compiled tables. Shapes: Q combos x N nodes; U term classes; LT
    logical terms x E expansion slots; S specs x D domains; P pending pods
    x per-pod term widths. All zero-width when the workload has no
    inter-pod affinity anywhere — the device kernels then compile away."""

    # static (ClusterSnapshot side)
    topo_dom: np.ndarray  # i32 (Q, N)
    u_topo: np.ndarray  # i32 (U,)
    u_spec: np.ndarray  # i32 (U,)
    lt_spec: np.ndarray  # i32 (LT,)
    lt_u: np.ndarray  # i32 (LT, E), -1 pad
    lt_sign: np.ndarray  # i8 (LT, E)
    # initial carry (ClusterSnapshot side)
    term_count: np.ndarray  # i32 (U, D)
    own_anti: np.ndarray  # i32 (LT, E, D)
    rev_hard: np.ndarray  # i32 (LT, E, D)
    rev_pref: np.ndarray  # i64 (LT, E, D)
    rev_anti: np.ndarray  # i64 (LT, E, D)
    spec_total: np.ndarray  # i32 (S,)
    # pending-pod arrays (PodBatch side)
    match_spec: np.ndarray  # i8 (P, S)
    ha_lt: np.ndarray  # i32 (P, TA), -1 pad — hard affinity terms
    ha_self: np.ndarray  # bool (P, TA) — pod matches its own term
    hq_lt: np.ndarray  # i32 (P, TQ), -1 pad — hard anti terms
    fwd_lt: np.ndarray  # i32 (P, TF), -1 pad — preferred terms
    fwd_w: np.ndarray  # i64 (P, TF) — signed weights (anti negative)
    own_hard: np.ndarray  # i32 (P, LT)
    own_pref: np.ndarray  # i64 (P, LT)
    own_anti_hard: np.ndarray  # i32 (P, LT)
    own_anti_pref: np.ndarray  # i64 (P, LT)
    has_affinity: np.ndarray  # bool (P,)
    has_anti: np.ndarray  # bool (P,)
    sym_reject: np.ndarray  # bool (P,) — fails everywhere (unknown-node
    #   anti owner matches this pod, or a poisoned symmetric scan)
    poison: bool  # an assigned pod's affinity fails to parse =>
    #   InterPodAffinityPriority errors for EVERY pod (interpod_affinity.go
    #   parses all pods; the error aborts the scheduling cycle)


class _Vocab:
    def __init__(self):
        self.ids: Dict[object, int] = {}
        self.items: List[object] = []

    def get(self, key) -> int:
        i = self.ids.get(key)
        if i is None:
            i = len(self.items)
            self.ids[key] = i
            self.items.append(key)
        return i

    def __len__(self):
        return len(self.items)


class InterPodCompiler:
    def __init__(
        self,
        state: ClusterState,
        pods: Sequence[Pod],
        node_names: Sequence[str],
        default_keys: Sequence[str] = DEFAULT_FAILURE_DOMAINS,
    ):
        self.state = state
        self.pods = list(pods)
        self.node_names = list(node_names)
        self.node_id = {n: i for i, n in enumerate(self.node_names)}
        self.default_keys = tuple(default_keys)
        self.specs = _Vocab()  # (ns_frozenset, sel_canon) -> s
        self.spec_impl: List[Tuple[frozenset, object]] = []  # (names, selector)
        self.topos = _Vocab()  # tuple(keys) -> q
        self.units = _Vocab()  # (s, q) -> u
        self.lts = _Vocab()  # (s, topology_key) -> lt
        self.lt_expansion: List[List[Tuple[int, int]]] = []  # lt -> [(u, sign)]

    # -- interning -----------------------------------------------------------

    def _spec_id(self, owner: Pod, term) -> int:
        names = get_namespaces_from_term(owner, term)
        sel = label_selector_as_selector(term.label_selector)
        key = (frozenset(names), _selector_canon(term.label_selector))
        s = self.specs.get(key)
        if s == len(self.spec_impl):
            self.spec_impl.append((frozenset(names), sel))
        return s

    def _combos(self, topology_key: str) -> List[Tuple[Tuple[str, ...], int]]:
        """Inclusion-exclusion expansion of a topology spec into key
        conjunctions with signs."""
        if topology_key:
            return [((topology_key,), 1)]
        out = []
        for r in range(1, len(self.default_keys) + 1):
            sign = 1 if r % 2 == 1 else -1
            for keys in combinations(self.default_keys, r):
                out.append((tuple(sorted(keys)), sign))
        return out

    def _lt_id(self, owner: Pod, term) -> int:
        s = self._spec_id(owner, term)
        key = (s, term.topology_key)
        lt = self.lts.get(key)
        if lt == len(self.lt_expansion):
            exp = []
            for keys, sign in self._combos(term.topology_key):
                q = self.topos.get(keys)
                u = self.units.get((s, q))
                exp.append((u, sign))
            self.lt_expansion.append(exp)
        return lt

    def _pod_matches_spec(self, pod: Pod, s: int) -> bool:
        names, sel = self.spec_impl[s]
        if names and pod.namespace not in names:
            return False
        return sel.matches(pod.metadata.labels)

    def _pod_self_match(self, pod: Pod, s: int) -> bool:
        """First-pod-of-collection self check (predicates.go:826-832):
        `names.Has(pod.Namespace)` is a LITERAL set membership — the empty
        all-namespaces set contains nothing, so the escape is denied."""
        names, sel = self.spec_impl[s]
        return pod.namespace in names and sel.matches(pod.metadata.labels)

    @staticmethod
    def _affinity(pod: Pod):
        """(affinity, parse_ok)."""
        try:
            return get_affinity(pod), True
        except Exception:
            return None, False

    # -- compilation ---------------------------------------------------------

    def compile(self) -> InterPodProgram:
        state, pods = self.state, self.pods
        assigned = state.all_assigned_pods()

        # pass 1: intern every term reachable from any pod.
        a_parsed = []  # (aff, ok) per assigned pod
        for ep in assigned:
            aff, ok = self._affinity(ep)
            a_parsed.append((aff, ok))
            if aff is None:
                continue
            for side in (aff.pod_affinity, aff.pod_anti_affinity):
                if side is None:
                    continue
                for t in side.required_during_scheduling_ignored_during_execution:
                    self._lt_id(ep, t)
                for wt in side.preferred_during_scheduling_ignored_during_execution:
                    self._lt_id(ep, wt.pod_affinity_term)
        p_parsed = []
        for pod in pods:
            aff, ok = self._affinity(pod)
            p_parsed.append((aff, ok))
            if aff is None:
                continue
            for side in (aff.pod_affinity, aff.pod_anti_affinity):
                if side is None:
                    continue
                for t in side.required_during_scheduling_ignored_during_execution:
                    self._lt_id(pod, t)
                for wt in side.preferred_during_scheduling_ignored_during_execution:
                    self._lt_id(pod, wt.pod_affinity_term)

        S, Q, U, LT = len(self.specs), len(self.topos), len(self.units), len(self.lts)
        N, P = len(self.node_names), len(pods)
        E = max([1] + [len(e) for e in self.lt_expansion])

        # topology domains per combo
        topo_dom = np.full((Q, N), -1, np.int32)
        n_dom = 1
        for q, keys in enumerate(self.topos.items):
            vals: Dict[Tuple[str, ...], int] = {}
            for n, name in enumerate(self.node_names):
                node = state.node_infos[name].node
                vv = tuple(node.metadata.labels.get(k, "") for k in keys)
                if any(v == "" for v in vv):
                    continue  # missing/empty label => never co-located
                d = vals.setdefault(vv, len(vals))
                topo_dom[q, n] = d
            n_dom = max(n_dom, len(vals))
        D = n_dom

        u_topo = np.zeros(U, np.int32)
        u_spec = np.zeros(U, np.int32)
        for (s, q), u in self.units.ids.items():
            u_spec[u], u_topo[u] = s, q
        lt_spec = np.zeros(LT, np.int32)
        lt_u = np.full((LT, E), -1, np.int32)
        lt_sign = np.zeros((LT, E), np.int8)
        for (s, _k), lt in self.lts.ids.items():
            lt_spec[lt] = s
            for e, (u, sign) in enumerate(self.lt_expansion[lt]):
                lt_u[lt, e], lt_sign[lt, e] = u, sign

        # initial carry from assigned pods
        term_count = np.zeros((U, max(1, D)), np.int32)
        own_anti = np.zeros((LT, E, max(1, D)), np.int32)
        rev_hard = np.zeros((LT, E, max(1, D)), np.int32)
        rev_pref = np.zeros((LT, E, max(1, D)), np.int64)
        rev_anti = np.zeros((LT, E, max(1, D)), np.int64)
        spec_total = np.zeros(max(0, S), np.int32)
        poison = False
        # (spec, ) anti-affinity specs owned by assigned pods on UNKNOWN
        # nodes: the symmetric check rejects every node for pods matching
        # them (oracle predicates.py `ep_node is None` branch).
        unknown_anti_specs: List[int] = []

        def _dom_of(u: int, n: int) -> int:
            return int(topo_dom[u_topo[u], n])

        for ep, (aff, ok) in zip(assigned, a_parsed):
            if not ok:
                poison = True
            m = np.array(
                [self._pod_matches_spec(ep, s) for s in range(S)], np.int32
            ) if S else np.zeros(0, np.int32)
            spec_total += m
            n = self.node_id.get(ep.spec.node_name, -1)
            if n >= 0:
                for u in range(U):
                    d = _dom_of(u, n)
                    if d >= 0 and m[u_spec[u]]:
                        term_count[u, d] += 1
            if aff is None:
                continue

            def _own(side_terms, table, weight_of=None):
                """Record ep's owned terms at its node's domains, one slot
                per expansion entry (the query re-applies the signs)."""
                for item in side_terms:
                    term = item if weight_of is None else item.pod_affinity_term
                    w = 1 if weight_of is None else weight_of(item)
                    lt = self._lt_id(ep, term)
                    if n < 0:
                        continue
                    for e, (u, _sign) in enumerate(self.lt_expansion[lt]):
                        d = _dom_of(u, n)
                        if d >= 0:
                            table[lt, e, d] += w
                return None

            if aff.pod_affinity is not None:
                _own(
                    aff.pod_affinity.required_during_scheduling_ignored_during_execution,
                    rev_hard,
                )
                _own(
                    aff.pod_affinity.preferred_during_scheduling_ignored_during_execution,
                    rev_pref,
                    lambda wt: wt.weight,
                )
            if aff.pod_anti_affinity is not None:
                for term in aff.pod_anti_affinity.required_during_scheduling_ignored_during_execution:
                    lt = self._lt_id(ep, term)
                    if n < 0:
                        unknown_anti_specs.append(int(lt_spec[lt]))
                    else:
                        for e, (u, _sign) in enumerate(self.lt_expansion[lt]):
                            d = _dom_of(u, n)
                            if d >= 0:
                                own_anti[lt, e, d] += 1
                _own(
                    aff.pod_anti_affinity.preferred_during_scheduling_ignored_during_execution,
                    rev_anti,
                    lambda wt: wt.weight,
                )

        # pending-pod arrays
        ha_lists: List[List[Tuple[int, bool]]] = []
        hq_lists: List[List[int]] = []
        fwd_lists: List[List[Tuple[int, int]]] = []
        for pod, (aff, ok) in zip(pods, p_parsed):
            ha, hq, fwd = [], [], []
            if aff is not None:
                if aff.pod_affinity is not None:
                    for t in aff.pod_affinity.required_during_scheduling_ignored_during_execution:
                        lt = self._lt_id(pod, t)
                        ha.append((lt, self._pod_self_match(pod, int(lt_spec[lt]))))
                    for wt in aff.pod_affinity.preferred_during_scheduling_ignored_during_execution:
                        if wt.weight == 0:
                            continue  # interpod_affinity.go:107 skips
                        fwd.append((self._lt_id(pod, wt.pod_affinity_term), wt.weight))
                if aff.pod_anti_affinity is not None:
                    for t in aff.pod_anti_affinity.required_during_scheduling_ignored_during_execution:
                        hq.append(self._lt_id(pod, t))
                    for wt in aff.pod_anti_affinity.preferred_during_scheduling_ignored_during_execution:
                        if wt.weight == 0:
                            continue
                        fwd.append(
                            (self._lt_id(pod, wt.pod_affinity_term), -wt.weight)
                        )
            ha_lists.append(ha)
            hq_lists.append(hq)
            fwd_lists.append(fwd)

        TA = max([1] + [len(x) for x in ha_lists])
        TQ = max([1] + [len(x) for x in hq_lists])
        TF = max([1] + [len(x) for x in fwd_lists])
        prog = InterPodProgram(
            topo_dom=topo_dom,
            u_topo=u_topo,
            u_spec=u_spec,
            lt_spec=lt_spec,
            lt_u=lt_u,
            lt_sign=lt_sign,
            term_count=term_count if U else np.zeros((0, 1), np.int32),
            own_anti=own_anti,
            rev_hard=rev_hard,
            rev_pref=rev_pref,
            rev_anti=rev_anti,
            spec_total=spec_total,
            match_spec=np.zeros((P, S), np.int8),
            ha_lt=np.full((P, TA), -1, np.int32),
            ha_self=np.zeros((P, TA), bool),
            hq_lt=np.full((P, TQ), -1, np.int32),
            fwd_lt=np.full((P, TF), -1, np.int32),
            fwd_w=np.zeros((P, TF), np.int64),
            own_hard=np.zeros((P, LT), np.int32),
            own_pref=np.zeros((P, LT), np.int64),
            own_anti_hard=np.zeros((P, LT), np.int32),
            own_anti_pref=np.zeros((P, LT), np.int64),
            has_affinity=np.zeros(P, bool),
            has_anti=np.zeros(P, bool),
            sym_reject=np.zeros(P, bool),
            poison=poison,
        )
        for i, (pod, (aff, ok)) in enumerate(zip(pods, p_parsed)):
            for s in range(S):
                prog.match_spec[i, s] = self._pod_matches_spec(pod, s)
            for j, (lt, selfm) in enumerate(ha_lists[i]):
                prog.ha_lt[i, j] = lt
                prog.ha_self[i, j] = selfm
            for j, lt in enumerate(hq_lists[i]):
                prog.hq_lt[i, j] = lt
            for j, (lt, w) in enumerate(fwd_lists[i]):
                prog.fwd_lt[i, j] = lt
                prog.fwd_w[i, j] = w
            if aff is not None:
                prog.has_affinity[i] = aff.pod_affinity is not None
                prog.has_anti[i] = aff.pod_anti_affinity is not None
                # what this pod will contribute once committed mid-scan
                # (per logical term; the device scatters into all E slots)
                if aff.pod_affinity is not None:
                    for t in aff.pod_affinity.required_during_scheduling_ignored_during_execution:
                        prog.own_hard[i, self._lt_id(pod, t)] += 1
                    for wt in aff.pod_affinity.preferred_during_scheduling_ignored_during_execution:
                        prog.own_pref[i, self._lt_id(pod, wt.pod_affinity_term)] += (
                            wt.weight
                        )
                if aff.pod_anti_affinity is not None:
                    for t in aff.pod_anti_affinity.required_during_scheduling_ignored_during_execution:
                        prog.own_anti_hard[i, self._lt_id(pod, t)] += 1
                    for wt in aff.pod_anti_affinity.preferred_during_scheduling_ignored_during_execution:
                        prog.own_anti_pref[
                            i, self._lt_id(pod, wt.pod_affinity_term)
                        ] += wt.weight
            # symmetric-check hard failures independent of the node
            if prog.has_anti[i]:
                if poison:
                    prog.sym_reject[i] = True
                for s in unknown_anti_specs:
                    if self._pod_matches_spec(pod, s):
                        prog.sym_reject[i] = True
        return prog
