"""ServiceAffinity / ServiceAntiAffinity compilation (Policy-arg driven).

Both predicates key off a pod's FIRST matching service
(predicates.go:596 NewServiceAffinityPredicate "just use the first
service"; selector_spreading.go:262-274 same): peers are assigned pods in
the pod's namespace matching that service's selector. Compiled state:

- **service groups** g: distinct (namespace, selector-set) of first
  services. Membership of ANY pod (assigned now or committed mid-scan) is
  precomputed host-side into per-pod bitmaps.
- ServiceAffinity: the implicit selector takes label values from the pod's
  own nodeSelector, else from the node of the FIRST peer — which, in
  all_assigned_pods order, is the peer on the earliest node in node_infos
  iteration order. The carry tracks min(order-index) per group; committing
  a pod lowers it. Queries map order-index -> node row -> label value id.
- ServiceAntiAffinity: score 10*(total-peers_at_value)/total over values
  of a config label, peers counted per node in the carry so fit-masking
  matches the reference's filtered labeledNodes.

Copy of kubernetes_tpu/snapshot/services.py: only the import package differs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kubernetes_tpu_torch.api import labels as labelpkg
from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.oracle.state import ClusterState

ORD_NONE = np.int32(2**31 - 1)  # "no peer yet"


@dataclass
class ServiceProgram:
    # static (snapshot side)
    lbl_val: np.ndarray  # i32 (L, N): value id of config label per node, -1 missing
    node_ord: np.ndarray  # i32 (N,): row -> node_infos order index
    ord_node: np.ndarray  # i32 (ORD,): order index -> row, -1 for None-nodes
    # initial carry
    first_peer: np.ndarray  # i32 (G,): min order index of a peer, ORD_NONE none
    peer_node_count: np.ndarray  # i32 (G, N)
    peer_total: np.ndarray  # i32 (G,)
    # pod side
    group: np.ndarray  # i32 (P,): the pod's own first-service group, -1 none
    member: np.ndarray  # i8 (P, G): peer membership per group
    fixed: np.ndarray  # i32 (P, L): value id pinned by nodeSelector, -1 unresolved
    labels: Tuple[str, ...] = ()


class ServiceCompiler:
    def __init__(
        self,
        state: ClusterState,
        pods: Sequence[Pod],
        node_names: Sequence[str],
        labels: Sequence[str],
    ):
        self.state = state
        self.pods = list(pods)
        self.node_names = list(node_names)
        self.labels = tuple(labels)

    def compile(self) -> ServiceProgram:
        state = self.state
        N, P, L = len(self.node_names), len(self.pods), len(self.labels)
        if L == 0:
            # no ServiceAffinity/AntiAffinity in the config: zero-width
            # program, so group-count changes never alter compiled shapes
            return ServiceProgram(
                lbl_val=np.zeros((0, N), np.int32),
                node_ord=np.zeros(N, np.int32),
                ord_node=np.zeros(1, np.int32),
                first_peer=np.zeros(0, np.int32),
                peer_node_count=np.zeros((0, N), np.int32),
                peer_total=np.zeros(0, np.int32),
                group=np.full(P, -1, np.int32),
                member=np.zeros((P, 0), np.int8),
                fixed=np.full((P, 0), -1, np.int32),
                labels=(),
            )
        row_of = {n: i for i, n in enumerate(self.node_names)}

        # node_infos iteration order, INCLUDING None-node entries — the
        # oracle's all_assigned_pods walks this order, so "first peer"
        # means the peer on the earliest entry here
        ord_keys = list(state.node_infos.keys())
        ord_of = {k: i for i, k in enumerate(ord_keys)}
        node_ord = np.full(N, ORD_NONE, np.int32)
        ord_node = np.full(max(1, len(ord_keys)), -1, np.int32)
        for i, key in enumerate(ord_keys):
            r = row_of.get(key, -1)
            ord_node[i] = r
            if r >= 0:
                node_ord[r] = i

        # label value vocab (shared across config labels; equality is all
        # that matters)
        values: Dict[str, int] = {}

        def vid(v: str) -> int:
            i = values.get(v)
            if i is None:
                i = len(values)
                values[v] = i
            return i

        lbl_val = np.full((L, N), -1, np.int32)
        for li, lbl in enumerate(self.labels):
            for r, name in enumerate(self.node_names):
                node = state.node_infos[name].node
                v = node.metadata.labels.get(lbl)
                if v is not None:
                    lbl_val[li, r] = vid(v)

        # groups: first matching service per pod (pending AND assigned —
        # assigned pods matter as peers, which is selector membership, but
        # group CREATION comes from any pod's first service)
        groups: Dict[Tuple[str, frozenset], int] = {}
        group_sel: List[Tuple[str, object]] = []  # (ns, Selector)

        def first_service_group(pod: Pod) -> int:
            for svc in state.services:
                if svc.metadata.namespace != pod.namespace:
                    continue
                sel = labelpkg.selector_from_set(svc.spec.selector)
                if sel.matches(pod.metadata.labels):
                    key = (
                        pod.namespace,
                        frozenset(svc.spec.selector.items()),
                    )
                    g = groups.get(key)
                    if g is None:
                        g = len(group_sel)
                        groups[key] = g
                        group_sel.append((pod.namespace, sel))
                    return g
            return -1

        assigned = state.all_assigned_pods()
        # groups come from PENDING pods only: assigned pods matter as
        # peers (selector membership below), and a group no pending pod
        # references would be a dead column
        pod_groups = [first_service_group(p) for p in self.pods]
        G = len(group_sel)

        def member_row(pod: Pod) -> np.ndarray:
            out = np.zeros(G, np.int8)
            for g, (ns, sel) in enumerate(group_sel):
                if pod.namespace == ns and sel.matches(pod.metadata.labels):
                    out[g] = 1
            return out

        first_peer = np.full(max(0, G), ORD_NONE, np.int32)
        peer_node_count = np.zeros((G, N), np.int32)
        peer_total = np.zeros(max(0, G), np.int32)
        for ep in assigned:
            m = member_row(ep)
            if not m.any():
                continue
            peer_total += m
            o = ord_of.get(ep.spec.node_name)
            r = row_of.get(ep.spec.node_name, -1)
            for g in range(G):
                if not m[g]:
                    continue
                if o is not None and o < first_peer[g]:
                    first_peer[g] = o
                if r >= 0:
                    peer_node_count[g, r] += 1

        prog = ServiceProgram(
            lbl_val=lbl_val,
            node_ord=node_ord,
            ord_node=ord_node,
            first_peer=first_peer,
            peer_node_count=peer_node_count,
            peer_total=peer_total,
            group=np.asarray(pod_groups, np.int32).reshape(P),
            member=np.zeros((P, G), np.int8),
            fixed=np.full((P, L), -1, np.int32),
            labels=self.labels,
        )
        for i, pod in enumerate(self.pods):
            prog.member[i] = member_row(pod)
            for li, lbl in enumerate(self.labels):
                v = pod.spec.node_selector.get(lbl)
                if v is not None:
                    prog.fixed[i, li] = vid(v)
        return prog
