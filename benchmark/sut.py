"""The system under test: kubernetes_tpu_torch's schedule algorithm,
built as the daemon holds it, over the program's own API objects made
from the cluster description.

This is the only module of the benchmark that imports the program.
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch.api import types as T
from kubernetes_tpu_torch.oracle.state import ClusterState
from kubernetes_tpu_torch.ops import probe_kernel, zreplay_kernel
from kubernetes_tpu_torch.scheduler.algorithm import TorchScheduleAlgorithm
from kubernetes_tpu_torch.trace import profile as trace_profile

#: the wave driver's routes whose pods K3 picks
ZREPLAY_ROUTES = ("zreplay", "zreplay_group")
#: dispatch tally keys that count pods, not dispatches
POD_TALLIES = ("scan_pods",)


def _meta(name: str, labels: dict, namespace: str) -> T.ObjectMeta:
    return T.ObjectMeta(name=name, namespace=namespace, labels=dict(labels))


def _containers(spec: list) -> list:
    return [T.Container(requests=dict(c.get("requests", {}))) for c in spec]


def build_state(desc: dict, s: int) -> ClusterState:
    """Initial state s of the description as the program's ClusterState."""
    ns = desc["namespace"]
    st = desc["states"][s]
    nodes = [T.Node(metadata=T.ObjectMeta(name=n["name"],
                                          labels=dict(n["labels"])),
                    status=T.NodeStatus(
                        allocatable=dict(n["allocatable"]),
                        conditions=[T.NodeCondition("Ready", "True")]))
             for n in st["nodes"]]
    bound = []
    for b in st["bound"]:
        p = T.Pod(metadata=_meta(b["name"], b["labels"], ns),
                  spec=T.PodSpec(containers=_containers(b["containers"])))
        p.spec.node_name = b["node"]
        bound.append(p)
    services = [T.Service(metadata=_meta(x["name"], {}, ns),
                          spec=T.ServiceSpec(selector=dict(x["selector"])))
                for x in desc["services"]]
    controllers = [T.ReplicationController(
        metadata=_meta(x["name"], {}, ns),
        spec=T.ReplicationControllerSpec(selector=dict(x["selector"]),
                                         replicas=x["replicas"]))
        for x in desc["controllers"]]
    return ClusterState.build(nodes, assigned_pods=bound, services=services,
                              controllers=controllers)


def build_backlog(desc: dict) -> list:
    """The pending pods of the groups, FIFO, named <group>-000000.."""
    ns = desc["namespace"]
    return [T.Pod(metadata=_meta(f"{g['name']}-{i:06d}", g["labels"], ns),
                  spec=T.PodSpec(containers=_containers(g["containers"])))
            for g in desc["groups"] for i in range(g["count"])]


class System:
    """One TorchScheduleAlgorithm, the initial states its calls alternate
    between, and the backlog every call schedules. Each call gives the
    backlog's pods fresh names and uids, as new pods of the same
    templates would arrive."""

    def __init__(self, desc: dict, device: str):
        self.device = torch.device(device)
        self.states = [build_state(desc, s)
                       for s in range(len(desc["states"]))]
        self.backlog = build_backlog(desc)
        self.base_names = [p.metadata.name for p in self.backlog]
        self.algo = TorchScheduleAlgorithm(device=device, profile="greedy")
        # the wave driver's dispatch tally, summed over calls (the driver
        # keeps one wave's)
        self.dispatches: dict = {}

    def call(self, g: int) -> list:
        """Call g of the run: schedule its state's backlog from the
        initial state; -> the chosen node name per pod, once the device
        has finished."""
        suffix = f"-{g}"
        for p, name in zip(self.backlog, self.base_names):
            p.metadata.name = p.metadata.uid = name + suffix
        names = self.algo.schedule_backlog(
            self.backlog, self.states[g % len(self.states)])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        for k, v in self.algo._wave.dispatches.items():
            self.dispatches[k] = self.dispatches.get(k, 0) + v
        return names

    def counters(self) -> dict:
        """The program's counters, as copies to diff across a window."""
        return {"dispatches": dict(self.dispatches),
                "k1_shapes": dict(probe_kernel.LAUNCHES_BY_SHAPE),
                "k3_shapes": dict(zreplay_kernel.LAUNCHES_BY_SHAPE),
                "k1": probe_kernel.LAUNCHES, "k3": zreplay_kernel.LAUNCHES,
                "phases": dict(trace_profile.exclusive_totals())}


def diff_counters(after: dict, before: dict) -> dict:
    """What the program counted between two counters() copies."""

    def sub(a, b):
        if isinstance(a, dict):
            return {k: a[k] - b.get(k, 0) for k in a if a[k] != b.get(k, 0)}
        return a - b

    return {k: sub(after[k], before[k]) for k in after}
