"""The port's ScheduleAlgorithm: ClusterState -> device -> node names.

PyTorch counterpart of kubernetes_tpu/scheduler/tpu_algorithm.py,
default provider, greedy profile, one device: encode the snapshot
columnar (snapshot/encode.py, one row per distinct pod template), pad
the node axis to a power of two, run the wave driver (models/wave.py),
and map the chosen node ids back to names. Decisions are bit-identical
to the serial oracle and to TPUScheduleAlgorithm.

Daemon mode (cache=): an IncrementalEncoder (snapshot/incremental.py)
subscribes to the SchedulerCache and patches the node tables per cache
event; each wave takes its snapshot from the encoder's wave_view, with
the fields unchanged since the previous wave named in `keep`, so the
wave driver reuses their device tensors. Where wave_view declines (its
scope gates: inter-pod affinity, volumes, ServiceAffinity and
ServiceAntiAffinity Policies) the wave falls back to the full encode, as
in the JAX package. warmup() builds the kernels and runs synthetic
backlogs before the first real wave; _sched_lock serializes it against
real waves.

Left out, with the items of ROADMAP.md queue 1 that bring them: the
mesh driver (item 5), the optimizing profile (item 4) and the bf16
shadow gate (item 3).

It runs on CUDA unless the caller passes device="cpu"; on a host without
CUDA the default raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from kubernetes_tpu_torch.api.types import (
    Container,
    Node,
    NodeCondition,
    NodeStatus,
    ObjectMeta,
    Pod,
    PodSpec,
)
from kubernetes_tpu_torch.models.wave import WaveScheduler
from kubernetes_tpu_torch.oracle.scheduler import FitError
from kubernetes_tpu_torch.oracle.state import ClusterState
from kubernetes_tpu_torch.snapshot.encode import (
    SnapshotEncoder,
    pod_feature_key,
)
from kubernetes_tpu_torch.snapshot.incremental import IncrementalEncoder
from kubernetes_tpu_torch.snapshot.pad import next_pow2, pad_snapshot
from kubernetes_tpu_torch.trace import profile as trace_profile


def _listed(lister) -> list:
    return lister.list() if lister is not None else []


class TorchScheduleAlgorithm:
    def __init__(self, device="cuda", min_run: int = 16, config=None,
                 replay=None, cache=None, service_lister=None,
                 controller_lister=None, replica_set_lister=None):
        """config: a models/batch SchedulerConfig overriding the default
        provider. replay overrides the wave's host replay engine (a
        testing seam, e.g. models/replay.replay_spec); it also sends
        zoned selector-spread runs to that replay instead of the device
        replay. cache: a scheduler/cache.SchedulerCache to schedule from
        in daemon mode, with the listers (`.list()`) of the Services,
        ReplicationControllers and ReplicaSets that SelectorSpread
        reads."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchScheduleAlgorithm: CUDA is not available; pass "
                "device='cpu' to run on the CPU")
        # the wave driver, exposed as TPUScheduleAlgorithm exposes its own
        self._wave = WaveScheduler(config=config, min_run=min_run,
                                   device=self.device, replay=replay)
        self._inc = None
        self._service_lister = service_lister
        self._controller_lister = controller_lister
        self._replica_set_lister = replica_set_lister
        if cache is not None:
            # daemon mode: maintain the snapshot from cache deltas
            # instead of re-encoding the cluster every wave
            self._inc = IncrementalEncoder(config=self._wave.config)
            cache.add_listener(self._inc.on_cache_event)
        # selectHost's round-robin counter persists across waves, like
        # the reference's genericScheduler.lastNodeIndex across pods
        self._last_node_index = 0
        # serializes warmup against real waves (the scheduling loop is
        # single-threaded; a daemon warms up on another thread)
        self._sched_lock = threading.Lock()

    def _dedup(self, pods: Sequence[Pod]):
        """Template-created pods (RC/RS/Job) are identical up to their
        name: encode one representative per distinct feature key."""
        reps: List[Pod] = []
        rep_of_key = {}
        rep_idx = np.empty(len(pods), np.int64)
        for i, p in enumerate(pods):
            k = pod_feature_key(p)
            r = rep_of_key.get(k)
            if r is None:
                r = len(reps)
                rep_of_key[k] = r
                reps.append(p)
            rep_idx[i] = r
        return reps, rep_idx

    def warmup(self, num_nodes: int, phase: str = "all") -> None:
        """Build the kernels and run the wave paths on a synthetic
        cluster of `num_nodes` nodes shaped like the common case
        (label-only pods, unlabelled nodes) before the first real pod
        arrives (kubernetes_tpu/scheduler/tpu_algorithm.py warmup): an
        nvcc build and the first use of each torch op otherwise land on
        the first scheduling cycle. Phase "run" runs a template run (the
        probe, K1, the replay and the fold) and two adjacent template
        runs (the grouped header probe and fold); phase "scan" runs two
        distinct pods (the serial scan). The JAX warmup also walks every
        pod-axis bucket a daemon wave can land in, one compiled program
        each; the port compiles no program per shape, so it has no such
        walk. A failed build or launch raises (see _warm_one)."""
        if self.device.type == "cuda":
            from kubernetes_tpu_torch.ops import probe_kernel, zreplay_kernel

            probe_kernel._lib()
            zreplay_kernel._lib()
        nodes = [
            Node(
                metadata=ObjectMeta(name=f"warm-{i:05d}"),
                status=NodeStatus(
                    allocatable={"cpu": "4", "memory": "32Gi", "pods": "110"},
                    conditions=[NodeCondition("Ready", "True")],
                ),
            )
            for i in range(max(num_nodes, 1))
        ]

        def pod(name, cpu):
            return Pod(
                metadata=ObjectMeta(name=name, labels={"app": "warm"}),
                spec=PodSpec(containers=[
                    Container(image="warm", requests={"cpu": cpu})
                ]),
            )

        state = ClusterState.build(nodes)
        n = max(self._wave.min_run, 2)
        if phase in ("all", "run"):
            self._warm_one([pod(f"w{i}", "100m") for i in range(n)],
                           state, nodes)
            self._warm_one([pod(f"wg{i}", "100m") for i in range(n)]
                           + [pod(f"wh{i}", "150m") for i in range(n)],
                           state, nodes)
        if phase in ("all", "scan"):
            self._warm_one([pod("w-scan", "200m"),
                            pod("w-scan2", "300m")], state, nodes)

    def _warm_one(self, backlog, state, nodes) -> None:
        """One synthetic wave, the real round-robin counter and encoder
        restored after it. In daemon mode it runs through a throwaway
        IncrementalEncoder fed the synthetic nodes, so the real view is
        never consulted and the wave takes the daemon's path.

        Deviation from kubernetes_tpu/scheduler/tpu_algorithm.py
        TPUScheduleAlgorithm._warm_one, which logs and swallows any
        exception: here an exception propagates, so a kernel that fails
        to build or to launch stops the warmup instead of hiding until
        the first real wave."""
        with self._sched_lock:
            saved_last, saved_inc = self._last_node_index, self._inc
            try:
                if saved_inc is not None:
                    inc = IncrementalEncoder(config=self._wave.config)
                    for n in nodes:
                        inc.on_cache_event("node_set", n)
                    self._inc = inc
                self._schedule_backlog_locked(backlog, state)
            finally:
                self._inc = saved_inc
                self._last_node_index = saved_last

    def schedule_backlog(self, pods: Sequence[Pod], state: ClusterState,
                         gangs: Optional[Sequence[dict]] = None
                         ) -> List[Optional[str]]:
        """Schedule a FIFO backlog as one wave: -> the chosen node name
        per pod (None where nothing fits).

        gangs: all-or-nothing spans of the backlog, [{"start", "length",
        "score_by_name": {node name: int} | None}] (the layout of
        scheduler/gang.GangDirector.plan_wave): each gang's score row is
        resolved into the snapshot's node order (padded rows score 0 and
        never fit) and handed to the wave driver."""
        if not pods:
            return []
        with self._sched_lock:
            return self._schedule_backlog_locked(pods, state, gangs)

    def _schedule_backlog_locked(self, pods: Sequence[Pod],
                                 state: ClusterState,
                                 gangs: Optional[Sequence[dict]] = None
                                 ) -> List[Optional[str]]:
        with trace_profile.phase_timer("encode"):
            reps, rep_idx = self._dedup(pods)
            snap = batch = None
            keep = frozenset()
            source = "full"
            if self._inc is not None:
                snap, batch, keep = self._inc.wave_view(
                    reps, services=_listed(self._service_lister),
                    controllers=_listed(self._controller_lister),
                    replica_sets=_listed(self._replica_set_lister))
                if snap is not None:
                    # the encoder instance, not only its kind: a warmup's
                    # throwaway encoder and the real one number their
                    # vocab bits and slots apart
                    source = self._inc.source_token
            if snap is None:
                # the full encode (no cache, or a scope gate hit)
                enc = SnapshotEncoder(state, reps, config=self._wave.config)
                snap = enc.encode_nodes()
                batch = enc.encode_pods()
                if snap.num_nodes:
                    snap = pad_snapshot(snap, next_pow2(snap.num_nodes, 64))
        if snap.num_nodes == 0:
            # empty cluster: every pod fails with FitError
            return [None] * len(pods)
        chosen, _final, last = self._wave.schedule_backlog(
            snap, batch, rep_idx, last_node_index=self._last_node_index,
            keep=keep, source=source,
            gangs=wave_gangs(gangs, snap.node_names))
        self._last_node_index = last
        names = snap.node_names
        return [
            (names[i] or None) if 0 <= i < len(names) else None
            for i in (int(c) for c in chosen)
        ]

    def schedule(self, pod: Pod, state: ClusterState) -> str:
        host = self.schedule_backlog([pod], state)[0]
        if host is None:
            raise FitError(pod, {})
        return host


def wave_gangs(gangs, node_names) -> Optional[List[dict]]:
    """The director's gang layout -> the wave driver's: each gang's
    per-node-NAME score (the heterogeneity throughput term) as an i64 row
    in snapshot node order, 0 on nodes it does not name and on padded
    rows. None when there are no gangs (kubernetes_tpu/scheduler/
    tpu_algorithm.py _schedule_backlog_locked)."""
    if not gangs:
        return None
    name_to_id = {nm: i for i, nm in enumerate(node_names) if nm}
    out = []
    for g in gangs:
        add = None
        by_name = g.get("score_by_name")
        if by_name:
            add = np.zeros(len(node_names), np.int64)
            for nm, v in by_name.items():
                i = name_to_id.get(nm)
                if i is not None:
                    add[i] = int(v)
        out.append({"start": g["start"], "length": g["length"],
                    "score_add": add})
    return out
