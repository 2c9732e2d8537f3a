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

The bf16 j-table profile (KUBERNETES_TPU_QUANT=bf16, parallel/quant) is
a declared approximation, shadow-checked as in the JAX package: a
ShadowGate samples waves (every KUBERNETES_TPU_QUANT_SHADOW-th, the first
always), each sampled wave runs again on a full-width shadow
WaveScheduler(quant_mode="off") from the same round-robin counter, and a
divergence counts scheduler_quant_shadow_divergence_total, takes the
shadow's picks and sends every later wave to the shadow.

The optimizing profile (profile="optimizing", or KUBERNETES_TPU_PROFILE
read through scheduler/optimizer.active_profile when profile is None;
an unknown value warns and takes greedy) wraps the wave driver in
scheduler/optimizer/profile.OptimizingWaveDriver, built at its first
wave: one grouped header probe, one joint-assignment solve (K7 on the
card), host re-validation, one grouped fold and the serial scan for the
rest, as in the JAX package. The daemon (scheduler/server.py,
factory.py) reaches it through the environment.

The mesh (mesh=, a parallel/shard.DeviceMesh): the node axis sharded
over the mesh's devices, through parallel/mesh.MeshWaveScheduler against
its resident sharded state (parallel/resident), with the sharded scan as
the in-carry fallback, as TPUScheduleAlgorithm(mesh=...) does. Each wave
is deduped, encoded (the incremental view in daemon mode, else the full
encode), padded to next_pow2(n, 64) and then to a mesh multiple; the
optimizing profile on a mesh warns and takes greedy, and `gangs` are
ignored there (the caller's all-or-nothing check guards the binds), as
in the JAX package.

It runs on CUDA unless the caller passes device="cpu"; on a host without
CUDA the default raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import logging
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
from kubernetes_tpu_torch.parallel import quant
from kubernetes_tpu_torch.scheduler.optimizer import (
    PROFILE_OPTIMIZING,
    active_profile,
)
from kubernetes_tpu_torch.snapshot.encode import (
    SnapshotEncoder,
    pod_feature_key,
)
from kubernetes_tpu_torch.snapshot.incremental import IncrementalEncoder
from kubernetes_tpu_torch.snapshot.pad import next_pow2, pad_snapshot
from kubernetes_tpu_torch.trace import profile as trace_profile

log = logging.getLogger(__name__)


def _listed(lister) -> list:
    return lister.list() if lister is not None else []


class TorchScheduleAlgorithm:
    def __init__(self, device="cuda", min_run: int = 16, config=None,
                 replay=None, cache=None, service_lister=None,
                 controller_lister=None, replica_set_lister=None,
                 profile=None, mesh=None):
        """config: a models/batch SchedulerConfig overriding the default
        provider. replay overrides the wave's host replay engine (a
        testing seam, e.g. models/replay.replay_spec); it also sends
        zoned selector-spread runs to that replay instead of the device
        replay. cache: a scheduler/cache.SchedulerCache to schedule from
        in daemon mode, with the listers (`.list()`) of the Services,
        ReplicationControllers and ReplicaSets that SelectorSpread
        reads. profile picks the wave driver: "greedy" (default;
        bit-identical to the serial oracle) or "optimizing" (the
        joint-packing profile, scheduler/optimizer); None reads
        KUBERNETES_TPU_PROFILE. mesh: a parallel/shard.DeviceMesh to
        shard the node axis over (the mesh driver; its devices replace
        `device`)."""
        self.device = torch.device(device)
        devices = mesh.devices if mesh is not None else (self.device,)
        if any(d.type == "cuda" for d in devices) \
                and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchScheduleAlgorithm: CUDA is not available; pass "
                "device='cpu' to run on the CPU")
        self._profile = active_profile(profile)
        # the optimizing profile's driver, wrapping self._wave, built at
        # its first wave
        self._opt = None
        self._mesh_sched = None
        self._wave = None
        self._shadow_gate = None
        self._shadow_wave = None
        if mesh is not None and self._profile == PROFILE_OPTIMIZING:
            # the optimizing profile is single-device; the mesh keeps the
            # greedy driver rather than silently changing semantics
            log.warning("KUBERNETES_TPU_PROFILE=optimizing is not "
                        "supported on the mesh driver; using greedy")
            self._profile = "greedy"
        if mesh is not None:
            from kubernetes_tpu_torch.parallel.mesh import MeshWaveScheduler

            self._mesh_sched = MeshWaveScheduler(mesh, config=config,
                                                 min_run=min_run)
            algo_config = self._mesh_sched.config
        else:
            # the wave driver, exposed as TPUScheduleAlgorithm exposes
            # its own
            self._wave = WaveScheduler(config=config, min_run=min_run,
                                       device=self.device, replay=replay)
            algo_config = self._wave.config
        if self._wave is not None \
                and quant.score_mode(self._wave._quant_mode) == "bf16":
            # the bf16 j-table profile is a DECLARED approximation:
            # sampled waves re-run on a full-width shadow driver and any
            # decision divergence increments the metric and permanently
            # falls the algorithm back to full width (parallel/quant
            # ShadowGate)
            self._shadow_gate = quant.ShadowGate()
            self._shadow_wave = WaveScheduler(
                config=config, min_run=min_run, device=self.device,
                replay=replay, quant_mode="off")
        self._inc = None
        self._service_lister = service_lister
        self._controller_lister = controller_lister
        self._replica_set_lister = replica_set_lister
        if cache is not None:
            # daemon mode: maintain the snapshot from cache deltas
            # instead of re-encoding the cluster every wave
            self._inc = IncrementalEncoder(config=algo_config)
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
        walk. Under the optimizing profile the joint-assignment kernel K7
        is built too, and the synthetic waves take that profile. A failed
        build or launch raises (see _warm_one). On a mesh, phase "run"
        and "scan" warm the mesh driver instead (_warmup_mesh)."""
        if self._mesh_sched is not None:
            if phase in ("all", "run"):
                self._warmup_mesh(num_nodes, scan=False)
            if phase in ("all", "scan"):
                self._warmup_mesh(num_nodes, scan=True)
            return
        if self.device.type == "cuda":
            from kubernetes_tpu_torch.ops import probe_kernel, zreplay_kernel

            probe_kernel._lib()
            zreplay_kernel._lib()
            if self._profile == PROFILE_OPTIMIZING:
                from kubernetes_tpu_torch.scheduler.optimizer.ops import (
                    assign_kernel,
                )

                assign_kernel._lib()
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

    def _warmup_mesh(self, num_nodes: int, scan: bool = False) -> None:
        """Build the mesh's kernels (K1 and the row scatter K8) and run
        synthetic backlogs through the mesh driver before real pods
        arrive. scan=False: a min_run template run (the sharded probe +
        fold), then two adjacent templates (the grouped header probe +
        grouped fold); scan=True: two pods that differ by their request
        (the sharded scan).

        Deviation from kubernetes_tpu/scheduler/tpu_algorithm.py
        TPUScheduleAlgorithm._warmup_mesh, which logs and swallows any
        exception: here an exception propagates, so a kernel that fails
        to build or to launch stops the warmup (see _warm_one)."""
        if any(d.type == "cuda" for d in self._mesh_sched.mesh.devices):
            from kubernetes_tpu_torch.ops import probe_kernel
            from kubernetes_tpu_torch.parallel import resident_kernel

            probe_kernel._lib()
            resident_kernel._lib()
        nodes = [
            Node(
                metadata=ObjectMeta(name=f"warm-{i:05d}"),
                status=NodeStatus(
                    allocatable={"cpu": "4", "memory": "32Gi",
                                 "pods": "110"},
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

        n = max(self._mesh_sched.min_run, 2)
        if scan:
            waves = [[pod(f"ws{i}", f"{100 + i}m") for i in range(2)]]
        else:
            waves = [[pod(f"w{i}", "100m") for i in range(n)],
                     [pod(f"wg{t}-{i}", f"{100 + 50 * t}m")
                      for t in range(2) for i in range(n)]]
        state = ClusterState.build(nodes)
        with self._sched_lock:
            saved_last, saved_inc = self._last_node_index, self._inc
            try:
                if saved_inc is not None:
                    inc = IncrementalEncoder(config=self._mesh_sched.config)
                    for nd in nodes:
                        inc.on_cache_event("node_set", nd)
                    self._inc = inc
                for wave in waves:
                    self._schedule_backlog_mesh(wave, state)
            finally:
                self._inc = saved_inc
                self._last_node_index = saved_last

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
        never fit) and handed to the wave driver. The mesh path ignores
        them and relies on the caller's all-or-nothing check before
        anything binds, as the JAX package's does."""
        if not pods:
            return []
        if self._mesh_sched is not None:
            # the same lock: serializes real waves against a warmup's
            # counter save/restore
            with self._sched_lock:
                return self._schedule_backlog_mesh(pods, state)
        with self._sched_lock:
            return self._schedule_backlog_locked(pods, state, gangs)

    def _schedule_backlog_mesh(self, pods: Sequence[Pod],
                               state: ClusterState) -> List[Optional[str]]:
        """The mesh path: the sharded wave driver against the resident
        sharded state. With a cache the incremental encoder supplies the
        wave's view; either way the resident state content-compares the
        snapshot against its host mirrors and ships only deltas."""
        with trace_profile.phase_timer("encode"):
            reps, rep_idx = self._dedup(pods)
            snap = batch = None
            if self._inc is not None:
                snap, batch, _keep = self._inc.wave_view(
                    reps, services=_listed(self._service_lister),
                    controllers=_listed(self._controller_lister),
                    replica_sets=_listed(self._replica_set_lister))
            if snap is None:
                enc = SnapshotEncoder(state, reps,
                                      config=self._mesh_sched.config)
                snap = enc.encode_nodes()
                batch = enc.encode_pods()
            n_real = snap.num_nodes
            if n_real == 0:
                return [None] * len(pods)
            # bucket the node axis (pow2, floor 64), then to a mesh
            # multiple, so node ids map back to THIS snapshot's names
            snap = pad_snapshot(snap, next_pow2(n_real, 64))
            snap = pad_snapshot(snap, self._mesh_sched.mesh.size)
        chosen, _final, last = self._mesh_sched.schedule_backlog(
            snap, batch, rep_idx, last_node_index=self._last_node_index)
        self._last_node_index = last
        names = snap.node_names
        return [names[i] if 0 <= i < n_real else None
                for i in (int(c) for c in chosen)]

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
        gang_rows = wave_gangs(gangs, snap.node_names)
        driver = self._wave
        if self._shadow_gate is not None and self._shadow_gate.fallen_back:
            # a shadow-compare divergence already proved the bf16
            # profile unsound for this workload: full width from here on
            driver = self._shadow_wave
        if self._profile == PROFILE_OPTIMIZING:
            if self._opt is None:
                from kubernetes_tpu_torch.scheduler.optimizer.profile import (
                    OptimizingWaveDriver,
                )

                self._opt = OptimizingWaveDriver(self._wave)
            driver = self._opt
        saved_last = self._last_node_index
        chosen, _final, last = driver.schedule_backlog(
            snap, batch, rep_idx, last_node_index=self._last_node_index,
            keep=keep, source=source, gangs=gang_rows)
        if (self._shadow_gate is not None and driver is self._wave
                and self._shadow_gate.should_check()):
            # full-width re-run from the same round-robin counter; the
            # shadow driver's own mirrors content-compare the view, so
            # keep stays empty (its last sighting may be waves old)
            s_chosen, _sf, s_last = self._shadow_wave.schedule_backlog(
                snap, batch, rep_idx, last_node_index=saved_last,
                keep=frozenset(), source=source, gangs=gang_rows)
            matched = np.array_equal(np.asarray(chosen),
                                     np.asarray(s_chosen))
            self._shadow_gate.record(matched)
            if not matched:
                from kubernetes_tpu_torch.metrics import (
                    scheduler_quant_shadow_divergence_total,
                )

                scheduler_quant_shadow_divergence_total.inc()
                log.warning(
                    "bf16 quantized profile diverged from full width "
                    "(wave of %d pods); falling back to full width",
                    len(pods))
                chosen, last = s_chosen, s_last
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
