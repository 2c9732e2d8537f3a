"""The port's ScheduleAlgorithm: ClusterState -> device -> node names.

PyTorch counterpart of kubernetes_tpu/scheduler/tpu_algorithm.py,
default provider, greedy profile, one device: encode the snapshot
columnar (snapshot/encode.py, one row per distinct pod template), pad
the node axis to a power of two, run the wave driver (models/wave.py),
and map the chosen node ids back to names. Decisions are bit-identical
to the serial oracle and to TPUScheduleAlgorithm.

It runs on CUDA unless the caller passes device="cpu"; on a host without
CUDA the default raises instead of carrying on on the CPU.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.models.wave import WaveScheduler
from kubernetes_tpu_torch.oracle.scheduler import FitError
from kubernetes_tpu_torch.oracle.state import ClusterState
from kubernetes_tpu_torch.snapshot.encode import (
    SnapshotEncoder,
    pod_feature_key,
)
from kubernetes_tpu_torch.snapshot.pad import next_pow2, pad_snapshot


class TorchScheduleAlgorithm:
    def __init__(self, device="cuda", min_run: int = 16, config=None,
                 replay=None):
        """config: a models/batch SchedulerConfig overriding the default
        provider. replay overrides the wave's host replay engine (a
        testing seam, e.g. models/replay.replay_spec); it also sends
        zoned selector-spread runs to that replay instead of the device
        replay."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchScheduleAlgorithm: CUDA is not available; pass "
                "device='cpu' to run on the CPU")
        # the wave driver, exposed as TPUScheduleAlgorithm exposes its own
        self._wave = WaveScheduler(config=config, min_run=min_run,
                                   device=self.device, replay=replay)
        # selectHost's round-robin counter persists across waves, like
        # the reference's genericScheduler.lastNodeIndex across pods
        self._last_node_index = 0

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
        reps, rep_idx = self._dedup(pods)
        enc = SnapshotEncoder(state, reps, config=self._wave.config)
        snap = enc.encode_nodes()
        batch = enc.encode_pods()
        if snap.num_nodes == 0:
            # empty cluster: every pod fails with FitError
            return [None] * len(pods)
        snap = pad_snapshot(snap, next_pow2(snap.num_nodes, 64))
        chosen, _final, last = self._wave.schedule_backlog(
            snap, batch, rep_idx, last_node_index=self._last_node_index,
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
