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
    def __init__(self, device="cuda", min_run: int = 16, config=None):
        """config: a models/batch SchedulerConfig overriding the default
        provider."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchScheduleAlgorithm: CUDA is not available; pass "
                "device='cpu' to run on the CPU")
        self._wave = WaveScheduler(config=config, min_run=min_run,
                                   device=self.device)
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

    def schedule_backlog(self, pods: Sequence[Pod],
                         state: ClusterState) -> List[Optional[str]]:
        """Schedule a FIFO backlog as one wave: -> the chosen node name
        per pod (None where nothing fits)."""
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
            snap, batch, rep_idx, last_node_index=self._last_node_index)
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
