"""Status manager (pkg/kubelet/status/manager.go): the single writer of
pod status back to the apiserver. Deduplicates (only version bumps sync)
and tolerates conflicts by refetching.

Copy of kubernetes_tpu/kubelet/status.py: only the import package differs."""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.client.rest import APIStatusError, RESTClient


class StatusManager:
    def __init__(self, client: RESTClient):
        self.client = client
        self._lock = threading.Lock()
        self._statuses: Dict[str, Tuple[str, str, t.PodStatus]] = {}
        self._synced_version: Dict[str, int] = {}
        self._version: Dict[str, int] = {}

    def set_pod_status(self, pod: t.Pod, status: t.PodStatus) -> None:
        with self._lock:
            uid = pod.metadata.uid
            prior = self._statuses.get(uid)
            if prior is not None and prior[2] == status:
                return  # manager.go SetPodStatus: unchanged -> no new sync
            self._statuses[uid] = (
                pod.metadata.namespace,
                pod.metadata.name,
                status,
            )
            self._version[uid] = self._version.get(uid, 0) + 1

    def get_pod_status(self, uid: str) -> Optional[t.PodStatus]:
        with self._lock:
            entry = self._statuses.get(uid)
            return entry[2] if entry else None

    def sync(self) -> None:
        """Push pending statuses (manager.go syncBatch)."""
        with self._lock:
            work = [
                (uid, ns, name, status, self._version[uid])
                for uid, (ns, name, status) in self._statuses.items()
                if self._version[uid] != self._synced_version.get(uid)
            ]
        for uid, ns, name, status, version in work:
            try:
                pod = self.client.pods(ns).get(name)
            except APIStatusError:
                continue
            if pod.metadata.uid != uid:
                continue  # same name, different incarnation
            pod.status = status
            try:
                self.client.pods(ns).update_status(pod)
            except APIStatusError:
                continue  # conflict: retry next sync
            with self._lock:
                self._synced_version[uid] = version

    def forget(self, uid: str) -> None:
        with self._lock:
            self._statuses.pop(uid, None)
            self._version.pop(uid, None)
            self._synced_version.pop(uid, None)
