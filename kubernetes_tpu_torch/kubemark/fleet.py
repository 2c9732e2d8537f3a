"""Hollow-node fleet (test/kubemark/start-kubemark.sh at scale).

HollowCluster (hollow.py) runs the REAL kubelet per node — faithful, but
each node costs half a dozen threads, so a thousand of them melt one
box. The fleet is the kubemark deployment shape instead: thousands of
hollow kubelets multiplexed onto a few threads and ONE pooled client
transport, exercising exactly the wire surface a real node fleet does —

  * node registration: bulk-created Node objects (kubemark's
    4-CPU/32Gi shape, perf/util.go:88-118)
  * NodeStatus heartbeats: a timer wheel paces each node's Ready
    refresh across its interval, and every tick's due heartbeats ride
    ONE /api/v1/batch request (N status merges, one store transaction)
    instead of N PUTs — 5k heartbeats/interval stay O(ticks) requests
  * pod lifecycle: each SHARD of nodes holds one watch stream whose
    field selector pins spec.nodeName to the shard's node set
    (`spec.nodeName in (...)` — served from the apiserver cacher's
    interest index, so a shard's stream costs O(its own pods), not
    O(all pods)); observed Pending pods are acked to Running through
    the same batch door. Observed deletes clear local ownership only:
    the store's delete is unconditional (no grace-period handshake in
    this framework), so there is nothing for a kubelet to commit.

The paced work all funnels through one pending queue drained by the
pacer thread, so fleet wire traffic per interval is a handful of batch
requests no matter how many nodes it simulates.

Copy of kubernetes_tpu/kubemark/fleet.py: only the import package differs.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.analysis import races as _races
from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.apiserver.fields import format_in_clause
from kubernetes_tpu_torch.client.rest import (
    RESTClient,
    WatchExpired,
    batch_status_item,
)
from kubernetes_tpu_torch.metrics import (
    kubemark_fleet_heartbeats_total,
    kubemark_fleet_pod_transitions_total,
)

_hb = kubemark_fleet_heartbeats_total.child()
_trans = kubemark_fleet_pod_transitions_total.child()


def _now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


@dataclass
class FleetConfig:
    """start-kubemark knobs, reduced to what the soak needs."""

    num_nodes: int = 100
    name_prefix: str = "hollow-"
    #: nodes per watch shard (one stream + one thread per shard)
    shard_size: int = 64
    #: node_status_update_frequency (kubelet.go 10s default)
    heartbeat_interval: float = 10.0
    #: timer-wheel resolution: due heartbeats gather per tick
    tick: float = 0.25
    #: max items per /api/v1/batch commit
    batch_max: int = 1024
    #: kubemark node shape (perf/util.go:88-118)
    allocatable: Dict[str, str] = field(default_factory=lambda: {
        "cpu": "4", "memory": "32Gi", "pods": "110",
    })


class HollowFleet:
    """N hollow kubelets on a few threads against one control plane."""

    def __init__(self, client: RESTClient,
                 config: Optional[FleetConfig] = None, **kw):
        self.client = client
        self.config = config or FleetConfig(**kw)
        n = self.config.num_nodes
        self.node_names = [
            f"{self.config.name_prefix}{i:05d}" for i in range(n)
        ]
        self._lock = threading.Lock()
        self._pending: List[dict] = []  # guarded-by: self._lock
        # pods this fleet has acked Running, uid -> (ns, name, node)
        self._running: Dict[str, Tuple[str, str, str]] = {}  # guarded-by: self._lock
        self._acked: set = set()  # uids with a queued/sent Running ack  # guarded-by: self._lock
        self.stats = {
            "heartbeats": 0, "transitions": 0, "deletions_observed": 0,
            "relists": 0, "batch_requests": 0, "watch_events": 0,
        }  # guarded-by: self._lock
        # rack-failure chaos: nodes in here have "vanished" — their
        # heartbeats stop and their pods are never acked again (the
        # kubelet process is gone), so the node-lifecycle controller
        # sees a stale Ready heartbeat and runs its eviction wave
        self._dead: set = set()  # guarded-by: self._lock
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # per-shard live watch stream, so stop() can unblock the shard
        # loops; a relist replaces the shard's slot, not appends
        self._streams: Dict[int, object] = {}  # guarded-by: self._lock
        _races.track(self, "kubemark.HollowFleet")

    # -- registration --------------------------------------------------------

    def _node_object(self, name: str) -> t.Node:
        alloc = dict(self.config.allocatable)
        return t.Node(
            metadata=t.ObjectMeta(
                name=name,
                labels={"kubernetes.io/hostname": name},
            ),
            status=t.NodeStatus(
                capacity=dict(alloc),
                allocatable=alloc,
                conditions=[t.NodeCondition(
                    "Ready", "True",
                    last_heartbeat_time=_now(),
                    reason="KubeletReady",
                )],
            ),
        )

    def register_nodes(self, chunk: int = 500) -> None:
        """Bulk node registration: one request per `chunk` nodes."""
        nodes = self.client.nodes()
        for i in range(0, len(self.node_names), chunk):
            res = nodes.create_many([
                self._node_object(nm)
                for nm in self.node_names[i:i + chunk]
            ])
            for r in res:
                if (r.get("status") != "Success"
                        and "already exists" not in r.get("message", "")):
                    raise RuntimeError(
                        f"hollow node registration failed: {r}"
                    )

    # -- heartbeats (timer wheel) --------------------------------------------

    def _heartbeat_item(self, node: str) -> dict:
        return batch_status_item("nodes", node, {
            "conditions": [{
                "type": "Ready",
                "status": "True",
                "reason": "KubeletReady",
                "lastHeartbeatTime": _now(),
            }],
        })

    def _pacer_loop(self) -> None:
        """The timer wheel: every tick, queue the due slot's heartbeats
        and flush EVERYTHING pending (heartbeats + shard acks) through
        the batch door."""
        cfg = self.config
        slots = max(1, int(round(cfg.heartbeat_interval / cfg.tick)))
        wheel: List[List[str]] = [[] for _ in range(slots)]
        for i, nm in enumerate(self.node_names):
            wheel[i % slots].append(nm)
        cursor = 0
        next_tick = time.monotonic()
        while not self._stop.is_set():
            next_tick += cfg.tick
            with self._lock:
                due = [nm for nm in wheel[cursor]
                       if nm not in self._dead]
            cursor = (cursor + 1) % slots
            if due:
                items = [self._heartbeat_item(nm) for nm in due]
                with self._lock:
                    self._pending.extend(items)
                    self.stats["heartbeats"] += len(items)
                _hb(len(items))
            self.flush()
            delay = next_tick - time.monotonic()
            if delay > 0:
                self._stop.wait(delay)
            else:
                # fell behind (a flush outlasted the tick): realign
                # instead of bursting a catch-up storm
                next_tick = time.monotonic()

    def flush(self) -> None:
        """Commit everything pending in batch_max-sized requests."""
        while True:
            with self._lock:
                if not self._pending:
                    return
                batch = self._pending[:self.config.batch_max]
                del self._pending[:len(batch)]
                self.stats["batch_requests"] += 1
            try:
                self.client.commit_batch(batch)
            except Exception:
                # requeue, don't drop: heartbeats would recur, but a
                # dropped Running ack is LOST — the uid is already in
                # _acked, so a relist's re-observation returns early
                # and the pod would stay Pending on the server forever
                with self._lock:
                    self._pending[:0] = batch
                return

    # -- pod lifecycle (shard watchers) --------------------------------------

    def _observe_pod(self, pod) -> None:
        """Ack a newly-bound pod to Running (Pending->Running, the
        hollow kubelet's syncPod outcome) exactly once."""
        uid = pod.metadata.uid
        with self._lock:
            if pod.spec.node_name in self._dead:
                return  # that kubelet is gone; nobody acks this pod
        if pod.status.phase not in ("", "Pending"):
            with self._lock:
                # already Running from a previous incarnation of this
                # fleet or another writer; track it for ownership counts
                if (pod.status.phase == "Running"
                        and uid not in self._running):
                    self._running[uid] = (
                        pod.metadata.namespace, pod.metadata.name,
                        pod.spec.node_name,
                    )
            return
        if not pod.spec.node_name:
            return
        item = batch_status_item(
            "pods", pod.metadata.name, {
                "phase": "Running",
                "startTime": _now(),
                "conditions": [{"type": "Ready", "status": "True"}],
            }, namespace=pod.metadata.namespace,
        )
        with self._lock:
            if uid in self._acked:
                return
            self._acked.add(uid)
            self._running[uid] = (
                pod.metadata.namespace, pod.metadata.name,
                pod.spec.node_name,
            )
            self._pending.append(item)
            self.stats["transitions"] += 1
        _trans()

    def _observe_delete(self, pod) -> None:
        uid = pod.metadata.uid
        with self._lock:
            self._running.pop(uid, None)
            self._acked.discard(uid)
            self.stats["deletions_observed"] += 1

    def _shard_loop(self, shard_id: int, shard_nodes: List[str]) -> None:
        """One list+watch per shard, field-selected to the shard's node
        set (reflector-lite: relist on expiry/failure)."""
        selector = format_in_clause("spec.nodeName", shard_nodes)
        pods = self.client.resource("pods")  # all namespaces
        while not self._stop.is_set():
            try:
                objs, rv = pods.list(field_selector=selector)
                for p in objs:
                    self._observe_pod(p)
                stream = pods.watch(resource_version=rv,
                                    field_selector=selector)
                with self._lock:
                    self._streams[shard_id] = stream
                for ev_type, obj in stream:
                    if self._stop.is_set():
                        return
                    with self._lock:
                        self.stats["watch_events"] += 1
                    if ev_type == "DELETED":
                        self._observe_delete(obj)
                    else:
                        self._observe_pod(obj)
            except WatchExpired:
                with self._lock:
                    self.stats["relists"] += 1
            except Exception:
                if self._stop.is_set():
                    return
                with self._lock:
                    self.stats["relists"] += 1
                self._stop.wait(0.5)

    # -- lifecycle -----------------------------------------------------------

    def run(self) -> "HollowFleet":
        self.register_nodes()
        cfg = self.config
        for s0 in range(0, len(self.node_names), cfg.shard_size):
            shard = self.node_names[s0:s0 + cfg.shard_size]
            th = threading.Thread(
                target=self._shard_loop,
                args=(s0 // cfg.shard_size, shard),
                name=f"hollow-shard-{s0 // cfg.shard_size:03d}",
                daemon=True,
            )
            th.start()
            self._threads.append(th)
        th = threading.Thread(
            target=self._pacer_loop, name="hollow-pacer", daemon=True
        )
        th.start()
        self._threads.append(th)
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            streams = list(self._streams.values())
        for s in streams:
            try:
                s.stop()
            except Exception:
                pass
        for th in self._threads:
            th.join(timeout=5)

    def fail_nodes(self, count_or_names) -> List[str]:
        """Rack failure: the given nodes (or the LAST `count` nodes)
        vanish mid-run — no more heartbeats, no more pod acks. Returns
        the failed node names. The Node objects stay in the store with
        a go-stale Ready heartbeat, exactly what a dead kubelet leaves
        behind; detection and eviction are the node-lifecycle
        controller's job, not the harness's."""
        if isinstance(count_or_names, int):
            if count_or_names <= 0:
                return []  # [-0:] would slice the WHOLE fleet
            names = list(self.node_names[-count_or_names:])
        else:
            names = list(count_or_names)
        with self._lock:
            self._dead.update(names)
        return names

    def running_pods(self) -> int:
        with self._lock:
            return len(self._running)

    def snapshot_stats(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self.stats)
        out["pods_running"] = self.running_pods()
        return out

    def __len__(self) -> int:
        return len(self.node_names)
