"""The mesh churn soak: continuous create/delete churn against the
resident sharded state, gated on zero steady-state kernel builds or
loads, flat RSS and zero table bytes on quiet waves.

Port-only: the counterpart of bench.py run_soak (`bench.py --soak`),
which lives in bench.py beside JAX code. The same 1,000-node cluster and
pod template (`build`, a copy of bench.py build), the same loop and the
same gates, through TorchScheduleAlgorithm(mesh=...):

- WAVE pods a wave, two warm waves first;
- balanced churn: once 4 * WAVE pods are bound, every other wave first
  evicts the 2 * WAVE oldest bound pods, so the population (and the
  honest RSS) stays flat;
- each wave's resident `wave_h2d_bytes` and `wave_table_bytes`;
- gates: 0 builds or loads under analysis/compile_guard.CompileSentinel
  after the warm-up, |rss drift| <= 0.10, and 0 table bytes on every
  wave that evicted nothing.

A churn wave evicts pods from nearly every node, more rows than the
resident state scatters (ResidentClusterState.SCATTER_FRAC), so it
re-places the changed tables whole (stats "replaces"), as the JAX
mesh does: the row scatter K8 does not launch here, K1 does, on every
shard of every wave.

    python -m kubernetes_tpu_torch.harness.mesh_soak --seconds 45 --shards 4
    python -m kubernetes_tpu_torch.harness.mesh_soak --waves 6 --shards 2 \\
        --device cpu

prints the record (bench.py's soak_smoke line) and exits 1 on a gate
breach. On CUDA the shards go round-robin over the visible cards, so on
a one-card host every shard is on that card.
"""

from __future__ import annotations

import argparse
import copy as _copy
import json
import statistics
import sys
import time
from typing import Callable, Optional

#: pods a wave (bench.py run_soak WAVE)
WAVE = 512


def build(num_nodes, num_pods, prior_pods=0):
    from kubernetes_tpu_torch.api.types import (
        Container,
        Node,
        NodeCondition,
        NodeStatus,
        ObjectMeta,
        Pod,
        PodSpec,
        Service,
        ServiceSpec,
    )
    from kubernetes_tpu_torch.oracle import ClusterState

    nodes = [
        Node(
            metadata=ObjectMeta(name=f"node-{i:05d}"),
            status=NodeStatus(
                # perf/util.go:88-118 node shape: 4 CPU / 32Gi / 110 pods
                allocatable={"cpu": "4", "memory": "32Gi", "pods": "110"},
                conditions=[NodeCondition("Ready", "True")],
            ),
        )
        for i in range(num_nodes)
    ]

    def pod(name):
        return Pod(
            metadata=ObjectMeta(name=name, labels={"name": "sched-perf"}),
            spec=PodSpec(
                # perf/util.go:120-141 pod shape: pause, 100m / 500Mi
                containers=[Container(requests={"cpu": "100m",
                                                "memory": "500Mi"})]
            ),
        )

    pods = [pod(f"pod-{i:06d}") for i in range(num_pods)]
    # pre-scheduled pods (the bench-matrix "prior pods" axis,
    # scheduler_bench_test.go:28-33), spread round-robin
    assigned = []
    for i in range(prior_pods):
        p = pod(f"prior-{i:06d}")
        p.spec.node_name = nodes[i % num_nodes].metadata.name
        assigned.append(p)
    state = ClusterState.build(
        nodes,
        assigned_pods=assigned,
        services=[
            Service(
                metadata=ObjectMeta(name="sched-perf"),
                spec=ServiceSpec(selector={"name": "sched-perf"}),
            )
        ],
    )
    return state, pods


class Churn:
    """The soak's pods: fresh copies of the template, the bound pods in
    bind order, the oldest evicted first (run_soak's make_pods, commit
    and evict). Package-neutral: it takes either package's
    ClusterState, template and algorithm."""

    def __init__(self, state, template):
        self.state, self.template = state, template
        self.serial = 0
        self.bound = []  # (pod, node) in bind order

    def make_pods(self, n):
        out = []
        for _ in range(n):
            p = _copy.copy(self.template)
            p.metadata = _copy.copy(p.metadata)
            p.metadata.name = f"soak-{self.serial:07d}"
            self.serial += 1
            out.append(p)
        return out

    def commit(self, pods, hosts):
        for p, h in zip(pods, hosts):
            if h is None:
                continue
            q = _copy.copy(p)
            q.spec = _copy.copy(p.spec)
            q.spec.node_name = h
            self.state.assign(q)
            self.bound.append((q, h))

    def evict(self, n):
        """Delete the n oldest bound pods (the churn's delete half)."""
        victims, rest = self.bound[:n], self.bound[n:]
        self.bound[:] = rest
        for q, h in victims:
            info = self.state.get_node_info_any(h)
            if info is not None:
                info.remove_pod(q)
        return len(victims)

    def wave(self, algo, churn: bool):
        """One wave: with churn and at least 4 * WAVE pods bound, first
        evict the 2 * WAVE oldest; then WAVE new pods, scheduled and
        committed. -> (pods, hosts, pods evicted)."""
        evicted = 0
        if churn and len(self.bound) >= 4 * WAVE:
            evicted = self.evict(2 * WAVE)
        pods = self.make_pods(WAVE)
        hosts = algo.schedule_backlog(pods, self.state)
        self.commit(pods, hosts)
        return pods, hosts, evicted


def mesh_devices(device: str, shards: int) -> list:
    """The shards' devices: every shard on `device`, or for "cuda"
    round-robin over the visible cards."""
    import torch

    if device == "cuda":
        n = max(1, torch.cuda.device_count())
        return [f"cuda:{s % n}" for s in range(shards)]
    return [device] * shards


def run_mesh_soak(seconds: Optional[float] = None, shards: int = 4,
                  device: str = "cuda", waves: Optional[int] = None,
                  on_wave: Optional[Callable] = None) -> dict:
    """Run the soak for `seconds` of churn waves (or exactly `waves`
    waves) after the two warm waves, over `shards` shards. -> the
    record, with "ok"; on_wave(pods, hosts, evicted) sees every wave,
    the warm ones too."""
    if (seconds is None) == (waves is None):
        raise ValueError("run_mesh_soak: give seconds or waves")
    from kubernetes_tpu_torch.analysis.compile_guard import CompileSentinel
    from kubernetes_tpu_torch.harness.soak import rss_mb
    from kubernetes_tpu_torch.native.build import ensure_all
    from kubernetes_tpu_torch.parallel.shard import DeviceMesh
    from kubernetes_tpu_torch.scheduler.algorithm import (
        TorchScheduleAlgorithm,
    )

    ensure_all()
    devices = mesh_devices(device, shards)
    state, template = build(1000, 1)
    algo = TorchScheduleAlgorithm(mesh=DeviceMesh(devices),
                                  device=devices[0])
    sentinel = CompileSentinel()
    churn = Churn(state, template[0])

    def wave(churning):
        pods, hosts, evicted = churn.wave(algo, churning)
        if on_wave is not None:
            on_wave(pods, hosts, evicted)
        return hosts, evicted

    # warmup: build and load every kernel library before the sentinel's
    # count is taken
    for _ in range(2):
        wave(False)
    warm_compiles = sentinel.compile_count()
    rss0 = rss_mb()
    resident = algo._mesh_sched.resident
    done = scheduled = churned = 0
    h2d_per_wave = []
    table_bytes = []
    evicted_flags = []
    rss_samples = [rss0]
    deadline = None if seconds is None else time.time() + seconds
    while (done < waves) if deadline is None else (time.time() < deadline):
        hosts, evicted = wave(done % 2 == 0)
        churned += evicted
        scheduled += sum(1 for h in hosts if h is not None)
        done += 1
        evicted_flags.append(bool(evicted))
        h2d_per_wave.append(resident.stats["wave_h2d_bytes"])
        table_bytes.append(resident.stats["wave_table_bytes"])
        rss_samples.append(rss_mb())
    steady_compiles = sentinel.compile_count() - warm_compiles
    rss_end = statistics.median(rss_samples[-5:])
    rss_base = statistics.median(rss_samples[:5])
    rss_drift = (rss_end - rss_base) / max(rss_base, 1.0)
    # steady-state waves against an unchanged topology ship no node
    # tables; only churn (delete) waves may scatter changed rows
    quiet_tables = [b for b, ev in zip(table_bytes, evicted_flags)
                    if not ev]
    record = {
        "metric": "soak_smoke",
        "seconds": seconds,
        "waves": done,
        "pods_scheduled": scheduled,
        "pods_churned": churned,
        "steady_state_compiles": steady_compiles,
        "rss_start_mb": round(rss_base, 1),
        "rss_end_mb": round(rss_end, 1),
        "rss_drift_frac": round(rss_drift, 4),
        "h2d_bytes_per_wave_median": int(
            statistics.median(h2d_per_wave)) if h2d_per_wave else 0,
        "quiet_wave_table_bytes_max": max(quiet_tables, default=0),
        # counters only: stats also carries the last-changed-fields
        # breadcrumb tuple
        "resident_stats": {k: int(v)
                           for k, v in resident.stats.items()
                           if isinstance(v, int)},
    }
    record["ok"] = (steady_compiles == 0 and abs(rss_drift) <= 0.10
                    and max(quiet_tables, default=0) == 0)
    return record


def breach(record: dict) -> str:
    """The gates a record breached, as run_soak words them ("" if
    none)."""
    quiet = record["quiet_wave_table_bytes_max"]
    return (("recompilation; " if record["steady_state_compiles"] else "")
            + (f"rss drift {record['rss_drift_frac']:+.1%}; "
               if abs(record["rss_drift_frac"]) > 0.10 else "")
            + ("node-table bytes on a quiet wave" if quiet else ""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=None,
                    help="churn for this long after the warm-up")
    ap.add_argument("--waves", type=int, default=None,
                    help="or run exactly this many churn waves")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--device", default="cuda", help='"cuda" or "cpu"')
    args = ap.parse_args(argv)
    if args.seconds is None and args.waves is None:
        args.seconds = 60
    record = run_mesh_soak(args.seconds, args.shards, args.device,
                           args.waves)
    print(json.dumps(record))
    if not record["ok"]:
        print("# SOAK GATE BREACH: " + breach(record), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
