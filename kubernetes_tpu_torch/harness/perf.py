"""scheduler_perf density harness (test/component/scheduler/perf).

PyTorch counterpart of kubernetes_tpu/harness/perf.py. Reproduces the
reference benchmark shape end to end through the REAL control plane:
in-process apiserver, N fake node objects (4 CPU / 32Gi / 110 pods —
perf/util.go:88-118), P pause pods (100m/500Mi — perf/util.go:120-141)
created through an RC-shaped generator, the scheduler daemon binding
through the API on `device` (the card unless the caller asks for the
CPU), and the reference's per-second "rate/total" printout
(scheduler_test.go:48-61).

    python -m kubernetes_tpu_torch.harness.perf --nodes 5000 --pods 50000
    python -m kubernetes_tpu_torch.harness.perf --nodes 1000 --pods 30000 \
        --separate
    python -m kubernetes_tpu_torch.harness.perf --nodes 50 --pods 500 \
        --device cpu

schedule_pods and schedule_pods_separate return the same stats dict
(pods/s over the harness's window, creation seconds, the creation ->
all-bound pipeline and its sustained pods/s; the separate mode adds the
apiserver's counters), and take two hooks for a caller that checks the
run: on_ready(sched, client) once the daemon is ready, just before pod
creation starts, and after(sched, client) once every pod is bound, while
the daemon and the apiserver still run. _measure, _phase_table,
_scrape_counters and _pipeline_snapshot are verbatim copies of the JAX
harness's. The JAX separate mode sets KUBERNETES_TPU_WARM_SCAN=1 to
warm the scan path up front; the port's warmup does not read it (its
scan-phase warmup builds no kernel), so the line is left out.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.rest import RESTClient
from kubernetes_tpu_torch.client.transport import LocalTransport
from kubernetes_tpu_torch.harness.creator import make_nodes, make_pods
from kubernetes_tpu_torch.scheduler.server import SchedulerServer, SchedulerServerOptions


def _pipeline_snapshot():
    """exclusive_totals() at pod-creation start (None with tracing
    off): the fallback anchor for degenerate measurement windows."""
    from kubernetes_tpu_torch.trace import profile as trace_profile
    from kubernetes_tpu_torch.trace import spans as trace_span

    return trace_profile.exclusive_totals() if trace_span.enabled() else None


def _wait_sched_ready(sched, out, timeout: float = 180.0) -> None:
    """Block until the scheduling loop is open (informers synced +
    run-path kernels built and launched). The density number measures
    steady-state scheduling throughput — the reference's scheduler is
    likewise fully up (informers synced, no compile analogue) before its
    harness starts creating pods (scheduler_test.go:41
    schedulerConfigFactory wiring). Daemon boot cost is reported
    separately here, not buried in the throughput window.

    Deviation from kubernetes_tpu/harness/perf.py _wait_sched_ready: a
    warmup that failed raises at once, with the daemon's error as its
    cause (the port's SchedulerServer keeps its loop closed then), where
    the JAX harness would wait for a loop that its daemon opens anyway."""
    t0 = time.time()
    deadline = t0 + timeout
    while not sched.ready.wait(0.05):
        err = getattr(sched, "error", None)
        if err is not None:
            raise RuntimeError(
                f"scheduler warmup failed: {err!r}; the loop stays closed"
            ) from err
        if time.time() > deadline:
            raise RuntimeError(
                f"scheduler not ready after {timeout:.0f}s; the density "
                "window would silently include boot cost"
            )
    print(f"scheduler ready in {time.time() - t0:.1f}s", file=out)


def _phase_table(before, wall: float, out,
                 title: str = "the measured window") -> None:
    """Print the per-phase breakdown of `wall` seconds of wire-path
    work (trace/profile.py vocabulary), diffed against the `before`
    exclusive_totals() snapshot. The exclusive timeline attributes each
    instant of the window to at most one active phase (bind — the
    wait-on-apiserver lane — claims only what no compute phase does),
    so the rows PARTITION the wall: they sum to <= wall and the
    residual is genuine idle/unattributed time."""
    from kubernetes_tpu_torch.trace import profile as trace_profile

    after = trace_profile.exclusive_totals()
    rows = [(p, after[p] - before[p]) for p in trace_profile.PHASES]
    total = sum(d for _, d in rows)
    print(f"per-phase breakdown of {title}:", file=out)
    for phase, d in rows:
        pct = 100.0 * d / wall if wall > 0 else 0.0
        print(f"  {phase:<9s} {d:8.3f}s  ({pct:5.1f}% of wall)", file=out)
    pct = 100.0 * total / wall if wall > 0 else 0.0
    print(
        f"  {'sum':<9s} {total:8.3f}s  ({pct:5.1f}% of wall "
        f"{wall:.3f}s; residual {wall - total:+.3f}s)",
        file=out,
    )


def _measure(count_scheduled, num_nodes, num_pods, out,
             label: str = "", pipeline_phases=None,
             pipeline_start: float = 0.0) -> float:
    """The per-second rate/total printout until saturation
    (scheduler_test.go:48-61), shared by both harness modes. The
    printout ticks at 1s like the reference; completion is polled at
    100ms so the recorded elapsed doesn't carry up to a second of
    post-completion slack. With tracing enabled, each window ends with
    the per-phase breakdown table (the bench acceptance artifact).

    pipeline_phases/pipeline_start (optional): an exclusive_totals()
    snapshot + wall timestamp taken when pod creation STARTED. When the
    scheduler fully kept pace with creation the post-creation window is
    degenerate (everything already bound at the first poll — a 0.1s
    wall measures the poll tick, not the wire path), and the breakdown
    is printed over the whole creation->all-bound pipeline instead."""
    from kubernetes_tpu_torch.trace import profile as trace_profile
    from kubernetes_tpu_torch.trace import spans as trace_span

    phases_before = (
        trace_profile.exclusive_totals() if trace_span.enabled() else None
    )
    prev, start = 0, time.time()
    next_print = start + 1.0
    first_poll = True
    while True:
        time.sleep(0.1)
        scheduled = count_scheduled()
        now = time.time()
        if scheduled >= num_pods:
            elapsed = now - start
            throughput = num_pods / elapsed
            print(
                f"scheduled {num_pods} pods on {num_nodes} nodes in "
                f"{elapsed:.1f}s ({throughput:.0f} pods/s){label}",
                file=out,
            )
            if phases_before is not None:
                if first_poll and pipeline_phases is not None:
                    # degenerate window: scheduling kept pace with
                    # creation, so attribute the whole pipeline span
                    print(
                        "window degenerate (all pods bound before "
                        "creation finished); breakdown covers the full "
                        "creation->bound pipeline:",
                        file=out,
                    )
                    _phase_table(
                        pipeline_phases, now - pipeline_start, out,
                        title="the creation->bound pipeline",
                    )
                else:
                    _phase_table(phases_before, elapsed, out)
            return throughput
        first_poll = False
        if now >= next_print:
            next_print += 1.0
            print(
                f"{time.strftime('%H:%M:%S')} Rate: "
                f"{scheduled - prev:5d} Total: {scheduled}",
                file=out,
            )
            prev = scheduled


def schedule_pods(
    num_nodes: int, num_pods: int, provider: str = "CUDAProvider",
    out=sys.stdout, device="cuda", on_ready=None, after=None,
) -> dict:
    """scheduler_test.go:41 schedulePods -> the run's stats: pods/sec
    over the steady window (prints rate/total each second like the
    reference), creation seconds, and the creation -> all-bound
    pipeline with its sustained pods/sec.

    Deviation from kubernetes_tpu/harness/perf.py schedule_pods: the
    daemon runs on `device` (SchedulerServerOptions.device), the hooks
    on_ready and after run (see the module docstring), the apiserver's
    watch caches are closed at the end, and it returns the stats dict of
    schedule_pods_separate (without the apiserver's counters) where the
    JAX harness returns the window's pods/sec alone."""
    server = APIServer()
    client = RESTClient(LocalTransport(server))
    make_nodes(client, num_nodes)
    sched = SchedulerServer(
        client, SchedulerServerOptions(algorithm_provider=provider,
                                       device=device)
    ).start()

    # count bindings from the scheduler's own assigned-pod informer —
    # exactly the reference's ScheduledPodLister poll
    # (scheduler_test.go:48-61). A dedicated watch stream would decode
    # every pod object a second time and steal a large slice of the
    # interpreter from the scheduler under measurement.
    def count_scheduled() -> int:
        return len(sched.factory.assigned_informer.store.list_keys())

    try:
        _wait_sched_ready(sched, out)
        if on_ready is not None:
            on_ready(sched, client)
        t0 = time.time()
        pipeline_phases = _pipeline_snapshot()
        make_pods(client, num_pods)
        created_secs = time.time() - t0
        print(
            f"created {num_pods} pods in {created_secs:.1f}s; scheduling...",
            file=out,
        )
        rate = _measure(count_scheduled, num_nodes, num_pods, out,
                        pipeline_phases=pipeline_phases,
                        pipeline_start=t0)
        pipeline_secs = time.time() - t0
        if after is not None:
            after(sched, client)
        return {
            "pods_per_sec": rate,
            "creation_seconds": created_secs,
            "pipeline_seconds": pipeline_secs,
            "sustained_pods_per_sec": num_pods / pipeline_secs,
        }
    finally:
        sched.stop()
        server.close_cachers()


def _scrape_counters(client) -> dict:
    """Sum the apiserver's wire counters from its /metrics text:
    {metric name -> summed value across label sets}. The bench records
    these per rep (BENCH JSON) so request-count regressions are visible
    next to pods/s."""
    try:
        code, payload = client.transport.request("GET", "/metrics")
    except Exception:
        return {}
    text = ""
    if isinstance(payload, dict):
        text = payload.get("text") or payload.get("message") or ""
    if code != 200 or not text:
        return {}
    want = (
        "apiserver_requests_total",
        "apiserver_watch_events_sent_total",
        "apiserver_watch_cache_hits_total",
        "apiserver_watch_cache_misses_total",
        "apiserver_batch_commit_size_objects_count",
        "apiserver_batch_commit_size_objects_sum",
        "storage_watch_events_dropped_total",
        "apiserver_watch_coalesced_frame_objects_count",
        "apiserver_watch_coalesced_frame_objects_sum",
        "apiserver_watch_coalesced_frame_bytes_sum",
        "storage_watch_fanout_pruned_total",
        "storage_watch_cache_ring_evictions_total",
    )
    out: dict = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        try:
            name_part, value = line.rsplit(" ", 1)
        except ValueError:
            continue
        name = name_part.split("{", 1)[0]
        if name in want:
            try:
                out[name] = out.get(name, 0.0) + float(value)
            except ValueError:
                pass
    return out


def _child_env() -> dict:
    """The environment of the harness's child interpreters: this one's,
    with the directory that holds the package first on PYTHONPATH, so
    `-m kubernetes_tpu_torch...` resolves from any working directory."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.environ.get("PYTHONPATH", "")
    return dict(os.environ,
                PYTHONPATH=root + (os.pathsep + path if path else ""))


def schedule_pods_separate(
    num_nodes: int, num_pods: int, provider: str = "CUDAProvider",
    out=sys.stdout, device="cuda", on_ready=None, after=None,
):
    """The density test across PROCESS boundaries, like the reference's
    real deployment (separate daemons): the apiserver runs in its own
    interpreter (TLV binary wire), pod creation in another, and the
    scheduler + measurement here. Returns a per-rep stats dict:
    pods_per_sec (the headline window), pipeline_seconds /
    sustained_pods_per_sec (creation-start -> all-bound — the honest
    end-to-end number when the headline window is degenerate), and the
    apiserver's request/watch-event/cache counters.

    Deviation from kubernetes_tpu/harness/perf.py
    schedule_pods_separate: the daemon runs on `device`, the children
    are the port's (`python -m kubernetes_tpu_torch.hyperkube apiserver`
    and `kubernetes_tpu_torch.harness.creator`, with the package on
    their PYTHONPATH), the hooks on_ready and after run (see the module
    docstring), and KUBERNETES_TPU_WARM_SCAN is not set (the port's
    warmup does not read it)."""
    import subprocess

    from kubernetes_tpu_torch.client.transport import HTTPTransport

    env = _child_env()
    api_proc = subprocess.Popen(
        [sys.executable, "-m", "kubernetes_tpu_torch.hyperkube", "apiserver",
         "--port", "0", "--enable-binary-wire"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env,
    )
    creator = None
    sched = None
    try:
        line = api_proc.stdout.readline()
        url = line.strip().rsplit(" ", 1)[-1]
        # patient timeout: a GIL-bound apiserver under a create storm can
        # answer a bulk request tens of seconds late; timing out loses
        # the reply (pods exist, client does not know) and forces the
        # serial top-up reconciliation
        # control-plane identity: this client drives node setup, the
        # scheduler daemon, and the measurement watch — exempt traffic
        # that must never queue behind the creator storm's flows
        client = RESTClient(HTTPTransport(url, binary=True,
                                          timeout=180.0,
                                          user="system:kube-scheduler"))
        deadline = time.time() + 15
        while not client.healthz():
            if time.time() > deadline:
                raise RuntimeError(f"apiserver at {url!r} never came up")
            time.sleep(0.1)
        make_nodes(client, num_nodes)
        sched = SchedulerServer(
            client, SchedulerServerOptions(algorithm_provider=provider,
                                           device=device)
        ).start()
        _wait_sched_ready(sched, out)
        if on_ready is not None:
            on_ready(sched, client)

        def count_scheduled() -> int:
            return len(sched.factory.assigned_informer.store.list_keys())

        t0 = time.time()
        pipeline_phases = _pipeline_snapshot()
        creator = subprocess.Popen(
            [sys.executable, "-m", "kubernetes_tpu_torch.harness.creator",
             "--server", url, "--pods", str(num_pods)],
            env=env,
        )
        creator.wait()
        if creator.returncode != 0:
            raise RuntimeError(
                f"pod creator exited {creator.returncode}; the "
                "measurement would wait forever"
            )
        created_secs = time.time() - t0
        print(
            f"created {num_pods} pods in {created_secs:.1f}s; "
            "scheduling...",
            file=out,
        )
        rate = _measure(count_scheduled, num_nodes, num_pods, out,
                        label=" [separate processes]",
                        pipeline_phases=pipeline_phases,
                        pipeline_start=t0)
        pipeline_secs = time.time() - t0
        if after is not None:
            after(sched, client)
        stats = {
            "pods_per_sec": rate,
            "creation_seconds": round(created_secs, 2),
            "pipeline_seconds": round(pipeline_secs, 2),
            "sustained_pods_per_sec": round(num_pods / pipeline_secs, 1),
        }
        counters = _scrape_counters(client)
        if counters:
            hits = counters.get("apiserver_watch_cache_hits_total", 0.0)
            misses = counters.get(
                "apiserver_watch_cache_misses_total", 0.0
            )
            stats.update({
                "apiserver_requests": int(counters.get(
                    "apiserver_requests_total", 0)),
                "watch_events_sent": int(counters.get(
                    "apiserver_watch_events_sent_total", 0)),
                "watch_cache_hits": int(hits),
                "watch_cache_misses": int(misses),
                "watch_cache_hit_rate": round(
                    hits / max(hits + misses, 1.0), 4),
                "batch_commits": int(counters.get(
                    "apiserver_batch_commit_size_objects_count", 0)),
                "batch_objects": int(counters.get(
                    "apiserver_batch_commit_size_objects_sum", 0)),
                "watch_events_dropped": int(counters.get(
                    "storage_watch_events_dropped_total", 0)),
                # coalesced-frame shape: how many events (and bytes)
                # each segmented burst frame carried on the wire
                "coalesced_frames": int(counters.get(
                    "apiserver_watch_coalesced_frame_objects_count", 0)),
                "coalesced_frame_objects": int(counters.get(
                    "apiserver_watch_coalesced_frame_objects_sum", 0)),
                "coalesced_frame_bytes": int(counters.get(
                    "apiserver_watch_coalesced_frame_bytes_sum", 0)),
                "fanout_pruned": int(counters.get(
                    "storage_watch_fanout_pruned_total", 0)),
                "ring_evictions": int(counters.get(
                    "storage_watch_cache_ring_evictions_total", 0)),
            })
            print(
                f"# apiserver wire: {stats.get('apiserver_requests', 0)} "
                f"requests, {stats.get('watch_events_sent', 0)} watch "
                f"events, cache hit rate "
                f"{stats.get('watch_cache_hit_rate', 0.0):.1%}, "
                f"{stats.get('batch_commits', 0)} batch commits / "
                f"{stats.get('batch_objects', 0)} objects",
                file=out,
            )
        return stats
    finally:
        if sched is not None:
            sched.stop()
        for proc in (creator, api_proc):
            if proc is None or proc.poll() is not None:
                continue
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=100)
    ap.add_argument("--pods", type=int, default=3000)
    ap.add_argument(
        "--provider", default="CUDAProvider",
        choices=["CUDAProvider", "TPUProvider", "DefaultProvider"],
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device of the scheduler (cpu runs it on "
                    "the host)")
    ap.add_argument(
        "--separate", action="store_true",
        help="run the apiserver and pod creators in their own processes "
        "(the reference's real deployment shape)",
    )
    # internal: the creator-subprocess entry for --separate
    ap.add_argument("--create-only", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--server", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.create_only:
        from kubernetes_tpu_torch.client.transport import HTTPTransport

        client = RESTClient(HTTPTransport(args.server, binary=True,
                                          timeout=180.0,
                                          user="perf-creator"))
        make_pods(client, args.pods)
        return
    if args.separate:
        schedule_pods_separate(args.nodes, args.pods, args.provider,
                               device=args.device)
        return
    schedule_pods(args.nodes, args.pods, args.provider, device=args.device)


if __name__ == "__main__":
    main()
