"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--baseline OLD.cu] [--baseline-k3 OLD.cu]
                          [--baseline-k6 OLD.cu] [--baseline-k7 OLD.cu]
                          [--baseline-k8 OLD.cu]

Phases, each printing one JSON line; any failure raises and exits
non-zero:
  1. device: the card's name, and its name and power limit as nvidia-smi
     reports them;
  2. build: the CUDA kernels (csrc/probe_kernel.cu, K1; csrc/
     zreplay_kernel.cu, K3, one report per template instance; csrc/
     preempt_kernel.cu, K6, one report per template instance; csrc/
     assign_kernel.cu, K7, the auction's and the beam's reports; csrc/
     resident_scatter.cu, K8, one report per template instance; csrc/
     chain_floor.cu, the yardsticks of K3, K7 and K8: the chain floor at
     128, 256 and 1,024 threads, the grid-sync floor and the launch
     floor, an empty kernel) built
     with nvcc for sm_90a from the
     sources in this checkout, in parallel, with ptxas's registers, spills
     and shared memory for each and, for K6, its static SASS counts
     (native/build.sass_counts: instructions, shuffles, barriers);
  3. kernel vs plain: ops/probe_kernel.resource_probe (K1) on the card
     against its plain torch version, exact equality, at the main path's
     shapes and on edge inputs (scenarios.PROBE_CASES, J=1 included),
     with profiler device times, the byte bound and the share of it
     reached, and the grid; with --baseline, also the probe kernel built
     from OLD.cu (a source with the same C interface, e.g. an earlier
     version of the kernel) against this checkout's, device times taken
     in turns (old, new, new, old) on every case; and K1's bf16 mode
     (resource_probe(bf16=True), the KUBERNETES_TPU_QUANT=bf16 profile)
     against its plain version, exact equality, on every PROBE_CASES
     entry and every scenarios.BF16_TERM_LISTS entry (the default
     weights, exact in bfloat16, and LR 30 + BA 1 and BA 7 + LR 40, whose
     bound passes 256 so that bfloat16 rounds), with the cells that
     round counted, and its profiler device time at (128, 8,192) beside
     the int64 mode's, the byte bound and the share;
  3b. K3 vs plain: ops/zreplay_kernel.replay_picks against
     replay_picks_plain, exact equality of chosen, j and (L, n_done,
     bailed), on scenarios.ZREPLAY_CASES, with device times (CUDA events
     around launches queued back to back behind a device sleep, outputs
     allocated once), microseconds per pick, the plain version's time
     and two bounds: the operations bound (the scores of the nodes fit at
     each pick) and the chain bound (the chain floor's time per step in a
     block of K3's 256 threads, measured first, times the run's picks);
     with --baseline-k3, also the pick loop built from OLD.cu (the same C
     interface) against this checkout's, device times in turns (old, new,
     new, old) and each one's max_abs_err against the plain version, on
     every case;
  3c. K6 vs plain: ops/preempt_kernel.victim_score against ops/preempt.
     victim_score_plain, exact equality of needed, cost and order, on
     scenarios.VICTIM_CASES (every slot invalid, fits now, fits only
     after evicting every candidate, no node fits, negative priorities,
     ties, C = 8, 32, 128, 1,024, the gang phase's own (8,192, 32), as
     the director builds it and as a fuzz, the director's table at C = 8,
     a fuzz at (8,192, 128) and a part-filled last block) and on the row
     tails (scenarios.VICTIM_TAILS, equality only), with each case's
     path (segment or block) and rows a block, the kernel's device time
     (profiler, every launch of the trace accounted for) with its inputs
     warm in L2 and, apart, with L2 flushed before each launch, the bound
     from the case's own candidates and its share, and the plain
     version's time; with --baseline-k6, also the scorer built from
     OLD.cu (the same C interface, e.g. an earlier version) against this
     checkout's, device times in turns (old, new, new, old), its
     max_abs_err against the plain version and both ptxas and SASS
     reports, on every case;
  3d. K7 vs plain: scheduler/optimizer/ops/assign_kernel.auction_assign
     (K7a, one cooperative launch) and beam_assign (K7b, one launch)
     against ops/assign._auction_assign_fn and _beam_assign_fn, exact
     equality of owner (dtype and values), on scenarios.ASSIGN_CASES (the
     solver fuzz's shapes, P and N not powers of two, all-equal scores,
     repeated FIFO ranks, a run past 64 rounds, pack_config2's full
     solve at (2,048, 1,024), the largest solve under the default slot
     cap at the density node count, (4,096, 8,192), beams at (32, 1,024)
     and (16, 8,192), an auction over two node tiles with a tie across
     the edge, clipped and repeated ranks, a beam whose placements free
     capacity, one that lands every step on one node, a beam at P = 64,
     and both solvers where used + req wraps) and on ASSIGN_WIDE_CASES
     (auctions over 49 node tiles and past the tiles shared memory holds),
     with the auction's path (unique keys or the general claim path),
     rounds run, grid and shared memory a block (0: node state in device
     memory); on the K7_TIMED shapes, the kernel's
     device time (profiler), the plain version's (CUDA events), the byte
     bound read once and over the rounds run (each round the rows of the
     slots that bid in it), for the auction the grid-sync bound (the
     syncs it ran times the grid-sync floor of csrc/chain_floor.cu
     measured at its grid) and for the beam the chain bound (P times the
     chain floor of a 128-thread block, its chain's four warps), and the
     shares; with --baseline-k7, also the K7 built from OLD.cu (the same
     C interface, e.g. an earlier version) held to the plain version on every
     case and timed in turns (old, new, new, old) on the K7_TIMED shapes,
     with baseline_ms and speedup;
  4. main path: the scheduler_perf density shape at the north-star size
     (5,000 nodes of 4 CPU / 32Gi / 110 pods, 50,000 pause pods of
     100m / 500Mi) through TorchScheduleAlgorithm on the card; every pod
     placed, 10 per node, names equal to the same call on the CPU, and
     the probe kernel launched (its launches counted by (J, N)); the
     encode (dedup, SnapshotEncoder, pad) timed alone on the same inputs
     beside the wave's wall;
  4b. zoned density: the same shape over zones a/b/c with one Service
     selecting every pod, so the run takes the zoned device replay (K1 +
     K3); every pod placed, zreplay dispatches > 0, K1 and K3 launched,
     and names equal to the same driver on the card with
     replay=replay_spec (the host spec replay); both wall times;
  4c. many templates: 5,000 unzoned nodes and 256 templates x 64 pods
     with distinct requests, through the grouped header probe (K1 at
     J=1); names equal to the same call on the CPU, group_probe >= 1;
  5. mixed backlog: ~1,000 heterogeneous nodes and a backlog of RC
     template runs, short runs and singletons, equal to the port's copy
     of the serial oracle, with its dispatch tally;
  6. Policy files with services: 5,000 policy-labelled nodes (zones
     a/b/c, disktype, memtype) and 64 Services x 128 pods, scheduled
     under each of scenarios.POLICY_DOCUMENTS (ServiceAffinity +
     LabelsPresence + ServiceAntiAffinity + LabelPreference; and
     ServiceAntiAffinity alone), each loaded from JSON through the
     port's load_policy -> create_from_config on the card; names equal
     to the same call on the CPU, each Service's pods in one zone (or in
     every zone), K1 launched; the wall time, its share in the host spec
     replay (models/replay.replay_spec), the dispatches, K1's launches
     by (J, N), and the device's busy time and idle share over a traced
     wave of 8 Services; on 1,000 nodes x 512 pods, names equal to the
     port's oracle copy resolved from the same document (resolve_policy,
     serial);
  7. the extender service: filter, prioritize (one pod, 5,000 nodes,
     2,000 existing pods) and scheduleBacklog (256 pending pods) through
     TorchExtenderServer.handle on the card and on a CPU instance,
     replies equal field for field; each verb's wall time, and its parts
     timed apart (JSON parse, object decode, snapshot encode, device);
  8. gangs and priority preemption: 5,000 density nodes each holding 24
     bound priority-0 pods of 150m / 500Mi; wave 1 of 4,096 singletons,
     256 gangs x 16 members (4 request templates of 100-250m,
     priorities 1-4), a gang short of its minMember and a priority-10
     gang of 256 x 1 CPU that cannot fit, through GangDirector.plan_wave
     -> TorchScheduleAlgorithm.schedule_backlog(gangs=) -> after_wave on
     the card (the director plans the big gang's victims with K6 at
     (8,192, 32)); wave 2 reruns the big gang without its victims and
     binds it whole. Hosts, parks, statuses, victims and dispatch
     tallies equal to the same flow on the CPU (host_jobs); no gang
     partly placed, no victim at priority 10 or above, K1 and K6
     launched; wall times per step and _place_gang's share;
  9. the daemon's scheduling core: (9a) phase 4's density shape through
     a SchedulerCache fed the nodes, TorchScheduleAlgorithm(cache=) warmed
     up for them and core.Scheduler.schedule_one until the queue is empty
     (waves of 4,096, then the bind pool): every pod bound, the names of
     phase 4's one-shot call pod for pod, every wave after the first from
     the incremental encoder's wave_view, K1 launched; the wall, pods/s,
     each wave's seconds in wave_view, the algorithm and the assume and
     bind, the resident tables' counts and the idle share; (9b) phase 8's
     gang scenario cut to 1,000 nodes through the same loop with the
     GangDirector wired in, the parked big gang queued again: binds,
     errors, statuses, victims and cycles equal to the same flow on the
     CPU (host_jobs), no gang partly bound, K1 and K6 launched;
  10. the scheduler daemon on the wire: (10a) harness/perf.schedule_pods
     at phase 4's density shape through the port's own control plane in
     this process (APIServer, LocalTransport, the informers, the FIFO,
     SchedulerServer on the card): every pod bound as read back from the
     apiserver, 10 a node, the hosts in the order the loop bound them
     equal to the one-shot schedule_backlog on the card over the
     apiserver's nodes and as many copies of its pod, every wave from
     wave_view, K1 launched; the harness's pods/s over its window and
     sustained from the start of creation to the last bind, the creation
     seconds, the waves, the phase table, K1's launches by (J, N) and the
     idle share over the creation -> all-bound window (a trace that loses
     K1 events is taken again, with the run); (10b) harness/perf.
     schedule_pods_separate at 1,000 nodes x 30,000 pods: the apiserver
     and the pod creator in their own interpreters over the binary wire,
     the daemon on the card here; every pod bound, the hosts in loop order
     and per node equal to the one-shot call's, the rates and the
     apiserver's counters; (10c) into 10a's idle daemon, 200 pods one at
     a time, each waiting for its bind: p50, p99 and max from the create
     request to the bind's return, the port's
     scheduler_e2e_scheduling_latency quantiles over them, and the picks
     equal to the last 200 of the one-shot call over all 50,200 pods;
  12. the kernel-path profiles: the JAX package's bench.py --raw-curve
     backlog (scenarios.multi_template_backlog: 8 templates in runs of
     512, each with a preferred anti-affinity to the next group and a
     Service, so every run takes the per-run probe) at 5,000 nodes
     (padded to 8,192) x 12,288 pods through TorchScheduleAlgorithm on
     the card, in the arms wide_serial (KUBERNETES_TPU_QUANT=off),
     quant_serial (int), wide_pipeline and quant_pipeline
     (KUBERNETES_TPU_PIPELINE=1), bf16 (KUBERNETES_TPU_QUANT=bf16 with
     KUBERNETES_TPU_QUANT_SHADOW=1: every wave shadow-checked at full
     width) and bf16 under scenarios.POLICY_LR30 (LeastRequested at
     weight 30, the bound past 256); each arm cold once and warm
     PROFILE_WARM times: walls, host-to-device bytes (Packer), the cold
     table bytes, the dispatches with their stage count, the probe's
     overlap seconds (trace/profile.overlap_totals), K1's launches by
     (J, N, mode) and the shadow gate's stats; the warm calls run in turns
     across the arms, the order reversed each round. Names equal across the
     four int64 arms, the default bf16 arm and the same call on the CPU
     (wide_serial's, in a host_jobs worker); the LR 30 arm's names equal
     a full-width call under the same Policy; the pipelined arms stage,
     the quantized arms place narrower tables, the bf16 arms launch K1's
     bf16 mode;
  13. the optimizing profile (TorchScheduleAlgorithm(profile=
     "optimizing")): the JAX package's bench.py --pack configs at full
     width through scenarios.pack_config2 (1,000 nodes padded to 1,024,
     2,000 pods of three templates, LeastRequested + BalancedAllocation)
     and pack_config4 (999 zoned nodes, 1,998 pods of two RC templates,
     the default provider), each in a greedy and an optimizing arm on the
     card: names equal to the port's CPU run of the same arm
     (host_jobs), the optimizing arm strictly above greedy in pods
     scheduled and in utilization, both at 6 dispatches or fewer, K1 and
     K7 launched in the optimizing arms by the counters and by the
     trace; each arm's wall and stats, and for the optimizing arms the
     solve's device time and the idle share from a second, traced call
     (a greedy arm's serial scan launches ~10^6 kernels, whose trace
     takes minutes to read: its idle share is not measured); on
     pack_config2's cluster a gang of 64 x 3 CPU ahead of 64 singletons
     binds all or nothing (both packages park it on the 1,000 nodes
     padded to 1,024: the auction's tie rotation runs over the padding)
     and whole on 1,024 nodes, a gang of 1,001 x 3 CPU comes back all
     None and a 24-pod wave takes the beam (K7b), each equal to the CPU;
  14. the mesh (parallel/mesh, parallel/resident; every shard on cuda:0,
     the one card): (a) the row scatter K8 (parallel/resident_kernel)
     against its plain version, exact, both one launch a shard
     (scatter_rows) and one device-wide launch of every shard
     (scatter_shipment), on scenarios.SCATTER_CASES (every dtype pair
     the snapshot places, the node axis first and second, 2-D rows,
     off-shard and padded rows, M = 64 and 1,024, 4 x 2,048 and 1 x
     8,192 nodes); (b) phase 4's
     density shape through TorchScheduleAlgorithm(mesh=...) at 4 shards
     and at 1: names equal to phase 4's, K1 launched at the shard width
     (2,048 at 4 shards), the wall after a warm-up call, the idle share
     and the dispatch tally; (c) that backlog in MESH_WAVES waves at 4
     shards on the resident state (reuse="auto", binds between waves)
     beside a reship run and one device in lockstep: steady waves ship
     no table bytes and keep every resident tensor's storage; then a
     churn wave (labels and allocatable on MESH_CHURN_NODES nodes, one
     node removed inside the bucket) launches K8 once for each device
     holding a shard that owns a changed row (once: the shards share the
     card), names equal to the reship run's and one device's; that
     launch is held against the plain version on each shard's tables as
     they were before it, and the shipment (as the resident state built
     it: rows at the placed dtypes) is timed (queued CUDA events) with
     its byte bound, its launch bound (the launch floor, csrc/
     chain_floor.cu's empty kernel timed the same way, times the
     launches it needs), the plain version and the index_copy_ calls
     that make the same update; with --baseline-k8, also the first K8 built
     from OLD.cu (its C interface: one launch an owning shard, e.g. `git
     show f2e6205:kubernetes_tpu_torch/csrc/resident_scatter.cu`) held
     to the same shipment and timed in turns (old, new, new, old), with
     baseline_ms and speedup; (d) MeshBatchScheduler at 4 shards on phase
     5's mixed scenario equal to the single-device scan;
  11. the kernels line, with the launch counts of each path it drove
     (K1's bf16 mode as its own entry, resource_probe_bf16: phase 12's
     bf16 arms are its path; K7's auction and beam as assign_auction and
     assign_beam: phase 13 is their path; K1's mesh paths; K8 as
     resident_scatter, the churn wave its path); then nvidia-smi's line,
     then the result line {"ok": true, "device": {...}}.

Every idle share comes from a profiler trace kept only when its K1, K3,
K6 and K7 events equal the launches the wrappers counted during the
traced call (device_busy_ms, and traced_call in phase 13); the line
prints both.

Each path's launch counts are set to 0 just before it and read just
after; a path that does not launch each of its kernels fails. The
host-only references (the serial oracle of phases 5 and 6, phase 6's
CPU runs, the CPU flows of phases 8 and 9b, phase 12's and phase 13's
CPU runs) run from
the start in three worker processes of two torch threads each
(host_jobs), beside the card's phases.

Exits non-zero, printing no result, when CUDA is not available or when
the port's package is not beside this script.
"""

from __future__ import annotations

import argparse
import io
import json
import math
import multiprocessing
import os
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

#: NVIDIA H100 SXM data sheet: HBM3 rate and the float64 and float32
#: rates of the CUDA cores (the probe's float64 BalancedAllocation math,
#: the pick loop's float32 SelectorSpread math); the int32 rate of the
#: CUDA cores from NVIDIA's H100 architecture whitepaper (SXM5: 33.5
#: TOPS), for the pick loop's 64-bit score sums and compares
HBM_BYTES_PER_S = 3.35e12
F64_FLOP_PER_S = 34e12
F32_FLOP_PER_S = 67e12
INT32_OPS_PER_S = 33.5e12
#: K3's block size (csrc/zreplay_kernel.cu THREADS): its chain bound uses
#: the chain floor of a block this size
K3_THREADS = 256
#: the threads of the K7 beam's chain (its four warps, one a beam): its
#: chain bound uses the chain floor of a block this size
BEAM_CHAIN_THREADS = 128
#: cycles of the device sleep that queued_ms puts ahead of its window
#: (about 20 ms at the H100's clocks)
SLEEP_CYCLES = 40_000_000
#: (nodes, services, pods per service) of phase 6, and of its check
#: against the serial oracle
POLICY_SIZE = (5000, 64, 128)
POLICY_ORACLE_SIZE = (1000, 4, 128)
#: (nodes, template scale) of phase 5's mixed backlog
MIXED_SIZE = (1000, 2)
#: worker processes for host_jobs (two cores of torch each)
HOST_WORKERS = 3
#: phase 8: (nodes, bound priority-0 pods per node, singletons, gangs,
#: members per gang, members of the priority-10 gang)
GANG_SIZE = (5000, 24, 4096, 256, 16, 256)
#: phase 9a: (nodes, pods), phase 4's density shape
DAEMON_SIZE = (5000, 50000)
#: phase 9b: phase 8's scenario cut to 1,000 nodes, and its singletons and
#: gangs in proportion (800 and 50); the times the parked big gang is
#: queued again
DAEMON_GANG_SIZE = (1000, 24, 800, 50, 16, 256)
DAEMON_GANG_RETRIES = 3
#: phase 10a: (nodes, pods) through the control plane in process, phase
#: 4's north-star density shape; 10b: (nodes, pods) across processes,
#: the shape of the JAX package's wire headline (BENCH_r10.json); 10c:
#: the pods created one at a time into 10a's idle daemon
WIRE_SIZE = (5000, 50000)
WIRE_SEPARATE_SIZE = (1000, 30000)
WIRE_LATENCY_PODS = 200
#: 10a's runs, each traced, until one trace keeps every K1 launch
WIRE_TRACE_TRIES = 3
#: phase 12: (nodes, pods) of the kernel-path profiles' backlog (the JAX
#: package's bench.py --raw-curve size, at the north star's node count),
#: and the warm calls of each arm after its cold one
PROFILE_SIZE = (5000, 12288)
PROFILE_WARM = 2


#: the script's start, for the elapsed seconds of every phase line
T0 = time.perf_counter()


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw,
                      "elapsed_s": time.perf_counter() - T0}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- phase 3: the kernel against its plain version ---------------------------


def probe_inputs(S, N, seed, **opts):
    """scenarios.probe_case placed on the card for one resource_probe
    call."""
    alloc, usage, pod = S.probe_case(N, seed, **opts)
    def put(a):
        return torch.tensor(a, dtype=torch.int64, device="cuda")

    return (tuple(map(put, alloc)), tuple(map(put, usage)),
            {k: put(v) for k, v in pod.items()})


def cuda_ms(fn, reps=21, inner=10) -> float:
    """Median over `reps` of the mean CUDA-event time of `inner` calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def queued_ms(fn, reps, inner) -> float:
    """Median over `reps` of the mean CUDA-event time of `inner` calls of
    fn back to back, queued behind a device sleep (SLEEP_CYCLES) so that
    the host's time to enqueue them falls outside the window: device time,
    with the gaps between launches. Raises if enqueuing them took the host
    half the sleep or more."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        if enqueue_s >= 0.01:
            raise AssertionError(f"enqueuing {inner} launches took the host "
                                 f"{enqueue_s * 1e3:.3f} ms: the window "
                                 f"would hold host time")
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def kernel_device_ms(fn, name, n=20, tries=8, events=False):
    """-> (mean device time of the kernel `name` per launch, summed device
    time of every kernel per call of fn, in ms, over n calls of fn, each
    launching `name` once, from the profiler's CUPTI trace; the launches
    of `name` that each trace taken recorded, the kept one last). A trace
    is kept only when it accounts for every launch: `name` recorded n
    times and every other kernel a multiple of n times. One that falls
    short is taken again, up to `tries` traces in all; then it raises,
    or with events=True times the n calls with queued CUDA events
    (queued_ms: device time with the gaps between launches, and whatever
    else fn queues) and marks `seen` with "events". (Traces on the H100
    have kept as few as 0 of 20 launches, in phase 3 and after it, and
    once none in 8 traces running; the rows print `traces`.)"""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total_us, count, all_us, whole = 0.0, 0, 0.0, True
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", 0.0)
            if not us:
                continue
            all_us += us
            whole = whole and ev.count % n == 0
            if name in ev.key:
                total_us += us
                count += ev.count
        seen.append(count)
        if count == n and whole:
            return total_us / count / 1e3, all_us / n / 1e3, seen
    if events:
        ms = queued_ms(fn, reps=5, inner=n)
        return ms, ms, seen + ["events"]
    raise RuntimeError(f"{tries} profiler traces of {n} launches of {name} "
                       f"recorded {seen} of them")


def device_busy_ms(fn, kernels, tries=5):
    """-> (summed device time of every kernel and copy of one traced call
    of fn, in ms, or None when the trace shows none; its wall seconds;
    {kernel: launches} that the wrappers counted during that call; the
    kernel events each trace taken recorded, {kernel: events}, the kept
    one last). kernels: {the kernel's symbol: its wrapper module, whose
    LAUNCHES counts its launches}. A trace is kept only when it records
    each kernel as many times as its wrapper counted launches during the
    traced call; one that falls short is taken again (fn is called
    again), up to `tries` traces in all; then it raises. (Traces on the
    H100 have kept as few as 0 of 20 launches; an idle share read from a
    trace that lost kernel events would be too high.) The trace records
    only the device's activity: the host's ops would add their own cost
    to the wall (and to the idle share) and to calls that launch
    millions of kernels."""
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for _ in range(tries):
        before = {k: m.LAUNCHES for k, m in kernels.items()}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launched = {k: m.LAUNCHES - before[k] for k, m in kernels.items()}
        busy_ms, events = trace_busy(prof, kernels)
        seen.append(events)
        if events == launched:
            return busy_ms, wall, launched, seen
    raise RuntimeError(f"{tries} profiler traces recorded {seen} kernel "
                       f"events where the wrappers counted the launches "
                       f"{launched}")


def trace_busy(prof, kernels) -> tuple:
    """A finished profiler trace -> (summed device time of every kernel
    and copy in it, in ms, or None when it shows none; {kernel: the
    events it recorded of each of `kernels`})."""
    events = dict.fromkeys(kernels, 0)
    busy_us = 0.0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += ev.self_device_time_total
        for k in kernels:
            if k in ev.key:
                events[k] += ev.count
    return (busy_us / 1e3 if busy_us else None), events


def idle_fields(busy_ms, wall, launched, seen) -> dict:
    """The idle-share fields of a phase's line, from device_busy_ms."""
    return {"traced_wall_s": wall, "device_busy_ms": busy_ms,
            "device_idle_share": (None if busy_ms is None
                                  else 1.0 - busy_ms / 1e3 / wall),
            "traced_launches": launched, "trace_kernel_events": seen}


def probe_bound_ms(J, N) -> tuple:
    """Least time for the sweep: each input read once, each output written
    once, over the HBM rate; the float64 ops (2 div, 2 sub, 1 mul per
    (j, n)) over the float64 rate. -> (ms, "bytes" | "operations")."""
    nbytes = 9 * 8 + 10 * N * 8 + N * 8 + J * N * 8
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 5 * J * N / F64_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def probe_case_inputs(S, seed, case):
    """-> (J, N, alloc, usage, pod, wants_res) of one PROBE_CASES entry
    on the card."""
    label, J, N, opts = case
    opts = dict(opts)
    wants_res = opts.pop("wants_res", True)
    alloc, usage, pod = probe_inputs(S, N, seed, **opts)
    return J, N, alloc, usage, pod, wants_res


def max_abs_err(PK, inputs, lib=None) -> int:
    """Largest |kernel - plain| over the frontier and the tab of one
    probe case, the kernel launched from lib (this checkout's by
    default)."""
    J, N, alloc, usage, pod, wants_res = inputs
    fr_k, tab_k = PK._launch(J, alloc, usage, PK.pod_vector(pod), 1, 1,
                             wants_res, lib=lib)
    fr_p, tab_p = PK.resource_probe_plain(J, alloc, usage, pod,
                                          (("lr", 1), ("ba", 1)),
                                          wants_res=wants_res)
    torch.cuda.synchronize()
    return max(int((fr_k - fr_p).abs().max()),
               int((tab_k - tab_p).abs().max()))


def phase_kernel(PK, S):
    terms = (("lr", 1), ("ba", 1))
    results = {}
    max_err = 0
    for seed, case in enumerate(S.PROBE_CASES):
        label = case[0]
        inputs = probe_case_inputs(S, seed, case)
        J, N, alloc, usage, pod, wants_res = inputs
        fr_k, tab_k = PK.resource_probe(J, alloc, usage, pod, terms,
                                        wants_res=wants_res)
        fr_p, tab_p = PK.resource_probe_plain(J, alloc, usage, pod, terms,
                                              wants_res=wants_res)
        torch.cuda.synchronize()
        err = max(int((fr_k - fr_p).abs().max()),
                  int((tab_k - tab_p).abs().max()))
        equal = bool(torch.equal(fr_k, fr_p) and torch.equal(tab_k, tab_p))
        max_err = max(max_err, err)
        pv = PK.pod_vector(pod)

        def launch():
            PK._launch(J, alloc, usage, pv, 1, 1, wants_res)

        # ms: the kernel's device time (profiler); call_device_ms: the
        # device time of every kernel of one wrapper call (the zero fill
        # of the frontier and the kernel); call_ms: the time of one
        # launch through the wrapper back to back (CUDA events), which
        # at these sizes is the host's launch rate
        ms, call_device_ms, traces = kernel_device_ms(
            launch, "resource_probe_kernel")
        call_ms = cuda_ms(launch)
        plain_ms = cuda_ms(lambda: PK.resource_probe_plain(
            J, alloc, usage, pod, terms, wants_res=wants_res))
        bound_ms, bound_by = probe_bound_ms(J, N)
        row = dict(ms=ms, call_device_ms=call_device_ms, traces=traces,
                   call_ms=call_ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   bound_share=bound_ms / ms, **PK.launch_grid(J, N))
        results.setdefault((J, N), row)
        emit("kernel_vs_plain", case=label, J=J, N=N, equal=equal,
             max_abs_err=err, library_call="none", **row)
        if not equal:
            raise AssertionError(f"probe kernel != plain on {label}")
    return results, max_err


def phase_kernel_bf16(PK, S, i64_row):
    """K1's bf16 mode against its plain version on every probe case and
    term list (exact), and its device time at the density path's shape,
    J=128, N=8,192 (the default terms), beside the int64 mode's
    (i64_row, phase_kernel's row at that shape). -> (its row, the
    largest |kernel - plain|)."""
    max_err = 0
    for seed, case in enumerate(S.PROBE_CASES):
        label = case[0]
        J, N, alloc, usage, pod, wants_res = probe_case_inputs(S, seed, case)
        for name, terms in S.BF16_TERM_LISTS:
            fr_k, tab_k = PK.resource_probe(J, alloc, usage, pod, terms,
                                            wants_res=wants_res, bf16=True)
            fr_p, tab_p = PK.resource_probe_plain(
                J, alloc, usage, pod, terms, wants_res=wants_res, bf16=True)
            _fr, tab_i = PK.resource_probe_plain(J, alloc, usage, pod,
                                                 terms, wants_res=wants_res)
            torch.cuda.synchronize()
            err = max(int((fr_k - fr_p).abs().max()),
                      int((tab_k - tab_p).abs().max()))
            equal = bool(torch.equal(fr_k, fr_p)
                         and torch.equal(tab_k, tab_p))
            max_err = max(max_err, err)
            emit("kernel_bf16_vs_plain", case=label, terms=name, J=J, N=N,
                 equal=equal, max_abs_err=err,
                 rounded_cells=int((tab_p != tab_i).sum()),
                 cells=tab_p.numel())
            if not equal:
                raise AssertionError(f"probe kernel bf16 != plain on "
                                     f"{label}, {name}")
    J, N = 128, 8192
    seed, case = next((i, c) for i, c in enumerate(S.PROBE_CASES)
                      if c[1:3] == (J, N))
    J, N, alloc, usage, pod, wants_res = probe_case_inputs(S, seed, case)
    terms = dict(S.BF16_TERM_LISTS)["default"]
    pv = PK.pod_vector(pod)
    ms, call_device_ms, traces = kernel_device_ms(
        lambda: PK._launch_bf16(J, alloc, usage, pv, terms, wants_res),
        "resource_probe_bf16_kernel")
    plain_ms = cuda_ms(lambda: PK.resource_probe_plain(
        J, alloc, usage, pod, terms, wants_res=wants_res, bf16=True))
    # the same bytes as the int64 mode: tab is int64 either way
    bound_ms, bound_by = probe_bound_ms(J, N)
    row = dict(ms=ms, call_device_ms=call_device_ms, traces=traces,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               bound_share=bound_ms / ms, i64_ms=i64_row["ms"],
               over_i64=ms / i64_row["ms"])
    emit("kernel_bf16_time", J=J, N=N, terms="default", **row)
    return row, max_err


def phase_baseline(PK, S, baseline_src):
    """The kernel built from baseline_src against this checkout's, on
    every probe case: device times (profiler) in turns old, new, new,
    old, and each one's max_abs_err against the plain version."""
    from kubernetes_tpu_torch.native.build import (
        build_cuda_file, ptxas_report,
    )

    path = build_cuda_file(os.path.abspath(baseline_src),
                           "probe_kernel_baseline")
    libs = {"old": PK.load(path), "new": PK._lib()}
    emit("baseline_build", source=baseline_src,
         ptxas=ptxas_report(path, "resource_probe_kernel"))
    for seed, case in enumerate(S.PROBE_CASES):
        inputs = probe_case_inputs(S, seed, case)
        J, N, alloc, usage, pod, wants_res = inputs
        pv = PK.pod_vector(pod)
        times = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            times[which].append(kernel_device_ms(
                lambda: PK._launch(J, alloc, usage, pv, 1, 1, wants_res,
                                   lib=libs[which]),
                "resource_probe_kernel")[0])
        bound_ms, bound_by = probe_bound_ms(J, N)
        old_ms = statistics.mean(times["old"])
        new_ms = statistics.mean(times["new"])
        emit("kernel_ab", case=case[0], J=J, N=N, old_ms=times["old"],
             new_ms=times["new"], speedup=old_ms / new_ms,
             bound_ms=bound_ms, bound_by=bound_by,
             old_bound_share=bound_ms / old_ms,
             new_bound_share=bound_ms / new_ms,
             old_max_abs_err=max_abs_err(PK, inputs, libs["old"]),
             new_max_abs_err=max_abs_err(PK, inputs, libs["new"]))


# -- phase 3b: K3 against its plain version -----------------------------------


def zreplay_bound_ms(N, K, node_picks) -> tuple:
    """Least time for one run's pick loop: its inputs read once (eleven
    i64 rows, the u8 fit row, the i32 zones, five scalars) and its outputs
    written once (chosen i32[K], j i64[N], three i64) over the HBM rate;
    what each pick needs of each node fit at it (node_picks in all): the
    float32 add of its spread and zone terms and the truncation, over the
    float32 rate, and the 64-bit add to its score and the compare with the
    maximum (two int32 operations each), over the int32 rate.
    -> (ms, "bytes" | "operations")."""
    nbytes = N * (11 * 8 + 1 + 4) + 5 * 8 + K * 4 + N * 8 + 3 * 8
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (2 * node_picks / F32_FLOP_PER_S
             + 4 * node_picks / INT32_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def live_node_picks(nodes, chosen) -> int:
    """The sum over a run's picks of the nodes fit at each (fit_static and
    j < frontier): the scores the pick loop must evaluate."""
    left = nodes["frontier"].cpu().tolist()
    fit = ((nodes["fit_static"] != 0) & (nodes["frontier"] > 0)).cpu()
    n_fit, total = int(fit.sum()), 0
    for m in chosen.cpu().tolist():
        if m < 0:
            break
        total += n_fit
        left[m] -= 1
        n_fit -= left[m] == 0
    return total


def zreplay_inputs(S, case, seed):
    """One scenarios.ZREPLAY_CASES entry on the card: -> (label, N,
    nodes, scalars, weights, kw)."""
    label, N, K, opts = case
    c = S.zreplay_case(N, seed, K=K, **opts)
    nodes = {k: torch.from_numpy(v).cuda() for k, v in c["nodes"].items()}
    veto = torch.from_numpy(c["veto"]).cuda()
    nodes["frontier"] = torch.where(veto, nodes["frontier"].clamp(max=1),
                                    nodes["frontier"])
    sc = c["scalars"]
    scalars = torch.tensor([sc["nz_mcpu"], sc["nz_mem"], sc["selfmatch"],
                            sc["L0"], 1], device="cuda")
    kw = {k: c[k] for k in ("K", "k_real", "rows_dyn", "num_zones",
                            "has_selectors")}
    return label, N, nodes, scalars, c["weights"], kw


def k3_reports(lib) -> dict:
    """ptxas's report of each template instance of K3 (its nodes per
    thread in registers; 0 is the device-memory path)."""
    from kubernetes_tpu_torch.native.build import ptxas_report

    return {f"slots={k}": ptxas_report(lib, f"zreplay_kernelILi{k}E")
            for k in (1, 2, 4, 8, 16, 32, 0)}


def phase_chain_floor(lib, steps=50000) -> dict:
    """The chain floor: the time of one step of csrc/chain_floor.cu (one
    block, a block-wide max, a broadcast and one barrier per step) at 256
    threads (K3's block), 1,024 and 128 (the K7 beam's chain), CUDA
    events over `steps` steps. -> {threads: microseconds per step}."""
    import ctypes

    fn = ctypes.CDLL(lib).chain_floor_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    out = torch.empty(1, dtype=torch.int64, device="cuda")
    us = {}
    for threads in (K3_THREADS, 1024, BEAM_CHAIN_THREADS):
        def launch():
            err = fn(out.data_ptr(), steps, threads,
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"chain_floor launch failed: error {err}")

        ms = queued_ms(launch, reps=5, inner=1)
        us[threads] = ms * 1e3 / steps
        emit("chain_floor", steps=steps, threads=threads, ms=ms,
             us_per_step=us[threads])
    return us


def k3_launcher(ZK, nodes, scalars, weights, lib=None, **kw):
    """-> a function that launches K3 (of lib; this checkout's by default)
    through its C entry on outputs and scratch allocated once, for
    timing. It passes by the wrapper, so its launches are not counted."""
    args, out, scratch = ZK._c_args(nodes, scalars, weights, lib=lib, **kw)
    fn = (lib or ZK._lib()).zreplay_launch

    def launch():
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"zreplay kernel launch failed: error {err}")

    launch.buffers = (out, scratch)
    return launch


def phase_k3(ZK, S, chain_us, old_lib=None):
    """K3 against its plain version on every ZREPLAY_CASES entry, with
    device times (queued_ms) and both bounds; with old_lib, also the K3
    of that library in turns old, new, new, old. chain_us: the chain
    floor's microseconds per step in a block of K3's size."""
    results = {}
    max_err = 0
    for seed, case in enumerate(S.ZREPLAY_CASES):
        label, N, nodes, scalars, weights, kw = zreplay_inputs(S, case, seed)
        got = ZK.replay_picks(nodes, scalars, weights, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = ZK.replay_picks_plain(nodes, scalars, weights, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3

        def err_of(out):
            return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                       for a, b in zip(out, want))

        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        err = err_of(got)
        max_err = max(max_err, err)
        picks = int((got[0] >= 0).sum())
        node_picks = live_node_picks(nodes, want[0])
        launchers = {"new": k3_launcher(ZK, nodes, scalars, weights, **kw)}
        if old_lib:
            launchers["old"] = k3_launcher(ZK, nodes, scalars, weights,
                                           old_lib, **kw)
        turns = ("old", "new", "new", "old") if old_lib else ("new",)
        reps, inner = (3, 1) if kw["K"] > 8192 else (7, 10)
        times = {"old": [], "new": []}
        for which in turns:
            times[which].append(queued_ms(launchers[which], reps, inner))
        ms = statistics.mean(times["new"])
        bound_ms, bound_by = zreplay_bound_ms(N, kw["K"], node_picks)
        chain_ms = chain_us * picks / 1e3
        row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, bound_share=bound_ms / ms,
                   chain_bound_ms=chain_ms, chain_share=chain_ms / ms,
                   picks=picks, node_picks=node_picks,
                   us_per_pick=ms * 1e3 / max(picks, 1),
                   scratch_bytes=ZK.scratch_bytes(N, kw["num_zones"]))
        if old_lib:
            old_ms = statistics.mean(times["old"])
            old = ZK._launch(nodes, scalars, weights, lib=old_lib, **kw)
            torch.cuda.synchronize()
            row.update(new_ms=times["new"], old_ms=times["old"],
                       old_us_per_pick=old_ms * 1e3 / max(picks, 1),
                       speedup=old_ms / ms, old_max_abs_err=err_of(old),
                       old_bound_share=bound_ms / old_ms,
                       old_chain_share=chain_ms / old_ms)
        results[label] = row
        emit("k3_vs_plain", case=label, N=N, K=kw["K"],
             k_real=kw["k_real"], num_zones=kw["num_zones"], equal=equal,
             max_abs_err=err, state=got[2].tolist(), library_call="none",
             **row)
        if not equal:
            raise AssertionError(f"K3 != plain on {label}")
    return results, max_err


# -- phase 3c: K6 against its plain version -----------------------------------


def victim_bound_ms(prio, gang_prio) -> tuple:
    """Least time for K6 on this case's inputs, counting only what its
    outputs depend on. Bytes: every slot's prio read and order written
    (8 B); a candidate's (prio < gang_prio) ord and four res rows (36 B
    more), since an invalid slot's key is the sentinel and what it frees
    is masked to 0; every node's free read and needed and cost written
    (44 B); req. Operations: a sort of each row's v candidates (v log2 v
    64-bit compares), six 64-bit prefix sums and eight 64-bit compares a
    candidate, two int32 operations for each 64-bit one. Bytes over the
    HBM rate, operations over the int32 rate. -> (ms, "bytes" |
    "operations")."""
    N, C = prio.shape
    per_row = (prio < gang_prio).sum(dim=1).to(torch.float64)
    valid = float(per_row.sum())
    nbytes = N * C * 8 + valid * 36 + N * 44 + 32
    sort = float((per_row * torch.log2(per_row.clamp(min=2))).sum())
    ops = 2 * (sort + 14 * valid)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def k6_report(lib, kernel) -> dict:
    """ptxas's report of one K6 kernel of lib, with its static SASS counts
    (native/build.sass_counts) under "sass"."""
    from kubernetes_tpu_torch.native.build import ptxas_report, sass_counts

    return {**ptxas_report(lib, kernel), "sass": sass_counts(lib, kernel)}


def k6_reports(lib) -> dict:
    """k6_report of each template instance of K6: the segment path at
    W = C <= 32, the block path at C = 64..1,024."""
    return {**{f"segment C={w}": k6_report(
                   lib, f"victim_score_kernel_segILi{w}E")
               for w in (1, 2, 4, 8, 16, 32)},
            **{f"block C={c}": k6_report(
                   lib, f"victim_score_kernel_blkILi{c}E")
               for c in (64, 128, 256, 512, 1024)}}


#: the per-case keys of K6's entry in the kernels line
K6_CASE_KEYS = ("N", "C", "path", "rows_per_block", "ms", "cold_ms",
                "baseline_ms", "baseline_cold_ms", "speedup", "bound_ms",
                "bound_by", "bound_share", "cold_bound_share", "plain_ms")

#: bytes written before a cold launch: twice the H100's 50 MB L2
L2_FLUSH_BYTES = 100 << 20


def phase_k6(VK, S, P, ptxas, old=None):
    """K6 against victim_score_plain on every scenarios.VICTIM_CASES entry,
    exact equality of needed, cost and order, with the kernel's device
    time (profiler) with its inputs warm in L2 (launched back to back)
    and cold (L2_FLUSH_BYTES written before each launch), CUDA events
    around launches queued behind a device sleep (gaps included) as a
    cross-check, the plain version's time (CUDA events), the bound and
    its share; and on every scenarios.VICTIM_TAILS shape, equality only.
    ptxas: k6_reports of this checkout's library. old: (library, its
    k6_report) of a baseline K6, also held to the plain version and
    timed in turns old, new, new, old. -> ({label: row}, max_abs_err)."""
    results, max_err = {}, 0
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def inputs(N, C, seed, kind):
        c = S.victim_case(N, C, seed, kind)
        return [torch.as_tensor(c[k]).cuda()
                for k in ("prio", "ord", "res", "free", "req")], \
            c["gang_prio"]

    def err_of(got, want):
        return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                   for a, b in zip(got, want))

    def same(got, want):
        return all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(got, want))

    for seed, (label, N, C, kind) in enumerate(S.VICTIM_CASES):
        args, gp = inputs(N, C, seed, kind)
        got = VK.victim_score(*args, gp)
        want = P.victim_score_plain(*args, gp)
        torch.cuda.synchronize()
        equal = same(got, want)
        err = err_of(got, want)
        max_err = max(max_err, err)
        libs = {"new": None}
        if old:
            libs["old"] = old[0]
        turns = ("old", "new", "new", "old") if old else ("new",)
        warm, traces = {"old": [], "new": []}, []
        for which in turns:
            ms, _, seen = kernel_device_ms(
                lambda lib=libs[which]: VK._launch(*args, gp, lib=lib),
                "victim_score_kernel")
            warm[which].append(ms)
            traces.append(seen)
        cold = {which: kernel_device_ms(
            lambda lib=lib: (flush.zero_(), VK._launch(*args, gp, lib=lib)),
            "victim_score_kernel")[0] for which, lib in libs.items()}
        events_ms = queued_ms(lambda: VK._launch(*args, gp), reps=7,
                              inner=10)
        plain_ms = cuda_ms(lambda: P.victim_score_plain(*args, gp), reps=7,
                           inner=3)
        bound_ms, bound_by = victim_bound_ms(args[0], gp)
        ms = statistics.mean(warm["new"])
        lay = VK.layout(C)
        kernel = (f"segment C={C}" if lay["path"] == "segment"
                  else f"block C={C}")
        row = dict(N=N, C=C, path=lay["path"], rows_per_block=lay["rows"],
                   threads=lay["threads"], ms=ms, new_ms=warm["new"],
                   traces=traces, cold_ms=cold["new"], events_ms=events_ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   bound_share=bound_ms / ms,
                   cold_bound_share=bound_ms / cold["new"],
                   ptxas=ptxas[kernel])
        if old:
            old_out = VK._launch(*args, gp, lib=old[0])
            torch.cuda.synchronize()
            old_ms = statistics.mean(warm["old"])
            row.update(baseline_ms=old_ms, old_ms=warm["old"],
                       baseline_cold_ms=cold["old"], speedup=old_ms / ms,
                       old_max_abs_err=err_of(old_out, want),
                       old_bound_share=bound_ms / old_ms,
                       old_ptxas=old[1])
        results[label] = row
        needed = got[0].cpu()
        emit("k6_vs_plain", case=label, kind=kind, equal=equal,
             max_abs_err=err, library_call="none",
             needed_counts={str(k): v for k, v in zip(
                 *(x.tolist() for x in torch.unique(
                     needed, return_counts=True)))}, **row)
        if not equal:
            raise AssertionError(f"K6 != plain on {label}")
    for N, C in S.VICTIM_TAILS:
        args, gp = inputs(N, C, N + C, "fuzz")
        got = VK.victim_score(*args, gp)
        want = P.victim_score_plain(*args, gp)
        torch.cuda.synchronize()
        equal = same(got, want)
        emit("k6_tail_vs_plain", N=N, C=C, equal=equal,
             max_abs_err=err_of(got, want), **VK.layout(C))
        if not equal:
            raise AssertionError(f"K6 != plain on the tail N={N} C={C}")
    return results, max_err


# -- phase 3d: K7 against its plain version -----------------------------------

#: the ASSIGN_CASES entries phase 3d times: the auction at pack_config2's
#: full solve and at the largest solve under the default slot cap at the
#: density node count, the beam at two node counts; the first of each
#: solver is its row in the kernels line
K7_TIMED = ("pack P=2048 N=1024", "pack P=4096 N=8192", "beam P=32 N=1024",
            "beam P=16 N=8192")
K7_MAIN = {"auction": "pack P=2048 N=1024", "beam": "beam P=32 N=1024"}
#: grid syncs in one run of the grid-sync floor
GRID_SYNC_STEPS = 2000


def assign_bound_ms(P, N) -> float:
    """Least time for one solve of K7: its inputs read once and owner
    written once over the HBM rate: fit and score (9 B a slot and node),
    req, commit, check, prio and order (76 B a slot), cap (32 B a node),
    owner (4 B a slot). The auction's rounds re-read the slot rows:
    assign_rounds_bound_ms counts them."""
    nbytes = P * N * 9 + P * 80 + N * 32
    return nbytes / HBM_BYTES_PER_S * 1e3


def assign_rounds_bound_ms(P, N, bids, ran) -> float:
    """Least time for the `ran` rounds an auction launch ran (bids
    i32[rounds] from assign_kernel._launch_auction, rounds_run of them
    `ran`): each round reads the rows of the slots that bid in it (fit,
    score, req, commit, check, prio and order: 9 B a node and 76 B) and
    cap (32 B a node); owner is written once. Slots already seated, or
    with no fitting node left, bid in no round and are not counted."""
    rows = int(bids.to(torch.int64).sum())
    nbytes = rows * (N * 9 + 76) + ran * N * 32 + P * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def auction_syncs(bids, ran, general) -> int:
    """The grid syncs an auction launch ran: one after its set-up, then a
    round's one (after the bid; the next round seats the winners) or two
    on the general path (and after the claim), and one in a round
    without a bid, where it stops."""
    per = 2 if general else 1
    stopped = ran and int(bids[ran - 1]) == 0
    return 1 + (ran - 1) * per + 1 if stopped else 1 + ran * per


def assign_sync_bound_ms(syncs, sync_us) -> float:
    """Least time of an auction launch's grid syncs: `syncs` times the
    grid-sync floor at its grid (sync_us microseconds each)."""
    return syncs * sync_us / 1e3


def assign_beam_chain_bound_ms(P, chain_us) -> float:
    """Least time of the beam's chain: P dependent steps, each at least
    the chain floor of a block of its four warps (chain_us microseconds,
    BEAM_CHAIN_THREADS)."""
    return P * chain_us / 1e3


def k7_reports(lib) -> dict:
    """ptxas's reports of lib's K7 kernels: the auction with its node
    state in shared memory ("auction"; a build with one auction instance
    names it plainly) and in device memory ("auction_slab", where built),
    and the beam."""
    from kubernetes_tpu_torch.native.build import ptxas_report

    return {"auction": (ptxas_report(lib, "assign_auction_kernelILb0E")
                        or ptxas_report(lib, "assign_auction_kernel")),
            "auction_slab": ptxas_report(lib, "assign_auction_kernelILb1E"),
            "beam": ptxas_report(lib, "assign_beam_kernel")}


#: the C interface a baseline K7 shares with this checkout's
K7_BASELINE_EXPORTS = ("assign_auction_launch", "assign_auction_scratch_bytes",
                       "assign_beam_launch")


def load_baseline_k7(AK, path):
    """A K7 library built from another assign_kernel.cu, with the exports
    it shares with this checkout's declared: its auction runs through
    AK._launch_auction(lib=), its beam through baseline_beam."""
    import ctypes

    lib = ctypes.CDLL(path)
    for name, res, args in AK._EXPORTS:
        if name in K7_BASELINE_EXPORTS:
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
    return lib


def baseline_beam(AK, lib, fit, score, req, commit, check, cap):
    """K7b of a baseline library whose beam walks the K x N x 4 used
    table of every beam: it takes that double buffer (2 x K x N x 4 i64)
    and the choices (2 x K x P i32) -> owner i32[P]."""
    P, N = fit.shape
    used = torch.empty((2 * AK.BEAM_K * N * 4,), dtype=torch.int64,
                       device=fit.device)
    choice = torch.empty((2 * AK.BEAM_K * P,), dtype=torch.int32,
                         device=fit.device)
    owner = torch.empty((P,), dtype=torch.int32, device=fit.device)
    err = lib.assign_beam_launch(
        fit.data_ptr(), score.data_ptr(), req.data_ptr(), commit.data_ptr(),
        check.data_ptr(), cap.data_ptr(), P, N, used.data_ptr(),
        choice.data_ptr(), owner.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"baseline beam launch failed: CUDA error {err}")
    return owner


def k7_inputs(S, A, case, seed):
    """An ASSIGN_CASES entry on the card -> (tables, prio, order, eps0,
    rounds)."""
    _label, P, N, kind, live, _solver = case
    c = S.assign_case(P, N, seed, kind, live)
    t = {k: torch.as_tensor(v).cuda() for k, v in c.items()}
    tabs = [t[k] for k in ("fit", "score", "req", "commit", "check", "cap")]
    return (tabs, t["prio"].to(torch.int32), t["order"].to(torch.int32),
            A.auction_eps0(c["score"], N), A.auction_rounds(P, N))


def phase_grid_sync_floor(chain_lib, AK, S) -> dict:
    """The grid-sync floor at each timed auction shape: a cooperative
    launch of csrc/chain_floor.cu grid_sync_floor_kernel with the
    auction's grid, block and dynamic shared memory at that (P, N), doing
    nothing but GRID_SYNC_STEPS grid syncs (queued CUDA events). ->
    {(P, N): microseconds per sync}."""
    import ctypes

    fn = ctypes.CDLL(chain_lib).grid_sync_floor_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    out = torch.empty(1, dtype=torch.int64, device="cuda")
    us = {}
    for label, P, N, _kind, _live, solver in S.ASSIGN_CASES:
        if label not in K7_TIMED or solver != "auction":
            continue
        blocks, smem = AK.auction_grid(P, N), AK.auction_smem_bytes(N)

        def launch():
            err = fn(out.data_ptr(), GRID_SYNC_STEPS, blocks,
                     AK.AUCTION_THREADS, smem,
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"grid_sync_floor launch failed: error "
                                   f"{err}")

        ms = queued_ms(launch, reps=5, inner=1)
        us[(P, N)] = ms * 1e3 / GRID_SYNC_STEPS
        emit("grid_sync_floor", P=P, N=N, blocks=blocks,
             threads=AK.AUCTION_THREADS, smem=smem, steps=GRID_SYNC_STEPS,
             ms=ms, us_per_sync=us[(P, N)])
    return us


def phase_k7(AK, A, S, ptxas, chain_us, sync_us, old=None):
    """K7 against its plain version on every scenarios.ASSIGN_CASES entry
    (the solver fuzz's shapes, P and N not powers of two, all-equal
    scores, repeated FIFO ranks, a run past 64 rounds, the profile's
    solve shapes, two node tiles, clipped ranks, negative commits, one
    node, P = 64), exact equality of owner, dtype and values, with the
    auction's path, rounds run and grid; on the K7_TIMED entries the
    kernel's device time (profiler, every launch of the trace accounted
    for; queued CUDA events where no trace keeps them all), the plain version's (CUDA events), the byte bound read once and
    over the rounds run, the grid-sync bound (auction) or the chain
    bound (beam), and the shares. chain_us: the chain floor of the
    beam's chain; sync_us: {(P, N): the grid-sync floor}. old: (library,
    its k7_reports) of a baseline K7, also held to the plain version on
    every case and timed in turns old, new, new, old. -> ({label: row},
    max_abs_err)."""
    results, max_err = {}, 0
    libs = {"new": None}
    if old:
        libs["old"] = old[0]
    turns = ("old", "new", "new", "old") if old else ("new",)
    for seed, case in enumerate(S.ASSIGN_CASES + S.ASSIGN_WIDE_CASES):
        label, P, N, kind, _live, solver = case
        tabs, prio, order, eps0, rounds = k7_inputs(S, A, case, seed)
        ran = general = None
        if solver == "auction":
            def kernel(lib=None):
                return AK._launch_auction(*tabs, prio, order, eps0, rounds,
                                          lib=lib)

            def plain():
                return A._auction_assign_fn(rounds, *tabs, prio, order, eps0)

            got, bids, flag = AK._launch_auction(*tabs, prio, order, eps0,
                                                 rounds, bids=True)
            torch.cuda.synchronize()
            ran = AK.rounds_run(bids)
            general = bool(int(flag[0]))
            symbol = "assign_auction_kernel"
        else:
            def kernel(lib=None):
                if lib is None:
                    return AK._launch_beam(*tabs)
                return baseline_beam(AK, lib, *tabs)

            def plain():
                return A._beam_assign_fn(4, 4, *tabs)

            got = kernel()
            symbol = "assign_beam_kernel"
        want = plain()
        torch.cuda.synchronize()

        def err_of(out):
            return int((out.to(torch.int64) - want.to(torch.int64))
                       .abs().max())

        equal = got.dtype == want.dtype and torch.equal(got, want)
        err = err_of(got)
        max_err = max(max_err, err)
        row = dict(P=P, N=N, kind=kind, solver=solver,
                   assigned=int((got >= 0).sum()), rounds=rounds,
                   rounds_run=ran, ptxas=ptxas[solver])
        if solver == "auction":
            row.update(grid=AK.auction_grid(P, N),
                       smem=AK.auction_smem_bytes(N),
                       path="general" if general else "unique",
                       syncs=auction_syncs(bids, ran, general))
        if old:
            old_got = kernel(old[0])
            torch.cuda.synchronize()
            row.update(old_equal=bool(old_got.dtype == want.dtype
                                      and torch.equal(old_got, want)),
                       old_max_abs_err=err_of(old_got))
        if label in K7_TIMED:
            times, seen = {"old": [], "new": []}, []
            for which in turns:
                ms, _call_ms, traces = kernel_device_ms(
                    lambda lib=libs[which]: kernel(lib), symbol, n=10,
                    events=True)
                times[which].append(ms)
                seen.append(traces)
            ms = statistics.mean(times["new"])
            once = assign_bound_ms(P, N)
            row.update(ms=ms, new_ms=times["new"], traces=seen,
                       plain_ms=cuda_ms(plain, reps=3, inner=1),
                       bound_ms=once, bound_by="bytes",
                       bound_share=once / ms)
            if solver == "auction":
                rounds_ms = assign_rounds_bound_ms(P, N, bids, ran)
                sync_ms = assign_sync_bound_ms(row["syncs"], sync_us[(P, N)])
                row.update(per_round_bound_ms=rounds_ms,
                           per_round_share=rounds_ms / ms,
                           sync_floor_us=sync_us[(P, N)],
                           sync_bound_ms=sync_ms, sync_share=sync_ms / ms)
            else:
                chain_ms = assign_beam_chain_bound_ms(P, chain_us)
                row.update(chain_floor_us=chain_us, chain_bound_ms=chain_ms,
                           chain_share=chain_ms / ms)
            if old:
                old_ms = statistics.mean(times["old"])
                row.update(baseline_ms=old_ms, old_ms=times["old"],
                           speedup=old_ms / ms, old_ptxas=old[1][solver])
        results[label] = row
        emit("k7_vs_plain", case=label, equal=equal, max_abs_err=err,
             library_call="none", **row)
        if not equal:
            raise AssertionError(f"K7 != plain on {label}")
        if old and not row["old_equal"]:
            raise AssertionError(f"baseline K7 != plain on {label}")
    return results, max_err


# -- phase 13: the optimizing profile -----------------------------------------

#: phase 13's waves on pack_config2's cluster beside its two arms: a gang
#: of 64 x 3 CPU at the head of 64 1-CPU singletons (room enough; on the
#: 1,000 nodes padded to 1,024 both packages park it, ROADMAP.md queue 3,
#: and on 1,024 nodes it binds whole), a gang of 1,001 x 3 CPU (one more
#: than the nodes: it cannot fit), and 24 pods (a wave the beam takes)
OPT_GANG_FIT = (64, 64)
OPT_GANG_UNFIT = 1001
OPT_BEAM_PODS = 24


def optimizing_waves(T, S):
    """phase 13's calls: -> [(label, pack config, pods, gangs, profile)],
    the pack configs at full size in both arms, then the gang and beam
    waves on pack_config2's cluster."""
    out = []
    for key, build in S.PACK_CONFIGS.items():
        cfg = build(T)
        for prof in ("greedy", "optimizing"):
            out.append((f"{key}_{prof}", cfg, cfg["pods"], None, prof))
    cfg = S.pack_config2(T)
    pods, gangs = S.pack_gang_wave(T, OPT_GANG_FIT[0],
                                   singles=OPT_GANG_FIT[1], name="fit")
    out.append(("gang_fit", cfg, pods, gangs, "optimizing"))
    out.append(("gang_fit_1024", S.pack_config2(T, n_nodes=1024), pods,
                gangs, "optimizing"))
    pods, gangs = S.pack_gang_wave(T, OPT_GANG_UNFIT, name="unfit")
    out.append(("gang_unfit", cfg, pods, gangs, "optimizing"))
    out.append(("beam_wave", cfg, cfg["pods"][:OPT_BEAM_PODS], None,
                "optimizing"))
    return out


def optimizing_algorithm(device, cfg, prof):
    from kubernetes_tpu_torch.models import batch as B
    from kubernetes_tpu_torch.harness import scenarios as S
    from kubernetes_tpu_torch.scheduler.algorithm import (
        TorchScheduleAlgorithm,
    )

    return TorchScheduleAlgorithm(device=device, profile=prof,
                                  config=S.pack_scheduler_config(B, cfg))


def optimizing_cpu_names():
    """Phase 13's calls on the CPU (a host_jobs worker): -> ({label:
    names}, {label: seconds})."""
    from kubernetes_tpu_torch.api import types as T
    from kubernetes_tpu_torch.harness import scenarios as S
    from kubernetes_tpu_torch.oracle import ClusterState

    names, seconds = {}, {}
    for label, cfg, pods, gangs, prof in optimizing_waves(T, S):
        t0 = time.perf_counter()
        names[label] = optimizing_algorithm("cpu", cfg, prof).schedule_backlog(
            pods, S.pack_state(ClusterState, cfg), gangs=gangs)
        seconds[label] = time.perf_counter() - t0
    return names, seconds


def traced_call(fn, kernels, solve_symbol, tries=3):
    """device_busy_ms for a call that also reports the device time of the
    kernel solve_symbol: -> (fn's result, idle fields, solve ms)."""
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for _ in range(tries):
        before = {k: m.LAUNCHES for k, m in kernels.items()}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launched = {k: m.LAUNCHES - before[k] for k, m in kernels.items()}
        busy_ms, events = trace_busy(prof, kernels)
        seen.append(events)
        if events == launched:
            solve_us = sum(ev.self_device_time_total
                           for ev in prof.key_averages()
                           if solve_symbol in ev.key)
            return (out, idle_fields(busy_ms, wall, launched, seen),
                    solve_us / 1e3)
    raise RuntimeError(f"{tries} profiler traces recorded {seen} kernel "
                       f"events where the wrappers counted {launched}")


def phase_optimizing(PK, AK, jobs):
    """Phase 13: the optimizing profile at full width. pack_config2 and
    pack_config4 in a greedy and an optimizing arm on the card, each
    arm's wall, an optimizing arm's call traced again (idle share, the
    solve's device time); names equal
    to the port's CPU run of the same arm (jobs["optimizing_cpu"]); the
    optimizing arm strictly above greedy in pods scheduled and
    utilization; both arms at 6 dispatches or fewer; K1 and K7 launched
    in the optimizing arms, by the counters and by the trace. On
    pack_config2's cluster: a gang with room binds all or nothing (on
    the padded 1,000 nodes both packages park it) and whole on 1,024
    nodes, an unfittable one comes back all None, and a 24-pod wave takes
    the beam (K7b), each equal to the CPU. -> {label: (K1 launches, K1 shapes, K7 launches, K7
    shapes)}."""
    from kubernetes_tpu_torch.api import types as T
    from kubernetes_tpu_torch.harness import scenarios as S
    from kubernetes_tpu_torch.oracle import ClusterState

    kernels = {"resource_probe_kernel": PK,
               "assign_auction_kernel": AK}
    cpu_names, cpu_seconds = jobs["optimizing_cpu"].get()
    paths, arms = {}, {}
    for label, cfg, pods, gangs, prof in optimizing_waves(T, S):
        state = S.pack_state(ClusterState, cfg)
        cold_wall = None
        if prof == "optimizing":
            # the first call pays the first use of each torch op; the
            # greedy arms run the serial scan, used since phase 5
            t0 = time.perf_counter()
            optimizing_algorithm("cuda", cfg, prof).schedule_backlog(
                pods, state, gangs=gangs)
            torch.cuda.synchronize()
            cold_wall = time.perf_counter() - t0
        algo = optimizing_algorithm("cuda", cfg, prof)
        reset(PK, AK)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        names = algo.schedule_backlog(pods, state, gangs=gangs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k7 = PK.LAUNCHES, AK.LAUNCHES
        k7_shapes = [{"solver": s, "P": P, "N": N, "launches": k}
                     for (s, P, N), k in sorted(AK.LAUNCHES_BY_SHAPE.items())]
        paths[label] = (k1, shapes(PK.LAUNCHES_BY_SHAPE), k7, k7_shapes)
        driver = algo._opt or algo._wave
        idle, solve_ms = dict.fromkeys((
            "traced_wall_s", "device_busy_ms", "device_idle_share",
            "traced_launches", "trace_kernel_events")), None
        if prof == "optimizing":
            # the same call again, traced; a greedy arm's ~10^6 scan
            # launches make a trace that takes minutes to read, so its
            # idle share is not measured here (phase 6 traces the scan)
            algo._last_node_index = 0
            traced, idle, solve_ms = traced_call(
                lambda: algo.schedule_backlog(pods, state, gangs=gangs),
                kernels if label != "beam_wave" else {
                    "resource_probe_kernel": PK, "assign_beam_kernel": AK},
                "assign_beam_kernel" if label == "beam_wave"
                else "assign_auction_kernel")
            if traced != names:
                raise AssertionError(f"phase 13 {label}: the traced call "
                                     f"chose other nodes")
        disp = dict(driver.dispatches)
        total = sum(v for k, v in disp.items() if k != "scan_pods")
        out = S.pack_outcome(pods, names, cfg["alloc_mcpu"])
        if names != cpu_names[label]:
            raise AssertionError(f"phase 13 {label}: the card's names differ "
                                 f"from the CPU run's")
        if total > 6:
            raise AssertionError(f"phase 13 {label}: {disp}")
        # traced_call kept only a trace whose K1 and K7 events equal the
        # launches counted during the call
        if prof == "optimizing" and (
                k1 <= 0 or k7 <= 0
                or 0 in idle["traced_launches"].values()):
            raise AssertionError(f"phase 13 {label}: K1 {k1}, K7 {k7}, "
                                 f"trace {idle['trace_kernel_events']}")
        arms[label] = out
        emit("optimizing", case=label, profile=prof,
             nodes=len(cfg["nodes"]), **out, wall_s=wall,
             cold_wall_s=cold_wall, solve_device_ms=solve_ms,
             stats=dict(algo._opt.stats) if algo._opt else None,
             dispatches=disp, dispatches_total=total, k1_launches=k1,
             k1_launches_by_shape=paths[label][1], k7_launches=k7,
             k7_launches_by_shape=k7_shapes, cpu_worker_s=cpu_seconds[label],
             equal_to_cpu=True, **idle)
    for key in S.PACK_CONFIGS:
        g, o = arms[f"{key}_greedy"], arms[f"{key}_optimizing"]
        if not (o["scheduled"] > g["scheduled"]
                and o["utilization"] > g["utilization"]):
            raise AssertionError(f"phase 13 {key}: optimizing {o} does not "
                                 f"beat greedy {g}")
    members, singles = OPT_GANG_FIT
    bound = {label: arms[label]["scheduled"] - singles
             for label in ("gang_fit", "gang_fit_1024")}
    if bound["gang_fit"] not in (0, members) \
            or bound["gang_fit_1024"] != members:
        raise AssertionError(f"phase 13: the 64-member gang bound "
                             f"{bound} (all or nothing; whole on 1,024 "
                             f"nodes)")
    if arms["gang_unfit"]["scheduled"] != 0:
        raise AssertionError("phase 13: the unfittable gang bound in part")
    if [s["solver"] for s in paths["beam_wave"][3]] != ["beam"]:
        raise AssertionError(f"phase 13: the 24-pod wave took "
                             f"{paths['beam_wave'][3]}")
    emit("optimizing_gates", gang_members_bound=bound, **{
        key: {"greedy": arms[f"{key}_greedy"],
              "optimizing": arms[f"{key}_optimizing"]}
        for key in S.PACK_CONFIGS})
    return paths


# -- phases 4 and 5: the scheduler -------------------------------------------


def phase_main_path(PK, ZK, T, ClusterState, TorchScheduleAlgorithm, S):
    from kubernetes_tpu_torch.snapshot.encode import SnapshotEncoder
    from kubernetes_tpu_torch.snapshot.pad import next_pow2, pad_snapshot

    n_nodes, n_pods = 5000, 50000
    nodes = S.density_nodes(T, n_nodes)
    pods = S.pause_pods(T, n_pods)
    state = ClusterState.build(nodes)
    # a first wave pays the first use of every torch CUDA kernel; the
    # measured wave is the second, from the same state
    t0 = time.perf_counter()
    TorchScheduleAlgorithm(device="cuda").schedule_backlog(pods, state)
    torch.cuda.synchronize()
    cold_wall = time.perf_counter() - t0
    algo = TorchScheduleAlgorithm(device="cuda")
    reset(PK, ZK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    names = algo.schedule_backlog(pods, state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = PK.LAUNCHES
    by_shape = shapes(PK.LAUNCHES_BY_SHAPE)
    tally = dict(algo._wave.dispatches)
    if any(n is None for n in names):
        raise AssertionError("main path left pods unplaced")
    per_node = {}
    for n in names:
        per_node[n] = per_node.get(n, 0) + 1
    if len(per_node) != n_nodes or set(per_node.values()) != {10}:
        raise AssertionError("main path did not place 10 pods per node")
    if launches <= 0:
        raise AssertionError("main path never launched the probe kernel")
    # the host split: the encode alone (dedup, SnapshotEncoder, node-axis
    # pad) on the same inputs, beside the wave's wall
    t1 = time.perf_counter()
    reps, _rep_idx = algo._dedup(pods)
    enc = SnapshotEncoder(state, reps, config=algo._wave.config)
    snap = enc.encode_nodes()
    enc.encode_pods()
    pad_snapshot(snap, next_pow2(snap.num_nodes, 64))
    encode_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    cpu_names = TorchScheduleAlgorithm(device="cpu").schedule_backlog(
        pods, state)
    cpu_wall = time.perf_counter() - t1
    if cpu_names != names:
        raise AssertionError("card and CPU runs chose different nodes")
    idle = idle_fields(*device_busy_ms(
        lambda: TorchScheduleAlgorithm(device="cuda").schedule_backlog(
            pods, state), counted_kernels(PK, ZK)))
    emit("main_path", nodes=n_nodes, pods=n_pods, wall_s=wall,
         encode_s=encode_s, encode_share=encode_s / wall,
         cold_wall_s=cold_wall, **idle,
         pods_per_s=n_pods / wall, probes=tally.get("probe", 0),
         scans=tally.get("scan", 0), scan_pods=tally.get("scan_pods", 0),
         kernel_launches=launches, launches_by_shape=by_shape,
         cpu_wall_s=cpu_wall, equal_to_cpu=True, pods_per_node=10)
    return launches, by_shape, names, wall


def reset(*kernels) -> None:
    for K in kernels:
        K.LAUNCHES = 0
        K.LAUNCHES_BY_SHAPE.clear()


def counted_kernels(*wrappers) -> dict:
    """{the kernel's symbol in a profiler trace: its wrapper module} for
    device_busy_ms."""
    symbols = {"probe_kernel": "resource_probe_kernel",
               "zreplay_kernel": "zreplay_kernel",
               "preempt_kernel": "victim_score_kernel"}
    return {symbols[m.__name__.rsplit(".", 1)[1]]: m for m in wrappers}


def phase_zoned_density(PK, ZK, T, ClusterState, TorchScheduleAlgorithm, S,
                        replay_spec, n_nodes=5000, n_pods=50000):
    """The density shape over zones a/b/c, one Service selecting every
    pod: the zoned device replay (K1 + K3) against the host spec replay
    (replay=replay_spec) on the card."""
    nodes = S.zoned_density_nodes(T, n_nodes)
    pods = S.pause_pods(T, n_pods)
    state = ClusterState.build(nodes, services=[
        S.service(T, "svc", {"name": "sched-perf"})])
    t0 = time.perf_counter()
    TorchScheduleAlgorithm(device="cuda").schedule_backlog(pods, state)
    torch.cuda.synchronize()
    cold_wall = time.perf_counter() - t0
    algo = TorchScheduleAlgorithm(device="cuda")
    reset(PK, ZK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    names = algo.schedule_backlog(pods, state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k3 = PK.LAUNCHES, ZK.LAUNCHES
    k1_shapes, k3_shapes = shapes(PK.LAUNCHES_BY_SHAPE), k3_shapes_of(ZK)
    tally = dict(algo._wave.dispatches)
    if any(n is None for n in names):
        raise AssertionError("zoned density left pods unplaced")
    if tally.get("zreplay", 0) + tally.get("zreplay_group", 0) <= 0:
        raise AssertionError(f"zoned density took no device replay: {tally}")
    if k1 <= 0 or k3 <= 0:
        raise AssertionError(f"zoned density launched K1 {k1}, K3 {k3} times")
    spec = TorchScheduleAlgorithm(device="cuda", replay=replay_spec)
    t1 = time.perf_counter()
    spec_names = spec.schedule_backlog(pods, state)
    torch.cuda.synchronize()
    spec_wall = time.perf_counter() - t1
    spec_tally = dict(spec._wave.dispatches)
    if spec_names != names:
        i = next(i for i, (a, b) in enumerate(zip(names, spec_names))
                 if a != b)
        raise AssertionError(f"zoned density: pod {i} went to {names[i]}, "
                             f"the spec replay chose {spec_names[i]}")
    per_zone = {}
    zone_of = {n.metadata.name: n.metadata.labels.get(S.ZONE) for n in nodes}
    for n in names:
        per_zone[zone_of[n]] = per_zone.get(zone_of[n], 0) + 1
    idle = idle_fields(*device_busy_ms(
        lambda: TorchScheduleAlgorithm(device="cuda").schedule_backlog(
            pods, state), counted_kernels(PK, ZK)))
    emit("zoned_density", nodes=n_nodes, pods=n_pods, wall_s=wall,
         cold_wall_s=cold_wall, pods_per_s=n_pods / wall,
         spec_replay_wall_s=spec_wall, spec_over_device=spec_wall / wall,
         **idle, dispatches=tally, spec_dispatches=spec_tally, k1_launches=k1,
         k1_launches_by_shape=k1_shapes, k3_launches=k3,
         k3_launches_by_shape=k3_shapes, pods_per_zone=per_zone,
         equal_to_spec_replay=True)
    return k1, k1_shapes, k3, k3_shapes


def phase_many_templates(PK, T, ClusterState, TorchScheduleAlgorithm, S,
                         n_nodes=5000, templates=256, per=64):
    """256 templates x 64 pods with distinct requests on 5,000 unzoned
    nodes: the grouped header probe (K1 at J=1) and host replay, against
    the same call on the CPU."""
    nodes = S.density_nodes(T, n_nodes)
    pods = S.template_pods(T, templates, per, cpu0=20, mem_step=40)
    state = ClusterState.build(nodes)
    algo = TorchScheduleAlgorithm(device="cuda")
    reset(PK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    names = algo.schedule_backlog(pods, state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k1_shapes = PK.LAUNCHES, shapes(PK.LAUNCHES_BY_SHAPE)
    j1 = sum(k for (J, _N, _m), k in PK.LAUNCHES_BY_SHAPE.items()
             if J == 1)
    tally = dict(algo._wave.dispatches)
    if tally.get("group_probe", 0) < 1 or j1 <= 0:
        raise AssertionError(f"many templates took no grouped probe: {tally}")
    t1 = time.perf_counter()
    cpu_names = TorchScheduleAlgorithm(device="cpu").schedule_backlog(
        pods, state)
    cpu_wall = time.perf_counter() - t1
    if cpu_names != names:
        raise AssertionError("many templates: card and CPU runs differ")
    emit("many_templates", nodes=n_nodes, templates=templates,
         pods=len(pods),
         wall_s=wall, pods_per_s=len(pods) / wall, cpu_wall_s=cpu_wall,
         dispatches=tally, group_probes=tally.get("group_probe", 0),
         probes=tally.get("probe", 0), k1_launches=k1,
         k1_launches_at_j1=j1, k1_launches_by_shape=k1_shapes,
         unscheduled=names.count(None), equal_to_cpu=True)
    return k1, k1_shapes


def k3_shapes_of(ZK) -> list:
    """{(N, K, num_zones): launches} -> [{"N", "K", "num_zones",
    "launches"}, ...] in order."""
    return [{"N": N, "K": K, "num_zones": z, "launches": k}
            for (N, K, z), k in sorted(ZK.LAUNCHES_BY_SHAPE.items())]


def mixed_oracle_names(n_nodes, scale):
    """The port's serial oracle copy on phase 5's mixed backlog: ->
    (names, seconds). Run in a worker process (host_jobs)."""
    from kubernetes_tpu_torch.api import types as T
    from kubernetes_tpu_torch.harness import scenarios as S
    from kubernetes_tpu_torch.oracle import ClusterState, GenericScheduler

    nodes, services = S.mixed_cluster(T, n_nodes)
    state = ClusterState.build(nodes, services=services)
    pods = S.mixed_backlog(T, scale=scale)
    t0 = time.perf_counter()
    names = GenericScheduler().schedule_backlog(pods, state)
    return names, time.perf_counter() - t0


def phase_mixed(PK, ZK, T, ClusterState, TorchScheduleAlgorithm, S,
                oracle):
    """The mixed backlog on the card against the serial oracle (oracle:
    the AsyncResult of mixed_oracle_names)."""
    nodes, services = S.mixed_cluster(T, MIXED_SIZE[0])
    pods = S.mixed_backlog(T, scale=MIXED_SIZE[1])
    state = ClusterState.build(nodes, services=services)
    algo = TorchScheduleAlgorithm(device="cuda")
    reset(PK, ZK)
    t0 = time.perf_counter()
    names = algo.schedule_backlog(pods, state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = PK.LAUNCHES
    by_shape = shapes(PK.LAUNCHES_BY_SHAPE)
    k3, k3_shapes = ZK.LAUNCHES, k3_shapes_of(ZK)
    tally = dict(algo._wave.dispatches)
    if launches <= 0:
        raise AssertionError("mixed backlog never launched the probe kernel")
    if tally.get("zreplay", 0) + tally.get("zreplay_group", 0) and k3 <= 0:
        raise AssertionError("mixed backlog's device replays never "
                             "launched K3")
    want, oracle_wall = oracle.get()
    if names != want:
        i = next(i for i, (a, b) in enumerate(zip(names, want)) if a != b)
        raise AssertionError(
            f"mixed backlog: pod {i} ({pods[i].metadata.name}) went to "
            f"{names[i]}, the oracle chose {want[i]}")
    emit("mixed_backlog", nodes=len(nodes), pods=len(pods), wall_s=wall,
         oracle_s=oracle_wall, dispatches=tally,
         probes=tally.get("probe", 0), scans=tally.get("scan", 0),
         scan_pods=tally.get("scan_pods", 0), kernel_launches=launches,
         launches_by_shape=by_shape, k3_launches=k3,
         k3_launches_by_shape=k3_shapes, unscheduled=want.count(None),
         equal_to_oracle=True)
    return launches, by_shape, k3, k3_shapes

# -- phase 6: Policy files with services; phase 7: the extender service ------


def policy_oracle_names(name, n_nodes, services, per):
    """The port's oracle copy resolved from POLICY_DOCUMENTS[name]
    (resolve_policy, serial) on a policy_nodes cluster and a
    service_backlog: -> (names, seconds). Run in a worker process
    (host_jobs), since the serial oracle takes minutes."""
    from kubernetes_tpu_torch.api import types as T
    from kubernetes_tpu_torch.harness import scenarios as S
    from kubernetes_tpu_torch.oracle import ClusterState, GenericScheduler
    # the provider registrations resolve_policy looks the keys up in
    import kubernetes_tpu_torch.scheduler.algorithmprovider  # noqa: F401
    from kubernetes_tpu_torch.scheduler.plugins import PluginFactoryArgs
    from kubernetes_tpu_torch.scheduler.policy import (
        load_policy, resolve_policy,
    )

    svcs, pods = S.service_backlog(T, services, per)
    state = ClusterState.build(S.policy_nodes(T, n_nodes), services=svcs)
    preds, prios = resolve_policy(
        load_policy(json.dumps(S.POLICY_DOCUMENTS[name])),
        PluginFactoryArgs())
    t0 = time.perf_counter()
    names = GenericScheduler(predicates=list(preds.items()),
                             priorities=prios).schedule_backlog(pods, state)
    return names, time.perf_counter() - t0


def policy_cpu_names(name, n_nodes, services, per):
    """POLICY_DOCUMENTS[name] through the port's load_policy ->
    create_from_config on the CPU (device="cpu"): -> (names, seconds).
    Run in a worker process (host_jobs)."""
    from kubernetes_tpu_torch.api import types as T
    from kubernetes_tpu_torch.harness import scenarios as S
    from kubernetes_tpu_torch.oracle import ClusterState
    from kubernetes_tpu_torch.scheduler.factory import create_from_config
    from kubernetes_tpu_torch.scheduler.policy import load_policy

    svcs, pods = S.service_backlog(T, services, per)
    state = ClusterState.build(S.policy_nodes(T, n_nodes), services=svcs)
    algo = create_from_config(
        load_policy(json.dumps(S.POLICY_DOCUMENTS[name])), device="cpu")
    t0 = time.perf_counter()
    names = algo.schedule_backlog(pods, state)
    return names, time.perf_counter() - t0


def host_jobs(pool, S) -> dict:
    """Start the run's host-only reference computations in `pool`, so
    that they overlap the card's phases: the serial oracle of phases 5
    and 6, phase 6's CPU runs, the CPU flows of phases 8 and 9b and
    phase 12's CPU run. -> {key:
    AsyncResult}."""
    jobs = {"mixed_oracle": pool.apply_async(mixed_oracle_names,
                                             MIXED_SIZE)}
    for name in S.POLICY_DOCUMENTS:
        jobs[f"policy_oracle_{name}"] = pool.apply_async(
            policy_oracle_names, (name, *POLICY_ORACLE_SIZE))
        jobs[f"policy_cpu_{name}"] = pool.apply_async(
            policy_cpu_names, (name, *POLICY_SIZE))
    jobs["gang_cpu"] = pool.apply_async(gang_cpu_flow, (GANG_SIZE,))
    jobs["daemon_gang_cpu"] = pool.apply_async(
        daemon_gang_cpu_flow, (DAEMON_GANG_SIZE, DAEMON_GANG_RETRIES))
    jobs["profile_cpu"] = pool.apply_async(profile_cpu_names,
                                           (PROFILE_SIZE,))
    jobs["optimizing_cpu"] = pool.apply_async(optimizing_cpu_names)
    return jobs


def worker_init() -> None:
    """A worker of host_jobs takes two of the host's cores for torch."""
    torch.set_num_threads(2)


class Stopwatch:
    """Adds up the seconds spent in obj.<name> (a module's function, an
    instance's method, or a class's method for every instance) while it
    is entered, by wrapping the attribute; `each` keeps every call's
    seconds and, given note, `notes` note(result) of every call. `cpu`
    adds up the calling threads' CPU seconds in it (time.thread_time):
    where threads share the interpreter, the wall also holds the time a
    call waited for the others. Calls from several threads add up under
    a lock."""

    def __init__(self, obj, name, note=None):
        self.obj, self.name, self.note = obj, name, note
        self.lock = threading.Lock()
        self.reset()

    def reset(self):
        self.seconds, self.calls, self.each, self.notes = 0.0, 0, [], []
        self.cpu = 0.0

    def __enter__(self):
        self.orig = orig = getattr(self.obj, self.name)

        def timed(*args, **kw):
            t0, c0 = time.perf_counter(), time.thread_time()
            out = None
            try:
                out = orig(*args, **kw)
                return out
            finally:
                dt = time.perf_counter() - t0
                dc = time.thread_time() - c0
                with self.lock:
                    self.seconds += dt
                    self.cpu += dc
                    self.calls += 1
                    self.each.append(dt)
                    if self.note is not None:
                        self.notes.append(self.note(out))

        setattr(self.obj, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.orig)


def zone_spread(names, pods, zone_of) -> dict:
    """-> {app label: {zone: pods}} of a placed service backlog."""
    out = {}
    for p, n in zip(pods, names):
        per = out.setdefault(p.metadata.labels["app"], {})
        z = zone_of.get(n)
        per[z] = per.get(z, 0) + 1
    return out


def phase_policy(PK, ZK, T, ClusterState, S, TorchScheduleAlgorithm,
                 replay_mod, jobs, traced_services=8):
    """Both Policy documents loaded from JSON through the port's
    load_policy -> create_from_config, at full width on the card:
    decisions equal to the same call on the CPU, every service's pods in
    one zone (ServiceAffinity) or in every zone (ServiceAntiAffinity
    alone), K1 launched; on a 1,000-node, 512-pod version, decisions
    equal to the oracle copy resolved from the same document (the CPU
    runs and the oracle: jobs from host_jobs)."""
    from kubernetes_tpu_torch.scheduler.factory import create_from_config
    from kubernetes_tpu_torch.scheduler.policy import load_policy

    n_nodes, services, per = POLICY_SIZE
    small = POLICY_ORACLE_SIZE
    nodes = S.policy_nodes(T, n_nodes)
    svcs, pods = S.service_backlog(T, services, per)
    state = ClusterState.build(nodes, services=svcs)
    zone_of = {n.metadata.name: n.metadata.labels[S.POLICY_ZONE]
               for n in nodes}
    n_s, s_s, per_s = small
    small_svcs, small_pods = S.service_backlog(T, s_s, per_s)
    small_state = ClusterState.build(S.policy_nodes(T, n_s),
                                     services=small_svcs)
    tr_svcs, tr_pods = S.service_backlog(T, traced_services, per)
    tr_state = ClusterState.build(nodes, services=tr_svcs)
    out = {}
    for name, doc in S.POLICY_DOCUMENTS.items():
        def algo():
            a = create_from_config(load_policy(json.dumps(doc)))
            if not isinstance(a, TorchScheduleAlgorithm):
                raise AssertionError(f"policy {name} left the device path")
            return a

        card = algo()
        reset(PK, ZK)
        torch.cuda.synchronize()
        with Stopwatch(replay_mod, "replay_spec") as spec:
            t0 = time.perf_counter()
            names = card.schedule_backlog(pods, state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        k1, k1_shapes = PK.LAUNCHES, shapes(PK.LAUNCHES_BY_SHAPE)
        k3 = ZK.LAUNCHES
        tally = dict(card._wave.dispatches)
        if k1 <= 0:
            raise AssertionError(f"policy {name} never launched K1")
        if any(n is None for n in names):
            raise AssertionError(f"policy {name} left pods unplaced")
        spread = zone_spread(names, pods, zone_of)
        zones = set(zone_of.values())
        for app, per_zone in spread.items():
            if name == "services" and len(per_zone) != 1:
                raise AssertionError(f"ServiceAffinity: {app} in {per_zone}")
            if name == "saa" and set(per_zone) != zones:
                raise AssertionError(f"ServiceAntiAffinity: {app} in "
                                     f"{per_zone}")
        gaps = [max(z.values()) - min(z.values()) for z in spread.values()]
        cpu_names, cpu_wall = jobs[f"policy_cpu_{name}"].get()
        if cpu_names != names:
            i = next(i for i, (a, b) in enumerate(zip(names, cpu_names))
                     if a != b)
            raise AssertionError(f"policy {name}: pod {i} went to "
                                 f"{names[i]} on the card, {cpu_names[i]} "
                                 f"on the CPU")
        idle = idle_fields(*device_busy_ms(
            lambda: algo().schedule_backlog(tr_pods, tr_state),
            counted_kernels(PK, ZK)))
        small_names = algo().schedule_backlog(small_pods, small_state)
        want, oracle_s = jobs[f"policy_oracle_{name}"].get()
        if small_names != want:
            i = next(i for i, (a, b) in enumerate(zip(small_names, want))
                     if a != b)
            raise AssertionError(f"policy {name} at {n_s} nodes: pod {i} "
                                 f"went to {small_names[i]}, the oracle "
                                 f"chose {want[i]}")
        emit("policy", policy=name, nodes=n_nodes, services=services,
             pods=len(pods), wall_s=wall, pods_per_s=len(pods) / wall,
             replay_spec_s=spec.seconds, replay_spec_calls=spec.calls,
             replay_spec_share=spec.seconds / wall, dispatches=tally,
             k1_launches=k1, k1_launches_by_shape=k1_shapes,
             k3_launches=k3, cpu_worker_wall_s=cpu_wall, equal_to_cpu=True,
             traced_pods=len(tr_pods), **idle,
             zones_per_service=sorted({len(z) for z in spread.values()}),
             max_zone_gap=max(gaps),
             oracle_nodes=n_s, oracle_pods=len(small_pods),
             oracle_s=oracle_s, equal_to_oracle=True)
        out[name] = (k1, k1_shapes)
    return out


def phase_extender(T, S, scheme, TorchExtenderServer, n_nodes=5000,
                   existing=2000, pending=256):
    """The extender service's three verbs through handle(), in process,
    on the card and on a CPU instance: replies equal field for field;
    each verb's wall time, then its parts timed apart (the body's JSON
    text parsed, the API objects decoded, the snapshot encoded, the
    device program, the reply's JSON text)."""
    from kubernetes_tpu_torch.api.types import Pod
    from kubernetes_tpu_torch.snapshot.encode import SnapshotEncoder

    bodies = {verb: json.dumps(body) for verb, body in
              S.extender_bodies(T, scheme, n_nodes, existing,
                                pending).items()}
    card = TorchExtenderServer()
    host = TorchExtenderServer(device="cpu")
    for verb, text in bodies.items():
        card.handle(verb, json.loads(text))  # the first use of each op
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        code, reply = card.handle(verb, json.loads(text))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t1 = time.perf_counter()
        cpu_code, cpu_reply = host.handle(verb, json.loads(text))
        cpu_wall = time.perf_counter() - t1
        if (code, json.dumps(reply, sort_keys=True)) != (
                cpu_code, json.dumps(cpu_reply, sort_keys=True)):
            raise AssertionError(f"extender {verb}: the card's reply "
                                 f"differs from the CPU's")
        if code != 200:
            raise AssertionError(f"extender {verb}: status {code}")
        parts = {}
        t = time.perf_counter()
        body = json.loads(text)
        parts["json_parse_s"] = time.perf_counter() - t
        t = time.perf_counter()
        state = card._decode_cluster(body)
        pods = ([card.scheme.decode(body["pod"], Pod)] if "pod" in body
                else [card.scheme.decode(p, Pod)
                      for p in body["pending"]["items"]])
        parts["decode_s"] = time.perf_counter() - t
        t = time.perf_counter()
        snap, batch = SnapshotEncoder(state, pods,
                                      config=card.config).encode()
        parts["encode_s"] = time.perf_counter() - t
        t = time.perf_counter()
        if verb == "scheduleBacklog":
            card._sched.schedule(snap, batch)
        else:
            card._sched.debug_evaluate(snap, batch)
        torch.cuda.synchronize()
        parts["device_s"] = time.perf_counter() - t
        t = time.perf_counter()
        json.dumps(reply)
        parts["reply_json_s"] = time.perf_counter() - t
        emit("extender", verb=verb, nodes=n_nodes, existing_pods=existing,
             pods=len(pods), body_bytes=len(text), wall_s=wall,
             cpu_wall_s=cpu_wall, equal_to_cpu=True,
             placed=(sum(v is not None for v in
                         reply["assignments"].values())
                     if verb == "scheduleBacklog" else None),
             passed=(len(reply["nodes"]["items"]) if verb == "filter"
                     else None), **parts)


# -- phase 8: gangs and priority preemption ----------------------------------


def gang_flow(device, n_nodes, per_node, singles, gangs, members, big,
              on_cycle=None):
    """The gang phase's director flow on `device`: a bound_cluster of
    n_nodes nodes holding per_node priority-0 pods each and a gang_wave;
    wave 1 through GangDirector.plan_wave -> TorchScheduleAlgorithm.
    schedule_backlog(gangs=) -> after_wave (the priority-10 gang parks and
    the director plans its victims); wave 2 reruns that gang on the wave-1
    state without its victims. on_cycle(), when given, is called just
    before wave 1 (the card's run resets its launch counts there).
    -> {"waves": [director_wave outcome, ...], "statuses", "victims"
    (names), "victim_priorities", "dispatches": [per wave], "timings":
    [per wave], "place_gang_s", "score_s", "build_s"}."""
    from kubernetes_tpu_torch.api import types as T
    from kubernetes_tpu_torch.harness import scenarios as S
    from kubernetes_tpu_torch.oracle import ClusterState
    from kubernetes_tpu_torch.scheduler import gang as G
    from kubernetes_tpu_torch.scheduler.algorithm import (
        TorchScheduleAlgorithm,
    )

    t0 = time.perf_counter()
    nodes, bound = S.bound_cluster(T, n_nodes, per_node)
    state = ClusterState.build(nodes, assigned_pods=bound)
    wave, groups = S.gang_wave(T, singles, gangs, members, big)
    big_pods = [p for p in wave
                if p.metadata.labels.get(T.POD_GROUP_LABEL) == "big"]
    build_s = time.perf_counter() - t0
    statuses, evicted = [], []
    director = S.gang_director(G, groups, statuses, evicted, device=device)
    algo = TorchScheduleAlgorithm(device=device)
    out = {"waves": [], "dispatches": [], "timings": []}
    if on_cycle is not None:
        on_cycle()
    with Stopwatch(G, "_place_gang") as place, \
            Stopwatch(director._scorer, "score") as score:
        for pods, st in ((wave, state), (big_pods, None)):
            if st is None:
                st = S.evict(state, evicted)
            # the wave returns host lists, so its time includes the card's
            with Stopwatch(director, "plan_wave") as plan, \
                    Stopwatch(algo, "schedule_backlog") as sched, \
                    Stopwatch(director, "after_wave") as after:
                t0 = time.perf_counter()
                out["waves"].append(S.director_wave(director, algo, pods,
                                                    st))
                cycle_s = time.perf_counter() - t0
            out["timings"].append({
                "plan_s": plan.seconds, "wave_s": sched.seconds,
                "after_s": after.seconds, "cycle_s": cycle_s})
            out["dispatches"].append(dict(algo._wave.dispatches))
    pg_map = director._pg_map()
    out.update(statuses=statuses,
               victims=[v.metadata.name for v in evicted],
               victim_priorities=sorted({director._priority_of(v, pg_map)
                                         for v in evicted}),
               place_gang_s=place.seconds, place_gang_calls=place.calls,
               score_s=score.seconds, score_calls=score.calls,
               build_s=build_s)
    return out


def gang_cpu_flow(size):
    """gang_flow on the CPU (device="cpu"), run in a worker process
    (host_jobs): -> (its result, seconds)."""
    t0 = time.perf_counter()
    out = gang_flow("cpu", *size)
    return out, time.perf_counter() - t0


def check_gangs(out, size):
    """The gang phase's own checks on one flow's result: the short gang
    parks before the wave, no gang is partly placed, the priority-10 gang
    parks in wave 1 with victims planned (none at priority 10 or above)
    and binds whole in wave 2. -> the number of gangs placed in wave 1."""
    big = size[-1]
    w1, w2 = out["waves"]
    if not any(n.startswith("short-") for n, _r in w1["parked"]):
        raise AssertionError("the short gang did not park before the wave")
    placed = 0
    for start, length, key, _prio in w1["layout"]:
        span = w1["hosts"][start:start + length]
        if None in span and any(h is not None for h in span):
            raise AssertionError(f"gang {key} partly placed")
        if key[1] == "big" and None not in span:
            raise AssertionError("the priority-10 gang fit without preemption")
        placed += None not in span
    if not out["victims"] or max(out["victim_priorities"]) >= 10:
        raise AssertionError(f"victims {len(out['victims'])} at priorities "
                             f"{out['victim_priorities']}")
    if len(w2["hosts"]) != big or None in w2["hosts"] or w2["errors"]:
        raise AssertionError("the priority-10 gang did not bind whole after "
                             "the evictions")
    return placed


def phase_gangs(PK, VK, jobs):
    """Phase 8: gang_flow on the card against the same flow on the CPU
    (jobs["gang_cpu"]): equal waves (backlog, layout, parks, hosts,
    errors), statuses, victims and dispatch tallies; the gang checks;
    K1 and K6 launched. -> (K1 launches, K1 shapes, K6 launches, K6
    shapes)."""
    def reset_counts():
        reset(PK, VK)
        torch.cuda.synchronize()

    out = gang_flow("cuda", *GANG_SIZE, on_cycle=reset_counts)
    k1, k1_shapes = PK.LAUNCHES, shapes(PK.LAUNCHES_BY_SHAPE)
    k6, k6_shapes = VK.LAUNCHES, k6_shapes_of(VK)
    if k1 <= 0 or k6 <= 0:
        raise AssertionError(f"the gang path launched K1 {k1}, K6 {k6} times")
    placed = check_gangs(out, GANG_SIZE)
    cpu, cpu_s = jobs["gang_cpu"].get()
    for key in ("waves", "statuses", "victims", "dispatches"):
        if out[key] != cpu[key]:
            raise AssertionError(f"gang phase: the card's {key} differ from "
                                 f"the CPU run's")
    n_nodes, per_node, singles, gangs, members, big = GANG_SIZE
    host_s = sum(t["plan_s"] + t["after_s"] for t in out["timings"])
    cycle_s = sum(t["cycle_s"] for t in out["timings"])
    emit("gangs", nodes=n_nodes, bound_pods=n_nodes * per_node,
         singletons=singles, gangs=gangs, members=members, big_members=big,
         wave_pods=len(out["waves"][0]["backlog"]),
         parked_before_wave=len(out["waves"][0]["parked"]),
         gangs_placed=placed, victims=len(out["victims"]),
         victim_priorities=out["victim_priorities"],
         timings=out["timings"], cycle_s=cycle_s, director_host_s=host_s,
         place_gang_s=out["place_gang_s"],
         place_gang_calls=out["place_gang_calls"],
         place_gang_share_of_director_host=out["place_gang_s"] / host_s,
         place_gang_share_of_cycle=out["place_gang_s"] / cycle_s,
         victim_score_s=out["score_s"], victim_score_calls=out["score_calls"],
         build_s=out["build_s"], dispatches=out["dispatches"],
         k1_launches=k1, k1_launches_by_shape=k1_shapes, k6_launches=k6,
         k6_launches_by_shape=k6_shapes, cpu_worker_wall_s=cpu_s,
         cpu_timings=cpu["timings"], equal_to_cpu=True)
    return k1, k1_shapes, k6, k6_shapes


# -- phase 9: the daemon's scheduling core -----------------------------------


def phase_daemon(PK, ZK, T, S, TorchScheduleAlgorithm, one_shot_names,
                 one_shot_wall):
    """9a: the density shape through the daemon's scheduling core on the
    card: a SchedulerCache fed the nodes, TorchScheduleAlgorithm(cache=)
    warmed up for them, core.Scheduler.schedule_one until the queue is
    empty (default max_batch) and the bind pool. Every pod bound, the
    names of phase 4's one-shot call, every wave after the first from the
    incremental view, K1 launched. -> (K1 launches, K1 shapes)."""
    from kubernetes_tpu_torch.scheduler import cache as C
    from kubernetes_tpu_torch.scheduler import core
    from kubernetes_tpu_torch.scheduler import gang as G
    from kubernetes_tpu_torch.snapshot.incremental import IncrementalEncoder

    n_nodes, n_pods = DAEMON_SIZE
    nodes = S.density_nodes(T, n_nodes)
    pods = S.pause_pods(T, n_pods)
    view = Stopwatch(IncrementalEncoder, "wave_view",
                     note=lambda out: out is not None and out[0] is not None)
    algo_sw = Stopwatch(TorchScheduleAlgorithm, "schedule_backlog",
                        note=lambda out: len(out or ()))
    bind_sw = Stopwatch(core.Scheduler, "_assume_and_bind_wave")
    algos, marks = [], {}

    def algorithm(cache):
        algo = TorchScheduleAlgorithm(device="cuda", cache=cache)
        t0 = time.perf_counter()
        algo.warmup(n_nodes)
        torch.cuda.synchronize()
        marks["warmup_s"] = time.perf_counter() - t0
        marks["stats"] = dict(algo._wave.stats)
        algos.append(algo)
        for sw in (view, algo_sw, bind_sw):
            sw.reset()
        reset(PK, ZK)
        torch.cuda.synchronize()
        marks["ends"] = [time.perf_counter()]
        return algo

    with view, algo_sw, bind_sw:
        out = S.daemon_flow(C, core, G, algorithm, nodes, backlog=pods,
                            on_wave=lambda: marks["ends"].append(
                                time.perf_counter()))
        torch.cuda.synchronize()
        wall = time.perf_counter() - marks["ends"][0]
    k1, k1_shapes = PK.LAUNCHES, shapes(PK.LAUNCHES_BY_SHAPE)
    algo = algos[0]
    binds = out["binds"]
    if out["errors"] or len(binds) != n_pods:
        raise AssertionError(f"daemon core: {len(binds)} of {n_pods} bound, "
                             f"{len(out['errors'])} errors")
    names = [binds.get(p.metadata.name) for p in pods]
    if names != one_shot_names:
        i = next(i for i, (a, b) in enumerate(zip(names, one_shot_names))
                 if a != b)
        raise AssertionError(f"daemon core: pod {i} went to {names[i]}, "
                             f"the one-shot call chose {one_shot_names[i]}")
    if out["cycles"] < 13 or len(view.notes) != out["cycles"]:
        raise AssertionError(f"daemon core: {out['cycles']} cycles, "
                             f"{len(view.notes)} wave views")
    if not all(view.notes[1:]):
        raise AssertionError(f"daemon core: a wave after the first took the "
                             f"full encode: {view.notes}")
    if k1 <= 0:
        raise AssertionError("daemon core never launched K1")
    ends = marks["ends"]
    waves = [{"pods": n, "wave_view_s": v, "algorithm_s": a,
              "assume_bind_s": b, "cycle_s": e1 - e0, "incremental": inc}
             for n, v, a, b, inc, e0, e1 in zip(
                 algo_sw.notes, view.each, algo_sw.each, bind_sw.each,
                 view.notes, ends, ends[1:])]
    # the resident tables' counts over the daemon's waves, warmup's left out
    stats = {k: v - (0 if k == "wave_table_bytes" else marks["stats"][k])
             for k, v in algo._wave.stats.items()}
    idle = idle_fields(*device_busy_ms(
        lambda: S.daemon_flow(
            C, core, G,
            lambda cache: TorchScheduleAlgorithm(device="cuda", cache=cache),
            nodes, backlog=pods),
        counted_kernels(PK, ZK)))
    emit("daemon", nodes=n_nodes, pods=n_pods, cycles=out["cycles"],
         wall_s=wall, pods_per_s=n_pods / wall,
         one_shot_wall_s=one_shot_wall, warmup_s=marks["warmup_s"],
         wave_view_s=view.seconds, wave_view_share=view.seconds / wall,
         algorithm_s=algo_sw.seconds, assume_bind_s=bind_sw.seconds,
         waves=waves, table_stats=stats,
         table_bytes_reused_per_wave=stats["table_bytes_reused"] / max(
             1, stats["waves"]),
         k1_launches=k1, k1_launches_by_shape=k1_shapes, **idle,
         all_bound=True, equal_to_one_shot=True,
         incremental_after_first=True)
    return k1, k1_shapes


def daemon_gang_flow(device, size, retries, on_start=None):
    """9b's flow on `device`: phase 8's gang scenario at `size` (nodes,
    bound priority-0 pods per node, singletons, gangs, members per gang,
    members of the priority-10 gang) through scenarios.daemon_flow with
    the GangDirector wired in; the parked big gang is queued again up to
    `retries` times. on_start(), when given, is called once the algorithm
    is warm, just before the loop (the card's run resets its launch
    counts there). -> the flow's outcome with "wall_s", the seconds from
    on_start to the end."""
    from kubernetes_tpu_torch.api import types as T
    from kubernetes_tpu_torch.harness import scenarios as S
    from kubernetes_tpu_torch.scheduler import cache as C
    from kubernetes_tpu_torch.scheduler import core
    from kubernetes_tpu_torch.scheduler import gang as G
    from kubernetes_tpu_torch.scheduler.algorithm import (
        TorchScheduleAlgorithm,
    )

    n_nodes, per_node, singles, gangs, members, big = size
    nodes, bound = S.bound_cluster(T, n_nodes, per_node)
    wave, groups = S.gang_wave(T, singles, gangs, members, big)
    marks = {}

    def algorithm(cache):
        algo = TorchScheduleAlgorithm(device=device, cache=cache)
        algo.warmup(n_nodes)
        if on_start is not None:
            on_start()
        marks["t0"] = time.perf_counter()
        return algo

    out = S.daemon_flow(C, core, G, algorithm, nodes, bound, wave,
                        groups=groups, retries=retries,
                        director_kw={"device": device})
    out["wall_s"] = time.perf_counter() - marks["t0"]
    out["layout"] = [(g.metadata.name, g.spec.min_member) for g in groups]
    return out


def daemon_gang_cpu_flow(size, retries):
    """daemon_gang_flow on the CPU, run in a worker process (host_jobs):
    -> (its outcome, seconds)."""
    t0 = time.perf_counter()
    out = daemon_gang_flow("cpu", size, retries)
    return out, time.perf_counter() - t0


def phase_daemon_gangs(PK, VK, jobs):
    """9b: daemon_gang_flow on the card against the same flow on the CPU
    (jobs["daemon_gang_cpu"]): equal binds, errors, statuses, victims and
    cycles; the short gang parked, no gang partly bound, the big gang
    bound whole after its victims, none of them at priority 10 or above;
    K1 and K6 launched. -> (K1 launches, K1 shapes, K6 launches, K6
    shapes)."""
    def reset_counts():
        reset(PK, VK)
        torch.cuda.synchronize()

    out = daemon_gang_flow("cuda", DAEMON_GANG_SIZE, DAEMON_GANG_RETRIES,
                           on_start=reset_counts)
    k1, k6 = PK.LAUNCHES, VK.LAUNCHES
    k1_shapes = shapes(PK.LAUNCHES_BY_SHAPE)
    k6_shapes = k6_shapes_of(VK)
    if k1 <= 0 or k6 <= 0:
        raise AssertionError(f"the daemon's gang flow launched K1 {k1}, K6 "
                             f"{k6} times")
    cpu, cpu_s = jobs["daemon_gang_cpu"].get()
    for key in ("binds", "errors", "statuses", "victims", "cycles"):
        if out[key] != cpu[key]:
            raise AssertionError(f"daemon gang flow: the card's {key} differ "
                                 f"from the CPU run's")
    binds = out["binds"]
    n_nodes, per_node, singles, gangs, members, big = DAEMON_GANG_SIZE
    placed = 0
    for name, min_member in out["layout"]:
        bound = sum(n.rsplit("-", 1)[0] == name for n in binds)
        whole = {"short": (0,), "big": (min_member,)}.get(
            name, (0, min_member))
        if bound not in whole:
            raise AssertionError(f"gang {name}: {bound} of {min_member} "
                                 f"members bound")
        placed += bound == min_member
    if not out["victims"]:
        raise AssertionError("the big gang preempted no one")
    if any(n.startswith("big-") for n in out["victims"]):
        raise AssertionError("the priority-10 gang preempted its own member")
    emit("daemon_gangs", nodes=n_nodes, bound_pods=n_nodes * per_node,
         singletons=singles, gangs=gangs, members=members, big_members=big,
         retries=DAEMON_GANG_RETRIES, cycles=out["cycles"],
         bound=len(binds), gangs_placed=placed,
         victims=len(out["victims"]), errors=len(out["errors"]),
         wall_s=out["wall_s"],
         cpu_worker_wall_s=cpu_s, cpu_wall_s=cpu["wall_s"],
         k1_launches=k1, k1_launches_by_shape=k1_shapes, k6_launches=k6,
         k6_launches_by_shape=k6_shapes, equal_to_cpu=True)
    return k1, k1_shapes, k6, k6_shapes


# -- phase 10: the scheduler daemon on the wire --------------------------------


class TraceShort(Exception):
    """A profiler trace that recorded fewer kernel events than the
    wrappers counted launches (device_busy_ms's rule)."""


def record_binds(sched, hosts: list) -> None:
    """Append the host of every pod the daemon's loop binds to `hosts`,
    in the order the loop binds them (Scheduler._assume_and_bind_wave,
    called on the loop's thread, wave by wave)."""
    loop = sched.scheduler
    orig = loop._assume_and_bind_wave

    def recorded(pairs, cycle_start):
        hosts.extend(h for _, h in pairs)
        return orig(pairs, cycle_start)

    loop._assume_and_bind_wave = recorded


def bound_per_node(pods) -> dict:
    """-> {node: pods bound there} of a pod list read from the
    apiserver."""
    out = {}
    for p in pods:
        if p.spec.node_name:
            out[p.spec.node_name] = out.get(p.spec.node_name, 0) + 1
    return out


def one_shot_hosts(TorchScheduleAlgorithm, ClusterState, nodes, template,
                   n_pods) -> tuple:
    """The port's one-shot schedule_backlog on the card over `nodes` and
    n_pods copies of `template` (a pod read back from the apiserver,
    unbound and renamed). -> (hosts, seconds)."""
    from kubernetes_tpu_torch.api.types import shallow_copy

    pods = []
    for i in range(n_pods):
        q = shallow_copy(template)
        q.metadata = shallow_copy(template.metadata)
        q.metadata.name = f"one-shot-{i:06d}"
        q.spec = shallow_copy(template.spec)
        q.spec.node_name = ""
        pods.append(q)
    t0 = time.perf_counter()
    hosts = TorchScheduleAlgorithm(device="cuda").schedule_backlog(
        pods, ClusterState.build(nodes))
    torch.cuda.synchronize()
    return hosts, time.perf_counter() - t0


def first_difference(got, want) -> str:
    i = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    return (f"{len(got)} and {len(want)} hosts; the first difference at "
            f"{i}: {got[i:i + 1]} against {want[i:i + 1]}")


def nearest_rank(xs, q) -> float:
    """The q-quantile of xs by the nearest-rank rule."""
    xs = sorted(xs)
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


def hist_quantiles(hist, before, qs) -> dict:
    """Quantiles of the observations a Histogram took since its
    bucket_counts() were `before`, as bucket upper bounds (its own
    percentile rule) -> {"count", "p50", ...} in the histogram's unit."""
    counts = [a - b for a, b in zip(hist.bucket_counts(), before)]
    total = sum(counts)
    out = {"count": total}
    for q in qs:
        cum, val = 0, float("inf")
        for bound, c in zip(list(hist.buckets) + [float("inf")], counts):
            cum += c
            if total and cum >= q * total:
                val = bound
                break
        out[f"p{round(q * 100)}"] = val
    return out


def single_pod_latency(sched, client, creator, n) -> tuple:
    """10c: n pods of the density template created one at a time into the
    idle daemon, each waiting for its bind. -> (seconds from the create
    request to the return of the pod's bind request, per pod)."""
    cfg = sched.scheduler.config
    done, cv = {}, threading.Condition()
    orig = cfg.binder

    def binder(pod, host):
        orig(pod, host)
        with cv:
            done[pod.metadata.name] = time.perf_counter()
            cv.notify_all()

    cfg.binder = binder
    lat = []
    try:
        for i in range(n):
            p = creator._perf_pod()
            p.metadata.generate_name = ""
            p.metadata.name = f"latency-{i:03d}"
            t0 = time.perf_counter()
            client.pods().create(p)
            with cv:
                if not cv.wait_for(lambda: p.metadata.name in done, 60):
                    raise AssertionError(f"single-pod latency: "
                                         f"{p.metadata.name} not bound in "
                                         f"60 s")
            lat.append(done[p.metadata.name] - t0)
    finally:
        cfg.binder = orig
    return lat


def phase_wire(PK, ZK, ClusterState, TorchScheduleAlgorithm):
    """10a: harness/perf.schedule_pods(5000, 50000, "CUDAProvider") on the
    card: the port's apiserver, LocalTransport, informers and
    SchedulerServer. Every pod bound as read back from the apiserver, 10
    a node, the hosts in the order the loop bound them equal to the
    one-shot call's over the apiserver's nodes and as many copies of its
    pod, every wave from wave_view, K1 launched; the idle share from a
    CUDA trace over the creation -> all-bound window, kept only when its
    K1 events equal the launches counted (the run is made again when not,
    up to WIRE_TRACE_TRIES runs). 10c, in the same daemon left idle:
    WIRE_LATENCY_PODS pods one at a time, their picks equal to the last
    of the one-shot call over all 50,200; a wave of one pod takes the
    serial scan (torch ops; no hand kernel yet, ROADMAP queue 2 K2), so
    its K1 launches are printed, not required. -> (10a's K1 launches,
    shapes)."""
    from torch.profiler import ProfilerActivity, profile

    from kubernetes_tpu_torch.harness import creator, perf
    from kubernetes_tpu_torch.metrics import scheduler_e2e_latency
    from kubernetes_tpu_torch.scheduler import algorithm, core, factory
    from kubernetes_tpu_torch.snapshot.incremental import IncrementalEncoder

    n_nodes, n_pods = WIRE_SIZE
    kernels = counted_kernels(PK, ZK)
    seen = []
    for _ in range(WIRE_TRACE_TRIES):
        rec = {"hosts": []}
        view = Stopwatch(IncrementalEncoder, "wave_view",
                         note=lambda out: out is not None
                         and out[0] is not None)
        # where the window's time goes, each in wall and thread-CPU
        # seconds: the algorithm (wave_view included), the loop's assume,
        # the wave's batch bind (the in-process apiserver's commit
        # included), the informer's confirmations into the cache
        parts = {"algorithm": Stopwatch(algorithm.TorchScheduleAlgorithm,
                                        "schedule_backlog"),
                 "assume_and_submit_bind": Stopwatch(
                     core.Scheduler, "_assume_and_bind_wave"),
                 "bind_batches": Stopwatch(factory.ConfigFactory,
                                           "_bind_many"),
                 "informer_confirms": Stopwatch(factory.ConfigFactory,
                                                "_cache_add_pod")}

        def on_ready(sched, client):
            record_binds(sched, rec["hosts"])
            view.reset()
            for sw in parts.values():
                sw.reset()
            reset(PK, ZK)
            torch.cuda.synchronize()
            rec["prof"] = profile(activities=[ProfilerActivity.CUDA])
            rec["prof"].__enter__()
            rec["t0"] = time.perf_counter()

        def after(sched, client):
            torch.cuda.synchronize()
            rec["wall"] = time.perf_counter() - rec["t0"]
            rec["prof"].__exit__(None, None, None)
            launched = {k: m.LAUNCHES for k, m in kernels.items()}
            rec["k1"], rec["k1_shapes"] = (PK.LAUNCHES,
                                           shapes(PK.LAUNCHES_BY_SHAPE))
            rec["busy_ms"], events = trace_busy(rec["prof"], kernels)
            seen.append(events)
            if events != launched:
                raise TraceShort(f"{events} against {launched}")
            rec["launched"] = launched
            rec["waves"] = len(view.notes)
            rec["incremental"] = list(view.notes)
            rec["parts"] = {k: {"wall_s": sw.seconds, "cpu_s": sw.cpu,
                                "calls": sw.calls}
                            for k, sw in [("wave_view", view),
                                          *parts.items()]}
            pods = client.pods().list()[0]
            rec["bound"] = sum(bool(p.spec.node_name) for p in pods)
            rec["per_node"] = bound_per_node(pods)
            one, rec["one_shot_s"] = one_shot_hosts(
                TorchScheduleAlgorithm, ClusterState,
                client.nodes().list()[0], pods[0],
                n_pods + WIRE_LATENCY_PODS)
            rec["one_shot"] = one
            # 10c: the daemon idle with every pod bound
            hist_before = scheduler_e2e_latency.bucket_counts()
            reset(PK, ZK)
            view.reset()
            torch.cuda.synchronize()
            rec["latency"] = single_pod_latency(sched, client, creator,
                                                WIRE_LATENCY_PODS)
            rec["lat_k1"], rec["lat_k1_shapes"] = (
                PK.LAUNCHES, shapes(PK.LAUNCHES_BY_SHAPE))
            rec["lat_incremental"] = list(view.notes)
            rec["e2e_us"] = hist_quantiles(scheduler_e2e_latency,
                                           hist_before, (0.5, 0.99, 1.0))

        out = io.StringIO()
        try:
            with view, parts["algorithm"], parts["assume_and_submit_bind"], \
                    parts["bind_batches"], parts["informer_confirms"]:
                stats = perf.schedule_pods(
                    n_nodes, n_pods, "CUDAProvider", out=out, device="cuda",
                    on_ready=on_ready, after=after)
        except TraceShort:
            continue
        break
    else:
        raise RuntimeError(f"{WIRE_TRACE_TRIES} runs' traces recorded {seen} "
                           f"kernel events, fewer than the launches")
    hosts, one = rec["hosts"], rec["one_shot"]
    if rec["bound"] != n_pods or len(hosts) < n_pods:
        raise AssertionError(f"wire: {rec['bound']} of {n_pods} pods bound")
    if len(rec["per_node"]) != n_nodes or set(
            rec["per_node"].values()) != {n_pods // n_nodes}:
        raise AssertionError("wire: not 10 pods on every node")
    if hosts[:n_pods] != one[:n_pods]:
        raise AssertionError("wire: the loop's hosts differ from the one-shot "
                             "call's: " + first_difference(hosts[:n_pods],
                                                           one[:n_pods]))
    if not rec["incremental"] or not all(rec["incremental"]):
        raise AssertionError(f"wire: a wave took the full encode: "
                             f"{rec['incremental']}")
    if rec["k1"] <= 0:
        raise AssertionError("wire: the daemon never launched K1")
    picks = hosts[n_pods:]
    if picks != one[n_pods:]:
        raise AssertionError("single pods: the picks differ from the "
                             "one-shot call's last: "
                             + first_difference(picks, one[n_pods:]))
    if not all(rec["lat_incremental"]):
        raise AssertionError("single pods: a wave took the full encode")
    lines = out.getvalue().splitlines()
    busy, wall = rec["busy_ms"], rec["wall"]
    emit("wire", nodes=n_nodes, pods=n_pods,
         pods_per_s=stats["pods_per_sec"],
         sustained_pods_per_s=stats["sustained_pods_per_sec"],
         creation_s=stats["creation_seconds"],
         pipeline_s=stats["pipeline_seconds"], waves=rec["waves"],
         parts=rec["parts"], one_shot_s=rec["one_shot_s"],
         traced_wall_s=wall, device_busy_ms=busy,
         device_idle_share=(None if busy is None
                            else 1.0 - busy / 1e3 / wall),
         traced_launches=rec["launched"], trace_kernel_events=seen,
         k1_launches=rec["k1"], k1_launches_by_shape=rec["k1_shapes"],
         harness=[ln for ln in lines if not ln[:2].isdigit()],
         all_bound=True, equal_to_one_shot=True, incremental=True)
    lat = rec["latency"]
    emit("wire_latency", pods=WIRE_LATENCY_PODS, bound_before=n_pods,
         p50_s=nearest_rank(lat, 0.5), p99_s=nearest_rank(lat, 0.99),
         max_s=max(lat), mean_s=sum(lat) / len(lat),
         e2e_histogram_us=rec["e2e_us"], k1_launches=rec["lat_k1"],
         k1_launches_by_shape=rec["lat_k1_shapes"],
         equal_to_one_shot=True)
    return rec["k1"], rec["k1_shapes"]


def phase_wire_separate(PK, ZK, ClusterState, TorchScheduleAlgorithm):
    """10b: harness/perf.schedule_pods_separate(1000, 30000,
    "CUDAProvider"): the port's apiserver in its own interpreter over the
    binary wire, the pod creator in another, the daemon on the card in
    this one. Every pod bound, the hosts in the loop's order (and so the
    per-node counts) equal to the one-shot call's over the apiserver's
    nodes; the rates and the apiserver's counters. -> (K1 launches,
    shapes)."""
    from kubernetes_tpu_torch.harness import perf

    n_nodes, n_pods = WIRE_SEPARATE_SIZE
    rec = {"hosts": []}

    def on_ready(sched, client):
        record_binds(sched, rec["hosts"])
        reset(PK, ZK)
        torch.cuda.synchronize()

    def after(sched, client):
        torch.cuda.synchronize()
        rec["k1"], rec["k1_shapes"] = PK.LAUNCHES, shapes(
            PK.LAUNCHES_BY_SHAPE)
        pods = client.pods().list()[0]
        rec["bound"] = sum(bool(p.spec.node_name) for p in pods)
        rec["per_node"] = bound_per_node(pods)
        rec["one_shot"], rec["one_shot_s"] = one_shot_hosts(
            TorchScheduleAlgorithm, ClusterState, client.nodes().list()[0],
            pods[0], n_pods)

    out = io.StringIO()
    stats = perf.schedule_pods_separate(n_nodes, n_pods, "CUDAProvider",
                                        out=out, device="cuda",
                                        on_ready=on_ready, after=after)
    if rec["bound"] != n_pods:
        raise AssertionError(f"wire across processes: {rec['bound']} of "
                             f"{n_pods} bound")
    one = rec["one_shot"]
    want = {}
    for h in one:
        want[h] = want.get(h, 0) + 1
    if rec["per_node"] != want:
        raise AssertionError("wire across processes: the per-node counts "
                             "differ from the one-shot call's")
    if rec["hosts"] != one:
        raise AssertionError("wire across processes: the loop's hosts "
                             "differ from the one-shot call's: "
                             + first_difference(rec["hosts"], one))
    if rec["k1"] <= 0:
        raise AssertionError("wire across processes never launched K1")
    lines = out.getvalue().splitlines()
    emit("wire_separate", nodes=n_nodes, pods=n_pods, **stats,
         one_shot_s=rec["one_shot_s"], k1_launches=rec["k1"],
         k1_launches_by_shape=rec["k1_shapes"],
         harness=[ln for ln in lines if not ln[:2].isdigit()],
         all_bound=True, equal_to_one_shot=True)
    return rec["k1"], rec["k1_shapes"]


# -- phase 12: the kernel-path profiles ---------------------------------------


#: (arm, environment, Policy document or None): the JAX package's
#: bench.py --raw-curve arms, then the bf16 profile shadow-checked every
#: wave, on the default weights and under POLICY_LR30
PROFILE_ARMS = (
    ("wide_serial", {"KUBERNETES_TPU_QUANT": "off",
                     "KUBERNETES_TPU_PIPELINE": None}, None),
    ("quant_serial", {"KUBERNETES_TPU_QUANT": "int",
                      "KUBERNETES_TPU_PIPELINE": None}, None),
    ("wide_pipeline", {"KUBERNETES_TPU_QUANT": "off",
                       "KUBERNETES_TPU_PIPELINE": "1"}, None),
    ("quant_pipeline", {"KUBERNETES_TPU_QUANT": "int",
                        "KUBERNETES_TPU_PIPELINE": "1"}, None),
    ("bf16", {"KUBERNETES_TPU_QUANT": "bf16",
              "KUBERNETES_TPU_QUANT_SHADOW": "1",
              "KUBERNETES_TPU_PIPELINE": None}, None),
    ("bf16_lr30", {"KUBERNETES_TPU_QUANT": "bf16",
                   "KUBERNETES_TPU_QUANT_SHADOW": "1",
                   "KUBERNETES_TPU_PIPELINE": None}, "POLICY_LR30"),
)


def with_env(env, fn):
    """fn() with the environment's keys set (None: unset), restored
    after: the profiles' switches are read when the algorithm is built."""
    saved = {k: os.environ.get(k) for k in env}
    try:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def profile_algorithm(TorchScheduleAlgorithm, S, device, policy):
    """The phase's algorithm on `device`: the default provider, or a
    Policy document of scenarios through load_policy ->
    create_from_config."""
    if policy is None:
        return TorchScheduleAlgorithm(device=device)
    from kubernetes_tpu_torch.scheduler.factory import create_from_config
    from kubernetes_tpu_torch.scheduler.policy import load_policy

    return create_from_config(load_policy(json.dumps(getattr(S, policy))),
                              device=device)


def profile_cpu_names(size):
    """wide_serial's call on the CPU (a host_jobs worker): -> (names,
    seconds)."""
    from kubernetes_tpu_torch.api import types as T
    from kubernetes_tpu_torch.harness import scenarios as S
    from kubernetes_tpu_torch.oracle import ClusterState
    from kubernetes_tpu_torch.scheduler.algorithm import (
        TorchScheduleAlgorithm,
    )

    nodes, services, pods = S.multi_template_backlog(T, *size)
    state = ClusterState.build(nodes, services=services)
    t0 = time.perf_counter()
    names = with_env(PROFILE_ARMS[0][1], lambda: TorchScheduleAlgorithm(
        device="cpu").schedule_backlog(pods, state))
    return names, time.perf_counter() - t0


def profile_call(PK, Packer, tp, algo, pods, state, rec, warm):
    """One call of an arm's algorithm from round-robin counter 0: its
    names; its wall, host-to-device bytes and K1 launches go into rec,
    and for a warm call also the probe's and the encode's seconds, the
    probe's overlap and the host's shipping (the pod rows' packing,
    every upload: a pinned copy and a non_blocking copy, the unpacks)."""
    from kubernetes_tpu_torch.models import wave as wave_mod

    algo._last_node_index = 0
    reset(PK)
    torch.cuda.synchronize()
    ov0, pt0 = tp.overlap_totals(), tp.phase_totals()
    b0 = Packer.total_h2d_bytes
    with Stopwatch(wave_mod, "pack_arrays") as pack_sw, \
            Stopwatch(Packer, "upload") as upload_sw, \
            Stopwatch(wave_mod, "unpack") as unpack_sw:
        t0 = time.perf_counter()
        names = algo.schedule_backlog(pods, state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ov1, pt1 = tp.overlap_totals(), tp.phase_totals()
    for key, k in PK.LAUNCHES_BY_SHAPE.items():
        rec["k1"][key] = rec["k1"].get(key, 0) + k
    h2d = Packer.total_h2d_bytes - b0
    if not warm:
        wave = algo._wave
        rec.update(cold_wall_s=wall, cold_h2d_bytes=h2d,
                   cold_table_bytes=wave.stats["table_bytes_total"],
                   placed_dtypes={f: str(wave._dev[f][2].dtype)
                                  for f in ("zone_id", "taint_count",
                                            "vz_zone", "vz_region")},
                   cold_dispatches=dict(wave.dispatches))
        return names
    rec["warm_wall_s"].append(wall)
    rec["warm_h2d_bytes"].append(h2d)
    for key, phase, totals in (("probe_overlap_s", "probe", (ov0, ov1)),
                               ("probe_s", "probe", (pt0, pt1)),
                               ("encode_s", "encode", (pt0, pt1))):
        rec[key] += totals[1][phase] - totals[0][phase]
    for name, sw in (("pack_rows", pack_sw), ("upload", upload_sw),
                     ("unpack_rows", unpack_sw)):
        rec["warm_shipping"][name]["seconds"] += sw.seconds
        rec["warm_shipping"][name]["calls"] += sw.calls
    return names


def phase_profiles(PK, S, TorchScheduleAlgorithm, jobs):
    """The kernel-path profiles on the card (see the module docstring,
    phase 12). -> (K1's bf16 launches on the bf16 arms, their shapes)."""
    from kubernetes_tpu_torch.api import types as T
    from kubernetes_tpu_torch.models.pack import Packer
    from kubernetes_tpu_torch.oracle import ClusterState
    from kubernetes_tpu_torch.trace import profile as tp

    t_phase = time.perf_counter()
    nodes, services, pods = S.multi_template_backlog(T, *PROFILE_SIZE)
    state = ClusterState.build(nodes, services=services)
    algos, names, recs = {}, {}, {}
    for arm, env, policy in PROFILE_ARMS:
        # the switches are read when the algorithm is built
        algos[arm] = with_env(env, lambda: profile_algorithm(
            TorchScheduleAlgorithm, S, "cuda", policy))
        recs[arm] = {"k1": {}, "warm_wall_s": [], "warm_h2d_bytes": [],
                     "probe_overlap_s": 0.0, "probe_s": 0.0,
                     "encode_s": 0.0,
                     "warm_shipping": {k: {"seconds": 0.0, "calls": 0}
                                       for k in ("pack_rows", "upload",
                                                 "unpack_rows")}}
        names[arm] = profile_call(PK, Packer, tp, algos[arm], pods, state,
                                  recs[arm], warm=False)
    # the warm calls in turns, every arm once a round, the order reversed
    # each round (ABBA), so that drift on the host falls on every arm
    order = [arm for arm, _env, _policy in PROFILE_ARMS]
    for r in range(PROFILE_WARM):
        for arm in (order if r % 2 == 0 else order[::-1]):
            if profile_call(PK, Packer, tp, algos[arm], pods, state,
                            recs[arm], warm=True) != names[arm]:
                raise AssertionError(f"kernel-path profiles: a warm call of "
                                     f"{arm} chose other nodes than its "
                                     f"cold one")
    for arm, env, policy in PROFILE_ARMS:
        wave, gate, rec = algos[arm]._wave, algos[arm]._shadow_gate, recs[arm]
        rec.update(
            pods_per_s_best=len(pods) / min(rec["warm_wall_s"]),
            dispatches=dict(wave.dispatches),
            stage=wave.dispatches.get("stage", 0),
            k1_launches=sum(rec["k1"].values()),
            k1_launches_by_shape=shapes(rec.pop("k1")),
            shadow_gate=None if gate is None else gate.stats(),
            table_stats=dict(wave.stats))
        emit("profile_arm", arm=arm, nodes=PROFILE_SIZE[0],
             pods=PROFILE_SIZE[1],
             env={k: v for k, v in env.items() if v is not None},
             policy=policy, unscheduled=names[arm].count(None), **rec)
    # the LR 30 arm's reference: the same Policy at full width, one call
    lr30_wide = with_env(
        {"KUBERNETES_TPU_QUANT": "off", "KUBERNETES_TPU_PIPELINE": None},
        lambda: profile_algorithm(TorchScheduleAlgorithm, S, "cuda",
                                  "POLICY_LR30").schedule_backlog(
                                      pods, state))
    cpu_names, cpu_s = jobs["profile_cpu"].get()
    base = names["wide_serial"]
    if base != cpu_names:
        raise AssertionError(f"kernel-path profiles: wide_serial on the "
                             f"card != the CPU run "
                             f"({first_difference(base, cpu_names)})")
    for arm, _env, policy in PROFILE_ARMS:
        want = lr30_wide if policy == "POLICY_LR30" else base
        if names[arm] != want:
            raise AssertionError(f"kernel-path profiles: {arm} chose other "
                                 f"nodes ({first_difference(names[arm], want)})")
        if None in names[arm]:
            raise AssertionError(f"kernel-path profiles: {arm} left pods "
                                 f"unplaced")
        rec = recs[arm]
        if "pipeline" in arm and rec["stage"] <= 0:
            raise AssertionError(f"{arm} staged nothing: {rec['dispatches']}")
        if "pipeline" not in arm and rec["stage"]:
            raise AssertionError(f"{arm} staged without the pipeline")
        modes = {d["mode"] for d in rec["k1_launches_by_shape"]}
        if modes != ({"bf16", "i64"} if arm.startswith("bf16") else {"i64"}):
            raise AssertionError(f"{arm} launched K1 in the modes {modes}")
        gate = rec["shadow_gate"]
        # every call is checked until a divergence, which falls back
        if arm.startswith("bf16") and (gate is None or gate["checked"] != (
                gate["divergence"] if gate["fallen_back"]
                else 1 + PROFILE_WARM)):
            raise AssertionError(f"{arm}: the shadow gate checked {gate}")
    wide_b = recs["wide_serial"]["cold_table_bytes"]
    quant_b = recs["quant_serial"]["cold_table_bytes"]
    if not quant_b < wide_b:
        raise AssertionError(f"narrowing placed {quant_b} table bytes, "
                             f"full width {wide_b}")
    bf16_launches = {arm: [d for d in recs[arm]["k1_launches_by_shape"]
                           if d["mode"] == "bf16"]
                     for arm in ("bf16", "bf16_lr30")}
    emit("profiles", nodes=PROFILE_SIZE[0], pods=PROFILE_SIZE[1],
         warm_calls=PROFILE_WARM,
         cold_table_bytes={a: r["cold_table_bytes"] for a, r in recs.items()},
         cold_table_bytes_wide_over_quant=wide_b / quant_b,
         best_warm_wall_s={a: min(r["warm_wall_s"])
                           for a, r in recs.items()},
         pipeline_over_serial={
             "wide": min(recs["wide_pipeline"]["warm_wall_s"])
             / min(recs["wide_serial"]["warm_wall_s"]),
             "quant": min(recs["quant_pipeline"]["warm_wall_s"])
             / min(recs["quant_serial"]["warm_wall_s"])},
         stage={a: r["stage"] for a, r in recs.items()},
         probe_overlap_s={a: r["probe_overlap_s"] for a, r in recs.items()},
         shadow_gates={a: recs[a]["shadow_gate"]
                       for a in ("bf16", "bf16_lr30")},
         bf16_launches_by_shape=bf16_launches,
         cpu_wall_s=cpu_s, equal_to_cpu=True, lr30_equal_to_full_width=True,
         lr30_names_differ_from_default=sum(
             a != b for a, b in zip(names["bf16_lr30"], base)),
         seconds=time.perf_counter() - t_phase)
    k1_bf16 = sum(d["launches"] for rows in bf16_launches.values()
                  for d in rows)
    by_shape = {arm: rows for arm, rows in bf16_launches.items()}
    return k1_bf16, by_shape


# -- phase 14: the mesh drivers ------------------------------------------------

#: phase 14: the shards of the mesh phases, all on cuda:0 (the card is
#: one), and (nodes, pods) of 14b and 14c: phase 4's density shape
MESH_SHARDS = (4, 1)
MESH_SIZE = (5000, 50000)
MESH_DEVICE = "cuda:0"
#: 14c: the density backlog's waves through the resident state, and the
#: nodes whose labels and allocatable change in the churn wave
MESH_WAVES = 10
MESH_CHURN_NODES = 50
def k8_inputs(S, case, seed=7):
    """One SCATTER_CASES entry on the card: -> (case, buffer, shard
    tables {name: tensor} a shard, names, axes, narrowed)."""
    label, shards, n, M, k, fields = case
    c = S.scatter_case(shards, n, M, k, seed=seed, fields=fields)
    names = [f[0] for f in c["fields"]]
    axes = [f[1] for f in c["fields"]]
    narrowed = frozenset(f[0] for f in c["fields"] if f[2])
    buf = torch.from_numpy(c["buf"]).cuda()
    tabs = [{nm: torch.from_numpy(v).cuda()
             for nm, v in S.scatter_shard_tables(c, s).items()}
            for s in range(shards)]
    return c, buf, tabs, names, axes, narrowed


def k8_abs_err(got, want):
    """The largest absolute difference of two scattered tables (numpy
    or tensors; NaN where both hold NaN counts as equal)."""
    import numpy as np

    got, want = (np.asarray(a.cpu().numpy() if torch.is_tensor(a) else a)
                 for a in (got, want))
    if got.size == 0:
        return 0
    if got.dtype.kind == "f":
        both = np.isnan(got) & np.isnan(want)
        d = np.where(both, 0.0, got.astype(np.float64)
                     - want.astype(np.float64))
        return float(np.abs(d).max())
    return int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max())


def k8_reports(lib) -> dict:
    """ptxas's report of each K8 instance: fields (8, 32, 96) x team
    width (1, 8, 32 threads a row)."""
    from kubernetes_tpu_torch.native.build import ptxas_report

    return {f"F={f} lanes={n}": ptxas_report(
        lib, f"resident_scatter_kernelILi{f}ELi{n}E")
        for f in (8, 32, 96) for n in (1, 8, 32)}


def phase_k8(RK, S):
    """14a: K8 against its plain version on every SCATTER_CASES entry
    (rows at host widths: every dtype pair the kernel widens), twice:
    one launch a shard (scatter_rows) and one device-wide launch of every
    shard (scatter_shipment), each exact and equal to the expected
    update. K8 is timed on the churn wave's own shipment
    (phase_k8_churn). -> max_abs_err."""
    import numpy as np

    rows, err = [], 0
    for case in S.SCATTER_CASES:
        label = case[0]
        c, buf, tabs, names, axes, narrowed = k8_inputs(S, case)
        n, shards = c["n_per_shard"], c["shards"]
        plain = [{nm: t.clone() for nm, t in tb.items()} for tb in tabs]
        wide = [{nm: t.clone() for nm, t in tb.items()} for tb in tabs]
        launches = RK.LAUNCHES
        for s in range(shards):
            RK.scatter_rows(c["layout"], buf, names, axes,
                            [tabs[s][nm] for nm in names], n, s * n,
                            narrowed)
            RK.scatter_rows_plain(c["layout"], buf, names, axes,
                                  [plain[s][nm] for nm in names], n, s * n,
                                  narrowed)
        RK.scatter_shipment(c["layout"], buf, names, axes,
                            [[tb[nm] for nm in names] for tb in wide],
                            range(shards), n, narrowed)
        if RK.LAUNCHES - launches != shards + 1:
            raise AssertionError(f"K8 {label}: {RK.LAUNCHES - launches} "
                                 f"launches for {shards} shards and one "
                                 f"device-wide call")
        torch.cuda.synchronize()
        case_err = 0
        for nm, ax in zip(names, axes):
            want = np.concatenate([pl[nm].cpu().numpy() for pl in plain],
                                  axis=ax)
            nan = want.dtype.kind == "f"
            for how, out in (("shard by shard", tabs), ("device-wide", wide)):
                got = np.concatenate([tb[nm].cpu().numpy() for tb in out],
                                     axis=ax)
                case_err = max(case_err, k8_abs_err(got, want))
                if not (np.array_equal(got, want, equal_nan=nan)
                        and np.array_equal(got, c["expected"][nm],
                                           equal_nan=nan)):
                    raise AssertionError(f"K8 {label} ({how}): field {nm} "
                                         f"differs from its plain version")
        err = max(err, case_err)
        rows.append({"label": label, "shards": shards,
                     "n_per_shard": n, "M": c["M"], "rows": len(c["rows"]),
                     "fields": len(names), "max_abs_err": case_err,
                     "param_bytes": RK.param_bytes(len(names)),
                     "matches_plain": True,
                     "device_wide_matches_plain": True})
    emit("k8_vs_plain", cases=rows)
    return err


def phase_launch_floor(chain_lib) -> float:
    """The launch floor: csrc/chain_floor.cu's empty kernel (one block of
    32 threads), launched through ctypes back to back and timed with
    queued_ms exactly as K8 is. -> ms a launch."""
    import ctypes

    fn = ctypes.CDLL(chain_lib).launch_floor_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

    def launch():
        err = fn(1, 32, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch_floor launch failed: error {err}")

    ms = queued_ms(launch, reps=21, inner=10)
    emit("launch_floor", blocks=1, threads=32, ms=ms)
    return ms


def shipment_owned(call) -> int:
    """The packed rows that a captured K8 launch's shards own."""
    n = call["n_per_shard"]
    idx = call["idx"]
    return int(sum(((idx >= s * n) & (idx < (s + 1) * n)).sum()
                   for s in call["shards"]))


def shipment_bound_bytes(RK, shipment) -> int:
    """The bytes K8 must move for a captured shipment (one entry a
    launch, a launch a device): the rows its shards own read once at
    their shipped widths and written once at their placed widths, and
    __idx__ read once by each launch."""
    import numpy as np

    total = 0
    for call in shipment:
        seg = RK._segments(call["layout"])
        owned = shipment_owned(call)
        for nm, dst in zip(call["names"], call["after"][0]):
            elems = dst.numel() // call["n_per_shard"]
            total += owned * elems * (np.dtype(seg[nm][1]).itemsize
                                      + dst.element_size())
        total += call["idx"].size * 8
    return total


def load_baseline_k8(path):
    """A K8 library built from the first resident_scatter.cu (f2e6205), its
    resident_scatter_launch declared with that C interface (buf, idx_off,
    M, n_per_shard, offset, n_fields, desc of 6 a field, stream)."""
    import ctypes

    lib = ctypes.CDLL(path)
    fn = lib.resident_scatter_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    return lib


def baseline_k8_launcher(RK, lib, shipment, tabs):
    """The first K8's loop on a captured shipment: one launch of the baseline
    library for each owning shard, into `tabs` (per call, per shard, per
    field), its descriptors (src_off, dst, outer, inner, src and dst
    codes) made once. -> a function that launches them all."""
    import ctypes

    launches = []
    for call, per_shard in zip(shipment, tabs):
        seg = RK._segments(call["layout"])
        idx_off, _dt, (M,) = seg["__idx__"]
        n = call["n_per_shard"]
        for s, dests in zip(call["shards"], per_shard):
            desc = []
            for nm, ax, dst in zip(call["names"], call["axes"], dests):
                off, dt, _shape = seg[nm]
                outer, inner = RK._axis_strides(tuple(dst.shape), ax)
                desc += [off, dst.data_ptr(), outer, inner,
                         RK._src_code(dt), RK._dst_code(dst)]
            launches.append((call["buf"].data_ptr(), idx_off, M, n, s * n,
                             len(call["names"]),
                             (ctypes.c_longlong * len(desc))(*desc)))

    def launch():
        stream = torch.cuda.current_stream().cuda_stream
        for args in launches:
            err = lib.resident_scatter_launch(*args, stream)
            if err != 0:
                raise RuntimeError(f"baseline K8 launch failed: CUDA error "
                                   f"{err}")

    return launch, len(launches)


def phase_k8_churn(RK, shards, shipment, floor_ms, old=None):
    """14c's K8 shipment on the card: each captured launch (one a device:
    every owning shard on it) against the plain version on the tables as
    they were before it, shard by shard (exact); then the shipment's
    device time (on copies of the tables, through a destination table of
    the copies built once: the same rows land again) beside its byte
    bound, its launch bound (floor_ms, the empty kernel's time, times the
    launches it needs), the plain version and the index_copy_ calls that
    make the same update. old: (the first K8's library, its ptxas report) to
    hold to the same shipment (one launch an owning shard) and time in
    turns old, new, new, old. -> (the row, max_abs_err)."""
    from kubernetes_tpu_torch.models.pack import unpack

    err = 0
    for call in shipment:
        call["idx"] = unpack(call["layout"], call["buf"],
                             call["narrowed"])["__idx__"].cpu().numpy()
        n = call["n_per_shard"]
        for s, before, after in zip(call["shards"], call["before"],
                                    call["after"]):
            plain = [t.clone() for t in before]
            RK.scatter_rows_plain(call["layout"], call["buf"], call["names"],
                                  call["axes"], plain, n, s * n,
                                  call["narrowed"])
            for nm, got, want in zip(call["names"], after, plain):
                err = max(err, k8_abs_err(got, want))
                if not torch.equal(got, want):
                    raise AssertionError(f"K8 on the churn wave: field {nm} "
                                         f"of shard {s} differs from its "
                                         f"plain version")

    def copies():
        return [[[t.clone() for t in after] for after in call["after"]]
                for call in shipment]

    tabs, plain_tabs = copies(), copies()
    tables = [RK.DestTable(call["buf"].device, call["n_shards"], {
        nm: {s: per[s_i][f] for s_i, s in enumerate(call["shards"])}
        for f, nm in enumerate(call["names"])})
        for call, per in zip(shipment, tabs)]

    def kernel():
        for call, per, table in zip(shipment, tabs, tables):
            RK.scatter_shipment(call["layout"], call["buf"], call["names"],
                                call["axes"], per, call["shards"],
                                call["n_per_shard"], call["narrowed"],
                                table=table)

    def plain_fn():
        for call, per in zip(shipment, plain_tabs):
            n = call["n_per_shard"]
            for s, dests in zip(call["shards"], per):
                RK.scatter_rows_plain(call["layout"], call["buf"],
                                      call["names"], call["axes"], dests, n,
                                      s * n, call["narrowed"])

    # the library yardstick: index_copy_ of the unpacked rows at
    # precomputed local indices, one call a field an owning shard
    lib_args = []
    for call, per in zip(shipment, plain_tabs):
        unpacked = unpack(call["layout"], call["buf"], call["narrowed"])
        idx = unpacked["__idx__"]
        n = call["n_per_shard"]
        for s, dests in zip(call["shards"], per):
            local = idx - s * n
            keep = torch.nonzero((idx >= 0) & (local >= 0)
                                 & (local < n)).flatten()
            for nm, ax, dst in zip(call["names"], call["axes"], dests):
                lib_args.append((dst.movedim(ax, 0), local[keep].clone(),
                                 unpacked[nm][keep].to(dst.dtype)
                                 .contiguous()))

    def library():
        for dst, at, src in lib_args:
            dst.index_copy_(0, at, src)

    old_row = {}
    fns = {"new": kernel}
    if old is not None:
        old_tabs = [[[t.clone() for t in before] for before in call["before"]]
                    for call in shipment]
        check, old_launches = baseline_k8_launcher(RK, old[0], shipment,
                                                   old_tabs)
        check()
        torch.cuda.synchronize()
        for call, per in zip(shipment, old_tabs):
            for after, got in zip(call["after"], per):
                if not all(torch.equal(a, b) for a, b in zip(got, after)):
                    raise AssertionError("baseline K8 differs from its "
                                         "plain version on the churn wave")
        fns["old"], _n = baseline_k8_launcher(RK, old[0], shipment, tabs)
        old_row = {"baseline_launches_per_call": old_launches,
                   "baseline_ptxas": old[1], "baseline_matches_plain": True}
    turns = ("old", "new", "new", "old") if old is not None else ("new",)
    times = {"old": [], "new": []}
    launches = RK.LAUNCHES
    for which in turns:
        times[which].append(queued_ms(fns[which], reps=21, inner=10))
    timed = len(times["new"]) * (21 * 10 + 1) * len(shipment)
    if RK.LAUNCHES - launches != timed:
        raise AssertionError("K8's timed calls did not launch it once for "
                             "each device holding an owning shard")
    for call, per in zip(shipment, tabs):
        for after, got in zip(call["after"], per):
            if not all(torch.equal(a, b) for a, b in zip(got, after)):
                raise AssertionError("K8's timed calls changed the tables")
    ms = statistics.mean(times["new"])
    bound_bytes = shipment_bound_bytes(RK, shipment)
    bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
    launch_bound_ms = floor_ms * len(shipment)
    call = shipment[0]
    row = {"label": "churn wave", "shards": shards,
           "n_per_shard": call["n_per_shard"], "M": int(call["idx"].size),
           "rows": sum(shipment_owned(c) for c in shipment),
           "owning_shards": [list(c["shards"]) for c in shipment],
           "fields": len(call["names"]), "field_names": call["names"],
           "dtypes": [str(t.dtype) for t in call["after"][0]],
           "param_bytes": RK.param_bytes(len(call["names"])),
           "max_abs_err": err, "matches_plain": True, "ms": ms,
           "new_ms": times["new"], "ms_per_launch": ms / len(shipment),
           "launches_per_call": len(shipment),
           "plain_ms": cuda_ms(plain_fn, reps=11, inner=5),
           "library_ms": queued_ms(library, reps=21, inner=10),
           "library_calls": len(lib_args), "bound_ms": bound_ms,
           "bound_by": "bytes", "bound_share": bound_ms / ms,
           "bound_bytes": bound_bytes, "launch_floor_ms": floor_ms,
           "launch_bound_ms": launch_bound_ms,
           "launch_share": launch_bound_ms / ms, **old_row}
    if old is not None:
        old_ms = statistics.mean(times["old"])
        row.update(baseline_ms=old_ms, old_ms=times["old"],
                   speedup=old_ms / ms,
                   baseline_launch_share=floor_ms * old_row[
                       "baseline_launches_per_call"] / old_ms)
    emit("k8_churn", **row)
    return row, err


def mesh_algorithm(TorchScheduleAlgorithm, DeviceMesh, k, **kw):
    return TorchScheduleAlgorithm(mesh=DeviceMesh([MESH_DEVICE] * k),
                                  device=MESH_DEVICE, **kw)


def phase_mesh_density(PK, T, ClusterState, TorchScheduleAlgorithm,
                       DeviceMesh, S, single_names, single_wall, k):
    """14b: phase 4's density shape through TorchScheduleAlgorithm(mesh=
    ...) at k shards on the card: the names of the single-device driver
    (phase 4), K1 launched at the shard width. -> (K1 launches, shapes,
    the row)."""
    n_nodes, n_pods = MESH_SIZE
    nodes = S.density_nodes(T, n_nodes)
    pods = S.pause_pods(T, n_pods)
    state = ClusterState.build(nodes)
    t0 = time.perf_counter()
    mesh_algorithm(TorchScheduleAlgorithm, DeviceMesh, k).schedule_backlog(
        pods, state)
    torch.cuda.synchronize()
    cold_wall = time.perf_counter() - t0
    algo = mesh_algorithm(TorchScheduleAlgorithm, DeviceMesh, k)
    reset(PK)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    names = algo.schedule_backlog(pods, state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k1_shapes = PK.LAUNCHES, shapes(PK.LAUNCHES_BY_SHAPE)
    tally = dict(algo._mesh_sched.dispatches)
    if names != single_names:
        i = next(i for i, (a, b) in enumerate(zip(names, single_names))
                 if a != b)
        raise AssertionError(f"mesh density at {k} shards: pod {i} went to "
                             f"{names[i]}, one device chose "
                             f"{single_names[i]}")
    n_bucket = 1 << (max(n_nodes, 64) - 1).bit_length()
    widths = {N for (_J, N, _m) in PK.LAUNCHES_BY_SHAPE}
    if k1 <= 0 or widths != {n_bucket // k}:
        raise AssertionError(f"mesh density at {k} shards: K1 {k1} launches "
                             f"at widths {widths}")
    idle = idle_fields(*device_busy_ms(
        lambda: mesh_algorithm(TorchScheduleAlgorithm, DeviceMesh,
                               k).schedule_backlog(pods, state),
        counted_kernels(PK)))
    row = {"shards": k, "nodes": n_nodes, "pods": n_pods, "wall_s": wall,
           "cold_wall_s": cold_wall, "pods_per_s": n_pods / wall,
           "single_device_wall_s": single_wall, "dispatches": tally,
           "resident_stats": dict(algo._mesh_sched.resident.stats),
           "k1_launches": k1, "k1_launches_by_shape": k1_shapes, **idle,
           "equal_to_single_device": True}
    emit("mesh_density", **row)
    return k1, k1_shapes, row


def phase_mesh_waves(PK, RK, T, ClusterState, TorchScheduleAlgorithm,
                     DeviceMesh, S, k=4):
    """14c: the density backlog in MESH_WAVES waves at k shards on the
    resident state (reuse="auto", the binds folded into the cluster
    between waves), beside a reship run and the single-device driver in
    lockstep: names equal, steady waves ship no table bytes and keep
    every resident tensor's storage. Then the churn wave: labels and
    allocatable change on MESH_CHURN_NODES nodes and one node goes (the
    bucket stays 8,192): K8 launches once for each device holding a shard
    that owns a changed row (once: the shards share the card), names
    equal the reship run's and one device's. -> (K1 launches and
    shapes over the waves, K8's launches and shapes on the churn wave,
    its K8 calls as phase_k8_churn takes them)."""
    n_nodes, n_pods = MESH_SIZE
    per = n_pods // MESH_WAVES
    nodes = S.density_nodes(T, n_nodes)
    state = ClusterState.build(nodes)
    algo = mesh_algorithm(TorchScheduleAlgorithm, DeviceMesh, k)
    reship = mesh_algorithm(TorchScheduleAlgorithm, DeviceMesh, k)
    reship._mesh_sched.reuse_default = "reship"
    single = TorchScheduleAlgorithm(device=MESH_DEVICE)
    res = algo._mesh_sched.resident
    bound, waves = [], []
    # the mesh driver's own launches: the reship run and one device run
    # in lockstep, their launches left out
    mine = {"k1": 0, "k1_shapes": {}, "k8": 0, "k8_shapes": {}}

    def counted(fn):
        before = (PK.LAUNCHES, dict(PK.LAUNCHES_BY_SHAPE), RK.LAUNCHES,
                  dict(RK.LAUNCHES_BY_SHAPE))
        out = fn()
        mine["k1"] += PK.LAUNCHES - before[0]
        mine["k8"] += RK.LAUNCHES - before[2]
        for key, src, old in (("k1_shapes", PK.LAUNCHES_BY_SHAPE,
                               before[1]),
                              ("k8_shapes", RK.LAUNCHES_BY_SHAPE,
                               before[3])):
            for shape, n in src.items():
                if n - old.get(shape, 0):
                    mine[key][shape] = (mine[key].get(shape, 0) + n
                                        - old.get(shape, 0))
        return out

    def wave(pods, st):
        t0 = time.perf_counter()
        got = counted(lambda: algo.schedule_backlog(pods, st))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        rs = reship.schedule_backlog(pods, st)
        torch.cuda.synchronize()
        reship_wall = time.perf_counter() - t0
        if got != rs or got != single.schedule_backlog(pods, st):
            raise AssertionError(f"mesh waves: wave {len(waves)} differs "
                                 f"from the reship run or one device")
        waves.append({"pods": len(pods), "wall_s": wall,
                      "reship_wall_s": reship_wall,
                      "table_bytes": res.stats["wave_table_bytes"],
                      "h2d_bytes": res.stats["wave_h2d_bytes"],
                      "dispatches": dict(algo._mesh_sched.dispatches)})
        return got

    reset(PK, RK)
    ptrs = None
    for w in range(MESH_WAVES):
        pods = S.pause_pods(T, per, name0=w * per)
        got = wave(pods, state)
        bound += S.bind_hosts(state, pods, got)
        if w == 0:
            ptrs = {(f, s): t.data_ptr() for f, ts in
                    list(res._static.items()) + list(res._carry.items())
                    for s, t in enumerate(ts) if t.numel()}
        elif waves[-1]["table_bytes"] != 0:
            raise AssertionError(f"mesh waves: steady wave {w} shipped "
                                 f"{waves[-1]['table_bytes']} table bytes")
    now = {(f, s): t.data_ptr() for f, ts in
           list(res._static.items()) + list(res._carry.items())
           for s, t in enumerate(ts) if t.numel()}
    if now != ptrs:
        raise AssertionError("mesh waves: a resident tensor moved")
    k1, k1_shapes = mine["k1"], shapes(mine["k1_shapes"])
    if RK.LAUNCHES or k1 <= 0:
        raise AssertionError(f"mesh waves: K8 {RK.LAUNCHES} launches on "
                             f"the steady waves, K1 {k1}")
    gone = n_nodes - 1
    changed = S.density_nodes(T, gone)
    step = gone // MESH_CHURN_NODES
    churned = list(range(0, step * MESH_CHURN_NODES, step))
    for i in churned:
        changed[i].metadata.labels = {"disktype": "ssd"}
        changed[i].status.allocatable = dict(changed[i].status.allocatable,
                                             cpu="8", memory="64Gi")
    gone_name = nodes[gone].metadata.name
    state = ClusterState.build(
        changed, assigned_pods=[q for q in bound
                                if q.spec.node_name != gone_name])
    reset(PK, RK)
    mine.update(k1=0, k1_shapes={}, k8=0, k8_shapes={})
    before = dict(res.stats)
    pods = S.pause_pods(T, per, name0=n_pods)
    # keep each K8 call of the churn wave (its shipment as the resident
    # state built it, its shards' tables before and after) for 14c's
    # check and timing; the copies are a few small tensors
    shipment, scatter = [], RK.scatter_shipment

    def kept(layout, buf, names, axes, shard_dests, shard_ids, n_per_shard,
             narrowed=frozenset(), table=None):
        ours = {id(t) for ts in list(res._static.values())
                + list(res._carry.values()) for t in ts}
        call = None
        if id(shard_dests[0][0]) in ours:  # the mesh run's
            call = {"layout": layout, "buf": buf, "names": list(names),
                    "axes": list(axes), "n_per_shard": n_per_shard,
                    "shards": [int(s) for s in shard_ids],
                    "n_shards": table.n_shards, "narrowed": narrowed,
                    "before": [[d.clone() for d in dests]
                               for dests in shard_dests]}
            shipment.append(call)
        scatter(layout, buf, names, axes, shard_dests, shard_ids,
                n_per_shard, narrowed, table=table)
        if call is not None:
            call["after"] = [[d.clone() for d in dests]
                             for dests in shard_dests]

    RK.scatter_shipment = kept
    try:
        wave(pods, state)
    finally:
        RK.scatter_shipment = scatter
    n_per_shard = (1 << (max(n_nodes, 64) - 1).bit_length()) // k
    owners = sorted({i // n_per_shard for i in churned + [gone]})
    # one launch for each device holding an owning shard: 1 on the card
    plan = RK.launch_plan([MESH_DEVICE] * k, owners, n_per_shard)
    k8, k8_shapes = mine["k8"], [
        {"M": M, "n_per_shard": n, "fields": f, "shards": sh, "launches": c}
        for (M, n, f, sh), c in sorted(mine["k8_shapes"].items())]
    churn_k1, churn_k1_shapes = mine["k1"], shapes(mine["k1_shapes"])
    if k8 != len(plan) or res.stats["scatters"] != before["scatters"] + 1 \
            or res.stats["rebuilds"] != before["rebuilds"] \
            or len(shipment) != k8 \
            or [c["shards"] for c in shipment] != [list(p.shards)
                                                   for p in plan]:
        raise AssertionError(f"mesh churn: K8 {k8} launches for {owners} "
                             f"owning shards on {len(plan)} devices "
                             f"({len(shipment)} kept), stats {res.stats}")
    row = {"shards": k, "waves": waves, "churned_nodes": len(churned),
           "removed_node": gone_name, "owning_shards": owners,
           "k8_launches": k8,
           "k8_launches_by_shape": k8_shapes,
           "churn_last_changed": res.stats.get("last_changed"),
           "resident_stats": dict(res.stats), "k1_launches": k1,
           "k1_launches_by_shape": k1_shapes,
           "churn_k1_launches": churn_k1,
           "churn_k1_launches_by_shape": churn_k1_shapes,
           "steady_table_bytes": [w["table_bytes"] for w in waves[1:-1]],
           "equal_to_reship": True, "equal_to_single_device": True,
           "storage_kept": True}
    emit("mesh_waves", **row)
    return (k1 + churn_k1, k1_shapes, churn_k1, churn_k1_shapes, k8,
            k8_shapes, shipment)


def phase_mesh_scan(T, ClusterState, S, DeviceMesh, k=4):
    """14d: MeshBatchScheduler at k shards on the mixed scenario (phase
    5's cluster and backlog) against the single-device scan on the card,
    the counterpart of the JAX package's dryrun_multichip."""
    from kubernetes_tpu_torch.models.batch import BatchScheduler
    from kubernetes_tpu_torch.parallel.mesh import MeshBatchScheduler
    from kubernetes_tpu_torch.snapshot.encode import SnapshotEncoder

    nodes, services = S.mixed_cluster(T, MIXED_SIZE[0])
    pods = S.mixed_backlog(T, scale=MIXED_SIZE[1])
    state = ClusterState.build(nodes, services=services)
    enc = SnapshotEncoder(state, pods)
    snap, batch = enc.encode_nodes(), enc.encode_pods()
    t0 = time.perf_counter()
    got = MeshBatchScheduler(DeviceMesh([MESH_DEVICE] * k)).schedule_names(
        snap, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = BatchScheduler(device=MESH_DEVICE).schedule_names(snap, batch)
    torch.cuda.synchronize()
    single_wall = time.perf_counter() - t0
    if got != want:
        i = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        raise AssertionError(f"mesh scan: pod {i} went to {got[i]}, the "
                             f"single-device scan chose {want[i]}")
    emit("mesh_scan", shards=k, nodes=len(nodes), pods=len(pods),
         wall_s=wall, ms_per_pod=wall / len(pods) * 1e3,
         single_device_wall_s=single_wall,
         unscheduled=got.count(None), equal_to_single_device=True)


def phase_mesh(PK, RK, T, ClusterState, TorchScheduleAlgorithm, S,
               density_names, density_wall, floor_ms, old_k8=None):
    """Phase 14, the mesh (floor_ms: the launch floor; old_k8: the first K8's
    library and ptxas report, --baseline-k8): -> (K8's row, K1 launches
    and shapes by path, K8 launches and shapes)."""
    from kubernetes_tpu_torch.parallel.shard import DeviceMesh

    t0 = time.perf_counter()
    case_err = phase_k8(RK, S)
    k1_paths, k1_shapes = {}, {}
    for k in MESH_SHARDS:
        n, sh, _row = phase_mesh_density(
            PK, T, ClusterState, TorchScheduleAlgorithm, DeviceMesh, S,
            density_names, density_wall, k)
        k1_paths[f"mesh_density_{k}"] = n
        k1_shapes[f"mesh_density_{k}"] = sh
    k = MESH_SHARDS[0]
    n, sh, n_churn, sh_churn, k8, k8_shapes, shipment = phase_mesh_waves(
        PK, RK, T, ClusterState, TorchScheduleAlgorithm, DeviceMesh, S, k)
    k8_row, churn_err = phase_k8_churn(RK, k, shipment, floor_ms, old_k8)
    k8_err = max(case_err, churn_err)
    k1_paths["mesh_waves"] = n - n_churn
    k1_shapes["mesh_waves"] = sh
    k1_paths["mesh_churn"] = n_churn
    k1_shapes["mesh_churn"] = sh_churn
    phase_mesh_scan(T, ClusterState, S, DeviceMesh)
    emit("mesh", seconds=time.perf_counter() - t0)
    return k8_row, k8_err, k1_paths, k1_shapes, k8, k8_shapes


def k6_shapes_of(VK) -> list:
    """K6's {(N, C): launches} -> [{"N", "C", "launches"}, ...] in
    order."""
    return [{"N": N, "C": C, "launches": k}
            for (N, C), k in sorted(VK.LAUNCHES_BY_SHAPE.items())]


def shapes(by_shape: dict) -> list:
    """K1's {(J, N, mode): launches} -> [{"J", "N", "G", "mode",
    "launches"}, ...] in order. K1 has no run axis: the grouped probe
    launches it once per run (G = 1 each)."""
    return [{"J": J, "N": N, "G": 1, "mode": mode, "launches": k}
            for (J, N, mode), k in sorted(by_shape.items())]


#: the per-case keys of K7's entries in the kernels line
K7_CASE_KEYS = ("P", "N", "ms", "baseline_ms", "speedup", "plain_ms",
                "bound_ms", "bound_share", "per_round_bound_ms",
                "per_round_share", "sync_bound_ms", "sync_share",
                "chain_bound_ms", "chain_share", "rounds_run", "syncs",
                "path", "grid")

#: the JAX functions K7 replaces, by solver
K7_REPLACES = {
    "auction": "kubernetes_tpu/scheduler/optimizer/ops/assign.py:61",
    "beam": "kubernetes_tpu/scheduler/optimizer/ops/assign.py:144",
}


def k7_entry(solver, times, err, ptxas, paths) -> dict:
    """K7's entry in the kernels line for one solver: its row at
    K7_MAIN's shape, its launches on phase 13's paths (the auction on the
    pack configs' optimizing arms and the gang waves, the beam on the
    24-pod wave) and its other timed shapes."""
    row = times[K7_MAIN[solver]]
    by_path = {label: sum(s["launches"] for s in p[3]
                          if s["solver"] == solver)
               for label, p in paths.items()}
    by_path = {k: v for k, v in by_path.items() if v}
    return {
        "name": f"assign_{solver}",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/assign_kernel.cu",
        "replaces": K7_REPLACES[solver],
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "launches_by_shape": {label: [s for s in p[3]
                                      if s["solver"] == solver]
                              for label, p in paths.items()
                              if label in by_path},
        "max_abs_err": err,
        "matches_plain": True,
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "bound_share": row["bound_share"],
        "per_round_bound_ms": row.get("per_round_bound_ms"),
        "sync_bound_ms": row.get("sync_bound_ms"),
        "chain_bound_ms": row.get("chain_bound_ms"),
        "rounds_run": row.get("rounds_run"),
        "path": row.get("path"),
        "baseline_ms": row.get("baseline_ms"),
        "speedup": row.get("speedup"),
        "paths": {label: r["path"] for label, r in times.items()
                  if r["solver"] == solver and "path" in r},
        "cases": {label: {k: r.get(k) for k in K7_CASE_KEYS}
                  for label, r in times.items()
                  if "ms" in r and r["solver"] == solver},
        "ptxas": ptxas[solver],
        "library_ms": None,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", metavar="OLD.cu",
                    help="also time the probe kernel built from this "
                    "source against this checkout's")
    ap.add_argument("--baseline-k3", metavar="OLD.cu",
                    help="also time the pick loop (K3) built from this "
                    "source against this checkout's")
    ap.add_argument("--baseline-k6", metavar="OLD.cu",
                    help="also time the victim scorer (K6) built from this "
                    "source against this checkout's")
    ap.add_argument("--baseline-k7", metavar="OLD.cu",
                    help="also check and time the joint-assignment solve "
                    "(K7) built from this source against this checkout's")
    ap.add_argument("--baseline-k8", metavar="OLD.cu",
                    help="also check and time the row scatter (K8) built "
                    "from this source (the first K8's C interface: one "
                    "launch a shard) against this checkout's on the churn "
                    "shipment")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from kubernetes_tpu_torch.harness import scenarios as S

    # the serial oracle and phase 6's CPU runs take minutes of host time:
    # they run in worker processes while the card works, and the pool's
    # exit terminates them whatever happens
    with multiprocessing.get_context("spawn").Pool(
            HOST_WORKERS, initializer=worker_init) as pool:
        return run(args, host_jobs(pool, S))


def run(args, jobs) -> int:
    from kubernetes_tpu_torch.api import types as T
    from kubernetes_tpu_torch.harness import scenarios as S
    from kubernetes_tpu_torch.models import replay
    from kubernetes_tpu_torch.native.build import (
        build_cuda, build_cuda_file, ptxas_report,
    )
    from kubernetes_tpu_torch.oracle import ClusterState
    from kubernetes_tpu_torch.ops import preempt as P
    from kubernetes_tpu_torch.ops import preempt_kernel as VK
    from kubernetes_tpu_torch.ops import probe_kernel as PK
    from kubernetes_tpu_torch.ops import zreplay_kernel as ZK
    from kubernetes_tpu_torch.parallel import resident_kernel as RK
    from kubernetes_tpu_torch.runtime import scheme
    from kubernetes_tpu_torch.scheduler.algorithm import (
        TorchScheduleAlgorithm,
    )
    from kubernetes_tpu_torch.scheduler.extender_server import (
        TorchExtenderServer,
    )
    from kubernetes_tpu_torch.scheduler.optimizer.ops import assign as A
    from kubernetes_tpu_torch.scheduler.optimizer.ops import (
        assign_kernel as AK,
    )

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)

    # one nvcc per kernel source, all started together
    builds = [PK.build, ZK.build, VK.build, AK.build,
              lambda: build_cuda("chain_floor"), RK.build]
    baselines = [(flag, src, name) for flag, src, name in (
        ("k3", args.baseline_k3, "zreplay_kernel_baseline"),
        ("k6", args.baseline_k6, "preempt_kernel_baseline"),
        ("k7", args.baseline_k7, "assign_kernel_baseline"),
        ("k8", args.baseline_k8, "resident_scatter_baseline")) if src]
    for _flag, src, name in baselines:
        builds.append(lambda src=src, name=name: build_cuda_file(
            os.path.abspath(src), name))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        k1_lib, k3_lib, k6_lib, k7_lib, chain_lib, k8_lib, *old_libs = \
            pool.map(lambda f: f(), builds)
    old_paths = {flag: path for (flag, _s, _n), path in zip(baselines,
                                                             old_libs)}
    k3_ptxas = k3_reports(k3_lib)
    k6_ptxas = k6_reports(k6_lib)
    k7_ptxas = k7_reports(k7_lib)
    k8_ptxas = k8_reports(k8_lib)
    emit("build", kernels=["resource_probe", "zreplay", "victim_score",
                           "assign", "chain_floor", "resident_scatter"],
         seconds=time.perf_counter() - t0,
         ptxas={"resource_probe": ptxas_report(k1_lib,
                                               "resource_probe_kernel"),
                "resource_probe_bf16": ptxas_report(
                    k1_lib, "resource_probe_bf16_kernel"),
                "zreplay": k3_ptxas,
                "victim_score": k6_ptxas,
                "assign": k7_ptxas,
                "chain_floor": {
                    **{f"threads={n}": ptxas_report(
                        chain_lib, f"chain_floor_kernelILi{n}E")
                       for n in (K3_THREADS, 1024, BEAM_CHAIN_THREADS)},
                    "grid_sync": ptxas_report(chain_lib,
                                              "grid_sync_floor_kernel"),
                    "launch_floor": ptxas_report(chain_lib,
                                                 "launch_floor_kernel")},
                "resident_scatter": k8_ptxas},
         c_replay=replay._load_lib() is not None)

    times, max_err = phase_kernel(PK, S)
    k1_bf16, bf16_err = phase_kernel_bf16(PK, S, times[(128, 8192)])
    if args.baseline:
        phase_baseline(PK, S, args.baseline)
    chain_us = phase_chain_floor(chain_lib)
    old_lib = None
    if "k3" in old_paths:
        old_lib = ZK.load(old_paths["k3"])
        emit("baseline_k3_build", source=args.baseline_k3,
             ptxas=ptxas_report(old_paths["k3"], "zreplay_kernel"),
             new_ptxas=k3_ptxas)
    k3_times, k3_err = phase_k3(ZK, S, chain_us[K3_THREADS], old_lib)
    old_k6 = None
    if "k6" in old_paths:
        old_k6 = (VK.load(old_paths["k6"]),
                  k6_report(old_paths["k6"], "victim_score_kernel"))
        emit("baseline_k6_build", source=args.baseline_k6,
             ptxas=old_k6[1], new_ptxas=k6_ptxas)
    k6_times, k6_err = phase_k6(VK, S, P, k6_ptxas, old_k6)
    old_k7 = None
    if "k7" in old_paths:
        old_k7 = (load_baseline_k7(AK, old_paths["k7"]),
                  k7_reports(old_paths["k7"]))
        emit("baseline_k7_build", source=args.baseline_k7,
             ptxas=old_k7[1], new_ptxas=k7_ptxas)
    sync_us = phase_grid_sync_floor(chain_lib, AK, S)
    k7_times, k7_err = phase_k7(AK, A, S, k7_ptxas,
                                chain_us[BEAM_CHAIN_THREADS], sync_us, old_k7)
    launches, density_shapes, density_names, density_wall = \
        phase_main_path(PK, ZK, T, ClusterState, TorchScheduleAlgorithm, S)
    z_k1, z_k1_shapes, z_k3, z_k3_shapes = phase_zoned_density(
        PK, ZK, T, ClusterState, TorchScheduleAlgorithm, S,
        replay.replay_spec)
    tpl_k1, tpl_k1_shapes = phase_many_templates(
        PK, T, ClusterState, TorchScheduleAlgorithm, S)
    mixed_launches, mixed_shapes, mixed_k3, mixed_k3_shapes = phase_mixed(
        PK, ZK, T, ClusterState, TorchScheduleAlgorithm, S,
        jobs["mixed_oracle"])
    policy = phase_policy(PK, ZK, T, ClusterState, S, TorchScheduleAlgorithm,
                          replay, jobs)
    phase_extender(T, S, scheme, TorchExtenderServer)
    gang_k1, gang_k1_shapes, gang_k6, gang_k6_shapes = phase_gangs(
        PK, VK, jobs)
    daemon_k1, daemon_k1_shapes = phase_daemon(
        PK, ZK, T, S, TorchScheduleAlgorithm, density_names, density_wall)
    daemon_gang_k1, daemon_gang_k1_shapes, daemon_gang_k6, \
        daemon_gang_k6_shapes = phase_daemon_gangs(PK, VK, jobs)
    wire_k1, wire_k1_shapes = phase_wire(PK, ZK, ClusterState,
                                         TorchScheduleAlgorithm)
    separate_k1, separate_k1_shapes = phase_wire_separate(
        PK, ZK, ClusterState, TorchScheduleAlgorithm)
    profile_bf16, profile_bf16_shapes = phase_profiles(
        PK, S, TorchScheduleAlgorithm, jobs)
    opt_paths = phase_optimizing(PK, AK, jobs)
    floor_ms = phase_launch_floor(chain_lib)
    old_k8 = None
    if "k8" in old_paths:
        old_k8 = (load_baseline_k8(old_paths["k8"]),
                  ptxas_report(old_paths["k8"], "resident_scatter_kernel"))
        emit("baseline_k8_build", source=args.baseline_k8,
             ptxas=old_k8[1], new_ptxas=k8_ptxas)
    k8, k8_err, mesh_k1, mesh_k1_shapes, k8_launches, k8_shapes = \
        phase_mesh(PK, RK, T, ClusterState, TorchScheduleAlgorithm, S,
                   density_names, density_wall, floor_ms, old_k8)

    # the density path probes J=128 over the 5,000 nodes padded to 8,192;
    # the zoned density path runs one 50,000-pick run in a 65,536 bucket
    k1 = times[(128, 8192)]
    k3 = k3_times["main N=8192 K=65536"]
    # the gang phase's victim table: 5,000 nodes padded to 8,192 rows of
    # 24 candidates in a 32 bucket
    k6 = k6_times["gang phase N=8192 C=32"]
    print(json.dumps({"kernels": [{
        "name": "resource_probe",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/probe_kernel.cu",
        "replaces": "kubernetes_tpu/ops/pallas_probe.py:63",
        "launches": launches,
        "launches_by_path": {"density": launches, "zoned_density": z_k1,
                             "many_templates": tpl_k1,
                             "mixed": mixed_launches,
                             **{f"policy_{k}": v[0]
                                for k, v in policy.items()},
                             "gangs": gang_k1, "daemon": daemon_k1,
                             "daemon_gangs": daemon_gang_k1,
                             "wire": wire_k1,
                             "wire_separate": separate_k1,
                             **{f"optimizing_{k}": v[0]
                                for k, v in opt_paths.items()},
                             **mesh_k1},
        "launches_by_shape": {"density": density_shapes,
                              "zoned_density": z_k1_shapes,
                              "many_templates": tpl_k1_shapes,
                              "mixed": mixed_shapes,
                              **{f"policy_{k}": v[1]
                                 for k, v in policy.items()},
                              "gangs": gang_k1_shapes,
                              "daemon": daemon_k1_shapes,
                              "daemon_gangs": daemon_gang_k1_shapes,
                              "wire": wire_k1_shapes,
                              "wire_separate": separate_k1_shapes,
                              **{f"optimizing_{k}": v[1]
                                 for k, v in opt_paths.items()},
                              **mesh_k1_shapes},
        "max_abs_err": max_err,
        "matches_plain": True,
        "ms": k1["ms"],
        "call_device_ms": k1["call_device_ms"],
        "call_ms": k1["call_ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "bound_share": k1["bound_share"],
        "grid": k1["grid"],
        "block": k1["block"],
        "j_chunk": k1["j_chunk"],
        "library_ms": None,
    }, {
        "name": "resource_probe_bf16",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/probe_kernel.cu",
        "replaces": "kubernetes_tpu/ops/pallas_probe.py:63",
        "mode": "bf16 (pallas_probe.py:95-104)",
        "launches": profile_bf16,
        "launches_by_path": {"profiles_bf16": profile_bf16},
        "launches_by_shape": {"profiles_bf16": profile_bf16_shapes},
        "max_abs_err": bf16_err,
        "matches_plain": True,
        "ms": k1_bf16["ms"],
        "call_device_ms": k1_bf16["call_device_ms"],
        "plain_ms": k1_bf16["plain_ms"],
        "bound_ms": k1_bf16["bound_ms"],
        "bound_by": k1_bf16["bound_by"],
        "bound_share": k1_bf16["bound_share"],
        "i64_ms": k1_bf16["i64_ms"],
        "library_ms": None,
    }, {
        "name": "zreplay",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/zreplay_kernel.cu",
        "replaces": "kubernetes_tpu/models/zreplay.py:59",
        "launches": z_k3,
        "launches_by_path": {"zoned_density": z_k3, "mixed": mixed_k3},
        "launches_by_shape": {"zoned_density": z_k3_shapes,
                              "mixed": mixed_k3_shapes},
        "max_abs_err": k3_err,
        "matches_plain": True,
        "ms": k3["ms"],
        "us_per_pick": k3["us_per_pick"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "bound_share": k3["bound_share"],
        "chain_bound_ms": k3["chain_bound_ms"],
        "chain_share": k3["chain_share"],
        "chain_floor_us_by_threads": chain_us,
        "node_picks": k3["node_picks"],
        "ptxas": k3_ptxas,
        "library_ms": None,
    }, {
        "name": "victim_score",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/preempt_kernel.cu",
        "replaces": "kubernetes_tpu/ops/preempt.py:42",
        "launches": gang_k6,
        "launches_by_path": {"gangs": gang_k6,
                             "daemon_gangs": daemon_gang_k6},
        "launches_by_shape": {"gangs": gang_k6_shapes,
                              "daemon_gangs": daemon_gang_k6_shapes},
        "max_abs_err": k6_err,
        "matches_plain": True,
        "ms": k6["ms"],
        "traces": k6["traces"],
        "events_ms": k6["events_ms"],
        "cold_ms": k6["cold_ms"],
        "plain_ms": k6["plain_ms"],
        "bound_ms": k6["bound_ms"],
        "bound_by": k6["bound_by"],
        "bound_share": k6["bound_share"],
        "baseline_ms": k6.get("baseline_ms"),
        "path": k6["path"],
        "rows_per_block": k6["rows_per_block"],
        "cases": {label: {key: row.get(key) for key in K6_CASE_KEYS}
                  for label, row in k6_times.items()},
        "ptxas": k6_ptxas,
        "library_ms": None,
    }, *[k7_entry(solver, k7_times, k7_err, k7_ptxas, opt_paths)
         for solver in ("auction", "beam")], {
        "name": "resident_scatter",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/resident_scatter.cu",
        "replaces": "kubernetes_tpu/parallel/resident.py:167",
        "launches": k8_launches,
        "launches_by_path": {"mesh_churn": k8_launches},
        "launches_by_shape": {"mesh_churn": k8_shapes},
        "max_abs_err": k8_err,
        "matches_plain": True,
        "shape": {k: k8[k] for k in ("shards", "n_per_shard", "M", "rows",
                                     "fields", "owning_shards")},
        "ms": k8["ms"],
        "ms_per_launch": k8["ms_per_launch"],
        "launches_per_call": k8["launches_per_call"],
        "plain_ms": k8["plain_ms"],
        "bound_ms": k8["bound_ms"],
        "bound_by": k8["bound_by"],
        "bound_share": k8["bound_share"],
        "bound_bytes": k8["bound_bytes"],
        "launch_floor_ms": k8["launch_floor_ms"],
        "launch_bound_ms": k8["launch_bound_ms"],
        "launch_share": k8["launch_share"],
        "baseline_ms": k8.get("baseline_ms"),
        "speedup": k8.get("speedup"),
        "param_bytes": k8["param_bytes"],
        "ptxas": k8_ptxas,
        "library_ms": k8["library_ms"],
        "library": "index_copy_",
        "library_calls": k8["library_calls"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
