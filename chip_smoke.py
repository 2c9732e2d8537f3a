"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--baseline OLD.cu] [--baseline-k3 OLD.cu]

Phases, each printing one JSON line; any failure raises and exits
non-zero:
  1. device: the card's name, and its name and power limit as nvidia-smi
     reports them;
  2. build: the CUDA kernels (csrc/probe_kernel.cu, K1; csrc/
     zreplay_kernel.cu, K3, one report per template instance; csrc/
     preempt_kernel.cu, K6; csrc/chain_floor.cu, K3's yardstick) built
     with nvcc for sm_90a from the
     sources in this checkout, in parallel, with ptxas's registers, spills
     and shared memory for each;
  3. kernel vs plain: ops/probe_kernel.resource_probe (K1) on the card
     against its plain torch version, exact equality, at the main path's
     shapes and on edge inputs (scenarios.PROBE_CASES, J=1 included),
     with profiler device times, the byte bound and the share of it
     reached, and the grid; with --baseline, also the probe kernel built
     from OLD.cu (a source with the same C interface, e.g. an earlier
     version of the kernel) against this checkout's, device times taken
     in turns (old, new, new, old) on every case;
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
     ties, C = 8, 32, 128, 1,024, and the gang phase's own (8,192, 32),
     as the director builds it and as a fuzz), with the kernel's device
     time (profiler, every launch of the trace accounted for), the bound
     from the case's own candidates and its share, and the plain
     version's time;
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
  9. the kernels line, with the launch counts of each path it drove;
     then nvidia-smi's line, then the result line
     {"ok": true, "device": {...}}.

Each path's launch counts are set to 0 just before it and read just
after; a path that does not launch each of its kernels fails. The
host-only references (the serial oracle of phases 5 and 6, phase 6's
CPU runs, phase 8's CPU flow) run from the start in three worker
processes of two torch threads each (host_jobs), beside the card's
phases.

Exits non-zero, printing no result, when CUDA is not available or when
the port's package is not beside this script.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
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


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


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


def kernel_device_ms(fn, name, n=20, tries=8):
    """-> (mean device time of the kernel `name` per launch, summed device
    time of every kernel per call of fn, in ms, over n calls of fn, each
    launching `name` once, from the profiler's CUPTI trace; the launches
    of `name` that each trace taken recorded, the kept one last). A trace
    is kept only when it accounts for every launch: `name` recorded n
    times and every other kernel a multiple of n times. One that falls
    short is taken again, up to `tries` traces in all; then it raises.
    (Traces on the H100 have kept as few as 0 of 20 launches, in phase 3
    and after it; the rows print `traces`.)"""
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
    raise RuntimeError(f"{tries} profiler traces of {n} launches of {name} "
                       f"recorded {seen} of them")


def device_busy_ms(fn):
    """-> (summed device time of every kernel and copy, in ms, or None
    when the trace shows none; wall seconds) of one traced call. The
    trace records only the device's activity: the host's ops would add
    their own cost to the wall (and to the idle share) and to calls that
    launch millions of kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(ev.self_device_time_total for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA)
    return (busy_us / 1e3 if busy_us else None), wall


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
    """K3's chain floor: the time of one step of csrc/chain_floor.cu (one
    block, a block-wide max, a broadcast and one barrier per step) at 256
    threads (K3's block) and at 1,024, CUDA events over `steps` steps.
    -> {threads: microseconds per step}."""
    import ctypes

    fn = ctypes.CDLL(lib).chain_floor_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    out = torch.empty(1, dtype=torch.int64, device="cuda")
    us = {}
    for threads in (K3_THREADS, 1024):
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


def phase_k6(VK, S, P):
    """K6 against victim_score_plain on every scenarios.VICTIM_CASES entry,
    exact equality of needed, cost and order, with the kernel's device
    time (profiler; and, as a cross-check, CUDA events around launches
    queued behind a device sleep, gaps included), the plain version's
    (CUDA events), the bound and its share. -> ({label: row},
    max_abs_err)."""
    results, max_err = {}, 0
    for seed, (label, N, C, kind) in enumerate(S.VICTIM_CASES):
        c = S.victim_case(N, C, seed, kind)
        args = [torch.as_tensor(c[k]).cuda()
                for k in ("prio", "ord", "res", "free", "req")]
        gp = c["gang_prio"]
        got = VK.victim_score(*args, gp)
        want = P.victim_score_plain(*args, gp)
        torch.cuda.synchronize()
        equal = all(a.dtype == b.dtype and torch.equal(a, b)
                    for a, b in zip(got, want))
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                  for a, b in zip(got, want))
        max_err = max(max_err, err)
        ms, _, traces = kernel_device_ms(lambda: VK._launch(*args, gp),
                                         "victim_score_kernel")
        events_ms = queued_ms(lambda: VK._launch(*args, gp), reps=7,
                              inner=10)
        plain_ms = cuda_ms(lambda: P.victim_score_plain(*args, gp), reps=7,
                           inner=3)
        bound_ms, bound_by = victim_bound_ms(args[0], gp)
        row = dict(ms=ms, traces=traces, events_ms=events_ms,
                   plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   bound_share=bound_ms / ms)
        results[label] = row
        needed = got[0].cpu()
        emit("k6_vs_plain", case=label, N=N, C=C, kind=kind, equal=equal,
             max_abs_err=err, library_call="none",
             needed_counts={str(k): v for k, v in zip(
                 *(x.tolist() for x in torch.unique(
                     needed, return_counts=True)))}, **row)
        if not equal:
            raise AssertionError(f"K6 != plain on {label}")
    return results, max_err


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
    busy_ms, traced_wall = device_busy_ms(
        lambda: TorchScheduleAlgorithm(device="cuda").schedule_backlog(
            pods, state))
    emit("main_path", nodes=n_nodes, pods=n_pods, wall_s=wall,
         encode_s=encode_s, encode_share=encode_s / wall,
         cold_wall_s=cold_wall, traced_wall_s=traced_wall,
         device_busy_ms=busy_ms,
         device_idle_share=(None if busy_ms is None
                            else 1.0 - busy_ms / 1e3 / traced_wall),
         pods_per_s=n_pods / wall, probes=tally.get("probe", 0),
         scans=tally.get("scan", 0), scan_pods=tally.get("scan_pods", 0),
         kernel_launches=launches, launches_by_shape=by_shape,
         cpu_wall_s=cpu_wall, equal_to_cpu=True, pods_per_node=10)
    return launches, by_shape


def reset(*kernels) -> None:
    for K in kernels:
        K.LAUNCHES = 0
        K.LAUNCHES_BY_SHAPE.clear()


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
    busy_ms, traced_wall = device_busy_ms(
        lambda: TorchScheduleAlgorithm(device="cuda").schedule_backlog(
            pods, state))
    emit("zoned_density", nodes=n_nodes, pods=n_pods, wall_s=wall,
         cold_wall_s=cold_wall, pods_per_s=n_pods / wall,
         spec_replay_wall_s=spec_wall, spec_over_device=spec_wall / wall,
         traced_wall_s=traced_wall, device_busy_ms=busy_ms,
         device_idle_share=(None if busy_ms is None
                            else 1.0 - busy_ms / 1e3 / traced_wall),
         dispatches=tally, spec_dispatches=spec_tally, k1_launches=k1,
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
    j1 = sum(k for (J, _N), k in PK.LAUNCHES_BY_SHAPE.items() if J == 1)
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
    and 6, phase 6's CPU runs and phase 8's CPU flow. -> {key:
    AsyncResult}."""
    jobs = {"mixed_oracle": pool.apply_async(mixed_oracle_names,
                                             MIXED_SIZE)}
    for name in S.POLICY_DOCUMENTS:
        jobs[f"policy_oracle_{name}"] = pool.apply_async(
            policy_oracle_names, (name, *POLICY_ORACLE_SIZE))
        jobs[f"policy_cpu_{name}"] = pool.apply_async(
            policy_cpu_names, (name, *POLICY_SIZE))
    jobs["gang_cpu"] = pool.apply_async(gang_cpu_flow, (GANG_SIZE,))
    return jobs


def worker_init() -> None:
    """A worker of host_jobs takes two of the host's cores for torch."""
    torch.set_num_threads(2)


class Stopwatch:
    """Adds up the seconds spent in obj.<name> (a module's function or an
    instance's method) while it is entered, by wrapping the attribute."""

    def __init__(self, obj, name):
        self.obj, self.name, self.seconds, self.calls = obj, name, 0.0, 0

    def __enter__(self):
        self.orig = orig = getattr(self.obj, self.name)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*args, **kw)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1

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
        busy_ms, traced_wall = device_busy_ms(
            lambda: algo().schedule_backlog(tr_pods, tr_state))
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
             traced_pods=len(tr_pods), traced_wall_s=traced_wall,
             device_busy_ms=busy_ms,
             device_idle_share=(None if busy_ms is None
                                else 1.0 - busy_ms / 1e3 / traced_wall),
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
    k6 = VK.LAUNCHES
    k6_shapes = [{"N": N, "C": C, "launches": k}
                 for (N, C), k in sorted(VK.LAUNCHES_BY_SHAPE.items())]
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


def shapes(by_shape: dict) -> list:
    """K1's {(J, N): launches} -> [{"J", "N", "G", "launches"}, ...] in
    order. K1 has no run axis: the grouped probe launches it once per run
    (G = 1 each)."""
    return [{"J": J, "N": N, "G": 1, "launches": k}
            for (J, N), k in sorted(by_shape.items())]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", metavar="OLD.cu",
                    help="also time the probe kernel built from this "
                    "source against this checkout's")
    ap.add_argument("--baseline-k3", metavar="OLD.cu",
                    help="also time the pick loop (K3) built from this "
                    "source against this checkout's")
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
    from kubernetes_tpu_torch.runtime import scheme
    from kubernetes_tpu_torch.scheduler.algorithm import (
        TorchScheduleAlgorithm,
    )
    from kubernetes_tpu_torch.scheduler.extender_server import (
        TorchExtenderServer,
    )

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)

    # one nvcc per kernel source, all started together
    builds = [PK.build, ZK.build, VK.build,
              lambda: build_cuda("chain_floor")]
    if args.baseline_k3:
        builds.append(lambda: build_cuda_file(
            os.path.abspath(args.baseline_k3), "zreplay_kernel_baseline"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        k1_lib, k3_lib, k6_lib, chain_lib, *old_k3 = pool.map(
            lambda f: f(), builds)
    k3_ptxas = k3_reports(k3_lib)
    k6_ptxas = ptxas_report(k6_lib, "victim_score_kernel")
    emit("build", kernels=["resource_probe", "zreplay", "victim_score",
                           "chain_floor"],
         seconds=time.perf_counter() - t0,
         ptxas={"resource_probe": ptxas_report(k1_lib,
                                               "resource_probe_kernel"),
                "zreplay": k3_ptxas,
                "victim_score": k6_ptxas,
                "chain_floor": {
                    f"threads={n}": ptxas_report(
                        chain_lib, f"chain_floor_kernelILi{n}E")
                    for n in (K3_THREADS, 1024)}},
         c_replay=replay._load_lib() is not None)

    times, max_err = phase_kernel(PK, S)
    if args.baseline:
        phase_baseline(PK, S, args.baseline)
    chain_us = phase_chain_floor(chain_lib)
    old_lib = None
    if old_k3:
        old_lib = ZK.load(old_k3[0])
        emit("baseline_k3_build", source=args.baseline_k3,
             ptxas=ptxas_report(old_k3[0], "zreplay_kernel"),
             new_ptxas=k3_ptxas)
    k3_times, k3_err = phase_k3(ZK, S, chain_us[K3_THREADS], old_lib)
    k6_times, k6_err = phase_k6(VK, S, P)
    launches, density_shapes = phase_main_path(
        PK, ZK, T, ClusterState, TorchScheduleAlgorithm, S)
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
                             "gangs": gang_k1},
        "launches_by_shape": {"density": density_shapes,
                              "zoned_density": z_k1_shapes,
                              "many_templates": tpl_k1_shapes,
                              "mixed": mixed_shapes,
                              **{f"policy_{k}": v[1]
                                 for k, v in policy.items()},
                              "gangs": gang_k1_shapes},
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
        "launches_by_path": {"gangs": gang_k6},
        "launches_by_shape": {"gangs": gang_k6_shapes},
        "max_abs_err": k6_err,
        "matches_plain": True,
        "ms": k6["ms"],
        "traces": k6["traces"],
        "events_ms": k6["events_ms"],
        "plain_ms": k6["plain_ms"],
        "bound_ms": k6["bound_ms"],
        "bound_by": k6["bound_by"],
        "bound_share": k6["bound_share"],
        "ptxas": k6_ptxas,
        "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
