"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--baseline OLD.cu]

Phases, each printing one JSON line; any failure raises and exits
non-zero:
  1. device: the card's name, and its name and power limit as nvidia-smi
     reports them;
  2. build: the CUDA kernels (csrc/probe_kernel.cu, K1; csrc/
     zreplay_kernel.cu, K3) built with nvcc for sm_90a from the sources
     in this checkout, in parallel, with ptxas's registers, spills and
     shared memory for each;
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
     bailed), on scenarios.ZREPLAY_CASES, with profiler device times,
     microseconds per pick, the plain version's time and the bound;
  4. main path: the scheduler_perf density shape at the north-star size
     (5,000 nodes of 4 CPU / 32Gi / 110 pods, 50,000 pause pods of
     100m / 500Mi) through TorchScheduleAlgorithm on the card; every pod
     placed, 10 per node, names equal to the same call on the CPU, and
     the probe kernel launched (its launches counted by (J, N));
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
  6. the kernels line, with the launch counts of each path it drove;
     then nvidia-smi's line, then the result line
     {"ok": true, "device": {...}}.

Each path's launch counts are set to 0 just before it and read just
after; a path that does not launch each of its kernels fails.

Exits non-zero, printing no result, when CUDA is not available or when
the port's package is not beside this script.
"""

from __future__ import annotations

import argparse
import json
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
#: the pick loop's float32 SelectorSpread math)
HBM_BYTES_PER_S = 3.35e12
F64_FLOP_PER_S = 34e12
F32_FLOP_PER_S = 67e12


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


def kernel_device_ms(fn, name, n=20, tries=3):
    """-> (mean device time of the kernel `name` per launch, summed device
    time of every kernel per call of fn), in ms, over n calls of fn, from
    the profiler's CUPTI trace. A trace that shows no device time for
    `name` is taken again, up to `tries` traces in all (one of some fifty
    traces in a run has come back empty); then it raises."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total_us, count, all_us = 0.0, 0, 0.0
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", 0.0)
            all_us += us
            if name in ev.key:
                total_us += us
                count += ev.count
        if count and total_us:
            return total_us / count / 1e3, all_us / n / 1e3
    raise RuntimeError(f"{tries} profiler traces show no device time for "
                       f"{name}")


def device_busy_ms(fn):
    """-> (summed device time of every kernel and copy, in ms, or None
    when the trace shows none; wall seconds) of one traced call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the device-side events (kernels, copies) carry the device time;
    # host ops' totals would count it a second time
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
        ms, call_device_ms = kernel_device_ms(launch,
                                              "resource_probe_kernel")
        call_ms = cuda_ms(launch)
        plain_ms = cuda_ms(lambda: PK.resource_probe_plain(
            J, alloc, usage, pod, terms, wants_res=wants_res))
        bound_ms, bound_by = probe_bound_ms(J, N)
        row = dict(ms=ms, call_device_ms=call_device_ms, call_ms=call_ms,
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


def zreplay_bound_ms(N, K, steps) -> tuple:
    """Least time for one run's pick loop: its inputs read once (eleven
    i64 rows, the u8 fit row, the i32 zones, five scalars) and its outputs
    written once (chosen i32[K], j i64[N], three i64) over the HBM rate;
    the float32 SelectorSpread arithmetic (a division and four multiply
    or add operations per node per step run) over the float32 rate.
    -> (ms, "bytes" | "operations")."""
    nbytes = N * (11 * 8 + 1 + 4) + 5 * 8 + K * 4 + N * 8 + 3 * 8
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 5 * N * steps / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


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


def phase_k3(ZK, S):
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
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                  for a, b in zip(got, want))
        max_err = max(max_err, err)
        picks = int((got[0] >= 0).sum())
        ms, _ = kernel_device_ms(
            lambda: ZK._launch(nodes, scalars, weights, **kw),
            "zreplay_kernel", n=3 if kw["K"] > 8192 else 10)
        bound_ms, bound_by = zreplay_bound_ms(N, kw["K"], picks)
        row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, bound_share=bound_ms / ms,
                   picks=picks, us_per_pick=ms * 1e3 / max(picks, 1),
                   scratch_bytes=ZK.scratch_bytes(N, kw["num_zones"]))
        results[label] = row
        emit("k3_vs_plain", case=label, N=N, K=kw["K"],
             k_real=kw["k_real"], num_zones=kw["num_zones"], equal=equal,
             max_abs_err=err, state=got[2].tolist(), library_call="none",
             **row)
        if not equal:
            raise AssertionError(f"K3 != plain on {label}")
    return results, max_err


# -- phases 4 and 5: the scheduler -------------------------------------------


def phase_main_path(PK, ZK, T, ClusterState, TorchScheduleAlgorithm, S):
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


def phase_mixed(PK, ZK, T, ClusterState, GenericScheduler,
                TorchScheduleAlgorithm, S):
    nodes, services = S.mixed_cluster(T, 1000)
    pods = S.mixed_backlog(T, scale=2)
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
    t1 = time.perf_counter()
    want = GenericScheduler().schedule_backlog(pods, state.clone())
    oracle_wall = time.perf_counter() - t1
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from kubernetes_tpu_torch.api import types as T
    from kubernetes_tpu_torch.harness import scenarios as S
    from kubernetes_tpu_torch.models import replay
    from kubernetes_tpu_torch.native.build import ptxas_report
    from kubernetes_tpu_torch.oracle import ClusterState, GenericScheduler
    from kubernetes_tpu_torch.ops import probe_kernel as PK
    from kubernetes_tpu_torch.ops import zreplay_kernel as ZK
    from kubernetes_tpu_torch.scheduler.algorithm import (
        TorchScheduleAlgorithm,
    )

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)

    # one nvcc per kernel source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        k1_lib, k3_lib = pool.map(lambda K: K.build(), (PK, ZK))
    emit("build", kernels=["resource_probe", "zreplay"],
         seconds=time.perf_counter() - t0,
         ptxas={"resource_probe": ptxas_report(k1_lib,
                                               "resource_probe_kernel"),
                "zreplay": ptxas_report(k3_lib, "zreplay_kernel")},
         c_replay=replay._load_lib() is not None)

    times, max_err = phase_kernel(PK, S)
    if args.baseline:
        phase_baseline(PK, S, args.baseline)
    k3_times, k3_err = phase_k3(ZK, S)
    launches, density_shapes = phase_main_path(
        PK, ZK, T, ClusterState, TorchScheduleAlgorithm, S)
    z_k1, z_k1_shapes, z_k3, z_k3_shapes = phase_zoned_density(
        PK, ZK, T, ClusterState, TorchScheduleAlgorithm, S,
        replay.replay_spec)
    tpl_k1, tpl_k1_shapes = phase_many_templates(
        PK, T, ClusterState, TorchScheduleAlgorithm, S)
    mixed_launches, mixed_shapes, mixed_k3, mixed_k3_shapes = phase_mixed(
        PK, ZK, T, ClusterState, GenericScheduler, TorchScheduleAlgorithm,
        S)

    # the density path probes J=128 over the 5,000 nodes padded to 8,192;
    # the zoned density path runs one 50,000-pick run in a 65,536 bucket
    k1 = times[(128, 8192)]
    k3 = k3_times["main N=8192 K=65536"]
    print(json.dumps({"kernels": [{
        "name": "resource_probe",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/csrc/probe_kernel.cu",
        "replaces": "kubernetes_tpu/ops/pallas_probe.py:63",
        "launches": launches,
        "launches_by_path": {"density": launches, "zoned_density": z_k1,
                             "many_templates": tpl_k1,
                             "mixed": mixed_launches},
        "launches_by_shape": {"density": density_shapes,
                              "zoned_density": z_k1_shapes,
                              "many_templates": tpl_k1_shapes,
                              "mixed": mixed_shapes},
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
        "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
